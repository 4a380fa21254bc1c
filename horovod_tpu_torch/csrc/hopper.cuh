// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, TMA tile loads through a tensor map, and warpgroup matrix
// products (wgmma) with operands in 128-byte-swizzled shared memory.
//
// Shared-memory tiles are written by TMA with CU_TENSOR_MAP_SWIZZLE_128B
// and a box 64 bf16 (128 bytes) wide: a tile of R rows is R x 128 bytes,
// 8-row groups 1024 bytes apart, the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8).  Every tile starts on a 1024-byte boundary, so the
// hardware's swizzle (on address bits [4:7) ^ [7:10)) agrees with TMA's,
// and a descriptor may start 32, 64 or 96 bytes into a row.  A head dim of
// 128 is two such tiles side by side ("halves"), each 64 columns wide.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hvd {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and raises the barrier's expected transaction bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completion is reported to `bar` in bytes.
// Elements outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Moves registers between warpgroups: every warp of the warpgroup runs it.
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B).  K-major operands use only the stride offset (1024: the
// next 8-row group); MN-major ones take the leading offset as the distance
// between 64-column halves and the stride offset as the next 8 rows of K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the points where it starts and ends.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define HVD_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HVD_ACC16(d, i) \
  HVD_ACC4(d, i), HVD_ACC4(d, i + 4), HVD_ACC4(d, i + 8), HVD_ACC4(d, i + 12)
#define HVD_ACC32(d) HVD_ACC16(d, 0), HVD_ACC16(d, 16)
#define HVD_ACC64(d) \
  HVD_ACC16(d, 0), HVD_ACC16(d, 16), HVD_ACC16(d, 32), HVD_ACC16(d, 48)

#define HVD_REGS32                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "   \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "   \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define HVD_REGS64                                            \
  HVD_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "   \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// The accumulator of m64nNk16 with fp32 D: thread t of the warpgroup
// (warp w = t / 32, g = (t % 32) / 4, t2 = 2 * (t % 4)) holds, for
// j < N / 8,
//   d[4j + 0] = (16w + g,     8j + t2)   d[4j + 1] = (16w + g,     8j + t2 + 1)
//   d[4j + 2] = (16w + g + 8, 8j + t2)   d[4j + 3] = (16w + g + 8, 8j + t2 + 1)
// and the A operand from registers (m64k16 bf16) takes, for the same rows,
//   a[0] = (r, t2..t2+1), a[1] = (r + 8, t2..t2+1),
//   a[2] = (r, t2+8..t2+9), a[3] = (r + 8, t2+8..t2+9):
// an accumulator's columns 16k..16k+15 packed to bf16 pairs are the A
// operand of k-slice k (pack_a below).

// D[64, N] (+)= A[64, 16] B[16, N]; A and B from shared memory, both
// K-major.  `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HVD_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HVD_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" HVD_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HVD_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64, N] += A[64, 16] B[16, N]; A from registers, B from shared memory
// MN-major (stored [k][n], the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HVD_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HVD_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" HVD_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HVD_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, accumulate);
  else wgmma_ss_n128(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator columns [16k, 16k + 16) of every k as bf16 A operands.
template <int NACC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NACC / 8][4],
                                       const float (&acc)[NACC]) {
#pragma unroll
  for (int k = 0; k < NACC / 8; ++k) {
    a[k][0] = pack_bf16(acc[8 * k + 0], acc[8 * k + 1]);
    a[k][1] = pack_bf16(acc[8 * k + 2], acc[8 * k + 3]);
    a[k][2] = pack_bf16(acc[8 * k + 4], acc[8 * k + 5]);
    a[k][3] = pack_bf16(acc[8 * k + 6], acc[8 * k + 7]);
  }
}

}  // namespace sm90
}  // namespace hvd
