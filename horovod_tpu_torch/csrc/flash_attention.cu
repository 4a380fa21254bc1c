// Flash attention, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/pallas/flash_attention.py:
//   forward  _fwd_kernel     (:130, built in _fwd :190, pallas_call :204)
//   dq       _bwd_dq_kernel  (:228, built in _bwd :337, pallas_call :368)
//   dk, dv   _bwd_dkv_kernel (:277, built in _bwd :337, pallas_call :385)
//
// Bound on the H100: operations.  At the main-path shape (q/k/v
// [8, 2048, 8, 128] bf16, causal) the products of the causal lower
// triangle come to 6.9e10 operations for the forward (two products),
// 1.03e11 for dq (three) and 1.37e11 for dk/dv (four): 0.069, 0.104 and
// 0.139 ms at 989 TFLOP/s bf16.  Reading q, k, v (and dO) once and writing
// the outputs once is about 0.04 ms at 3.35 TB/s, so the tensor cores, not
// the memory, are the limit.
//
// Two designs live here, chosen by dtype in the C entry points.
//
// bf16, every kernel (namespace sm90k): wgmma, TMA, one producer warp.
// - Block of 384 threads: two consumer warpgroups and a producer
//   warpgroup, of which one warp makes the copies.
//   Forward: persistent, one block an SM (or one a work tile, if fewer).
//   A work tile is 128 query rows of one (b, h), 64 a warpgroup (wgmma
//   m64), looping over 128-key K/V tiles; the tiles go out longest first
//   (q tile descending, b*h fastest) in a fixed snake over the blocks
//   (block x takes tiles i G + x for even i, i G + G - 1 - x for odd i, G
//   blocks), which evens the causal tiles' lengths out: at the main shape
//   the busiest of 132 blocks has 3% more key tiles than the mean (a
//   plain stride, 9%).  The schedule does not depend on timing.  dq: 128
//   query rows a block, 64 a warpgroup, looping over 64-key K/V tiles.
//   dk/dv: 128 keys a block, 64 a warpgroup, looping over 64-query Q/dO
//   tiles.  Q (forward, per tile), Q and dO (dq), K and V (dk/dv) load
//   once and stay in shared memory.
// - Copies: TMA through 4-D tensor maps (D, H, T, B) over the tensors' own
//   strides (the qkv.unbind views need no copy), built in the C entry
//   point and passed as __grid_constant__ parameters.  The box is 64
//   columns (128 bytes) wide with 128-byte swizzle; D = 128 is two boxes
//   side by side.  Rows past T and columns past D are zero-filled by the
//   copy engine, so D <= 64 runs the 64-column instance and 64 < D <= 128
//   the 128-column one.  Each stage is handed over through a "full"
//   mbarrier (TMA transaction bytes) and returned through an "empty" one
//   (one arrival per consumer warp).  Forward: Q in two buffers, so that
//   the producer loads the next tile's Q, and its first K and V stages,
//   while the consumers finish the current tile; K and V in separate
//   rings (3 K and 2 V stages at D = 128, 3 and 3 at D = 64): K is
//   returned as soon as S has retired, V after P V, and the producer
//   loads K of key tile k + 1 before V of tile k.  The rings' phases, the
//   Q buffer and the turn order run on counters that carry from one work
//   tile of a block to the next; m, l and O start afresh at each tile.
//   2 + 3 + 2 tiles of 32 KB fill 225 KB at D = 128, so 3 K stages leave
//   room for only 2 of V (3 + 2, 2 + 2 and 2 + 3 timed alike on an H100).
//   dq: 3 stages of K/V; dk/dv: 3 stages of Q/dO/lse/delta.  lse is used
//   as log2(e) * lse, or +inf for rows past T_q or fully masked, so that p
//   = exp2(s - lse) is 0 there without a test: staged by the producer in
//   dk/dv, held in registers for a thread's two rows in dq.
// - Products on wgmma with fp32 accumulators in registers.  Forward: S =
//   Q K^T (m64n128k16, A and B K-major in shared memory), then O += P V
//   with P converted in place from S's accumulator to bf16 A-operand
//   registers and V read MN-major (transposed).  dq: S = Q K^T and dP =
//   dO V^T (m64n64k16 from shared memory), then dQ += dS K with dS from
//   registers and K read MN-major from the stage that served as S's B
//   operand; the scale is applied to dQ once, at the end.  dk/dv: S^T = K
//   Q^T and dP^T = V dO^T (m64n64k16 from shared memory), then dV += P^T dO
//   and dK += dS^T Q with P^T and dS^T from registers, dO and Q MN-major.
//   No P, dS or their transposes go through shared memory.  The forward
//   overlaps within a warpgroup (S of tile k is started together with O +=
//   P V of tile k - 1, O is rescaled while S runs, and the softmax of tile
//   k runs while P V is on the tensor cores), between the two (ping-pong:
//   named barriers hand the turn to issue products from one warpgroup to
//   the other, so that one's softmax runs while the other's products run),
//   and across work tiles (the turn that starts a tile's first S also
//   starts the previous tile's last P V, whose epilogue follows the new
//   tile's softmax).  dq runs its products in order: the overlap, tried
//   there, was the slower.
// - Forward epilogue: O / l in bf16 goes into the warpgroup's own 64 rows
//   of the Q buffer the tile retires, in the swizzled layout, and one
//   thread a warpgroup stores them with a TMA store through an O map
//   (rows past T_q and columns past D are clipped); the buffer goes back
//   to the producer once the store has read it (cp.async.bulk
//   wait_group.read), checked two turns later, so that the storing thread
//   seldom waits.  lse is a plain fp32 store.  dq and dk/dv store from
//   registers.
// - Softmax in log2 units with exp2 (ex2.approx), log2(e) folded into the
//   scale (in the forward, p = exp2(FFMA(s, scale, -max)) with the row max
//   taken on the raw scores); the causal and ragged masks only on tiles
//   that meet the diagonal or the ragged edge.  P and dS are rounded to
//   bf16 before their products; max, sums, lse, delta and accumulators
//   stay fp32.
// - Registers: the block starts with 168 a thread (65536 / 384);
//   setmaxnreg gives the producer warpgroup 24 and each consumer thread
//   240, which holds dk/dv's two 64 x 128 fp32 accumulators (128
//   registers) beside S^T and dP^T, dq's one beside S and dP, and the
//   forward's O beside S and P, without spilling (-Xptxas -v: no spills in
//   any instance).
//
// fp32, every kernel: full fp32 products (no TF32) with scalar FMAs, in
// the accumulator layout of mma.sync m16n8.  One block of 4 warps per
// (b*h, 64-row tile), each warp 16 rows; 64-row tiles of K/V (Q/dO) staged
// in shared memory by synchronous loads; P and dS through shared memory.
//
// Common to both:
// - No block writes another block's output, so the backward needs no
//   atomics and is deterministic (the reference's dq / dk-dv split, not
//   FlashAttention-2's atomic dq).
// - Causal skipping at tile granularity: the forward and dq stop at the
//   last key tile that meets the diagonal (reference :172-178, :270-271),
//   dk/dv starts at the first query tile that meets it (:325-329).  The
//   mask is top-left, q_pos >= k_pos from index 0 (:146-159), also when
//   T_q != T_kv.  The longest rows go first.
// - Any T: the ragged edge tile is zero-filled in the loads and masked,
//   which gives what the reference gives with smaller blocks.
// - out, dq, dk, dv are written as contiguous [B, T, H, D]; lse and delta
//   are plain fp32 [B*H, T_q] vectors (the TPU's packed 128-lane layout and
//   its MXU transposes are not needed here).
// - The running max starts at -1e30, not -inf, with the reference's guards
//   (:163-165, :181, :257-261), so fully masked rows give out 0, lse -1e30
//   and no gradient.
// Not yet done (later work): overlap of the elementwise work with the
// products inside a dq or dk/dv warpgroup, or a ping-pong of their
// warpgroups; TMA stores of dq, dk and dv; persistent dq and dk/dv.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTile = 64;               // rows of every tile
constexpr int kWarps = 4;               // 16 rows of the tile per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

// Shared-memory row pitch in elements: rows padded by 16 bytes, so that
// the rows one warp reads at the same column fall in distinct banks.
template <typename T> __host__ __device__ constexpr int padded(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}

// Element strides of a [B, T, H, D] tensor whose D is contiguous.
struct Strides {
  long long b, t, h;
};

// Warp-level fp32 product, in full fp32 with scalar FMAs, into
// accumulators laid out as mma.sync m16n8 C fragments: c[j] holds, for
// this lane (g = lane / 4, t2 = 2 * (lane % 4)), rows {g, g + 8} and
// columns {8j + t2, 8j + t2 + 1} of a [16, 8 * NT] result:
//   c[j][0] = (g, 8j + t2)      c[j][1] = (g, 8j + t2 + 1)
//   c[j][2] = (g + 8, 8j + t2)  c[j][3] = (g + 8, 8j + t2 + 1)
// C[16, ncols] += A[16, kdim] B[kdim, ncols].  A is row-major with pitch
// lda.  B is stored [n][k] with pitch ldb (the product is A B^T, kKN false)
// or [k][n] (kKN true).  ncols is a multiple of 8, at most 8 * NT.
template <bool kKN, int NT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int kdim, int ncols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  for (int k = 0; k < kdim; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < ncols) {
        const int n = j * 8 + t2;
        const float b0 = kKN ? B[k * ldb + n] : B[n * ldb + k];
        const float b1 = kKN ? B[k * ldb + n + 1] : B[(n + 1) * ldb + k];
        c[j][0] = fmaf(a0, b0, c[j][0]);
        c[j][1] = fmaf(a0, b1, c[j][1]);
        c[j][2] = fmaf(a1, b0, c[j][2]);
        c[j][3] = fmaf(a1, b1, c[j][3]);
      }
    }
  }
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a,
                                                             float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a,
                                                          float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
// (bf16: the stores of the sm90k kernels)
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [row0, row0 + kTile) of a [n_rows, d] slab whose rows lie
// row_stride elements apart, into shared memory with pitch ld.  Rows past
// n_rows are zero-filled.  16-byte vectors: d * sizeof(T), row_stride *
// sizeof(T) and the base address are multiples of 16 (checked by the
// wrapper).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int d, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = d / V;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Number of kTile-row key tiles that the query rows [q0, q_end) of a
// causal problem see: the last one holds key q_end - 1.
__device__ __forceinline__ int key_tiles(int q0, int tq, int tkv,
                                         bool causal) {
  const int all = (tkv + kTile - 1) / kTile;
  if (!causal) return all;
  const int q_end = min(q0 + kTile, tq);
  return min(all, (q_end - 1) / kTile + 1);
}

struct Problem {
  int h, tq, tkv, d;
  float scale;
  bool causal;
  Strides qs, ks, vs, dos;
};

// Shared memory of each kernel, in bytes, for head dim d.
template <typename T> __host__ __device__ constexpr int fwd_smem(int d) {
  return (3 * kTile * padded<T>(d) + kTile * padded<T>(kTile)) * sizeof(T);
}
template <typename T> __host__ __device__ constexpr int dq_smem(int d) {
  return (4 * kTile * padded<T>(d) + kTile * padded<T>(kTile)) * sizeof(T);
}
template <typename T> __host__ __device__ constexpr int dkv_smem(int d) {
  return (4 * kTile * padded<T>(d) + 2 * kTile * padded<T>(kTile)) *
             sizeof(T) + 2 * kTile * sizeof(float);
}

// ------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Problem pb, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = pb.d, ld = padded<T>(d), ldp = padded<T>(kTile);
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kTile * ld;
  T* sV = sK + kTile * ld;
  T* sP = sV + kTile * ld;

  const int bh = blockIdx.y, b = bh / pb.h, h = bh - b * pb.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wrow = warp * 16;
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const T* qg = q + b * pb.qs.b + h * pb.qs.h;
  const T* kg = k + b * pb.ks.b + h * pb.ks.h;
  const T* vg = v + b * pb.vs.b + h * pb.vs.h;
  load_tile(sQ, qg, pb.qs.t, q0, pb.tq, d, ld);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kMaxD / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int nk = key_tiles(q0, pb.tq, pb.tkv, pb.causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kg, pb.ks.t, k0, pb.tkv, d, ld);
    load_tile(sV, vg, pb.vs.t, k0, pb.tkv, d, ld);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    warp_mma<false, kTile / 8>(s, sQ + wrow * ld, ld, sK, ld, d, kTile);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t2 + (e & 1), row = rows[e >> 1];
        const bool keep = col < pb.tkv && (!pb.causal || row >= col);
        s[j][e] = keep ? s[j][e] * pb.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = m[i] > kNegInf / 2 ? expf(m[i] - mx[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[j][e] = mx[i] > kNegInf / 2 ? expf(s[j][e] - mx[i]) : 0.f;
        rsum[i] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + quad_sum(rsum[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kMaxD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // P (rounded to T) through shared memory, this warp's 16 rows only
    T* pw = sP + wrow * ldp;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      store2(pw + g * ldp + j * 8 + t2, s[j][0], s[j][1]);
      store2(pw + (g + 8) * ldp + j * 8 + t2, s[j][2], s[j][3]);
    }
    __syncwarp();
    warp_mma<true, kMaxD / 8>(o, pw, ldp, sV, ld, kTile, d);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= pb.tq) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    const float inv = 1.f / l_safe;
    T* orow = out + ((static_cast<long long>(b) * pb.tq + row) * pb.h + h) * d;
#pragma unroll
    for (int j = 0; j < kMaxD / 8; ++j)
      if (j * 8 < d)
        store2(orow + j * 8 + t2, o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    if (t2 == 0)
      lse[static_cast<long long>(bh) * pb.tq + row] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------------ dq
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(Problem pb, const T* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = pb.d, ld = padded<T>(d), ldp = padded<T>(kTile);
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = sQ + kTile * ld;
  T* sK = sDO + kTile * ld;
  T* sV = sK + kTile * ld;
  T* sDS = sV + kTile * ld;

  const int bh = blockIdx.y, b = bh / pb.h, h = bh - b * pb.h;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wrow = warp * 16;
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const T* kg = k + b * pb.ks.b + h * pb.ks.h;
  const T* vg = v + b * pb.vs.b + h * pb.vs.h;
  load_tile(sQ, q + b * pb.qs.b + h * pb.qs.h, pb.qs.t, q0, pb.tq, d, ld);
  load_tile(sDO, dout + b * pb.dos.b + h * pb.dos.h, pb.dos.t, q0, pb.tq, d,
            ld);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < pb.tq;
    const long long at = static_cast<long long>(bh) * pb.tq + rows[i];
    row_lse[i] = in ? lse[at] : kNegInf;
    row_delta[i] = in ? delta[at] : 0.f;
  }

  float acc[kMaxD / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nk = key_tiles(q0, pb.tq, pb.tkv, pb.causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(sK, kg, pb.ks.t, k0, pb.tkv, d, ld);
    load_tile(sV, vg, pb.vs.t, k0, pb.tkv, d, ld);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_mma<false, kTile / 8>(s, sQ + wrow * ld, ld, sK, ld, d, kTile);
    warp_mma<false, kTile / 8>(dp, sDO + wrow * ld, ld, sV, ld, d, kTile);
    T* dsw = sDS + wrow * ldp;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + j * 8 + t2 + (e & 1);
        // p = exp(s - lse), zero where masked or where the row is fully
        // masked (lse = -1e30, reference :257-261)
        const bool keep = col < pb.tkv && (!pb.causal || rows[i] >= col) &&
                          row_lse[i] > kNegInf / 2;
        const float p = keep ? expf(s[j][e] * pb.scale - row_lse[i]) : 0.f;
        ds[e] = p * (dp[j][e] - row_delta[i]) * pb.scale;
      }
      store2(dsw + g * ldp + j * 8 + t2, ds[0], ds[1]);
      store2(dsw + (g + 8) * ldp + j * 8 + t2, ds[2], ds[3]);
    }
    __syncwarp();
    warp_mma<true, kMaxD / 8>(acc, dsw, ldp, sK, ld, kTile, d);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= pb.tq) continue;
    T* drow =
        dq + ((static_cast<long long>(b) * pb.tq + rows[i]) * pb.h + h) * d;
#pragma unroll
    for (int j = 0; j < kMaxD / 8; ++j)
      if (j * 8 < d) store2(drow + j * 8 + t2, acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// --------------------------------------------------------------- dk, dv
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(Problem pb, const T* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = pb.d, ld = padded<T>(d), ldp = padded<T>(kTile);
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kTile * ld;
  T* sQ = sV + kTile * ld;
  T* sDO = sQ + kTile * ld;
  T* sP = sDO + kTile * ld;  // P^T: [key][query]
  T* sDS = sP + kTile * ldp;  // dS^T
  float* sLse = reinterpret_cast<float*>(sDS + kTile * ldp);
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.y, b = bh / pb.h, h = bh - b * pb.h;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wrow = warp * 16;
  const int keys[2] = {k0 + wrow + g, k0 + wrow + g + 8};

  const T* qg = q + b * pb.qs.b + h * pb.qs.h;
  const T* dog = dout + b * pb.dos.b + h * pb.dos.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * pb.tq;
  const float* delta_bh = delta + static_cast<long long>(bh) * pb.tq;
  load_tile(sK, k + b * pb.ks.b + h * pb.ks.h, pb.ks.t, k0, pb.tkv, d, ld);
  load_tile(sV, v + b * pb.vs.b + h * pb.vs.h, pb.vs.t, k0, pb.tkv, d, ld);

  float dk_acc[kMaxD / 8][4], dv_acc[kMaxD / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // query tiles strictly before this key tile see none of it
  const int nq = (pb.tq + kTile - 1) / kTile;
  const int first = pb.causal ? k0 / kTile : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(sQ, qg, pb.qs.t, q0, pb.tq, d, ld);
    load_tile(sDO, dog, pb.dos.t, q0, pb.tq, d, ld);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < pb.tq ? lse_bh[row] : kNegInf;
      sDelta[threadIdx.x] = row < pb.tq ? delta_bh[row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys, 32 queries
    // at a time (keeps the registers of the two dk/dv accumulators free)
    T* pw = sP + wrow * ldp;
    T* dsw = sDS + wrow * ldp;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * (kTile / 2);
      float st[kTile / 16][4], dpt[kTile / 16][4];
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      warp_mma<false, kTile / 16>(st, sK + wrow * ld, ld, sQ + c0 * ld, ld,
                                  d, kTile / 2);
      warp_mma<false, kTile / 16>(dpt, sV + wrow * ld, ld, sDO + c0 * ld, ld,
                                  d, kTile / 2);
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + t2 + (e & 1), key = keys[e >> 1];
          const int row = q0 + c;
          const float row_lse = sLse[c];
          const bool keep = row < pb.tq && key < pb.tkv &&
                            (!pb.causal || row >= key) &&
                            row_lse > kNegInf / 2;
          p[e] = keep ? expf(st[j][e] * pb.scale - row_lse) : 0.f;
          ds[e] = p[e] * (dpt[j][e] - sDelta[c]) * pb.scale;
        }
        const int col = c0 + j * 8 + t2;
        store2(pw + g * ldp + col, p[0], p[1]);
        store2(pw + (g + 8) * ldp + col, p[2], p[3]);
        store2(dsw + g * ldp + col, ds[0], ds[1]);
        store2(dsw + (g + 8) * ldp + col, ds[2], ds[3]);
      }
    }
    __syncwarp();
    warp_mma<true, kMaxD / 8>(dv_acc, pw, ldp, sDO, ld, kTile, d);
    warp_mma<true, kMaxD / 8>(dk_acc, dsw, ldp, sQ, ld, kTile, d);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= pb.tkv) continue;
    const long long at =
        ((static_cast<long long>(b) * pb.tkv + keys[i]) * pb.h + h) * d;
#pragma unroll
    for (int j = 0; j < kMaxD / 8; ++j) {
      if (j * 8 < d) {
        store2(dk + at + j * 8 + t2, dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
        store2(dv + at + j * 8 + t2, dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------- launching
// Above 48 KB, dynamic shared memory must be allowed per kernel, once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool valid(int b, int h, int tq, int tkv, int d) {
  return b > 0 && h > 0 && tq > 0 && tkv > 0 && d % 16 == 0 && d >= 16 &&
         d <= kMaxD && static_cast<long long>(b) * h <= 65535;
}

// strides: 3 per tensor (batch, seq, head), in argument order
Problem problem(int h, int tq, int tkv, int d, float scale, int causal,
                const long long* strides, int n_tensors) {
  Problem pb{h, tq, tkv, d, scale, causal != 0, {}, {}, {}, {}};
  Strides* dst[4] = {&pb.qs, &pb.ks, &pb.vs, &pb.dos};
  for (int i = 0; i < n_tensors; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return pb;
}

template <typename T>
cudaError_t launch_fwd(const Problem& pb, int b, const void* q,
                       const void* k, const void* v, void* out, void* lse,
                       cudaStream_t s) {
  static const cudaError_t once =
      allow_smem(flash_fwd_kernel<T>, fwd_smem<T>(kMaxD));
  if (once != cudaSuccess) return once;
  const dim3 grid((pb.tq + kTile - 1) / kTile, b * pb.h);
  flash_fwd_kernel<T><<<grid, kThreads, fwd_smem<T>(pb.d), s>>>(
      pb, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const Problem& pb, int b, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* delta, void* dq, cudaStream_t s) {
  static const cudaError_t once =
      allow_smem(flash_bwd_dq_kernel<T>, dq_smem<T>(kMaxD));
  if (once != cudaSuccess) return once;
  const dim3 grid((pb.tq + kTile - 1) / kTile, b * pb.h);
  flash_bwd_dq_kernel<T><<<grid, kThreads, dq_smem<T>(pb.d), s>>>(
      pb, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Problem& pb, int b, const void* q,
                       const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk,
                       void* dv, cudaStream_t s) {
  static const cudaError_t once =
      allow_smem(flash_bwd_dkv_kernel<T>, dkv_smem<T>(kMaxD));
  if (once != cudaSuccess) return once;
  const dim3 grid((pb.tkv + kTile - 1) / kTile, b * pb.h);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, dkv_smem<T>(pb.d), s>>>(
      pb, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

// ===================================================== bf16 on Hopper
// The bf16 kernels: wgmma products, TMA tile loads through a ring of
// shared-memory stages, one producer warp beside two consumer warpgroups.
// See the note at the top of the file.
namespace sm90k {

using namespace hvd::sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;    // warpgroups 0, 1 consume; 2 loads
constexpr int kProducerWarp = 8;  // the one warp of warpgroup 2 that works
constexpr int kConsumerWarps = 8;
// Registers a thread after setmaxnreg: the block starts with 168 each
// (65536 / 384, rounded down to 8); the producer warpgroup gives most of
// its share to the two consumer warpgroups (2 x 128 x 240 + 128 x 24 =
// 168 x 384).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBwdStages = 3;    // Q/dO/lse/delta stages
constexpr int kFwdM = 128;       // query rows of a forward block
constexpr int kFwdN = 128;       // keys of a forward K/V tile
constexpr int kBwdN = 128;       // keys of a dk/dv block
constexpr int kBwdM = 64;        // queries of a dk/dv Q/dO tile
constexpr int kDqStages = 3;     // K/V stages of dq
constexpr int kDqM = 128;        // query rows of a dq block
constexpr int kDqN = 64;         // keys of a dq K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One 64-column half of a rows x D tile, in elements.
__host__ __device__ constexpr int half_elems(int rows) { return rows * 64; }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// K-major operand: rows [row0, row0 + 64 or N) of a tile, k-slice kk
// (16 columns; half kk / 4, 32 bytes per slice inside the half).
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* tile, int rows,
                                                int row0, int kk) {
  return sw128_desc(tile + (kk / 4) * half_elems(rows) + row0 * 64 +
                        (kk % 4) * 16,
                    16, 1024);
}

// kmajor_desc(tile, rows, row0, kk) - kmajor_desc(tile, rows, row0, 0)
// (the start address in 16-byte units; no carry: shared memory < 256 KB).
__host__ __device__ constexpr uint64_t kmajor_step(int rows, int kk) {
  return static_cast<uint64_t>((kk / 4) * half_elems(rows) * 2 +
                               (kk % 4) * 32) / 16;
}

// MN-major operand [k][n] of a rows x D tile: k-slice kk is rows
// [16 kk, 16 kk + 16); n runs over D, the next 64 columns one half on.
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* tile, int rows,
                                                 int kk) {
  return sw128_desc(tile + kk * 16 * 64, half_elems(rows) * 2, 1024);
}

// Shared memory, in bytes from a 1024-aligned base.  Forward: two Q
// buffers (the one a tile retires also stages its O for the TMA store), KS
// K stages and VS V stages; at D = 128, 2 + 3 + 2 tiles of 32 KB and the
// barriers fill 225 KB of the 227 KB a block may use.
template <int D, int KS, int VS> struct FwdLayout {
  static constexpr int kQ = kFwdM * D * 2;       // one Q (or O) tile
  static constexpr int kKV = kFwdN * D * 2;      // one K or V tile
  static constexpr int kK0 = 2 * kQ;
  static constexpr int kV0 = kK0 + KS * kKV;
  static constexpr int kBars = kV0 + VS * kKV;
  // q_full[2], q_empty[2], k_full[KS], k_empty[KS], v_full[VS], v_empty[VS]
  static constexpr int kBytes = kBars + (4 + 2 * KS + 2 * VS) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// K and V stages of the forward for head dim D.
template <int D> struct FwdStages;
template <> struct FwdStages<64> { static constexpr int kK = 3, kV = 3; };
template <> struct FwdStages<128> { static constexpr int kK = 3, kV = 2; };

// Every tile starts on a 1024-byte boundary (the swizzle's period).
template <int D> struct BwdLayout {
  static constexpr int kStages = kBwdStages;
  static constexpr int kKV = kBwdN * D * 2;      // K or V, resident
  static constexpr int kQ = kBwdM * D * 2;       // one Q or dO tile
  static constexpr int kStage = 2 * kQ;          // Q and dO of a stage
  static constexpr int kStages0 = 2 * kKV;
  static constexpr int kRows = kStages0 + kStages * kStage;  // lse, delta
  static constexpr int kBars = kRows + kStages * 2 * kBwdM * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

template <int D> struct DqLayout {
  static constexpr int kStages = kDqStages;
  static constexpr int kQ = kDqM * D * 2;        // Q or dO, resident
  static constexpr int kKV = kDqN * D * 2;       // one K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kStages0 = 2 * kQ;
  static constexpr int kBars = kStages0 + kStages * kStage;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// ------------------------------------------------------------- forward
// Persistent: gridDim.x blocks (at most one an SM) walk the work tiles,
// each 128 query rows of one (b, h).  Tile t is q tile n_qt - 1 - t / BH
// (the longest rows first) of bh = t % BH; block x takes tiles i * G + x
// for even i and i * G + G - 1 - x for odd i (G = gridDim.x), a snake
// that evens out the causal tiles' lengths over the blocks.  Consumer
// warpgroup wg owns rows [64 wg, 64 wg + 64) of every tile.
template <int D, int KS, int VS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap o_map, Problem pb,
                   int n_bh, float* __restrict__ lse) {
  using L = FwdLayout<D, KS, VS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* k_empty = k_full + KS;
  uint64_t* v_full = k_empty + KS;
  uint64_t* v_empty = v_full + VS;
  auto sQ = [&](int i) { return reinterpret_cast<bf16*>(sm + i * L::kQ); };
  auto sK = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::kK0 + s * L::kKV);
  };
  auto sV = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::kV0 + s * L::kKV);
  };

  const int n_qt = (pb.tq + kFwdM - 1) / kFwdM;
  const int n_tiles = n_qt * n_bh;
  const int all = (pb.tkv + kFwdN - 1) / kFwdN;
  // the i-th tile of this block, or -1 past the last
  auto tile_of = [&](int i) {
    const int x = (i & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int t = i * gridDim.x + x;
    return t < n_tiles ? t : -1;
  };
  struct Work {
    int b, h, bh, q0, nk;
  };
  auto work = [&](int t) {
    Work w;
    const int r = t / n_bh;
    w.bh = t - r * n_bh;
    w.b = w.bh / pb.h;
    w.h = w.bh - w.b * pb.h;
    w.q0 = (n_qt - 1 - r) * kFwdM;
    // the last key tile holds key q_end - 1 (top-left causal)
    const int q_end = min(w.q0 + kFwdM, pb.tq);
    w.nk = pb.causal ? min(all, (q_end - 1) / kFwdN + 1) : all;
    return w;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2);  // the storing thread of each warpgroup
    }
    for (int s = 0; s < KS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Key tiles are counted over all of a block's work tiles (`it`), and so
  // are the Q buffers (`i`): the rings' phases carry from tile to tile.
  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      int it = 0;
      for (int i = 0, t; (t = tile_of(i)) >= 0; ++i) {
        const Work w = work(t);
        const int qb = i & 1;
        // the O of tile i - 2, staged in this buffer, has been read out
        mbar_wait(&q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], L::kQ);
        for (int hf = 0; hf < D / 64; ++hf)
          tma_load_4d(sQ(qb) + hf * half_elems(kFwdM), &q_map, &q_full[qb],
                      64 * hf, w.h, w.q0, w.b);
        // K of key tile kt ahead of V of kt - 1: S needs K one turn
        // before P V needs V
        for (int kt = 0; kt <= w.nk; ++kt) {
          if (kt < w.nk) {
            const int j = it + kt, s = j % KS;
            mbar_wait(&k_empty[s], ((j / KS) & 1) ^ 1);
            mbar_arrive_expect_tx(&k_full[s], L::kKV);
            for (int hf = 0; hf < D / 64; ++hf)
              tma_load_4d(sK(s) + hf * half_elems(kFwdN), &k_map, &k_full[s],
                          64 * hf, w.h, kt * kFwdN, w.b);
          }
          if (kt > 0) {
            const int j = it + kt - 1, s = j % VS;
            mbar_wait(&v_empty[s], ((j / VS) & 1) ^ 1);
            mbar_arrive_expect_tx(&v_full[s], L::kKV);
            for (int hf = 0; hf < D / 64; ++hf)
              tma_load_4d(sV(s) + hf * half_elems(kFwdN), &v_map, &v_full[s],
                          64 * hf, w.h, (kt - 1) * kFwdN, w.b);
          }
        }
        it += w.nk;
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bool storer = (threadIdx.x & 127) == 0;  // issues the O store
  const float c = pb.scale * kLog2e;  // scores in log2 units

  // Ping-pong: the warpgroups take turns to issue their products, so that
  // one's softmax runs while the other's products are on the tensor cores.
  // Named barrier 1 + wg is warpgroup wg's turn (its 128 threads wait, the
  // other's 128 arrive); warpgroup 0 goes first.  Both warpgroups run the
  // same turns in the same order (a warpgroup whose rows lie past T_q
  // computes on the zero-filled rows), so the turns stay in step.
  auto turn_wait = [&] { hvd::bar_sync(1 + wg, 256); };
  auto turn_pass = [&] { hvd::bar_arrive(2 - wg, 256); };
  if (wg == 1) turn_pass();

  auto wait_k = [&](int j) { mbar_wait(&k_full[j % KS], (j / KS) & 1); };
  auto wait_v = [&](int j) { mbar_wait(&v_full[j % VS], (j / VS) & 1); };
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };

  float o[D / 2], sc[kFwdN / 2], alpha[2], m[2], l[2];
  uint32_t pa[kFwdN / 16][4];

  // The descriptors of k-slice kk are those of slice 0 plus a constant
  // (their address field counts 16 bytes), so a turn computes two.
  // S = Q K^T of key tile j: this warpgroup's 64 rows, 128 keys
  auto start_scores = [&](int j, const bf16* q_tile) {
    const uint64_t a0 = kmajor_desc(q_tile, kFwdM, wg * 64, 0);
    const uint64_t b0 = kmajor_desc(sK(j % KS), kFwdN, 0, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kFwdN>(sc, a0 + kmajor_step(kFwdM, kk),
                      b0 + kmajor_step(kFwdN, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of key tile j, P (bf16) from registers.  No wgmma of these
  // two may sit behind a branch (say, to skip the masked half of a
  // diagonal tile): ptxas then serializes the whole pipeline (C7520).
  auto start_pv = [&](int j) {
    const uint64_t b0 = mnmajor_desc(sV(j % VS), kFwdN, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdN / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], b0 + kk * 16 * 64 * 2 / 16);
    wgmma_commit();
  };
  // O *= alpha of the last softmax, before the P V that adds to it
  auto rescale = [&] {
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * jj + e] *= alpha[e >> 1];
  };
  // Online softmax of key tile kt of the work tile at q0, in log2 units:
  // S becomes P (fp32) in place, m and l move on, alpha rescales O.  The
  // row max of c s comes from the raw scores (c max s, or c min s for c <
  // 0: the same value, since rounding keeps the order), so that p =
  // exp2(c s - m) is one FFMA and one exp2 an element.  Masks only on the
  // tiles that meet the diagonal or the ragged edge of the keys: a masked
  // score becomes the sentinel `none` (+-1e30, never a max) and then p = 0.
  auto softmax = [&](int q0, int kt) {
    const int wg_row_min = q0 + wg * 64;
    const int row0 = wg_row_min + w4 * 16 + g;  // and row0 + 8
    const int k0 = kt * kFwdN;
    const bool need_mask = (pb.causal && k0 + kFwdN - 1 > wg_row_min) ||
                           k0 + kFwdN > pb.tkv;
    const bool up = c >= 0.f;  // the same in every thread
    const float none = up ? kNegInf : -kNegInf;
    float mr[2] = {none, none};
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kFwdN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool keep = col < pb.tkv && (!pb.causal || row >= col);
          float& x = sc[4 * j + e];
          x = keep ? x : none;
          mr[e >> 1] = up ? fmaxf(mr[e >> 1], x) : fminf(mr[e >> 1], x);
        }
    } else if (up) {
#pragma unroll
      for (int j = 0; j < kFwdN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mr[e >> 1] = fmaxf(mr[e >> 1], sc[4 * j + e]);
    } else {
#pragma unroll
      for (int j = 0; j < kFwdN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mr[e >> 1] = fminf(mr[e >> 1], sc[4 * j + e]);
    }
    float base[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mr[r] = up ? quad_max(mr[r]) : quad_min(mr[r]);
      const float mx = fmaxf(m[r], mr[r] != none ? mr[r] * c : kNegInf);
      // exp2(-1e30 - finite) is 0: a row seen for the first time drops
      // its empty past; a row with no key yet keeps l = 0, o = 0
      alpha[r] = fast_exp2(m[r] - mx);
      base[r] = mx > kNegInf / 2 ? mx : 0.f;
      m[r] = mx;
    }
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kFwdN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[4 * j + e];
          x = x == none ? 0.f : fast_exp2(fmaf(x, c, -base[e >> 1]));
          rsum[e >> 1] += x;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kFwdN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[4 * j + e];
          x = fast_exp2(fmaf(x, c, -base[e >> 1]));
          rsum[e >> 1] += x;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] + quad_sum(rsum[r]);
  };

  // Epilogue of work tile w (Q buffer qb, statistics mm, ll): O / l in
  // bf16 into this warpgroup's 64 rows of the Q buffer (its last S has
  // retired; the other warpgroup reads only its own rows), in the
  // 128-byte-swizzled layout of a load: the 16-byte chunk ch of row r at
  // ch ^ (r % 8), where r % 8 = g.  Then one thread stores the rows
  // through the O map, which clips rows past T_q.  The buffer goes back
  // to the producer once the store has read it (retire_store).
  int stored = -1;  // Q buffer whose O store may still be reading it
  auto epilogue = [&](const Work& w, int qb, const float (&mm)[2],
                      const float (&ll)[2]) {
    bf16* const o_tile = sQ(qb);
    const int wg_row_min = w.q0 + wg * 64;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_safe = ll[r] > 0.f ? ll[r] : 1.f;
      const float inv = 1.f / l_safe;
      bf16* orow = o_tile + (wg * 64 + w4 * 16 + g + 8 * r) * 64;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + (j / 8) * half_elems(kFwdM) +
                                     ((j % 8) ^ g) * 8 + t2) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      const int row = wg_row_min + w4 * 16 + g + 8 * r;
      if (t2 == 0 && row < pb.tq)
        lse[static_cast<long long>(w.bh) * pb.tq + row] =
            mm[r] > kNegInf / 2 ? (mm[r] + log2f(l_safe)) * kLn2 : kNegInf;
    }
    fence_proxy_async();
    hvd::bar_sync(3 + wg, 128);
    if (storer && wg_row_min < pb.tq) {
      for (int hf = 0; hf < D / 64; ++hf)
        tma_store_4d(&o_map, o_tile + hf * half_elems(kFwdM) + wg * 64 * 64,
                     64 * hf, w.h, wg_row_min, w.b);
      bulk_commit();
    }
    stored = qb;
  };
  auto retire_store = [&] {
    if (stored >= 0) {
      if (storer) {
        bulk_wait_read<0>();
        mbar_arrive(&q_empty[stored]);
      }
      stored = -1;
    }
  };

  // One stream of turns over all of the block's key tiles: the first S
  // alone; then each turn starts S of key tile `it`, rescales O while S
  // runs and starts O += P V of key tile it - 1, and the softmax of `it`
  // runs while P V is on the tensor cores.  A turn whose S opens the next
  // work tile also finishes the last one (its last P V, then its epilogue
  // after the new tile's softmax), so the tensor cores do not wait at the
  // seams between work tiles; m, l and O start afresh there.  The last P V
  // of the block alone.
  int i = 0, t = tile_of(0);
  if (t >= 0) {
    Work w = work(t);
    int it = 0;  // key tiles whose S has been started, over all tiles
    mbar_wait(&q_full[0], 0);
    wait_k(0);
    turn_wait();
    start_scores(0, sQ(0));
    turn_pass();
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    wgmma_wait<0>();
    fence_regs(sc);
    release(&k_empty[0]);
    softmax(w.q0, 0);
    pack_a<kFwdN / 2>(pa, sc);
    ++it;
    for (;;) {
      const bf16* q_tile = sQ(i & 1);
      for (int kt = 1; kt < w.nk; ++kt, ++it) {
        wait_k(it);
        turn_wait();
        start_scores(it, q_tile);
        rescale();
        wait_v(it - 1);
        start_pv(it - 1);
        turn_pass();
        if (kt == 2) retire_store();  // the store has had a turn to read
        wgmma_wait<1>();  // S done; P V of it - 1 may still run
        fence_regs(sc);
        release(&k_empty[it % KS]);
        softmax(w.q0, kt);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(&v_empty[(it - 1) % VS]);
        pack_a<kFwdN / 2>(pa, sc);
      }
      const int tn = tile_of(i + 1);
      if (tn < 0) break;
      // the next work tile's first S beside this one's last P V
      const Work wn = work(tn);
      const int qn = (i + 1) & 1;
      retire_store();  // if not yet: the producer needs it for this Q
      mbar_wait(&q_full[qn], ((i + 1) >> 1) & 1);
      wait_k(it);
      turn_wait();
      start_scores(it, sQ(qn));
      rescale();
      wait_v(it - 1);
      start_pv(it - 1);
      turn_pass();
      const float mp[2] = {m[0], m[1]}, lp[2] = {l[0], l[1]};
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      wgmma_wait<1>();
      fence_regs(sc);
      release(&k_empty[it % KS]);
      softmax(wn.q0, 0);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(&v_empty[(it - 1) % VS]);
      epilogue(w, i & 1, mp, lp);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      pack_a<kFwdN / 2>(pa, sc);
      ++it;
      ++i;
      w = wn;
    }
    turn_wait();
    rescale();
    wait_v(it - 1);
    start_pv(it - 1);
    turn_pass();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(&v_empty[(it - 1) % VS]);
    epilogue(w, i & 1, m, l);
  }
  if (wg == 0) turn_wait();  // warpgroup 1's last pass
  if (storer) bulk_wait_read<0>();
}

// --------------------------------------------------------------- dk, dv
// Block: 128 keys of one (b, h); consumer warpgroup wg owns keys
// [64 wg, 64 wg + 64).  K and V stay in shared memory; Q, dO, lse and
// delta come in 64-query tiles through kStages stages.  The producer warp
// stages lse (as log2 e * lse, +inf where the row is past T_q or fully
// masked, so that exp2 gives p = 0 there) and delta beside the tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map, Problem pb,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv) {
  using L = BwdLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(sm);
  bf16* sV = reinterpret_cast<bf16*>(sm + L::kKV);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  auto stage = [&](int s) { return sm + L::kStages0 + s * L::kStage; };
  auto sQ = [&](int s) { return reinterpret_cast<bf16*>(stage(s)); };
  auto sDO = [&](int s) { return reinterpret_cast<bf16*>(stage(s) + L::kQ); };
  auto sLse = [&](int s) {
    return reinterpret_cast<float*>(sm + L::kRows) + s * 2 * kBwdM;
  };
  auto sDelta = [&](int s) { return sLse(s) + kBwdM; };

  const int bh = blockIdx.x, b = bh / pb.h, h = bh - b * pb.h;
  const int k0 = blockIdx.y * kBwdN;  // longest first: key 0 sees all
  const int nq = (pb.tq + kBwdM - 1) / kBwdM;
  // query tiles before the one holding query k0 see none of these keys
  const int first = pb.causal ? min(k0 / kBwdM, nq) : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducerWarp) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
      for (int hf = 0; hf < D / 64; ++hf) {
        tma_load_4d(sK + hf * half_elems(kBwdN), &k_map, kv_full, 64 * hf, h,
                    k0, b);
        tma_load_4d(sV + hf * half_elems(kBwdN), &v_map, kv_full, 64 * hf, h,
                    k0, b);
      }
    }
    const float* lse_bh = lse + static_cast<long long>(bh) * pb.tq;
    const float* delta_bh = delta + static_cast<long long>(bh) * pb.tq;
    for (int it = 0; it < nq - first; ++it) {
      const int s = it % kStages, q0 = (first + it) * kBwdM;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      for (int i = lane; i < kBwdM; i += 32) {
        const int q = q0 + i;
        const float lv = q < pb.tq ? lse_bh[q] : kNegInf;
        sLse(s)[i] = lv > kNegInf / 2 ? lv * kLog2e : __int_as_float(0x7f800000);
        sDelta(s)[i] = q < pb.tq ? delta_bh[q] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::kQ);
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(sQ(s) + hf * half_elems(kBwdM), &q_map, &full[s],
                      64 * hf, h, q0, b);
          tma_load_4d(sDO(s) + hf * half_elems(kBwdM), &do_map, &full[s],
                      64 * hf, h, q0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wg_key0 = k0 + wg * 64;
  const int key0 = wg_key0 + w4 * 16 + g;  // and key0 + 8
  const float c = pb.scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < nq - first; ++it) {
    const int s = it % kStages, q0 = (first + it) * kBwdM;
    mbar_wait(&full[s], (it / kStages) & 1);
    // a tile wholly above the diagonal for these keys adds nothing
    if (!(pb.causal && q0 + kBwdM - 1 < wg_key0)) {
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float st[kBwdM / 2], dpt[kBwdM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBwdM>(st, kmajor_desc(sK, kBwdN, wg * 64, kk),
                        kmajor_desc(sQ(s), kBwdM, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBwdM>(dpt, kmajor_desc(sV, kBwdN, wg * 64, kk),
                        kmajor_desc(sDO(s), kBwdM, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale; the
      // causal mask only on tiles that meet the diagonal
      const float* l2 = sLse(s);
      const float* dl = sDelta(s);
      const bool need_mask = pb.causal && q0 < wg_key0 + 63;
#pragma unroll
      for (int j = 0; j < kBwdM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + t2 + (e & 1);
          float p = fast_exp2(st[4 * j + e] * c - l2[col]);
          if (need_mask && q0 + col < key0 + (e >> 1) * 8) p = 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dl[col]) * pb.scale;
        }
      uint32_t pa[kBwdM / 16][4], dsa[kBwdM / 16][4];
      pack_a<kBwdM / 2>(pa, st);
      pack_a<kBwdM / 2>(dsa, dpt);

      // dV += P^T dO, dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdM / 16; ++kk)
        wgmma_rs<D>(dv_acc, pa[kk], mnmajor_desc(sDO(s), kBwdM, kk));
#pragma unroll
      for (int kk = 0; kk < kBwdM / 16; ++kk)
        wgmma_rs<D>(dk_acc, dsa[kk], mnmajor_desc(sQ(s), kBwdM, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= pb.tkv) continue;
    const long long at =
        ((static_cast<long long>(b) * pb.tkv + key) * pb.h + h) * pb.d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j * 8 < pb.d) {
        store2(dk + at + j * 8 + t2, dk_acc[4 * j + 2 * i],
               dk_acc[4 * j + 2 * i + 1]);
        store2(dv + at + j * 8 + t2, dv_acc[4 * j + 2 * i],
               dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ dq
// Block: 128 query rows of one (b, h); consumer warpgroup wg owns rows
// [64 wg, 64 wg + 64).  Q and dO stay in shared memory; K and V come in
// 64-key tiles through kStages stages.  Each consumer thread keeps the
// log2(e) * lse (+inf for rows past T_q or fully masked, so that exp2
// gives p = 0 there) and delta of its two rows in registers.  Per tile: S
// = Q K^T and dP = dO V^T (m64n64k16 from shared memory), dS = P (dP -
// delta) packed in place to bf16 A-operand registers, dQ += dS K with K
// read MN-major from the same stage, and the stage is released.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map, Problem pb,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      bf16* __restrict__ dq) {
  using L = DqLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(sm);
  bf16* sDO = reinterpret_cast<bf16*>(sm + L::kQ);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;
  auto sK = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::kStages0 + s * L::kStage);
  };
  auto sV = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::kStages0 + s * L::kStage +
                                   L::kKV);
  };

  const int bh = blockIdx.x, b = bh / pb.h, h = bh - b * pb.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqM;  // longest first
  const int q_end = min(q0 + kDqM, pb.tq);
  const int all = (pb.tkv + kDqN - 1) / kDqN;
  // the last key tile holds key q_end - 1 (top-left causal)
  const int nk = pb.causal ? min(all, (q_end - 1) / kDqN + 1) : all;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_arrive_expect_tx(qdo_full, 2 * L::kQ);
      for (int hf = 0; hf < D / 64; ++hf) {
        tma_load_4d(sQ + hf * half_elems(kDqM), &q_map, qdo_full, 64 * hf, h,
                    q0, b);
        tma_load_4d(sDO + hf * half_elems(kDqM), &do_map, qdo_full, 64 * hf,
                    h, q0, b);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(sK(s) + hf * half_elems(kDqN), &k_map, &full[s],
                      64 * hf, h, kt * kDqN, b);
          tma_load_4d(sV(s) + hf * half_elems(kDqN), &v_map, &full[s],
                      64 * hf, h, kt * kDqN, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wg_row_min = q0 + wg * 64;
  const int row0 = wg_row_min + w4 * 16 + g;  // and row0 + 8
  const float c = pb.scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = static_cast<long long>(bh) * pb.tq + row;
    const float lv = row < pb.tq ? lse[at] : kNegInf;
    lse2[i] = lv > kNegInf / 2 ? lv * kLog2e : __int_as_float(0x7f800000);
    dl[i] = row < pb.tq ? delta[at] : 0.f;
  }
  // Tiles this warpgroup computes: none when its rows all lie past T_q;
  // with the causal mask, none wholly above its diagonal.
  const int kt_end = wg_row_min >= pb.tq ? 0
                     : pb.causal ? min(nk, (wg_row_min + 63) / kDqN + 1)
                                 : nk;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  float sc[kDqN / 2], dp[kDqN / 2];
  uint32_t dsa[kDqN / 16][4];
  mbar_wait(qdo_full, 0);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt % kStages, k0 = kt * kDqN;
    mbar_wait(&full[st], (kt / kStages) & 1);
    // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kDqN>(sc, kmajor_desc(sQ, kDqM, wg * 64, kk),
                     kmajor_desc(sK(st), kDqN, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kDqN>(dp, kmajor_desc(sDO, kDqM, wg * 64, kk),
                     kmajor_desc(sV(st), kDqN, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta) in place of dP, P = exp2(S c - lse2); masks only
    // on tiles that meet the diagonal or the ragged edge of the keys
    const bool need_mask = (pb.causal && k0 + kDqN - 1 > wg_row_min) ||
                           k0 + kDqN > pb.tkv;
#pragma unroll
    for (int j = 0; j < kDqN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = fast_exp2(sc[4 * j + e] * c - lse2[i]);
        if (need_mask) {
          const int col = k0 + j * 8 + t2 + (e & 1), row = row0 + 8 * i;
          if (col >= pb.tkv || (pb.causal && row < col)) p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[i]);
      }
    pack_a<kDqN / 2>(dsa, dp);

    // dQ += dS K, dS (bf16) from registers, K MN-major from the same stage
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqN / 16; ++kk)
      wgmma_rs<D>(acc, dsa[kk], mnmajor_desc(sK(st), kDqN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dsa);
    release(st);
  }
  // the tiles this warpgroup skips still pass through its stages
  for (int kt = kt_end; kt < nk; ++kt) {
    const int st = kt % kStages;
    mbar_wait(&full[st], (kt / kStages) & 1);
    release(st);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= pb.tq) continue;
    bf16* drow =
        dq + ((static_cast<long long>(b) * pb.tq + row) * pb.h + h) * pb.d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (j * 8 < pb.d)
        store2(drow + j * 8 + t2, acc[4 * j + 2 * i] * pb.scale,
               acc[4 * j + 2 * i + 1] * pb.scale);
  }
}

// ------------------------------------------------------------ host side
// cuTensorMapEncodeTiled from libcuda, found through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [B, T, H, D] tensor with element strides st (batch, seq, head;
// D contiguous) as a 4-D map (D, H, T, B), box 64 x 1 x rows x 1 with
// 128-byte swizzle: one 64-column half of a rows-row tile per load, zeros
// past D and past T.
cudaError_t make_map(CUtensorMap* map, const void* base, int b, int t, int h,
                     int d, const Strides& st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  // a dimension of extent 1 is never stepped over: give it a valid stride
  cuuint64_t bytes[3] = {static_cast<cuuint64_t>(st.h) * 2,
                         static_cast<cuuint64_t>(st.t) * 2,
                         static_cast<cuuint64_t>(st.b) * 2};
  cuuint64_t prev = static_cast<cuuint64_t>(d) * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) bytes[i] = (prev + 15) / 16 * 16;
    prev = bytes[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// SMs of the current card, read once.
cudaError_t sm_count(int* n) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached = sms;
  }
  *n = cached;
  return cudaSuccess;
}

// The forward's persistent grid: one block an SM, or one a work tile.
cudaError_t fwd_grid(int b, int h, int tq, int* grid) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>(b) * h * ((tq + kFwdM - 1) / kFwdM);
  *grid = static_cast<int>(std::min<long long>(tiles, sms));
  return cudaSuccess;
}

template <int D>
cudaError_t launch_fwd(const Problem& pb, int b, const void* q, const void* k,
                       const void* v, void* out, void* lse, cudaStream_t s) {
  constexpr int KS = FwdStages<D>::kK, VS = FwdStages<D>::kV;
  using L = FwdLayout<D, KS, VS>;
  const auto kernel = flash_fwd_sm90<D, KS, VS>;
  static const cudaError_t once = allow_smem(kernel, L::kAlloc);
  if (once != cudaSuccess) return once;
  // out is contiguous [b, tq, h, d]; its map stores 64-row boxes
  const Strides os{static_cast<long long>(pb.tq) * pb.h * pb.d,
                   static_cast<long long>(pb.h) * pb.d, pb.d};
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err;
  int grid = 0;
  if ((err = make_map(&mq, q, b, pb.tq, pb.h, pb.d, pb.qs, kFwdM)) ||
      (err = make_map(&mk, k, b, pb.tkv, pb.h, pb.d, pb.ks, kFwdN)) ||
      (err = make_map(&mv, v, b, pb.tkv, pb.h, pb.d, pb.vs, kFwdN)) ||
      (err = make_map(&mo, out, b, pb.tq, pb.h, pb.d, os, 64)) ||
      (err = fwd_grid(b, pb.h, pb.tq, &grid)))
    return err;
  kernel<<<grid, kThreads, L::kAlloc, s>>>(mq, mk, mv, mo, pb, b * pb.h,
                                           static_cast<float*>(lse));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Problem& pb, int b, const void* q,
                       const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       cudaStream_t s) {
  using L = BwdLayout<D>;
  static const cudaError_t once =
      allow_smem(flash_bwd_dkv_sm90<D>, L::kAlloc);
  if (once != cudaSuccess) return once;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = make_map(&mq, q, b, pb.tq, pb.h, pb.d, pb.qs, kBwdM)) ||
      (err = make_map(&mk, k, b, pb.tkv, pb.h, pb.d, pb.ks, kBwdN)) ||
      (err = make_map(&mv, v, b, pb.tkv, pb.h, pb.d, pb.vs, kBwdN)) ||
      (err = make_map(&mdo, dout, b, pb.tq, pb.h, pb.d, pb.dos, kBwdM)))
    return err;
  const dim3 grid(b * pb.h, (pb.tkv + kBwdN - 1) / kBwdN);
  flash_bwd_dkv_sm90<D><<<grid, kThreads, L::kAlloc, s>>>(
      mq, mk, mv, mdo, pb, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Problem& pb, int b, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* delta, void* dq, cudaStream_t s) {
  using L = DqLayout<D>;
  const auto kernel = flash_bwd_dq_sm90<D>;
  static const cudaError_t once = allow_smem(kernel, L::kAlloc);
  if (once != cudaSuccess) return once;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = make_map(&mq, q, b, pb.tq, pb.h, pb.d, pb.qs, kDqM)) ||
      (err = make_map(&mk, k, b, pb.tkv, pb.h, pb.d, pb.ks, kDqN)) ||
      (err = make_map(&mv, v, b, pb.tkv, pb.h, pb.d, pb.vs, kDqN)) ||
      (err = make_map(&mdo, dout, b, pb.tq, pb.h, pb.d, pb.dos, kDqM)))
    return err;
  const dim3 grid(b * pb.h, (pb.tq + kDqM - 1) / kDqM);
  kernel<<<grid, kThreads, L::kAlloc, s>>>(
      mq, mk, mv, mdo, pb, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq));
  return cudaGetLastError();
}

}  // namespace sm90k

}  // namespace

extern "C" {

// q [b, tq, h, d], k/v [b, tkv, h, d], strided (D contiguous; strides: 9
// int64, batch/seq/head of q, k, v).  out: contiguous [b, tq, h, d];
// lse: fp32 [b*h, tq].
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int b, int h, int tq, int tkv, int d,
                  const long long* strides, float scale, int causal,
                  int dtype, void* stream) {
  if (!valid(b, h, tq, tkv, d)) return cudaErrorInvalidValue;
  const Problem pb = problem(h, tq, tkv, d, scale, causal, strides, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case hvd::kFloat32:
      return launch_fwd<float>(pb, b, q, k, v, out, lse, s);
    case hvd::kBFloat16:  // wgmma kernels, head dim padded to 64 or 128
      return d <= 64 ? sm90k::launch_fwd<64>(pb, b, q, k, v, out, lse, s)
                     : sm90k::launch_fwd<128>(pb, b, q, k, v, out, lse, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 forward's launch plan for [b, tq, h, d]: its persistent grid
// and its K and V stages.
int hvd_flash_fwd_plan(int b, int h, int tq, int d, int* grid, int* k_stages,
                       int* v_stages) {
  if (!valid(b, h, tq, 1, d)) return cudaErrorInvalidValue;
  *k_stages = d <= 64 ? sm90k::FwdStages<64>::kK : sm90k::FwdStages<128>::kK;
  *v_stages = d <= 64 ? sm90k::FwdStages<64>::kV : sm90k::FwdStages<128>::kV;
  return sm90k::fwd_grid(b, h, tq, grid);
}

// dout strided like q (strides: 12 int64, q, k, v, dout); lse, delta fp32
// [b*h, tq]; dq contiguous [b, tq, h, d].
int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int b, int h, int tq, int tkv, int d,
                     const long long* strides, float scale, int causal,
                     int dtype, void* stream) {
  if (!valid(b, h, tq, tkv, d)) return cudaErrorInvalidValue;
  const Problem pb = problem(h, tq, tkv, d, scale, causal, strides, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case hvd::kFloat32:
      return launch_dq<float>(pb, b, q, k, v, dout, lse, delta, dq, s);
    case hvd::kBFloat16:
      return d <= 64 ? sm90k::launch_dq<64>(pb, b, q, k, v, dout, lse, delta,
                                            dq, s)
                     : sm90k::launch_dq<128>(pb, b, q, k, v, dout, lse,
                                             delta, dq, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// As hvd_flash_bwd_dq; dk, dv contiguous [b, tkv, h, d].
int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int b, int h, int tq, int tkv,
                      int d, const long long* strides, float scale,
                      int causal, int dtype, void* stream) {
  if (!valid(b, h, tq, tkv, d)) return cudaErrorInvalidValue;
  const Problem pb = problem(h, tq, tkv, d, scale, causal, strides, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case hvd::kFloat32:
      return launch_dkv<float>(pb, b, q, k, v, dout, lse, delta, dk, dv, s);
    case hvd::kBFloat16:
      return d <= 64 ? sm90k::launch_dkv<64>(pb, b, q, k, v, dout, lse,
                                             delta, dk, dv, s)
                     : sm90k::launch_dkv<128>(pb, b, q, k, v, dout, lse,
                                              delta, dk, dv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
