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
// Design against that bound:
// - bf16 products run on the tensor cores: mma.sync m16n8k16 with bf16
//   inputs and fp32 accumulation, operands brought from shared memory with
//   ldmatrix.  P and dS are rounded to bf16 before their products, as
//   FlashAttention-2 does; running max, row sums, lse, delta and every
//   accumulator stay fp32.  fp32 inputs take a scalar-FMA product in full
//   fp32 (no TF32) with the same accumulator layout, so the softmax code is
//   shared.
// - One block of 4 warps per (b*h, 64-row tile); each warp owns 16 rows of
//   the tile.  Forward and dq: 64 query rows, looping over 64-key tiles of
//   K/V staged in shared memory.  dk/dv: 64 key rows, looping over 64-query
//   tiles of Q/dO.  No block writes another block's output, so the backward
//   needs no atomics and is deterministic (the reference's dq / dk-dv
//   split, not FlashAttention-2's atomic dq).
// - Causal skipping at tile granularity: the forward and dq stop at the
//   last key tile that meets the diagonal (reference :172-178, :270-271),
//   dk/dv starts at the first query tile that meets it (:325-329).  The
//   mask is top-left, q_pos >= k_pos from index 0 (:146-159), also when
//   T_q != T_kv.  Forward and dq blocks start with the longest rows.
// - Any T: the ragged edge tile is zero-filled in the loads and masked in
//   the softmax, which gives what the reference gives with smaller blocks.
// - q, k, v and dO are read in place through element strides (batch, seq,
//   head; D contiguous), so the model's qkv.unbind views need no copy.
//   out, dq, dk, dv are written as contiguous [B, T, H, D]; lse and delta
//   are plain fp32 [B*H, T_q] vectors (the TPU's packed 128-lane layout and
//   its MXU transposes are not needed here).
// - The running max starts at -1e30, not -inf, with the reference's guards
//   (:163-165, :181, :257-261), so fully masked rows give out 0, lse -1e30
//   and no gradient.
// Not yet done (later work): wgmma, TMA and warp specialisation; cp.async
// double buffering of the K/V (Q/dO) tiles.
#include "common.cuh"

namespace {

constexpr int kTile = 64;               // rows of every tile
constexpr int kWarps = 4;               // 16 rows of the tile per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

// Shared-memory row pitch in elements: rows padded by 16 bytes, so that
// the 8 rows one ldmatrix reads start in 8 distinct 16-byte bank groups.
template <typename T> __host__ __device__ constexpr int padded(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}

// Element strides of a [B, T, H, D] tensor whose D is contiguous.
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp-level product into accumulators laid out as mma.sync m16n8 C
// fragments: c[j] holds, for this lane (g = lane / 4, t2 = 2 * (lane % 4)),
// rows {g, g + 8} and columns {8j + t2, 8j + t2 + 1} of a [16, 8 * NT]
// result:
//   c[j][0] = (g, 8j + t2)      c[j][1] = (g, 8j + t2 + 1)
//   c[j][2] = (g + 8, 8j + t2)  c[j][3] = (g + 8, 8j + t2 + 1)
// C[16, ncols] += A[16, kdim] B[kdim, ncols].  A is row-major with pitch
// lda.  B is stored [n][k] with pitch ldb (the product is A B^T, kKN false)
// or [k][n] (kKN true).  kdim and ncols are multiples of 16, at most KMAX
// and 8 * NT.
template <bool kKN, int NT, int KMAX>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4],
                                         const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb,
                                         int kdim, int ncols) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KMAX / 16; ++kk) {
    if (kk * 16 < kdim) {
      uint32_t a[4];
      ldmatrix_x4(a, A + (lane & 15) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        if (jj * 16 < ncols) {
          uint32_t b[4];
          if constexpr (kKN) {
            ldmatrix_x4_trans(b, B + (kk * 16 + (lane & 15)) * ldb +
                                     jj * 16 + (lane >> 4) * 8);
          } else {
            ldmatrix_x4(b, B + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * ldb +
                               kk * 16 + ((lane >> 3) & 1) * 8);
          }
          mma_bf16(c[2 * jj], a, b[0], b[1]);
          mma_bf16(c[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// The same product for fp32 operands, in full fp32 with scalar FMAs.
template <bool kKN, int NT, int KMAX>
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
    warp_mma<false, kTile / 8, kMaxD>(s, sQ + wrow * ld, ld, sK, ld, d,
                                      kTile);

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
    warp_mma<true, kMaxD / 8, kTile>(o, pw, ldp, sV, ld, kTile, d);
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
    warp_mma<false, kTile / 8, kMaxD>(s, sQ + wrow * ld, ld, sK, ld, d,
                                      kTile);
    warp_mma<false, kTile / 8, kMaxD>(dp, sDO + wrow * ld, ld, sV, ld, d,
                                      kTile);
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
    warp_mma<true, kMaxD / 8, kTile>(acc, dsw, ldp, sK, ld, kTile, d);
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
      warp_mma<false, kTile / 16, kMaxD>(st, sK + wrow * ld, ld,
                                         sQ + c0 * ld, ld, d, kTile / 2);
      warp_mma<false, kTile / 16, kMaxD>(dpt, sV + wrow * ld, ld,
                                         sDO + c0 * ld, ld, d, kTile / 2);
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
    warp_mma<true, kMaxD / 8, kTile>(dv_acc, pw, ldp, sDO, ld, kTile, d);
    warp_mma<true, kMaxD / 8, kTile>(dk_acc, dsw, ldp, sQ, ld, kTile, d);
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

}  // namespace

// fp32 and bf16 only: the dtype codes of ops/cuda/_build.py DTYPE_CODES.
#define HVD_FLASH_DISPATCH(code, ...)        \
  switch (code) {                            \
    case hvd::kFloat32: {                    \
      using scalar_t = float;                \
      return __VA_ARGS__;                    \
    }                                        \
    case hvd::kBFloat16: {                   \
      using scalar_t = __nv_bfloat16;        \
      return __VA_ARGS__;                    \
    }                                        \
    default:                                 \
      return cudaErrorInvalidValue;          \
  }

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
  HVD_FLASH_DISPATCH(dtype,
                     launch_fwd<scalar_t>(pb, b, q, k, v, out, lse, s));
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
  HVD_FLASH_DISPATCH(dtype, launch_dq<scalar_t>(pb, b, q, k, v, dout, lse,
                                                delta, dq, s));
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
  HVD_FLASH_DISPATCH(dtype, launch_dkv<scalar_t>(pb, b, q, k, v, dout, lse,
                                                 delta, dk, dv, s));
}

}  // extern "C"
