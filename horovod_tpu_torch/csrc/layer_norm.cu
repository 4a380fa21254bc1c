// Fused LayerNorm, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/pallas/layer_norm.py:
//   forward  _fwd_kernel (:36, built in _call_fwd :80, pallas_call :92)
//   backward _bwd_kernel (:53, built in _ln_bwd :131, pallas_call :148)
//
// Bound on the H100: bytes.  A row of d values costs ~2 FLOP per byte,
// far below the ~295 FLOP/byte where the tensor cores would bound it.  At
// the main-path shape (N = 16384 rows, d = 1024, bf16) the forward must
// read x (32 MiB) and write out (32 MiB) plus 128 KiB of mean/rstd: about
// 64 MiB, 20 us at 3.35 TB/s.  The backward reads x and dy and writes dx:
// about 96 MiB, 30 us.
//
// Design against that bound: every element crosses HBM once per
// direction, and enough loads are in flight to cover the memory's latency.
//   forward:  one block per row.  Threads load 16 bytes each, stage the
//             row in shared memory as fp32, reduce the mean, then the
//             centred variance as the TPU kernel does (not E[x^2] -
//             mean^2), and write the normalised row.  mean/rstd are plain
//             fp32 [N] vectors, written only when a gradient is needed.
//   backward: rows belong to warps, not blocks.  A row is cut into
//             16-byte chunks; a group of `group` warps shares it, each
//             lane holding up to 4 chunks of x and dy in registers (8 on
//             the wide path below; d = 1024 bf16 is one warp a row).  The row's two sums (of dy*g
//             and dy*g*x-hat) come from warp shuffles, and, for a group of
//             several warps, an exchange through shared memory behind a
//             barrier of that group alone: no block-wide barrier per row.
//             Narrow rows (group <= 8, blocks of 8 warps): gamma and the
//             lane's dgamma/dbeta partials live in registers for the whole
//             kernel, and each warp loads its next row before the
//             arithmetic of the current one, so two rows are in flight a
//             warp.  Wide rows (more than 8 warps at 4 chunks a lane; one
//             group of up to 16 warps a block): gamma and the partials
//             sit in shared memory, each column owned by one thread.  At the end a block sums its groups' partials in a
//             fixed order and writes one fp32 [d] row of a [num_blocks, d]
//             scratch; a second kernel sums the scratch over blocks in two
//             fixed-order levels (chunks of blocks, then the chunks).  The
//             TPU kernel accumulated across sequential grid steps
//             (layer_norm.py:69-77); GPU blocks run in no order, and
//             atomics would make the result change from run to run.  The
//             geometry depends on (n, d, dtype) and the caller's block
//             count alone, so the result is bitwise the same on any card.
// Not yet done (later work): TMA loads, several rows per block for small d
// in the forward.
#include "common.cuh"

namespace {

using hvd::Vec;
using hvd::aligned16;

template <typename T, bool VEC>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ out, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int d,
                              float eps) {
  extern __shared__ float smem[];
  float* row = smem;      // [d] the row in fp32
  float* red = smem + d;  // [32] reduction scratch
  constexpr int V = Vec<T>::kN;
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + off;
  T* outr = out + off;
  constexpr int width = VEC ? V : 1;
  const int start = threadIdx.x * width;
  const int step = blockDim.x * width;

  float sum = 0.f;
  for (int i = start; i < d; i += step) {
    float v[V];
    if constexpr (VEC) {
      hvd::load_vec(xr + i, v);
    } else {
      v[0] = hvd::to_float(xr[i]);
    }
    #pragma unroll
    for (int j = 0; j < width; ++j) {
      row[i + j] = v[j];
      sum += v[j];
    }
  }
  const float mean = hvd::block_sum(sum, red) / d;

  // each thread reads back only the elements it staged itself
  float sq = 0.f;
  for (int i = start; i < d; i += step)
    #pragma unroll
    for (int j = 0; j < width; ++j) {
      const float c = row[i + j] - mean;
      sq += c * c;
    }
  const float var = hvd::block_sum(sq, red) / d;
  const float rstd = rsqrtf(var + eps);

  for (int i = start; i < d; i += step) {
    float o[V];
    #pragma unroll
    for (int j = 0; j < width; ++j)
      o[j] = (row[i + j] - mean) * rstd * gamma[i + j] + beta[i + j];
    if constexpr (VEC) {
      hvd::store_vec(outr + i, o);
    } else {
      outr[i] = hvd::from_float<T>(o[0]);
    }
  }
  if (mean_out != nullptr && threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

// ------------------------------------------------------------ backward
// A row of d elements is cut into chunks of V = 16 / sizeof(T) elements
// (one 16-byte vector; on the scalar path the last chunk may be partial).
// Chunk (s * group + w) * 32 + lane is slot s of lane `lane` of warp w of
// the row's group, so neighbouring lanes read neighbouring 16 bytes.
constexpr int kBwdWarps = 8;    // warps of a block on the narrow path
constexpr int kMaxSlots = 4;    // chunks of a row a lane holds (narrow)
constexpr int kWideSlots = 8;   // chunks of a row a lane holds (wide)
constexpr int kMaxGroup = 16;   // warps sharing a row (wide path: a block)
constexpr int kXch = 2 * kMaxGroup * 2;  // floats: [parity][warp][s1, s2]

// One lane's chunks of one row as loaded, and the row's statistics.
template <int NV> struct Slice {
  uint4 x[NV], dy[NV];
  float mu, rs;
};

template <typename T, int NV, bool VEC>
__device__ __forceinline__ void load_slice(Slice<NV>& sl,
                                           const T* __restrict__ x,
                                           const T* __restrict__ dy,
                                           const float* __restrict__ mean,
                                           const float* __restrict__ rstd,
                                           int r, int d, int chunk0,
                                           int cstep) {
  constexpr int V = Vec<T>::kN;
  const size_t off = static_cast<size_t>(r) * d;
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int c = (chunk0 + s * cstep) * V;
    sl.x[s] = sl.dy[s] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (VEC) {
      if (c < d) {
        sl.x[s] = *reinterpret_cast<const uint4*>(x + off + c);
        sl.dy[s] = *reinterpret_cast<const uint4*>(dy + off + c);
      }
    } else {
      T* ex = reinterpret_cast<T*>(&sl.x[s]);
      T* ed = reinterpret_cast<T*>(&sl.dy[s]);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c + j < d) {
          ex[j] = x[off + c + j];
          ed[j] = dy[off + c + j];
        }
    }
  }
  sl.mu = mean[r];
  sl.rs = rstd[r];
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int j) {
  return hvd::to_float(reinterpret_cast<const T*>(&raw)[j]);
}

// Waits for the `count` threads of named barrier `id` (ids 1-15; 0 is
// __syncthreads').
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// dx of every row, and one [d] row of dgamma/dbeta partials a block.
// Narrow (WIDE false): blocks of kBwdWarps warps, kBwdWarps / group rows
// at a time; gamma and the partials in registers; the next row loaded
// before the arithmetic of the current one.  Wide: one group of `group`
// warps a block (at most 512 threads, so 128 registers a thread); gamma
// and the partials in shared memory.
template <typename T, int NV, bool VEC, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 32 * kMaxGroup : 32 * kBwdWarps, 1)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ dg_part,
                  float* __restrict__ db_part, int n, int d, int group) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float smem[];
  float* xch = smem;          // the row sums of a group's warps
  float* cols = smem + kXch;  // wide: gamma, dgamma, dbeta [d] each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = WIDE ? 1 : kBwdWarps / group;  // rows at a time
  const int gi = warp / group, wi = warp - gi * group;
  const int chunk0 = wi * 32 + lane, cstep = group * 32;
  auto col = [&](int s) { return (chunk0 + s * cstep) * V; };

  float gam[NV][V], dg[NV][V], db[NV][V];
#pragma unroll
  for (int s = 0; s < NV; ++s)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = col(s) + j;
      const float gv = c < d ? gamma[c] : 0.f;
      if constexpr (WIDE) {
        if (c < d) {  // the thread owns column c
          cols[c] = gv;
          cols[d + c] = cols[2 * d + c] = 0.f;
        }
      } else {
        gam[s][j] = gv;
        dg[s][j] = db[s][j] = 0.f;
      }
    }
  // wide: chunks past d read gamma of column d - 1, which another thread
  // owns (times dy = 0)
  if constexpr (WIDE) __syncthreads();

  const int row_step = gridDim.x * groups;
  int r = blockIdx.x * groups + gi;
  int parity = 0;
  Slice<NV> cur, nxt;
  if (r < n) load_slice<T, NV, VEC>(cur, x, dy, mean, rstd, r, d, chunk0,
                                    cstep);
  for (; r < n; r += row_step) {
    const int rn = r + row_step;
    if (!WIDE && rn < n)
      load_slice<T, NV, VEC>(nxt, x, dy, mean, rstd, rn, d, chunk0, cstep);

    // chunks past d hold zeros: dy = 0 and gamma = 0 add nothing
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int s = 0; s < NV; ++s)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float g = WIDE ? cols[min(col(s) + j, d - 1)] : gam[s][j];
        const float xh = (elem<T>(cur.x[s], j) - cur.mu) * cur.rs;
        const float dyg = elem<T>(cur.dy[s], j) * g;
        s1 += dyg;
        s2 += dyg * xh;
      }
    s1 = hvd::warp_sum(s1);
    s2 = hvd::warp_sum(s2);
    if (group > 1) {  // the group's warps in index order, the same sum in all
      if (lane == 0) {
        xch[(parity * kMaxGroup + warp) * 2] = s1;
        xch[(parity * kMaxGroup + warp) * 2 + 1] = s2;
      }
      group_sync(1 + gi, group * 32);
      s1 = s2 = 0.f;
      for (int w = 0; w < group; ++w) {
        s1 += xch[(parity * kMaxGroup + gi * group + w) * 2];
        s2 += xch[(parity * kMaxGroup + gi * group + w) * 2 + 1];
      }
      parity ^= 1;  // the next row writes the other half, so no WAR race
    }
    const float m1 = s1 / d, m2 = s2 / d;

    const size_t off = static_cast<size_t>(r) * d;
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int c = col(s);
      if (c >= d) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dv = elem<T>(cur.dy[s], j);
        const float xh = (elem<T>(cur.x[s], j) - cur.mu) * cur.rs;
        if constexpr (WIDE) {
          const int cj = min(c + j, d - 1);  // past d: dv = 0 adds nothing
          o[j] = cur.rs * (dv * cols[cj] - m1 - xh * m2);
          cols[d + cj] += dv * xh;
          cols[2 * d + cj] += dv;
        } else {
          o[j] = cur.rs * (dv * gam[s][j] - m1 - xh * m2);
          dg[s][j] += dv * xh;
          db[s][j] += dv;
        }
      }
      if constexpr (VEC) {
        hvd::store_vec(dx + off + c, o);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (c + j < d) dx[off + c + j] = hvd::from_float<T>(o[j]);
      }
    }
    if constexpr (WIDE) {
      if (rn < n)
        load_slice<T, NV, VEC>(cur, x, dy, mean, rstd, rn, d, chunk0, cstep);
    } else {
      cur = nxt;
    }
  }

  float* out_g = dg_part + static_cast<size_t>(blockIdx.x) * d;
  float* out_b = db_part + static_cast<size_t>(blockIdx.x) * d;
  if constexpr (WIDE) {  // each thread writes the columns it owns
#pragma unroll
    for (int s = 0; s < NV; ++s)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = col(s) + j;
        if (c < d) {
          out_g[c] = cols[d + c];
          out_b[c] = cols[2 * d + c];
        }
      }
  } else {  // the groups' partials, summed in group order
    float* sdg = cols;               // [groups][d]
    float* sdb = cols + groups * d;  // [groups][d]
#pragma unroll
    for (int s = 0; s < NV; ++s)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = col(s) + j;
        if (c < d) {
          sdg[gi * d + c] = dg[s][j];
          sdb[gi * d + c] = db[s][j];
        }
      }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float a = 0.f, b = 0.f;
      for (int g = 0; g < groups; ++g) {
        a += sdg[g * d + c];
        b += sdb[g * d + c];
      }
      out_g[c] = a;
      out_b[c] = b;
    }
  }
}

// dgamma/dbeta = column sums of the [num_blocks, d] partials in two
// fixed-order levels: thread row ty of a block sums blocks [ty * per,
// (ty + 1) * per) in index order, then row 0 sums the kRedRows results in
// order.  A block takes 32 columns.
constexpr int kRedRows = 16;

__global__ void __launch_bounds__(32 * kRedRows)
    ln_bwd_reduce_kernel(const float* __restrict__ dg_part,
                         const float* __restrict__ db_part, int num_blocks,
                         int d, float* __restrict__ dgamma,
                         float* __restrict__ dbeta) {
  __shared__ float red[2][kRedRows][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const int per = (num_blocks + kRedRows - 1) / kRedRows;
  const int end = min(num_blocks, (ty + 1) * per);
  float a = 0.f, b = 0.f;
  if (c < d)
    for (int i = ty * per; i < end; ++i) {
      a += dg_part[static_cast<size_t>(i) * d + c];
      b += db_part[static_cast<size_t>(i) * d + c];
    }
  red[0][ty][tx] = a;
  red[1][ty][tx] = b;
  __syncthreads();
  if (ty != 0 || c >= d) return;
  a = b = 0.f;
  for (int k = 0; k < kRedRows; ++k) {
    a += red[0][k][tx];
    b += red[1][k][tx];
  }
  dgamma[c] = a;
  dbeta[c] = b;
}

template <typename T>
int row_threads(int d) {
  const int vecs = (d + Vec<T>::kN - 1) / Vec<T>::kN;
  int t = (vecs + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr int kSmemMax = 232448;  // shared memory a block may use

// Largest d the kernels take (ops/cuda/layer_norm.py MAX_D).  Within it:
// the forward stages one fp32 row in shared memory, and the wide backward
// holds 8 chunks a lane in at most 16 warps (16384 fp32) and 3 fp32 rows
// of shared memory (19328 columns in 227 KB).
constexpr int kMaxD = (kSmemMax / 4 - 32) / 4;

template <typename T, int NV, bool VEC, bool WIDE>
cudaError_t launch_bwd_as(int blocks, int threads, size_t smem,
                          cudaStream_t s, const T* x, const float* gamma,
                          const float* mean, const float* rstd, const T* dy,
                          T* dx, float* dg_part, float* db_part, int n,
                          int d, int group) {
  const auto kernel = ln_bwd_kernel<T, NV, VEC, WIDE>;
  static const cudaError_t once = allow_smem(kernel, kSmemMax);
  if (once != cudaSuccess) return once;
  kernel<<<blocks, threads, smem, s>>>(x, gamma, mean, rstd, dy, dx, dg_part,
                                       db_part, n, d, group);
  return cudaGetLastError();
}

// Chooses the row geometry from d: `group` warps a row, NV chunks a lane.
template <typename T, bool VEC>
cudaError_t launch_bwd(int blocks, cudaStream_t s, const T* x,
                       const float* gamma, const float* mean,
                       const float* rstd, const T* dy, T* dx, float* dg_part,
                       float* db_part, int n, int d) {
  const int chunks = (d + Vec<T>::kN - 1) / Vec<T>::kN;
  int group = (chunks + 32 * kMaxSlots - 1) / (32 * kMaxSlots);
  if (group > kBwdWarps) {
    group = (chunks + 32 * kWideSlots - 1) / (32 * kWideSlots);
    if (group > kMaxGroup) return cudaErrorInvalidValue;
    const size_t smem = (kXch + 3 * static_cast<size_t>(d)) * sizeof(float);
    return launch_bwd_as<T, kWideSlots, VEC, true>(
        blocks, 32 * group, smem, s, x, gamma, mean, rstd, dy, dx, dg_part,
        db_part, n, d, group);
  }
  while (kBwdWarps % group) ++group;  // 1, 2, 4 or 8 warps a row
  const size_t smem =
      (kXch + 2 * static_cast<size_t>(kBwdWarps / group) * d) * sizeof(float);
  const int threads = 32 * kBwdWarps;
#define HVD_LN_BWD(NV)                                                      \
  launch_bwd_as<T, NV, VEC, false>(blocks, threads, smem, s, x, gamma, mean, \
                                   rstd, dy, dx, dg_part, db_part, n, d,     \
                                   group)
  if (group == 1 && chunks <= 32) return HVD_LN_BWD(1);
  if (group == 1 && chunks <= 64) return HVD_LN_BWD(2);
  return HVD_LN_BWD(kMaxSlots);
#undef HVD_LN_BWD
}

}  // namespace

extern "C" {

int hvd_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                       void* out, void* mean, void* rstd, int n, int d,
                       float eps, int dtype, void* stream) {
  if (d > kMaxD) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (static_cast<size_t>(d) + 32) * sizeof(float);
  HVD_DISPATCH(dtype, {
    const bool vec = d % Vec<scalar_t>::kN == 0 && aligned16(x) &&
                     aligned16(out);
    auto kernel = vec ? ln_fwd_kernel<scalar_t, true>
                      : ln_fwd_kernel<scalar_t, false>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n, row_threads<scalar_t>(d), smem, s>>>(
        static_cast<const scalar_t*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<scalar_t*>(out),
        static_cast<float*>(mean), static_cast<float*>(rstd), d, eps);
  });
  return cudaGetLastError();
}

// partials: fp32 [2, num_blocks, d] scratch owned by the caller;
// num_blocks, with n and d, fixes the order of every sum.
int hvd_layer_norm_bwd(const void* x, const void* gamma, const void* mean,
                       const void* rstd, const void* dy, void* dx,
                       void* partials, void* dgamma, void* dbeta, int n,
                       int d, int num_blocks, int dtype, void* stream) {
  if (n == 0 || num_blocks <= 0 || d > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dg_part = static_cast<float*>(partials);
  float* db_part = dg_part + static_cast<size_t>(num_blocks) * d;
  HVD_DISPATCH(dtype, {
    const auto* xs = static_cast<const scalar_t*>(x);
    const auto* dys = static_cast<const scalar_t*>(dy);
    auto* dxs = static_cast<scalar_t*>(dx);
    const bool vec = d % Vec<scalar_t>::kN == 0 && aligned16(x) &&
                     aligned16(dy) && aligned16(dx);
    const auto* g = static_cast<const float*>(gamma);
    const auto* mu = static_cast<const float*>(mean);
    const auto* rs = static_cast<const float*>(rstd);
    const cudaError_t err =
        vec ? launch_bwd<scalar_t, true>(num_blocks, s, xs, g, mu, rs, dys,
                                         dxs, dg_part, db_part, n, d)
            : launch_bwd<scalar_t, false>(num_blocks, s, xs, g, mu, rs, dys,
                                          dxs, dg_part, db_part, n, d);
    if (err != cudaSuccess) return err;
  });
  ln_bwd_reduce_kernel<<<(d + 31) / 32, 32 * kRedRows, 0, s>>>(
      dg_part, db_part, num_blocks, d, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return cudaGetLastError();
}

}  // extern "C"
