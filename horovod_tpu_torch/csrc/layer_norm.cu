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
// direction, and enough 16-byte loads are in flight to cover the memory's
// latency.  Both directions give rows to warps, not blocks.  A row is cut
// into 16-byte chunks; a group of `group` warps shares it, each lane
// holding up to 4 chunks in registers (8 on the wide path below; d = 1024
// bf16 is one warp a row, 4 chunks a lane).  A row's sums are butterfly
// warp shuffles, so every lane holds the bitwise-same result, and, for a
// group of several warps, an exchange through shared memory behind a
// named barrier of that group alone: no block-wide barrier per row.  The
// geometry is a function of d and the dtype alone, so every row's
// arithmetic is the same whatever n and the block count are.
//   forward:  blocks of 8 warps (2 resident an SM: 128 registers a
//             thread) walk the rows in a fixed grid; the wrapper sizes the
//             grid from the card's SM count.  gamma and beta are loaded
//             once a warp, as 16-byte vectors, into registers.  Each warp
//             asks L2 for its next row (prefetch.global.L2, no registers)
//             before the arithmetic of the current one, so two rows are
//             in flight a warp; holding the next row in registers instead
//             needed more than 128 a thread and spilled.  The mean is a
//             group sum of x, then the centred variance a second one of
//             (x - mean)^2 from the same registers, as the TPU kernel
//             computes it (not E[x^2] - mean^2).  out is written as 16-byte
//             vectors; mean/rstd are plain fp32 [N] vectors, written only
//             when a gradient is needed.  Widths that are no multiple of 16
//             bytes, or unaligned rows, take the same kernel with element
//             loads and stores (the scalar path; 1 block an SM bound, so
//             that its extra registers do not spill).
//   backward: the row's two sums (of dy*g and dy*g*x-hat) as above.
//             Narrow rows (group <= 8, blocks of 8 warps): gamma and the
//             lane's dgamma/dbeta partials live in registers for the whole
//             kernel, and each warp loads its next row before the
//             arithmetic of the current one.  At the end a block sums its
//             groups' partials in a fixed order and writes one fp32 [d]
//             row of a [num_blocks, d] scratch; a second kernel sums the
//             scratch over blocks in two fixed-order levels (chunks of
//             blocks, then the chunks).  The TPU kernel accumulated across
//             sequential grid steps (layer_norm.py:69-77); GPU blocks run
//             in no order, and atomics would make the result change from
//             run to run.  The block count comes from n alone, so the
//             result is bitwise the same on any card.
//   wide rows (more than 8 warps at 4 chunks a lane; one group of up to
//             16 warps a block): gamma, beta (forward) or gamma and the
//             partials (backward) sit in shared memory; the backward
//             loads no row ahead.
// Not yet done (later work): TMA loads; wide rows without spills.
#include <algorithm>

#include "common.cuh"

namespace {

using hvd::Vec;
using hvd::aligned16;

// ------------------------------------------------------- row geometry
// A row of d elements is cut into chunks of V = 16 / sizeof(T) elements
// (one 16-byte vector; on the scalar path the last chunk may be partial).
// Chunk (s * group + w) * 32 + lane is slot s of lane `lane` of warp w of
// the row's group, so neighbouring lanes read neighbouring 16 bytes.  The
// geometry (group, NV) is a function of d and the dtype alone (geometry
// below), so a row's sums are taken in the same order whatever n is.
constexpr int kRowWarps = 8;    // warps of a block on the narrow path
constexpr int kMaxSlots = 4;    // chunks of a row a lane holds (narrow)
constexpr int kWideSlots = 8;   // chunks of a row a lane holds (wide)
constexpr int kMaxGroup = 16;   // warps sharing a row (wide path: a block)
constexpr int kXch = 2 * kMaxGroup * 2;  // floats: [parity][warp][s1, s2]

// Slots s < NV of one lane's chunks of row `off / d`: 16-byte loads on the
// vector path, element by element on the scalar one; zeros past d.
template <typename T, int NV, bool VEC>
__device__ __forceinline__ void load_chunks(uint4 (&dst)[NV],
                                            const T* __restrict__ src,
                                            size_t off, int d, int chunk0,
                                            int cstep) {
  constexpr int V = Vec<T>::kN;
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int c = (chunk0 + s * cstep) * V;
    dst[s] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (VEC) {
      if (c < d) dst[s] = *reinterpret_cast<const uint4*>(src + off + c);
    } else {
      T* e = reinterpret_cast<T*>(&dst[s]);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c + j < d) e[j] = src[off + c + j];
    }
  }
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int j) {
  return hvd::to_float(reinterpret_cast<const T*>(&raw)[j]);
}

// Sum of v over the `group` warps that share a row, the same in every
// lane: a butterfly warp sum, then (group > 1) the warps' sums in index
// order through xch behind the group's own named barrier.  Each call
// writes the half of xch that `parity` names and flips it, so a warp that
// runs ahead to the next call cannot overwrite what a slower one still
// reads.
__device__ __forceinline__ float group_sum(float v, float* xch, int& parity,
                                           int group, int gi, int warp,
                                           int lane) {
  v = hvd::warp_sum(v);
  if (group == 1) return v;
  if (lane == 0) xch[parity * kMaxGroup + warp] = v;
  hvd::bar_sync(1 + gi, group * 32);
  v = 0.f;
  for (int w = 0; w < group; ++w) v += xch[parity * kMaxGroup + gi * group + w];
  parity ^= 1;
  return v;
}

// ------------------------------------------------------------- forward
// out (and mean, rstd) of every row.  Narrow (WIDE false): blocks of
// kRowWarps warps, kRowWarps / group rows at a time; gamma and beta in
// registers for the whole kernel (16-byte loads, once a warp).  Wide: one
// group of `group` warps a block; gamma and beta in shared memory.  Both
// ask L2 for the warp's next row before the arithmetic of the current
// one, so two rows are in flight a warp.  The mean is a group sum of x, the
// variance a second one of (x - mean)^2 from the same registers (centred,
// as the TPU kernel computes it).  ONE: a warp a row (group 1), so that
// the slots lie a compile-time stride apart and their addresses take no
// registers of their own.
template <typename T, int NV, bool VEC, bool WIDE, bool ONE>
__global__ void __launch_bounds__(WIDE ? 32 * kMaxGroup : 32 * kRowWarps,
                                  WIDE || !VEC ? 1 : 2)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int n, int d, int row_group, float eps) {
  constexpr int V = Vec<T>::kN;
  const int group = ONE ? 1 : row_group;
  constexpr int GS = WIDE ? 1 : NV;  // slots of gamma/beta in registers
  extern __shared__ float smem[];
  float* xch = smem;          // a group's partial sums, [parity][warp]
  float* cols = smem + kXch;  // wide: gamma, beta [d] each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = WIDE ? 1 : kRowWarps / group;  // rows at a time
  const int gi = warp / group, wi = warp - gi * group;
  const int chunk0 = wi * 32 + lane, cstep = group * 32;
  auto col = [&](int s) { return (chunk0 + s * cstep) * V; };

  float gam[GS][V], bet[GS][V];
  if constexpr (WIDE) {
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      cols[c] = gamma[c];
      cols[d + c] = beta[c];
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int c = col(s);
      if (VEC && c < d) {  // V floats: V / 4 16-byte loads each
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(gamma + c + j);
          const float4 b4 = *reinterpret_cast<const float4*>(beta + c + j);
          gam[s][j] = g4.x, gam[s][j + 1] = g4.y;
          gam[s][j + 2] = g4.z, gam[s][j + 3] = g4.w;
          bet[s][j] = b4.x, bet[s][j + 1] = b4.y;
          bet[s][j + 2] = b4.z, bet[s][j + 3] = b4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          gam[s][j] = c + j < d ? gamma[c + j] : 0.f;
          bet[s][j] = c + j < d ? beta[c + j] : 0.f;
        }
      }
    }
  }

  const int row_step = gridDim.x * groups;
  int parity = 0;
  for (int r = blockIdx.x * groups + gi; r < n; r += row_step) {
    const size_t off = static_cast<size_t>(r) * d;
    uint4 cur[NV];
    load_chunks<T, NV, VEC>(cur, x, off, d, chunk0, cstep);
    // the next row's 128-byte lines, the group's share of them, asked of
    // L2 before this row's arithmetic
    const int rn = r + row_step;
    if (rn < n) {
      const char* p =
          reinterpret_cast<const char*>(x + static_cast<size_t>(rn) * d);
      for (int off = chunk0 * 128; off < d * static_cast<int>(sizeof(T));
           off += cstep * 128)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + off));
    }

    // chunks past d hold zeros: they add nothing to the first sum
    float s1 = 0.f;
#pragma unroll
    for (int s = 0; s < NV; ++s)
#pragma unroll
      for (int j = 0; j < V; ++j) s1 += elem<T>(cur[s], j);
    const float mu =
        group_sum(s1, xch, parity, group, gi, warp, lane) / d;
    float s2 = 0.f;
#pragma unroll
    for (int s = 0; s < NV; ++s)
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (col(s) + (VEC ? 0 : j) < d) {
          const float c = elem<T>(cur[s], j) - mu;
          s2 += c * c;
        }
    const float rs = rsqrtf(
        group_sum(s2, xch, parity, group, gi, warp, lane) / d + eps);

#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int c = col(s);
      if (c >= d) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float g, b;
        if constexpr (WIDE) {
          const int cj = min(c + j, d - 1);  // past d: not stored
          g = cols[cj];
          b = cols[d + cj];
        } else {
          g = gam[s][j];
          b = bet[s][j];
        }
        o[j] = (elem<T>(cur[s], j) - mu) * rs * g + b;
      }
      if constexpr (VEC) {
        hvd::store_vec(out + off + c, o);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (c + j < d) out[off + c + j] = hvd::from_float<T>(o[j]);
      }
    }
    if (mean_out != nullptr && wi == 0 && lane == 0) {
      mean_out[r] = mu;
      rstd_out[r] = rs;
    }
  }
}

// ------------------------------------------------------------ backward
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
  const size_t off = static_cast<size_t>(r) * d;
  load_chunks<T, NV, VEC>(sl.x, x, off, d, chunk0, cstep);
  load_chunks<T, NV, VEC>(sl.dy, dy, off, d, chunk0, cstep);
  sl.mu = mean[r];
  sl.rs = rstd[r];
}

// dx of every row, and one [d] row of dgamma/dbeta partials a block.
// Narrow (WIDE false): blocks of kRowWarps warps, kRowWarps / group rows
// at a time; gamma and the partials in registers; the next row loaded
// before the arithmetic of the current one.  Wide: one group of `group`
// warps a block (at most 512 threads, so 128 registers a thread); gamma
// and the partials in shared memory.
template <typename T, int NV, bool VEC, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 32 * kMaxGroup : 32 * kRowWarps, 1)
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
  const int groups = WIDE ? 1 : kRowWarps / group;  // rows at a time
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
      hvd::bar_sync(1 + gi, group * 32);
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr int kSmemMax = 232448;  // shared memory a block may use

// Largest d the kernels take (ops/cuda/layer_norm.py MAX_D).  Within it
// a row takes at most 16 warps at 8 chunks a lane (16384 fp32), and the
// wide backward's 3 fp32 rows of shared memory fit in 227 KB (19328
// columns); the bound is that of a forward that stages one fp32 row in
// shared memory, kept so that the wrappers take the same widths as
// before.
constexpr int kMaxD = (kSmemMax / 4 - 32) / 4;

// Row geometry from d and the dtype alone: `group` warps a row and `nv`
// chunks a lane; wide above kRowWarps warps at kMaxSlots chunks a lane.
struct Geometry {
  int group, nv;
  bool wide;
};

template <typename T>
Geometry geometry(int d) {
  const int chunks = (d + Vec<T>::kN - 1) / Vec<T>::kN;
  int group = (chunks + 32 * kMaxSlots - 1) / (32 * kMaxSlots);
  if (group > kRowWarps)
    return {(chunks + 32 * kWideSlots - 1) / (32 * kWideSlots), kWideSlots,
            true};
  while (kRowWarps % group) ++group;  // 1, 2, 4 or 8 warps a row
  const int nv = group == 1 && chunks <= 32   ? 1
                 : group == 1 && chunks <= 64 ? 2
                                              : kMaxSlots;
  return {group, nv, false};
}

template <typename T, int NV, bool VEC, bool WIDE, bool ONE = false>
cudaError_t launch_fwd_as(int blocks, int threads, size_t smem,
                          cudaStream_t s, const T* x, const float* gamma,
                          const float* beta, T* out, float* mean, float* rstd,
                          int n, int d, int group, float eps) {
  const auto kernel = ln_fwd_kernel<T, NV, VEC, WIDE, ONE>;
  static const cudaError_t once = allow_smem(kernel, kSmemMax);
  if (once != cudaSuccess) return once;
  kernel<<<blocks, threads, smem, s>>>(x, gamma, beta, out, mean, rstd, n, d,
                                       group, eps);
  return cudaGetLastError();
}

// Blocks: as many as have a row for each of their groups, at most
// max_blocks (the wrapper's choice from the card's SM count).
template <typename T, bool VEC>
cudaError_t launch_fwd(int max_blocks, cudaStream_t s, const T* x,
                       const float* gamma, const float* beta, T* out,
                       float* mean, float* rstd, int n, int d, float eps) {
  const Geometry g = geometry<T>(d);
  if (g.group > kMaxGroup) return cudaErrorInvalidValue;
  const int rows = g.wide ? 1 : kRowWarps / g.group;  // a block at a time
  const int blocks = static_cast<int>(
      std::min<long long>((n + rows - 1) / rows, max_blocks));
  if (g.wide)
    return launch_fwd_as<T, kWideSlots, VEC, true>(
        blocks, 32 * g.group, (kXch + 2 * static_cast<size_t>(d)) * 4, s, x,
        gamma, beta, out, mean, rstd, n, d, g.group, eps);
#define HVD_LN_FWD(NV, ONE)                                              \
  launch_fwd_as<T, NV, VEC, false, ONE>(blocks, 32 * kRowWarps, kXch * 4, \
                                        s, x, gamma, beta, out, mean,    \
                                        rstd, n, d, g.group, eps)
  if (g.nv == 1) return HVD_LN_FWD(1, true);
  if (g.nv == 2) return HVD_LN_FWD(2, true);
  if (g.group == 1) return HVD_LN_FWD(kMaxSlots, true);
  return HVD_LN_FWD(kMaxSlots, false);
#undef HVD_LN_FWD
}

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

template <typename T, bool VEC>
cudaError_t launch_bwd(int blocks, cudaStream_t s, const T* x,
                       const float* gamma, const float* mean,
                       const float* rstd, const T* dy, T* dx, float* dg_part,
                       float* db_part, int n, int d) {
  const Geometry g = geometry<T>(d);
  if (g.group > kMaxGroup) return cudaErrorInvalidValue;
  if (g.wide)
    return launch_bwd_as<T, kWideSlots, VEC, true>(
        blocks, 32 * g.group, (kXch + 3 * static_cast<size_t>(d)) * 4, s, x,
        gamma, mean, rstd, dy, dx, dg_part, db_part, n, d, g.group);
  const size_t smem =
      (kXch + 2 * static_cast<size_t>(kRowWarps / g.group) * d) * 4;
#define HVD_LN_BWD(NV)                                                   \
  launch_bwd_as<T, NV, VEC, false>(blocks, 32 * kRowWarps, smem, s, x,   \
                                   gamma, mean, rstd, dy, dx, dg_part,   \
                                   db_part, n, d, g.group)
  if (g.nv == 1) return HVD_LN_BWD(1);
  if (g.nv == 2) return HVD_LN_BWD(2);
  return HVD_LN_BWD(kMaxSlots);
#undef HVD_LN_BWD
}

}  // namespace

extern "C" {

// max_blocks: the most blocks the forward may launch (the wrapper's
// choice from the card's SM count); the rows are spread over them.
int hvd_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                       void* out, void* mean, void* rstd, int n, int d,
                       float eps, int max_blocks, int dtype, void* stream) {
  if (d > kMaxD || max_blocks <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HVD_DISPATCH(dtype, {
    const auto* xs = static_cast<const scalar_t*>(x);
    const auto* g = static_cast<const float*>(gamma);
    const auto* b = static_cast<const float*>(beta);
    auto* os = static_cast<scalar_t*>(out);
    auto* mu = static_cast<float*>(mean);
    auto* rs = static_cast<float*>(rstd);
    const bool vec = d % Vec<scalar_t>::kN == 0 && aligned16(x) &&
                     aligned16(out) && aligned16(gamma) && aligned16(beta);
    const cudaError_t err =
        vec ? launch_fwd<scalar_t, true>(max_blocks, s, xs, g, b, os, mu, rs,
                                         n, d, eps)
            : launch_fwd<scalar_t, false>(max_blocks, s, xs, g, b, os, mu,
                                          rs, n, d, eps);
    if (err != cudaSuccess) return err;
  });
  return cudaSuccess;
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
