// Cotangents of the RBF Gram and of the fused predict mean, for Hopper
// (sm_90a).  The two length cotangents compute
//
//   dl[b, d] = sum_ij W[b, i, j] * exp(-1/2 |z_i - z_j|^2) * (z_id - z_jd)^2 / l[b, d],
//
// with z = x / l, for one of two forms of the weight W:
//
// * rbf_gram_vjp:    W = G, the dense (B, Na, Nb) cotangent of a Gram (the
//                    backward of gram_kernels.RBFGram);
// * rbf_predict_vjp: W[b, i, j] = sum_c g[b, i, c] * alpha[b, j, c], rank C,
//                    with g (B, M, C) the cotangent of a predict mean (the
//                    length part of the backward of gram_kernels.RBFPredictMean;
//                    its alpha cotangent is rbf_predict_mean with the test and
//                    training points swapped).
//
// The points cotangent of the Gram, rbf_gram_vjp_points, computes
//
//   dxa[b, i, d] = sum_j G[b, i, j] * exp(-1/2 |za_i - zb_j|^2) * (zb_jd - za_id) / l[b, d];
//
// the cotangent of the other point set is the same kernel with the points
// swapped and G read transposed through its strides (no copy).
//
// They recompute the exponentials and never materialise a Gram.
//
// Replace XLA's autodiff of gple_tpu/ops/kernels.py:gram inside jax.grad:
// with respect to the lengths in the constrained ladder's losses
// (gple_tpu/gp/opt.py:297), with respect to the points in validation's
// full-ARD NLL fit (gple_tpu/validation.py:98-104, where z = W x is formed
// outside the Gram and the kernel sees unit lengths).  No Pallas kernel had a
// backward: gram_pallas and predict_mean_pallas were never differentiated on
// the TPU.
//
// What bounds them on the H100 (gple_tpu_torch/ops/kernel_bench.py):
// rbf_gram_vjp reads the (B, Na, Nb) cotangent once, ~24 FP64 instructions a
// pair against 8 bytes, so at D = 2 the bytes bound it (5.0 us for B = 2,
// N = 1024 at 3.35 TB/s).  rbf_predict_vjp reads O((M + N) (D + C)) bytes and
// issues ~24 + C FP64 instructions a pair: the FP64 pipe bounds it.
// rbf_gram_vjp_points reads the cotangent once and issues 3D + 17 FP64
// instructions a pair: bytes bound it too, but at validation's shapes
// ((1 | 7, 200, 200), 0.1-0.7 us of bytes) a launch's latency is the floor.
// The designs, simple first:
//
// * Length cotangents: grid (column tiles, row tiles, B).  A block of
//   kThreads threads owns kThreads columns j, one a thread, held in registers
//   (scaled point, alpha row), and kRowTile rows i, copied once into shared
//   memory (scaled point, g row) and read by every thread at the same
//   address: a broadcast.  A dense cotangent is read along j, so a warp's
//   loads of G are coalesced.  Each thread accumulates its D sums over the
//   tile's rows; the block adds its threads' sums by a tree in shared memory
//   in a fixed order and writes one partial per (block, d) to a scratch
//   tensor.  A second kernel, one block per (b, d), adds the partials in a
//   fixed order and divides by l.
// * Points cotangent: row reductions, one warp per row i, kPointRows rows a
//   block, grid (row tiles, B).  The block stages a tile of kPointTile scaled
//   columns zb_j in shared memory (one division per column and block, laid
//   out by dimension so a warp's reads are contiguous); each lane walks the
//   tile's columns lane, lane + 32, ... in order, and the warp adds its lanes'
//   sums by an xor butterfly.  A dense cotangent is read along j (coalesced);
//   read transposed, a warp's 32 loads fall in 32 sectors, which the L2 holds
//   at these sizes.
//
// No atomics: two launches on the same inputs are bit-identical.  Inputs are
// read through their strides (a stride-0 batch broadcasts one point set, a
// broadcast or transposed cotangent is read in place); the outputs are
// contiguous, (B, D) and (B, Na, D).  Templated on float and double; the
// port's path uses double.  Launches on the caller's stream, allocates
// nothing (the length cotangents take a scratch of gram_kernels.vjp_partials()
// partials from the caller), and returns cudaGetLastError() to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // columns per block: gram_kernels.VJP_COLS_PER_BLOCK
constexpr int kRowTile = 32;         // rows per block: gram_kernels.VJP_ROWS_PER_BLOCK
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

// C == 0: dense weight G; C >= 1: rank-C weight g alpha^T
template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads)
rbf_vjp_partial_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                       const T* __restrict__ l, const T* __restrict__ gw,
                       const T* __restrict__ alpha, T* __restrict__ part, int na, int nb,
                       long long sa_b, long long sa_n, long long sa_d,
                       long long sb_b, long long sb_n, long long sb_d,
                       long long sl_b, long long sl_d,
                       long long sg_b, long long sg_i, long long sg_j,
                       long long sp_b, long long sp_n, long long sp_c) {
  constexpr int W = D + C;  // shared row: z_i[0..D), g_i[0..C)
  __shared__ T s_row[kRowTile][W];
  __shared__ T s_red[D][kThreads];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kRowTile;
  const int rows = min(kRowTile, na - i0);
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + tid;

  T len[D];
#pragma unroll
  for (int d = 0; d < D; ++d) len[d] = l[b * sl_b + d * sl_d];
  for (int t = tid; t < rows; t += kThreads) {
    const long long i = i0 + t;
#pragma unroll
    for (int d = 0; d < D; ++d) s_row[t][d] = xa[b * sa_b + i * sa_n + d * sa_d] / len[d];
#pragma unroll
    for (int c = 0; c < C; ++c) s_row[t][D + c] = gw[b * sg_b + i * sg_i + c * sg_j];
  }
  const bool valid = j < nb;
  T zb[D];
#pragma unroll
  for (int d = 0; d < D; ++d) zb[d] = valid ? xb[b * sb_b + j * sb_n + d * sb_d] / len[d] : T(0);
  T a[C > 0 ? C : 1];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = valid ? alpha[b * sp_b + j * sp_n + c * sp_c] : T(0);
  __syncthreads();

  T acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = T(0);
  if (valid) {
    const T* grow = gw + b * sg_b + static_cast<long long>(i0) * sg_i + j * sg_j;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      T sq[D];
      T d2 = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const T diff = s_row[r][d] - zb[d];
        sq[d] = diff * diff;
        d2 += sq[d];
      }
      T w;
      if constexpr (C == 0) {
        w = grow[r * sg_i];
      } else {
        w = T(0);
#pragma unroll
        for (int c = 0; c < C; ++c) w += s_row[r][D + c] * a[c];
      }
      const T wk = w * exp_t(T(-0.5) * d2);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += wk * sq[d];
    }
  }

  // the block's sums, by a fixed-order tree
#pragma unroll
  for (int d = 0; d < D; ++d) s_red[d][tid] = acc[d];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int d = 0; d < D; ++d) s_red[d][tid] += s_red[d][tid + s];
    }
    __syncthreads();
  }
  if (tid < D) {
    const long long p = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    const long long nparts = static_cast<long long>(gridDim.x) * gridDim.y;
    part[(b * nparts + p) * D + tid] = s_red[tid][0];
  }
}

// out[b, d] = (sum over the partials of (b, d), in a fixed order) / l[b, d]
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
rbf_vjp_reduce_kernel(const T* __restrict__ part, const T* __restrict__ l, T* __restrict__ out,
                      long long nparts, int d, long long sl_b, long long sl_d) {
  __shared__ T s_red[kReduceThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / d;
  const int dd = blockIdx.x % d;
  T s = T(0);
  for (long long p = tid; p < nparts; p += kReduceThreads) s += part[(b * nparts + p) * d + dd];
  s_red[tid] = s;
  __syncthreads();
  for (int k = kReduceThreads / 2; k > 0; k >>= 1) {
    if (tid < k) s_red[tid] += s_red[tid + k];
    __syncthreads();
  }
  if (tid == 0) out[static_cast<long long>(b) * d + dd] = s_red[0] / l[b * sl_b + dd * sl_d];
}

template <typename T, int C>
void launch_partial(dim3 grid, cudaStream_t s, int d, const T* xa, const T* xb, const T* l,
                    const T* gw, const T* alpha, T* part, int na, int nb,
                    long long sa_b, long long sa_n, long long sa_d,
                    long long sb_b, long long sb_n, long long sb_d,
                    long long sl_b, long long sl_d,
                    long long sg_b, long long sg_i, long long sg_j,
                    long long sp_b, long long sp_n, long long sp_c) {
#define GPLE_VJP_CASE(DIM)                                                              \
  case DIM:                                                                             \
    rbf_vjp_partial_kernel<T, DIM, C><<<grid, kThreads, 0, s>>>(                        \
        xa, xb, l, gw, alpha, part, na, nb, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b,   \
        sl_d, sg_b, sg_i, sg_j, sp_b, sp_n, sp_c);                                      \
    break;
  switch (d) {
    GPLE_VJP_CASE(1)
    GPLE_VJP_CASE(2)
    GPLE_VJP_CASE(3)
    GPLE_VJP_CASE(4)
    default:
      break;
  }
#undef GPLE_VJP_CASE
}

// c == 0: dense weight gw (B, Na, Nb); c >= 1: gw (B, Na, C) and alpha (B, Nb, C)
template <typename T>
int launch_rbf_vjp(const T* xa, const T* xb, const T* l, const T* gw, const T* alpha, T* out,
                   T* scratch, int batch, int na, int nb, int d, int c,
                   long long sa_b, long long sa_n, long long sa_d,
                   long long sb_b, long long sb_n, long long sb_d,
                   long long sl_b, long long sl_d,
                   long long sg_b, long long sg_i, long long sg_j,
                   long long sp_b, long long sp_n, long long sp_c, void* stream) {
  if (d < 1 || d > 4 || c < 0 || c > 2 || batch < 1 || batch > 65535 || na < 1 || nb < 1 ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nb + kThreads - 1) / kThreads, (na + kRowTile - 1) / kRowTile, batch);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 0) {
    launch_partial<T, 0>(grid, s, d, xa, xb, l, gw, alpha, scratch, na, nb, sa_b, sa_n, sa_d,
                         sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i, sg_j, sp_b, sp_n, sp_c);
  } else if (c == 1) {
    launch_partial<T, 1>(grid, s, d, xa, xb, l, gw, alpha, scratch, na, nb, sa_b, sa_n, sa_d,
                         sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i, sg_j, sp_b, sp_n, sp_c);
  } else {
    launch_partial<T, 2>(grid, s, d, xa, xb, l, gw, alpha, scratch, na, nb, sa_b, sa_n, sa_d,
                         sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i, sg_j, sp_b, sp_n, sp_c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nparts = static_cast<long long>(grid.x) * grid.y;
  rbf_vjp_reduce_kernel<T><<<batch * d, kReduceThreads, 0, s>>>(scratch, l, out, nparts, d,
                                                                 sl_b, sl_d);
  return static_cast<int>(cudaGetLastError());
}

// rows (warps) per block of the points cotangent: gram_kernels.POINTS_VJP_ROWS_PER_BLOCK
constexpr int kPointRows = 8;
constexpr int kPointTile = kPointRows * 32;   // columns staged per tile

template <typename T, int D>
__global__ void __launch_bounds__(kPointTile)
rbf_gram_vjp_points_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                           const T* __restrict__ l, const T* __restrict__ gout,
                           T* __restrict__ out, int na, int nb,
                           long long sa_b, long long sa_n, long long sa_d,
                           long long sb_b, long long sb_n, long long sb_d,
                           long long sl_b, long long sl_d,
                           long long sg_b, long long sg_i, long long sg_j) {
  __shared__ T s_zb[D][kPointTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * kPointRows + (tid >> 5);
  const bool row_ok = i < na;

  T len[D], za[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    len[d] = l[b * sl_b + d * sl_d];
    za[d] = row_ok ? xa[b * sa_b + i * sa_n + d * sa_d] / len[d] : T(0);
    acc[d] = T(0);
  }
  const T* grow = gout + b * sg_b + (row_ok ? i : 0) * sg_i;

  for (long long j0 = 0; j0 < nb; j0 += kPointTile) {
    const long long jt = j0 + tid;
#pragma unroll
    for (int d = 0; d < D; ++d)
      s_zb[d][tid] = jt < nb ? xb[b * sb_b + jt * sb_n + d * sb_d] / len[d] : T(0);
    __syncthreads();
    if (row_ok) {
      const int cols = static_cast<int>(min(static_cast<long long>(kPointTile), nb - j0));
#pragma unroll 4
      for (int c = lane; c < cols; c += 32) {
        T diff[D];
        T d2 = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          diff[d] = s_zb[d][c] - za[d];
          d2 += diff[d] * diff[d];
        }
        const T wk = grow[(j0 + c) * sg_j] * exp_t(T(-0.5) * d2);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += wk * diff[d];
      }
    }
    __syncthreads();
  }

  // the warp's sums, by a fixed-order butterfly
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (row_ok && lane == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[(static_cast<long long>(b) * na + i) * D + d] = acc[d] / len[d];
  }
}

template <typename T>
int launch_rbf_gram_vjp_points(const T* xa, const T* xb, const T* l, const T* gout, T* out,
                               int batch, int na, int nb, int d,
                               long long sa_b, long long sa_n, long long sa_d,
                               long long sb_b, long long sb_n, long long sb_d,
                               long long sl_b, long long sl_d,
                               long long sg_b, long long sg_i, long long sg_j, void* stream) {
  if (d < 1 || d > 4 || batch < 1 || batch > 65535 || na < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((na + kPointRows - 1) / kPointRows, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPLE_POINTS_CASE(DIM)                                                           \
  case DIM:                                                                             \
    rbf_gram_vjp_points_kernel<T, DIM><<<grid, kPointTile, 0, s>>>(                     \
        xa, xb, l, gout, out, na, nb, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d,   \
        sg_b, sg_i, sg_j);                                                              \
    break;
  switch (d) {
    GPLE_POINTS_CASE(1)
    GPLE_POINTS_CASE(2)
    GPLE_POINTS_CASE(3)
    GPLE_POINTS_CASE(4)
    default:
      break;
  }
#undef GPLE_POINTS_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rbf_gram_vjp_f32(const float* xa, const float* xb, const float* l, const float* gout,
                     float* out, float* scratch, int batch, int na, int nb, int d,
                     long long sa_b, long long sa_n, long long sa_d,
                     long long sb_b, long long sb_n, long long sb_d,
                     long long sl_b, long long sl_d,
                     long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_vjp<float>(xa, xb, l, gout, nullptr, out, scratch, batch, na, nb, d, 0,
                               sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i,
                               sg_j, 0, 0, 0, stream);
}

int rbf_gram_vjp_f64(const double* xa, const double* xb, const double* l, const double* gout,
                     double* out, double* scratch, int batch, int na, int nb, int d,
                     long long sa_b, long long sa_n, long long sa_d,
                     long long sb_b, long long sb_n, long long sb_d,
                     long long sl_b, long long sl_d,
                     long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_vjp<double>(xa, xb, l, gout, nullptr, out, scratch, batch, na, nb, d, 0,
                                sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i,
                                sg_j, 0, 0, 0, stream);
}

int rbf_predict_vjp_f32(const float* xt, const float* xtr, const float* l, const float* g,
                        const float* alpha, float* out, float* scratch, int batch, int m,
                        int n, int d, int c,
                        long long st_b, long long st_m, long long st_d,
                        long long sr_b, long long sr_n, long long sr_d,
                        long long sl_b, long long sl_d,
                        long long sg_b, long long sg_m, long long sg_c,
                        long long sa_b, long long sa_n, long long sa_c, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rbf_vjp<float>(xt, xtr, l, g, alpha, out, scratch, batch, m, n, d, c, st_b,
                               st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d, sg_b, sg_m, sg_c,
                               sa_b, sa_n, sa_c, stream);
}

int rbf_predict_vjp_f64(const double* xt, const double* xtr, const double* l, const double* g,
                        const double* alpha, double* out, double* scratch, int batch, int m,
                        int n, int d, int c,
                        long long st_b, long long st_m, long long st_d,
                        long long sr_b, long long sr_n, long long sr_d,
                        long long sl_b, long long sl_d,
                        long long sg_b, long long sg_m, long long sg_c,
                        long long sa_b, long long sa_n, long long sa_c, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rbf_vjp<double>(xt, xtr, l, g, alpha, out, scratch, batch, m, n, d, c, st_b,
                                st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d, sg_b, sg_m, sg_c,
                                sa_b, sa_n, sa_c, stream);
}

int rbf_gram_vjp_points_f32(const float* xa, const float* xb, const float* l,
                            const float* gout, float* out, int batch, int na, int nb, int d,
                            long long sa_b, long long sa_n, long long sa_d,
                            long long sb_b, long long sb_n, long long sb_d,
                            long long sl_b, long long sl_d,
                            long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_gram_vjp_points<float>(xa, xb, l, gout, out, batch, na, nb, d, sa_b, sa_n,
                                           sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i,
                                           sg_j, stream);
}

int rbf_gram_vjp_points_f64(const double* xa, const double* xb, const double* l,
                            const double* gout, double* out, int batch, int na, int nb, int d,
                            long long sa_b, long long sa_n, long long sa_d,
                            long long sb_b, long long sb_n, long long sb_d,
                            long long sl_b, long long sl_d,
                            long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_gram_vjp_points<double>(xa, xb, l, gout, out, batch, na, nb, d, sa_b,
                                            sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b,
                                            sg_i, sg_j, stream);
}

}  // extern "C"
