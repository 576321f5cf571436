// Fused RBF cross-kernel mean for Hopper (sm_90a).
//
//   out[b, m, c] = sum_n exp(-1/2 |(xt[b,m] - xtr[b,n]) / l[b]|^2) * alpha[b, n, c]
//
// with C in {1, 2} right-hand sides, without materialising the (M, N)
// cross-kernel.  Magnitudes and sigma^2 are applied by the caller.
//
// Replaces the Pallas TPU kernel gple_tpu/ops/pallas_gram.py:predict_mean_pallas
// (body _predict_kernel).  That kernel walked the training tiles along a
// sequential grid axis and carried the partial sum in a VMEM scratch
// accumulator.  Hopper's blocks run in parallel and in no order, so here:
//
// * each thread owns one test row and keeps its C partial sums in registers;
// * a loop inside the block walks the training set in tiles of kTile points,
//   staging the scaled points z = x / l and their alpha rows in shared memory
//   (every thread then reads the same shared address: a broadcast);
// * no atomics and no second pass: one block covers all N for its rows.
//
// What bounds it on the H100: the exp.  Per (test, train) pair it reads
// nothing from device memory (both operands are in registers or shared
// memory) and does ~D multiply-adds plus one exp, so at the evolve query fan
// (3 x 10240 x 1024 pairs per step) it is bound by the f64 exp throughput of
// the SMs; small blocks (kThreads rows) keep enough blocks in flight to spread
// the work over all 132 SMs.
//
// Ragged edges are masked here (no sentinel padding); inputs are read through
// their strides, so a batch stride of 0 broadcasts one point set over several
// length sets.  The output is contiguous (B, M, C).  Templated on float and
// double; the port's path uses double.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // test rows per block
constexpr int kTile = 128;    // training points staged per pass

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads)
rbf_predict_mean_kernel(const T* __restrict__ xt, const T* __restrict__ xtr,
                        const T* __restrict__ l, const T* __restrict__ alpha,
                        T* __restrict__ out, int m_total, int n_total,
                        long long st_b, long long st_m, long long st_d,
                        long long sr_b, long long sr_n, long long sr_d,
                        long long sl_b, long long sl_d,
                        long long sa_b, long long sa_n, long long sa_c) {
  __shared__ T s_z[kTile][D];
  __shared__ T s_alpha[kTile][C];

  const int b = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < m_total;

  T len[D];
  T zt[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    len[d] = l[b * sl_b + d * sl_d];
    zt[d] = live ? xt[b * st_b + m * st_m + d * st_d] / len[d] : T(0);
  }
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);

  for (int n0 = 0; n0 < n_total; n0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int t = threadIdx.x; t < kTile; t += kThreads) {
      const int n = n0 + t;
      if (n < n_total) {
#pragma unroll
        for (int d = 0; d < D; ++d)
          s_z[t][d] = xtr[b * sr_b + n * sr_n + d * sr_d] / len[d];
#pragma unroll
        for (int c = 0; c < C; ++c)
          s_alpha[t][c] = alpha[b * sa_b + n * sa_n + c * sa_c];
      }
    }
    __syncthreads();
    const int count = min(kTile, n_total - n0);
    if (live) {
      for (int t = 0; t < count; ++t) {
        T d2 = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const T diff = zt[d] - s_z[t][d];
          d2 += diff * diff;
        }
        const T k = exp_t(T(-0.5) * d2);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += k * s_alpha[t][c];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[(static_cast<long long>(b) * m_total + m) * C + c] = acc[c];
  }
}

template <typename T, int C>
void launch_c(dim3 grid, cudaStream_t s, int d, const T* xt, const T* xtr,
              const T* l, const T* alpha, T* out, int m, int n,
              long long st_b, long long st_m, long long st_d,
              long long sr_b, long long sr_n, long long sr_d,
              long long sl_b, long long sl_d,
              long long sa_b, long long sa_n, long long sa_c) {
#define GPLE_PREDICT_CASE(DIM)                                                 \
  case DIM:                                                                    \
    rbf_predict_mean_kernel<T, DIM, C><<<grid, kThreads, 0, s>>>(              \
        xt, xtr, l, alpha, out, m, n, st_b, st_m, st_d, sr_b, sr_n, sr_d,      \
        sl_b, sl_d, sa_b, sa_n, sa_c);                                         \
    break;
  switch (d) {
    GPLE_PREDICT_CASE(1)
    GPLE_PREDICT_CASE(2)
    GPLE_PREDICT_CASE(3)
    GPLE_PREDICT_CASE(4)
    default:
      break;
  }
#undef GPLE_PREDICT_CASE
}

template <typename T>
int launch_rbf_predict_mean(const T* xt, const T* xtr, const T* l, const T* alpha,
                            T* out, int batch, int m, int n, int d, int c,
                            long long st_b, long long st_m, long long st_d,
                            long long sr_b, long long sr_n, long long sr_d,
                            long long sl_b, long long sl_d,
                            long long sa_b, long long sa_n, long long sa_c,
                            void* stream) {
  if (d < 1 || d > 4 || c < 1 || c > 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kThreads - 1) / kThreads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 1) {
    launch_c<T, 1>(grid, s, d, xt, xtr, l, alpha, out, m, n, st_b, st_m, st_d,
                   sr_b, sr_n, sr_d, sl_b, sl_d, sa_b, sa_n, sa_c);
  } else {
    launch_c<T, 2>(grid, s, d, xt, xtr, l, alpha, out, m, n, st_b, st_m, st_d,
                   sr_b, sr_n, sr_d, sl_b, sl_d, sa_b, sa_n, sa_c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rbf_predict_mean_f32(const float* xt, const float* xtr, const float* l,
                         const float* alpha, float* out, int batch, int m, int n,
                         int d, int c, long long st_b, long long st_m, long long st_d,
                         long long sr_b, long long sr_n, long long sr_d,
                         long long sl_b, long long sl_d,
                         long long sa_b, long long sa_n, long long sa_c, void* stream) {
  return launch_rbf_predict_mean<float>(xt, xtr, l, alpha, out, batch, m, n, d, c,
                                        st_b, st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d,
                                        sa_b, sa_n, sa_c, stream);
}

int rbf_predict_mean_f64(const double* xt, const double* xtr, const double* l,
                         const double* alpha, double* out, int batch, int m, int n,
                         int d, int c, long long st_b, long long st_m, long long st_d,
                         long long sr_b, long long sr_n, long long sr_d,
                         long long sl_b, long long sl_d,
                         long long sa_b, long long sa_n, long long sa_c, void* stream) {
  return launch_rbf_predict_mean<double>(xt, xtr, l, alpha, out, batch, m, n, d, c,
                                         st_b, st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d,
                                         sa_b, sa_n, sa_c, stream);
}

}  // extern "C"
