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
// accumulator.  Hopper's blocks run in parallel and in no order.
//
// What bounds it on the H100: FP64 arithmetic.  Per (test, train, length set)
// triple it reads nothing from device memory and issues 2D + 1 DP
// instructions for the scaled distance, 15 for libdevice exp() (its fast path
// in the SASS of this kernel) and C multiply-adds: 21-22 at D = 2.  The FP64
// pipe retires 64 of them per SM per clock, so the kernel is fast only if every
// SM holds enough warps with independent exp chains to cover the DFMA latency
// and the exp's own non-FP64 instructions.  The design:
//
// * Split N across blocks.  Grid (row tiles, splits, B): each block takes
//   kRowsPerBlock test rows against one chunk of the training set, so that a
//   fan of 10N test rows still puts several 4-warp blocks on every SM.  The
//   caller chooses the split (gple_tpu_torch/ops/gram_kernels.py:predict_plan).
//   With more than one split each block writes its partial sums to a scratch
//   tensor (S, B, M, C), and a second small kernel adds them in split order:
//   no atomics, so two launches on the same inputs are bit-identical.  The
//   second kernel is a programmatic dependent launch: the first lets it launch
//   once its blocks have finished the chunk, and it waits (griddepcontrol.wait)
//   for the partial sums, so its launch overlaps the first kernel's tail.
// * The chunk lives in shared memory.  Its points and alpha rows are copied
//   once with cp.async, element by element through the strides (a stride-0
//   batch or a strided alpha needs no copy on the host), while each thread
//   loads its own test rows; each thread then scales the points it copied,
//   z = x / l, and one barrier later the block walks the chunk with no
//   further synchronisation.  Every thread reads the same shared address: a
//   broadcast.  At most kMaxChunk points, so (D + C) * 8 * 1024 bytes stay
//   within the 48 KB of dynamic shared memory a block gets without opting in.
// * Each thread owns kRows test rows (strided by the block width, so loads and
//   stores stay coalesced): every shared-memory point feeds kRows independent
//   exp chains, and the training loop is unrolled 4 times, which also spreads
//   the loop's fixed instructions (the exp's constants, the shared loads) over
//   8 triples.
//
// No tensor cores: with C <= 2 right-hand sides the product k * alpha is at
// most 2 FMAs per triple against 20 for the distance and the exp, DMMA cannot
// evaluate the exp,
// and the broadcast-difference form (exact at D = 2, unlike |a|^2 + |b|^2 -
// 2 a.b) is not a matrix product.
//
// Ragged edges are masked (no sentinel padding).  The output is contiguous
// (B, M, C).  Templated on float and double; the port's path uses double.
// Launches on the caller's stream, allocates nothing (the caller passes the
// scratch), and returns cudaGetLastError() to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                    // 4 warps, one per SM sub-partition
constexpr int kRows = 2;                         // test rows per thread
constexpr int kRowsPerBlock = kThreads * kRows;  // gram_kernels.PREDICT_ROWS_PER_BLOCK
constexpr int kMaxChunk = 1024;                  // gram_kernels.PREDICT_MAX_CHUNK
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

// one element, global -> shared, asynchronous (sizeof(T) is 4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads)
rbf_predict_partial_kernel(const T* __restrict__ xt, const T* __restrict__ xtr,
                           const T* __restrict__ l, const T* __restrict__ alpha,
                           T* __restrict__ part, int m_total, int n_total, int chunk,
                           long long st_b, long long st_m, long long st_d,
                           long long sr_b, long long sr_n, long long sr_d,
                           long long sl_b, long long sl_d,
                           long long sa_b, long long sa_n, long long sa_c) {
  constexpr int W = D + C;  // shared row of a training point: z[0..D), alpha[0..C)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_pt = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int n0 = split * chunk;
  const int count = min(chunk, n_total - n0);

  // 1. start the copy of this block's chunk of the training set
  for (int t = threadIdx.x; t < count; t += kThreads) {
    const long long n = n0 + t;
#pragma unroll
    for (int d = 0; d < D; ++d)
      cp_async_elem(s_pt + t * W + d, xtr + b * sr_b + n * sr_n + d * sr_d);
#pragma unroll
    for (int c = 0; c < C; ++c)
      cp_async_elem(s_pt + t * W + D + c, alpha + b * sa_b + n * sa_n + c * sa_c);
  }

  // 2. meanwhile, this thread's test rows, scaled
  T len[D];
#pragma unroll
  for (int d = 0; d < D; ++d) len[d] = l[b * sl_b + d * sl_d];
  const int m0 = blockIdx.x * kRowsPerBlock + threadIdx.x;
  T zt[kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long m = m0 + r * kThreads;
#pragma unroll
    for (int d = 0; d < D; ++d)
      zt[r][d] = m < m_total ? xt[b * st_b + m * st_m + d * st_d] / len[d] : T(0);
  }

  // 3. scale the points this thread copied; one barrier publishes the chunk
  cp_async_wait_all();
  for (int t = threadIdx.x; t < count; t += kThreads) {
#pragma unroll
    for (int d = 0; d < D; ++d) s_pt[t * W + d] = s_pt[t * W + d] / len[d];
  }
  __syncthreads();

  // 4. walk the chunk: kRows independent exp chains per point
  T acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = T(0);
#pragma unroll 4
  for (int t = 0; t < count; ++t) {
    const T* p = s_pt + t * W;
    T z[D], a[C];
#pragma unroll
    for (int d = 0; d < D; ++d) z[d] = p[d];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = p[D + c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      T d2 = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const T diff = zt[r][d] - z[d];
        d2 += diff * diff;
      }
      const T k = exp_t(T(-0.5) * d2);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] += k * a[c];
    }
  }

  // let the second pass launch now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // 5. this split's sums: straight to out (one split) or to the scratch
  T* dst = part + (static_cast<long long>(split) * gridDim.z + b) * m_total * C;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long m = m0 + r * kThreads;
    if (m < m_total) {
#pragma unroll
      for (int c = 0; c < C; ++c) dst[m * C + c] = acc[r][c];
    }
  }
}

// out[i] = sum over splits, in split order, of part[split, i]
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
rbf_predict_reduce_kernel(const T* __restrict__ part, T* __restrict__ out,
                          long long total, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partial sums are complete
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= total) return;
  T s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * total + i];
  out[i] = s;
}

template <typename T, int C>
void launch_partial(dim3 grid, size_t smem, cudaStream_t s, int d, const T* xt,
                    const T* xtr, const T* l, const T* alpha, T* part, int m, int n,
                    int chunk, long long st_b, long long st_m, long long st_d,
                    long long sr_b, long long sr_n, long long sr_d,
                    long long sl_b, long long sl_d,
                    long long sa_b, long long sa_n, long long sa_c) {
#define GPLE_PREDICT_CASE(DIM)                                                   \
  case DIM:                                                                      \
    rbf_predict_partial_kernel<T, DIM, C><<<grid, kThreads, smem, s>>>(          \
        xt, xtr, l, alpha, part, m, n, chunk, st_b, st_m, st_d, sr_b, sr_n, sr_d, \
        sl_b, sl_d, sa_b, sa_n, sa_c);                                           \
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
                            T* out, T* scratch, int batch, int m, int n, int d, int c,
                            int splits, int chunk,
                            long long st_b, long long st_m, long long st_d,
                            long long sr_b, long long sr_n, long long sr_d,
                            long long sl_b, long long sl_d,
                            long long sa_b, long long sa_n, long long sa_c,
                            void* stream) {
  // the splits must cover [0, n) with no empty chunk
  if (d < 1 || d > 4 || c < 1 || c > 2 || batch < 1 || m < 1 || n < 1 || splits < 1 ||
      chunk < 1 || chunk > kMaxChunk || static_cast<long long>(splits) * chunk < n ||
      static_cast<long long>(splits - 1) * chunk >= n || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock, splits, batch);
  const size_t smem = static_cast<size_t>(chunk) * (d + c) * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* part = splits > 1 ? scratch : out;
  if (c == 1) {
    launch_partial<T, 1>(grid, smem, s, d, xt, xtr, l, alpha, part, m, n, chunk, st_b,
                         st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d, sa_b, sa_n, sa_c);
  } else {
    launch_partial<T, 2>(grid, smem, s, d, xt, xtr, l, alpha, part, m, n, chunk, st_b,
                         st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d, sa_b, sa_n, sa_c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * m * c;
  const unsigned blocks = static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kReduceThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rbf_predict_reduce_kernel<T>, static_cast<const T*>(scratch),
                           out, total, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rbf_predict_mean_f32(const float* xt, const float* xtr, const float* l,
                         const float* alpha, float* out, float* scratch, int batch,
                         int m, int n, int d, int c, int splits, int chunk,
                         long long st_b, long long st_m, long long st_d,
                         long long sr_b, long long sr_n, long long sr_d,
                         long long sl_b, long long sl_d,
                         long long sa_b, long long sa_n, long long sa_c, void* stream) {
  return launch_rbf_predict_mean<float>(xt, xtr, l, alpha, out, scratch, batch, m, n, d, c,
                                        splits, chunk, st_b, st_m, st_d, sr_b, sr_n, sr_d,
                                        sl_b, sl_d, sa_b, sa_n, sa_c, stream);
}

int rbf_predict_mean_f64(const double* xt, const double* xtr, const double* l,
                         const double* alpha, double* out, double* scratch, int batch,
                         int m, int n, int d, int c, int splits, int chunk,
                         long long st_b, long long st_m, long long st_d,
                         long long sr_b, long long sr_n, long long sr_d,
                         long long sl_b, long long sl_d,
                         long long sa_b, long long sa_n, long long sa_c, void* stream) {
  return launch_rbf_predict_mean<double>(xt, xtr, l, alpha, out, scratch, batch, m, n, d, c,
                                         splits, chunk, st_b, st_m, st_d, sr_b, sr_n, sr_d,
                                         sl_b, sl_d, sa_b, sa_n, sa_c, stream);
}

}  // extern "C"
