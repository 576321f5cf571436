// Batched unit-magnitude RBF Gram matrix for Hopper (sm_90a).
//
//   out[b, i, j] = exp(-1/2 * sum_d ((xa[b,i,d] - xb[b,j,d]) / l[b,d])^2)
//
// Replaces the Pallas TPU kernel gple_tpu/ops/pallas_gram.py:gram_pallas
// (body _gram_kernel).  That kernel expanded the distance as
// |a|^2 + |b|^2 - 2 a.b to put the cross term on the MXU, padded the rows to
// 128 with 1e12 sentinels, and ran in f32.  Here the distance keeps the
// broadcast-difference form of gple_tpu/ops/kernels.py:gram, exact at
// PhaseDim = 2 where the expansion cancels for nearby points; each point is
// scaled as x / l (a true division, the same IEEE operation as the plain
// PyTorch version), once per tile rather than once per output.
//
// What bounds it on the H100: writing the output.  The variance cross-grams
// are 170-250 MB and the refit's five (1024, 1024) grams 42 MB, at 3.35 TB/s.
// The exps are not free beside that: at D = 2 an entry costs ~23 FP64
// instructions, about 57% of the write time at the FP64 pipe's rate, so they
// have to run while earlier stores drain.  The design:
//
// * One warp owns a tile of kTileRows rows x 32 * V columns, V = 16 bytes /
//   sizeof(T).  Each lane holds its V column points and one row point in
//   registers, scaled once; the row points reach the other lanes by shuffle,
//   so there is no shared memory and no barrier.
// * Each lane computes V neighbouring outputs of a row and writes them as one
//   16-byte store: a warp writes a contiguous 512-byte row segment.  A store
//   does not block the lane, so the next rows' exps run while earlier rows'
//   stores drain, across the kTileRows rows of a tile (unrolled) and across
//   the warps an SM holds; 32 rows per warp make blocks long-lived (a
//   variance gram is 3840 blocks where one output per thread made 122,880).
// * A row whose start is not 16-byte aligned (Nb not a multiple of V) and the
//   ragged column end take scalar stores; ragged rows are masked.  No
//   sentinel padding.
//
// No tensor cores: the difference form is not a matrix product, and the
// kernel's limit is the output's bytes, which the expansion form would not
// reduce.  Inputs are read through their strides (a batch stride of 0
// broadcasts one point set over several length sets); the output is
// contiguous (B, Na, Nb).  Templated on float and double; the port's path
// uses double.  Launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() to the caller.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;                  // warps per block, stacked along rows
constexpr int kTileRows = 32;              // rows per warp: one row point per lane
constexpr int kRowsPerBlock = kWarps * kTileRows;  // gram_kernels.GRAM_ROWS_PER_BLOCK

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

// one 16-byte store of a lane's V outputs
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
rbf_gram_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                const T* __restrict__ l, T* __restrict__ out,
                int na, int nb, bool aligned,
                long long sa_b, long long sa_n, long long sa_d,
                long long sb_b, long long sb_n, long long sb_d,
                long long sl_b, long long sl_d) {
  constexpr int V = 16 / sizeof(T);  // outputs per lane and row: one 16-byte store
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int i0 = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * kTileRows;
  const int j0 = blockIdx.x * (32 * V) + lane * V;
  if (i0 >= na) return;  // the whole warp: i0 is uniform across it

  T len[D];
#pragma unroll
  for (int d = 0; d < D; ++d) len[d] = l[b * sl_b + d * sl_d];
  T zb[V][D];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long j = j0 + v;
#pragma unroll
    for (int d = 0; d < D; ++d)
      zb[v][d] = j < nb ? xb[b * sb_b + j * sb_n + d * sb_d] / len[d] : T(0);
  }
  T za[D];  // row i0 + lane, handed to the other lanes by shuffle
  {
    const long long i = i0 + lane;
#pragma unroll
    for (int d = 0; d < D; ++d)
      za[d] = i < na ? xa[b * sa_b + i * sa_n + d * sa_d] / len[d] : T(0);
  }

  const int rows = min(kTileRows, na - i0);
  const bool vec = aligned && j0 + V <= nb;  // one 16-byte store per row
  T* dst = out + (static_cast<long long>(b) * na + i0) * nb + j0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r, dst += nb) {
    T zr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) zr[d] = __shfl_sync(0xffffffffu, za[d], r);
    T val[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T d2 = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const T diff = zr[d] - zb[v][d];
        d2 += diff * diff;
      }
      val[v] = exp_t(T(-0.5) * d2);
    }
    if (vec) {
      store16(dst, val);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (j0 + v < nb) dst[v] = val[v];
    }
  }
}

template <typename T>
int launch_rbf_gram(const T* xa, const T* xb, const T* l, T* out,
                    int batch, int na, int nb, int d,
                    long long sa_b, long long sa_n, long long sa_d,
                    long long sb_b, long long sb_n, long long sb_d,
                    long long sl_b, long long sl_d, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (d < 1 || d > 4 || batch < 1 || na < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nb + 32 * V - 1) / (32 * V), (na + kRowsPerBlock - 1) / kRowsPerBlock,
                  batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every row starts on a 16-byte boundary iff the base does and Nb * sizeof(T) % 16 == 0
  const bool aligned = nb % V == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
#define GPLE_GRAM_CASE(DIM)                                                          \
  case DIM:                                                                          \
    rbf_gram_kernel<T, DIM><<<grid, kWarps * 32, 0, s>>>(                            \
        xa, xb, l, out, na, nb, aligned, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d); \
    break;
  switch (d) {
    GPLE_GRAM_CASE(1)
    GPLE_GRAM_CASE(2)
    GPLE_GRAM_CASE(3)
    GPLE_GRAM_CASE(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPLE_GRAM_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rbf_gram_f32(const float* xa, const float* xb, const float* l, float* out,
                 int batch, int na, int nb, int d,
                 long long sa_b, long long sa_n, long long sa_d,
                 long long sb_b, long long sb_n, long long sb_d,
                 long long sl_b, long long sl_d, void* stream) {
  return launch_rbf_gram<float>(xa, xb, l, out, batch, na, nb, d, sa_b, sa_n, sa_d,
                                sb_b, sb_n, sb_d, sl_b, sl_d, stream);
}

int rbf_gram_f64(const double* xa, const double* xb, const double* l, double* out,
                 int batch, int na, int nb, int d,
                 long long sa_b, long long sa_n, long long sa_d,
                 long long sb_b, long long sb_n, long long sb_d,
                 long long sl_b, long long sl_d, void* stream) {
  return launch_rbf_gram<double>(xa, xb, l, out, batch, na, nb, d, sa_b, sa_n, sa_d,
                                 sb_b, sb_n, sb_d, sl_b, sl_d, stream);
}

}  // extern "C"
