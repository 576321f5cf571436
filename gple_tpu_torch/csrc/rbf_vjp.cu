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
// The points cotangent of the Gram, rbf_gram_vjp_points, computes both point
// sets' cotangents in one launch (a Gram backward whose points both need a
// gradient: validation's full-ARD z = W x), or either one:
//
//   dxa[b, i, d] = sum_j G[b, i, j] * exp(-1/2 |za_i - zb_j|^2) * (zb_jd - za_id) / l[b, d],
//   dxb[b, j, d] = sum_i G[b, i, j] * exp(-1/2 |za_i - zb_j|^2) * (za_id - zb_jd) / l[b, d].
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
// rbf_gram_vjp reads the (B, Na, Nb) cotangent once against 4D + 16 FP64
// instructions a pair: at D = 2, 8 bytes against 24 instructions, so the
// bytes bound it (5.0 us for B = 2, N = 1024 at 3.35 TB/s), but the FP64
// pipe is not far behind (3.0 us): the kernel reaches its bound only if the
// cotangent's bytes stream in while the exps run.  rbf_predict_vjp reads
// O((M + N) (D + C)) bytes and issues 4D + 16 + C FP64 instructions a pair:
// the FP64 pipe bounds it, and it needs enough independent exp chains on
// every SM to cover the DFMA latency.  rbf_gram_vjp_points reads the
// cotangent once against 4D + 17 FP64 instructions a pair (one distance and
// one exp, D multiply-adds into each side's sum): at D = 2 its bytes bound
// it (0.10 us at B = 1, 200^2, against 0.06 us of FP64 work), but neither
// is near what bounds it at validation's shapes: a launch's latency and the
// chain of dependent steps inside a block.
//
// * Length cotangents: one kernel, one launch a call (the first design
//   launched a partial-sum kernel and a reduce kernel; the second launch's
//   latency was most of a call at validation's shapes).  Grid (column tiles, row blocks,
//   B), kThreads = 256 threads a block.  A thread owns kCols = 2 adjacent
//   columns j (scaled points and alpha rows in registers), so every row
//   feeds two independent exp chains, and the row loop is unrolled 4 times
//   (8 chains in flight a thread); the block walks a run of `rows` rows i,
//   whose scaled points (and g rows) it copies once into shared memory and
//   every thread reads at the same address: a broadcast.  The caller's plan
//   (gram_kernels.vjp_plan) sizes `rows` so that the grid is about four
//   blocks (32 warps) an SM: at the ladder's shapes the whole grid is one
//   wave, and fewer, longer blocks leave too few warps to hide the FP64
//   latency (kernel_bench --sweep).
//   - The dense cotangent, contiguous along j and aligned (`vec`): each
//     thread reads its two columns of a row as one 16-byte (double) copy,
//     cp.async straight into its own slot of a shared-memory ring kDepth
//     rows deep, so the next rows' bytes are in flight while this row's
//     exps run.  A thread reads only the slots it filled, so a
//     cp.async.wait_group and no barrier orders the ring; a slot is refilled
//     one row after it was read (kDepth + 1 slots).  Any other layout (an
//     odd row stride, a column stride other than 1: a broadcast or padded
//     view) takes the strided branch, plain loads through the strides.  A
//     transposed cotangent (row stride 1) never reaches it: the sum is
//     symmetric in (a, G) <-> (b, G^T), so the wrapper swaps the point sets
//     and reads G^T, which is contiguous along its rows.
//   - The rank-C weight: the tile's g rows sit in shared memory beside the
//     scaled points; W[i, j] is C multiply-adds from registers.
//   - The sums: each thread adds its two columns' sums, a warp adds its
//     lanes' by an xor butterfly (__shfl_xor_sync, a fixed order), and
//     thread 0 adds the block's warps and writes the block's partial of each
//     (b, d) to the scratch, laid out (b, d)-major.  Then thread 0 takes a
//     ticket from a counter (an acq_rel atomic: it releases the partials and
//     acquires the other blocks'); the block that takes the last ticket adds
//     every partial of each (b, d) in index order (one warp a (b, d), each
//     lane kTailLoads partials in flight, lane-strided, then a butterfly:
//     the same order whichever block is last), divides by l, writes the
//     (B, D) result and resets the counter to 0 for the next launch.  No
//     float atomics: two launches on the same inputs are bit-identical.
//   Where the time goes at B = 2, N = 1024 (kernel_bench --variants, device
//   time from CUDA-graph replays): 10.6 us a call; 9.1 without the ticket
//   and the last block's sum, 7.7 without the exps, 9.1 without the
//   cotangent's reads; a B = 1, 150^2 call, whose blocks each walk a few
//   rows, takes 5-7.  The whole grid is one wave, so each block's latency
//   (its loads, its rows' exp chains, its ticket) is most of a call, and its
//   bytes and its FP64 work overlap only partly.
// * Points cotangent (design (b)): one launch a Gram backward, both point
//   sets (or either: a null output is a side not computed).  Grid (tiles of
//   xa's side + tiles of xb's side, B), kPairThreads = 256 threads a block;
//   a block owns `own` points of one side (rows of G for xa's, columns for
//   xb's) and sums each over the whole other axis, so no sum leaves the
//   block: no scratch, no ticket, no float atomics, and two launches on the
//   same inputs are bit-identical.  Each pair's distance and exp are
//   computed once a side: 2 (3D + 17) FP64 instructions a pair, about 1.8
//   times the function's 4D + 17 at D = 2.  Design (a), one exp a pair over
//   tiles of pairs whose row and column partials the last block to take a
//   ticket adds, took 9.6 | 8.1 | 30.4 us against (b)'s 3.1 | 3.0 | 11.4 at
//   B = 1, 200^2 | 160^2 | 1024^2 (kernel_bench --variants, CUDA-graph
//   replays on an H100 80GB HBM3 at 700 W, as below): its serial tail
//   outweighs the halved FP64 work even at 1024^2, so it was removed.
//   - A chunk of kPairChunk points of the summed axis: every global read is
//     started before any is used (`own` elements of G a thread by cp.async
//     straight into shared memory, one point a thread into registers, in
//     the first chunk the block's own points and one reciprocal a length,
//     which replaces every division), then one barrier.  G is staged along
//     the axis it is contiguous in: side a along its rows, side b across
//     them in runs of `own` >= 4 elements (whole 32-byte sectors), so no
//     side reads it across its columns; a transposed G the other way round,
//     other layouts through both strides.  Validation passes both a
//     contiguous and a transposed cotangent, half the backwards each.
//   - per = 256 / own threads a point, each with kPairUnroll pairs in
//     flight (branch-free: a pair past the chunk's end has a zero weight),
//     summed by an xor butterfly and then the point's warps in index order.
//   - gram_kernels.points_plan sizes `own` for about two blocks an SM
//     (kernel_bench --sweep): own = 4 at validation's B = 1, 160^2 and
//     200^2 (80 and 100 blocks), 8 at 1024^2 (one wave; 4 is two).
//   What bounds it at validation's shapes (kernel_bench --variants, CUDA-
//   graph replays, B = 1, 200^2): ~3 us a call against 0.10 us of bytes
//   (and 0.11 us of its own FP64 work); of it the launch 1.2 us (the
//   kernel returning at once), the chunk's reads and barrier 1.0
//   (returning after the barrier: 2.3), the exps, sums and writes the rest
//   (without the exps 0.15 less).
//   The first design (one warp a row, one side a launch, divisions, one
//   exp chain a lane) took 3.9 us for xa's side (G along its rows) and 4.1
//   for xb's (G^T), each launch alone.
//
// Inputs are read through their strides (a stride-0 batch broadcasts one
// point set; a broadcast cotangent is read in place); the outputs are
// contiguous, (B, D), (B, Na, D) and (B, Nb, D).  Templated on float and double; the
// port's path uses double.  Launches on the caller's stream, allocates
// nothing (the length cotangents take the caller's scratch of
// gram_kernels.vjp_plan partials and its counter, which must hold 0; two
// launches that share a counter must not run at once), and returns
// cudaGetLastError() to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                // gram_kernels.VJP_THREADS
constexpr int kCols = 2;                     // columns a thread: gram_kernels.VJP_COLS_PER_THREAD
constexpr int kColsPerBlock = kThreads * kCols;
constexpr int kMaxRows = 256;                // rows a block stages: gram_kernels.VJP_MAX_ROWS
constexpr int kDepth = 2;                    // cotangent rows in flight a thread (dense path)
constexpr int kSlots = kDepth + 1;
constexpr int kWarps = kThreads / 32;
constexpr int kTailLoads = 8;               // partials in flight a lane in the last block

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

// BYTES from global to shared memory, asynchronously (16 bytes: bypass L1)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(BYTES) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// C == 0: dense weight G (VEC: read by 2-column cp.async copies, else through
// its strides); C >= 1: rank-C weight g alpha^T
template <typename T, int D, int C, bool VEC>
__global__ void __launch_bounds__(kThreads)
rbf_vjp_kernel(const T* __restrict__ xa, const T* __restrict__ xb, const T* __restrict__ l,
               const T* __restrict__ gw, const T* __restrict__ alpha, T* __restrict__ out,
               T* __restrict__ part, unsigned* __restrict__ ticket, int na, int nb, int rows,
               long long sa_b, long long sa_n, long long sa_d,
               long long sb_b, long long sb_n, long long sb_d,
               long long sl_b, long long sl_d,
               long long sg_b, long long sg_i, long long sg_j,
               long long sp_b, long long sp_n, long long sp_c) {
  constexpr int W = D + C;  // shared row: z_i[0..D), g_i[0..C)
  __shared__ T s_row[kMaxRows][W];
  __shared__ __align__(16) T s_g[VEC ? kSlots : 1][kThreads][kCols];
  __shared__ T s_warp[kWarps][D];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * rows;
  const int nrows = min(rows, na - i0);
  const long long j0 = static_cast<long long>(blockIdx.x) * kColsPerBlock + kCols * tid;

  bool ok[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) ok[q] = j0 + q < nb;
  // the dense cotangent's row i0 at this thread's first column
  const T* grow = gw + b * sg_b + static_cast<long long>(i0) * sg_i + j0 * sg_j;

  // 1. start the copies of the first kDepth rows of this thread's columns
  auto issue = [&](int r, int slot) {
#pragma unroll
    for (int q = 0; q < kCols; q += 2) {
      if (ok[q + 1]) {
        cp_async<2 * sizeof(T)>(&s_g[slot][tid][q], grow + r * sg_i + q);
      } else if (ok[q]) {
        cp_async<sizeof(T)>(&s_g[slot][tid][q], grow + r * sg_i + q);
      }
    }
    cp_async_commit();
  };
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (s < nrows) {
        issue(s, s);
      } else {
        cp_async_commit();
      }
    }
  }

  // 2. meanwhile the block's rows (scaled points, g rows) and this thread's columns
  T len[D];
#pragma unroll
  for (int d = 0; d < D; ++d) len[d] = l[b * sl_b + d * sl_d];
  for (int t = tid; t < nrows; t += kThreads) {
    const long long i = i0 + t;
#pragma unroll
    for (int d = 0; d < D; ++d) s_row[t][d] = xa[b * sa_b + i * sa_n + d * sa_d] / len[d];
#pragma unroll
    for (int c = 0; c < C; ++c) s_row[t][D + c] = gw[b * sg_b + i * sg_i + c * sg_j];
  }
  T zb[kCols][D];
  T a[kCols][C > 0 ? C : 1];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const long long j = j0 + q;
#pragma unroll
    for (int d = 0; d < D; ++d) zb[q][d] = ok[q] ? xb[b * sb_b + j * sb_n + d * sb_d] / len[d] : T(0);
#pragma unroll
    for (int c = 0; c < C; ++c) a[q][c] = ok[q] ? alpha[b * sp_b + j * sp_n + c * sp_c] : T(0);
  }
  __syncthreads();

  // 3. walk the rows: kCols independent exp chains a row
  T acc[kCols][D];
#pragma unroll
  for (int q = 0; q < kCols; ++q)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[q][d] = T(0);
  int slot = 0;
#pragma unroll 4
  for (int r = 0; r < nrows; ++r) {
    T w[kCols];
    if constexpr (C > 0) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        w[q] = T(0);
#pragma unroll
        for (int c = 0; c < C; ++c) w[q] += s_row[r][D + c] * a[q][c];
      }
    } else if constexpr (VEC) {
      cp_async_wait<kDepth - 1>();  // row r has landed
#pragma unroll
      for (int q = 0; q < kCols; ++q) w[q] = ok[q] ? s_g[slot][tid][q] : T(0);
      // refill the slot read one row ago with row r + kDepth
      const int refill = slot == 0 ? kSlots - 1 : slot - 1;
      if (r + kDepth < nrows) {
        issue(r + kDepth, refill);
      } else {
        cp_async_commit();
      }
      slot = slot == kSlots - 1 ? 0 : slot + 1;
    } else {
#pragma unroll
      for (int q = 0; q < kCols; ++q) w[q] = ok[q] ? grow[r * sg_i + q * sg_j] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      T sq[D];
      T d2 = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const T diff = s_row[r][d] - zb[q][d];
        sq[d] = diff * diff;
        d2 += sq[d];
      }
      const T wk = w[q] * exp_t(T(-0.5) * d2);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[q][d] += wk * sq[d];
    }
  }

  // 4. the block's sums: the thread's columns, the warp's lanes, the warps
  T sum[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    sum[d] = acc[0][d];
#pragma unroll
    for (int q = 1; q < kCols; ++q) sum[d] += acc[q][d];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) sum[d] += __shfl_xor_sync(0xffffffffu, sum[d], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) s_warp[warp][d] = sum[d];
  }
  __syncthreads();
  const long long parts = static_cast<long long>(gridDim.x) * gridDim.y;
  if (tid == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      T s = s_warp[0][d];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) s += s_warp[k][d];
      part[(static_cast<long long>(b) * D + d) * parts + blockIdx.y * gridDim.x + blockIdx.x] = s;
    }
    // the ticket: a release of this block's partials, an acquire of the others'
    unsigned t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(t) : "l"(ticket) : "memory");
    s_last = t == static_cast<unsigned>(parts) * gridDim.z - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // 5. the last block: out[b, d] = (the partials of (b, d), in index order) / l[b, d]
  __threadfence();
  for (int q = warp; q < static_cast<int>(gridDim.z) * D; q += kWarps) {
    const int bb = q / D;
    const int dd = q - bb * D;
    const T* p = part + static_cast<long long>(q) * parts;
    T s = T(0);
    for (long long k0 = lane; k0 < parts; k0 += 32 * kTailLoads) {
      T v[kTailLoads];
#pragma unroll
      for (int u = 0; u < kTailLoads; ++u) {
        const long long k = k0 + 32 * u;
        v[u] = k < parts ? __ldcg(p + k) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kTailLoads; ++u) s += v[u];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[static_cast<long long>(bb) * D + dd] = s / l[bb * sl_b + dd * sl_d];
  }
  if (tid == 0) *ticket = 0u;
}

template <typename T, int C, bool VEC>
void launch_vjp(dim3 grid, cudaStream_t s, int d, const T* xa, const T* xb, const T* l,
                const T* gw, const T* alpha, T* out, T* part, unsigned* ticket, int na, int nb,
                int rows, long long sa_b, long long sa_n, long long sa_d,
                long long sb_b, long long sb_n, long long sb_d,
                long long sl_b, long long sl_d,
                long long sg_b, long long sg_i, long long sg_j,
                long long sp_b, long long sp_n, long long sp_c) {
#define GPLE_VJP_CASE(DIM)                                                              \
  case DIM:                                                                             \
    rbf_vjp_kernel<T, DIM, C, VEC><<<grid, kThreads, 0, s>>>(                           \
        xa, xb, l, gw, alpha, out, part, ticket, na, nb, rows, sa_b, sa_n, sa_d, sb_b,  \
        sb_n, sb_d, sl_b, sl_d, sg_b, sg_i, sg_j, sp_b, sp_n, sp_c);                    \
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

// c == 0: dense weight gw (B, Na, Nb), read by 2-column copies where vec is
// 1 (which needs a column stride of 1, even row and batch strides and a
// 2-element-aligned pointer); c >= 1: gw (B, Na, C) and alpha (B, Nb, C).
// rows: rows a block walks (at most kMaxRows); scratch: B * (cdiv(Na, rows)
// * cdiv(Nb, kColsPerBlock)) * d partials; ticket: a counter holding 0
template <typename T>
int launch_rbf_vjp(const T* xa, const T* xb, const T* l, const T* gw, const T* alpha, T* out,
                   T* scratch, unsigned* ticket, int batch, int na, int nb, int d, int c,
                   int rows, int vec, long long sa_b, long long sa_n, long long sa_d,
                   long long sb_b, long long sb_n, long long sb_d,
                   long long sl_b, long long sl_d,
                   long long sg_b, long long sg_i, long long sg_j,
                   long long sp_b, long long sp_n, long long sp_c, void* stream) {
  if (d < 1 || d > 4 || c < 0 || c > 2 || batch < 1 || batch > 65535 || na < 1 || nb < 1 ||
      rows < 1 || rows > kMaxRows || scratch == nullptr || ticket == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (c != 0 || sg_j != 1 || sg_i % 2 != 0 || sg_b % 2 != 0 ||
              reinterpret_cast<unsigned long long>(gw) % (2 * sizeof(T)) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long col_tiles = (static_cast<long long>(nb) + kColsPerBlock - 1) / kColsPerBlock;
  const long long row_blocks = (static_cast<long long>(na) + rows - 1) / rows;
  if (row_blocks > 65535 || col_tiles * row_blocks * batch >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_blocks), batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 0 && vec) {
    launch_vjp<T, 0, true>(grid, s, d, xa, xb, l, gw, alpha, out, scratch, ticket, na, nb, rows,
                           sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i, sg_j,
                           sp_b, sp_n, sp_c);
  } else if (c == 0) {
    launch_vjp<T, 0, false>(grid, s, d, xa, xb, l, gw, alpha, out, scratch, ticket, na, nb,
                            rows, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i,
                            sg_j, sp_b, sp_n, sp_c);
  } else if (c == 1) {
    launch_vjp<T, 1, false>(grid, s, d, xa, xb, l, gw, alpha, out, scratch, ticket, na, nb,
                            rows, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i,
                            sg_j, sp_b, sp_n, sp_c);
  } else {
    launch_vjp<T, 2, false>(grid, s, d, xa, xb, l, gw, alpha, out, scratch, ticket, na, nb,
                            rows, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i,
                            sg_j, sp_b, sp_n, sp_c);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- the points cotangent: both point sets of a Gram in one launch ------------

constexpr int kPairThreads = 256;
constexpr int kPairChunk = 256;    // sum-axis points a block stages at a time
constexpr int kPairMaxOwn = 16;    // own points a block: gram_kernels.POINTS_MAX_OWN
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kPairUnroll = 4;     // independent pairs (exp chains) a thread has in flight

// Block (x, b): x < tiles_a takes `own` rows i of G (the cotangent of xa),
// x >= tiles_a `own` columns j (that of xb); either way the block sums over
// the whole other axis, chunk by chunk, so no sum leaves the block.
template <typename T, int D>
__global__ void __launch_bounds__(kPairThreads)
rbf_gram_vjp_points_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                           const T* __restrict__ l, const T* __restrict__ gout,
                           T* __restrict__ out_a, T* __restrict__ out_b, int na, int nb,
                           int own_shift, int tiles_a,
                           long long sa_b, long long sa_n, long long sa_d,
                           long long sb_b, long long sb_n, long long sb_d,
                           long long sl_b, long long sl_d,
                           long long sg_b, long long sg_i, long long sg_j) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int own = 1 << own_shift;
  const int per_shift = 8 - own_shift;           // log2 of the threads an own point
  const int per = 1 << per_shift;
  T* s_g = reinterpret_cast<T*>(s_raw);          // [own][kPairChunk + 1]: G, own-major
  T* s_z = s_g + own * (kPairChunk + 1);         // [D][kPairChunk]: scaled sum-axis points
  T* s_red = s_z + D * kPairChunk;               // [kPairWarps][D]: warp sums

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const bool side_a = static_cast<int>(blockIdx.x) < tiles_a;
  const long long o0 = static_cast<long long>(side_a ? blockIdx.x : blockIdx.x - tiles_a)
                       << own_shift;
  // side a: own points xa (rows of G), summed over xb; side b the other way
  const T* xo = side_a ? xa + b * sa_b : xb + b * sb_b;
  const T* xk = side_a ? xb + b * sb_b : xa + b * sa_b;
  const long long so_n = side_a ? sa_n : sb_n, so_d = side_a ? sa_d : sb_d;
  const long long sk_n = side_a ? sb_n : sa_n, sk_d = side_a ? sb_d : sa_d;
  const long long sg_own = side_a ? sg_i : sg_j, sg_sum = side_a ? sg_j : sg_i;
  const int n_own = side_a ? na : nb, n_sum = side_a ? nb : na;
  T* out = side_a ? out_a : out_b;
  const int n_o = static_cast<int>(min(static_cast<long long>(own), n_own - o0));
  // stage the tile along the axis G is contiguous in: the sum axis (G's rows
  // on side a) unless only the own axis is (G's rows on side b, in runs of
  // `own` elements; a transposed G the other way round)
  const bool sum_fast = sg_sum == 1 || sg_own != 1;
  const T* gt = gout + b * sg_b + o0 * sg_own;

  const int r = tid >> per_shift;                // this thread's own point
  const int p = tid & (per - 1);                 // its place among the point's threads
  const bool o_ok = r < n_o;

  T inv[D], zo[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = T(0);
  for (int k0 = 0; k0 < n_sum; k0 += kPairChunk) {
    const int kc = min(kPairChunk, n_sum - k0);
    if (k0 > 0) __syncthreads();                 // the last chunk's tile is read
    // the chunk's global reads, all started before any is used: `own`
    // elements of G a thread, straight into shared memory, and one point
    for (int e = tid; e < (own << 8); e += kPairThreads) {
      const int rr = sum_fast ? e >> 8 : e & (own - 1);
      const int kk = sum_fast ? e & (kPairChunk - 1) : e >> own_shift;
      if (rr < n_o && kk < kc)
        cp_async<sizeof(T)>(&s_g[rr * (kPairChunk + 1) + kk],
                            gt + rr * sg_own + (k0 + kk) * sg_sum);
    }
    cp_async_commit();
    T zk[D];
#pragma unroll
    for (int d = 0; d < D; ++d) zk[d] = tid < kc ? xk[(k0 + tid) * sk_n + d * sk_d] : T(0);
    if (k0 == 0) {                               // under the first chunk's reads
#pragma unroll
      for (int d = 0; d < D; ++d) {
        zo[d] = o_ok ? xo[(o0 + r) * so_n + d * so_d] : T(0);
        inv[d] = T(1) / l[b * sl_b + d * sl_d];  // one division a length
        zo[d] *= inv[d];
      }
    }
    if (tid < kc) {
#pragma unroll
      for (int d = 0; d < D; ++d) s_z[d * kPairChunk + tid] = zk[d] * inv[d];
    }
    cp_async_wait<0>();
    __syncthreads();
    if (o_ok) {
      // kPairUnroll pairs at a time, branch-free: a pair past the chunk's
      // end reads its last point with a zero weight
      const T* grow = s_g + r * (kPairChunk + 1);
      for (int k1 = p; k1 < kc; k1 += kPairUnroll * per) {
        T wk[kPairUnroll], diff[kPairUnroll][D];
#pragma unroll
        for (int u = 0; u < kPairUnroll; ++u) {
          const int k = min(k1 + u * per, kc - 1);
          T d2 = T(0);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            diff[u][d] = s_z[d * kPairChunk + k] - zo[d];
            d2 += diff[u][d] * diff[u][d];
          }
          wk[u] = (k1 + u * per < kc ? grow[k] : T(0)) * exp_t(T(-0.5) * d2);
        }
#pragma unroll
        for (int u = 0; u < kPairUnroll; ++u)
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += wk[u] * diff[u][d];
      }
    }
  }

  // the point's sums in a fixed order: an xor butterfly over its lanes, then
  // its warps in index order
  for (int off = min(per, 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (per > 32) {
    if ((tid & 31) == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) s_red[(tid >> 5) * D + d] = acc[d];
    }
    __syncthreads();
    if (p == 0) {
      const int w0 = tid >> 5;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[d] = s_red[w0 * D + d];
        for (int q = 1; q < per >> 5; ++q) acc[d] += s_red[(w0 + q) * D + d];
      }
    }
  }
  if (o_ok && p == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      out[((static_cast<long long>(b) * n_own) + o0 + r) * D + d] = acc[d] * inv[d];
  }
}

// out_a (B, Na, D) and out_b (B, Nb, D), contiguous; either may be null (that
// side is not computed).  own: points a block, a power of two in [1, kPairMaxOwn]
template <typename T>
int launch_rbf_gram_vjp_points(const T* xa, const T* xb, const T* l, const T* gout, T* out_a,
                               T* out_b, int batch, int na, int nb, int d, int own,
                               long long sa_b, long long sa_n, long long sa_d,
                               long long sb_b, long long sb_n, long long sb_d,
                               long long sl_b, long long sl_d,
                               long long sg_b, long long sg_i, long long sg_j, void* stream) {
  int own_shift = 0;
  while ((1 << own_shift) < own) ++own_shift;
  if (d < 1 || d > 4 || batch < 1 || batch > 65535 || na < 1 || nb < 1 ||
      own != (1 << own_shift) || own > kPairMaxOwn || (out_a == nullptr && out_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_a = out_a ? (static_cast<long long>(na) + own - 1) / own : 0;
  const long long tiles_b = out_b ? (static_cast<long long>(nb) + own - 1) / own : 0;
  if (tiles_a + tiles_b >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles_a + tiles_b), batch);
  const size_t smem = sizeof(T) * (own * (kPairChunk + 1) + d * kPairChunk + kPairWarps * d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPLE_POINTS_CASE(DIM)                                                           \
  case DIM:                                                                             \
    rbf_gram_vjp_points_kernel<T, DIM><<<grid, kPairThreads, smem, s>>>(                \
        xa, xb, l, gout, out_a, out_b, na, nb, own_shift, static_cast<int>(tiles_a),    \
        sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d, sg_b, sg_i, sg_j);              \
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
                     float* out, float* scratch, unsigned* ticket, int batch, int na, int nb,
                     int d, int rows, int vec,
                     long long sa_b, long long sa_n, long long sa_d,
                     long long sb_b, long long sb_n, long long sb_d,
                     long long sl_b, long long sl_d,
                     long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_vjp<float>(xa, xb, l, gout, nullptr, out, scratch, ticket, batch, na, nb,
                               d, 0, rows, vec, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d,
                               sg_b, sg_i, sg_j, 0, 0, 0, stream);
}

int rbf_gram_vjp_f64(const double* xa, const double* xb, const double* l, const double* gout,
                     double* out, double* scratch, unsigned* ticket, int batch, int na, int nb,
                     int d, int rows, int vec,
                     long long sa_b, long long sa_n, long long sa_d,
                     long long sb_b, long long sb_n, long long sb_d,
                     long long sl_b, long long sl_d,
                     long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_vjp<double>(xa, xb, l, gout, nullptr, out, scratch, ticket, batch, na, nb,
                                d, 0, rows, vec, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b,
                                sl_d, sg_b, sg_i, sg_j, 0, 0, 0, stream);
}

int rbf_predict_vjp_f32(const float* xt, const float* xtr, const float* l, const float* g,
                        const float* alpha, float* out, float* scratch, unsigned* ticket,
                        int batch, int m, int n, int d, int c, int rows,
                        long long st_b, long long st_m, long long st_d,
                        long long sr_b, long long sr_n, long long sr_d,
                        long long sl_b, long long sl_d,
                        long long sg_b, long long sg_m, long long sg_c,
                        long long sa_b, long long sa_n, long long sa_c, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rbf_vjp<float>(xt, xtr, l, g, alpha, out, scratch, ticket, batch, m, n, d, c,
                               rows, 0, st_b, st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d, sg_b,
                               sg_m, sg_c, sa_b, sa_n, sa_c, stream);
}

int rbf_predict_vjp_f64(const double* xt, const double* xtr, const double* l, const double* g,
                        const double* alpha, double* out, double* scratch, unsigned* ticket,
                        int batch, int m, int n, int d, int c, int rows,
                        long long st_b, long long st_m, long long st_d,
                        long long sr_b, long long sr_n, long long sr_d,
                        long long sl_b, long long sl_d,
                        long long sg_b, long long sg_m, long long sg_c,
                        long long sa_b, long long sa_n, long long sa_c, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rbf_vjp<double>(xt, xtr, l, g, alpha, out, scratch, ticket, batch, m, n, d, c,
                                rows, 0, st_b, st_m, st_d, sr_b, sr_n, sr_d, sl_b, sl_d, sg_b,
                                sg_m, sg_c, sa_b, sa_n, sa_c, stream);
}

int rbf_gram_vjp_points_f32(const float* xa, const float* xb, const float* l,
                            const float* gout, float* out_a, float* out_b, int batch, int na,
                            int nb, int d, int own,
                            long long sa_b, long long sa_n, long long sa_d,
                            long long sb_b, long long sb_n, long long sb_d,
                            long long sl_b, long long sl_d,
                            long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_gram_vjp_points<float>(xa, xb, l, gout, out_a, out_b, batch, na, nb, d,
                                           own, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b, sl_d,
                                           sg_b, sg_i, sg_j, stream);
}

int rbf_gram_vjp_points_f64(const double* xa, const double* xb, const double* l,
                            const double* gout, double* out_a, double* out_b, int batch,
                            int na, int nb, int d, int own,
                            long long sa_b, long long sa_n, long long sa_d,
                            long long sb_b, long long sb_n, long long sb_d,
                            long long sl_b, long long sl_d,
                            long long sg_b, long long sg_i, long long sg_j, void* stream) {
  return launch_rbf_gram_vjp_points<double>(xa, xb, l, gout, out_a, out_b, batch, na, nb, d,
                                            own, sa_b, sa_n, sa_d, sb_b, sb_n, sb_d, sl_b,
                                            sl_d, sg_b, sg_i, sg_j, stream);
}

}  // extern "C"
