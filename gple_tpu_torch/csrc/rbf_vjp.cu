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
// rbf_gram_vjp reads the (B, Na, Nb) cotangent once against 4D + 16 FP64
// instructions a pair: at D = 2, 8 bytes against 24 instructions, so the
// bytes bound it (5.0 us for B = 2, N = 1024 at 3.35 TB/s), but the FP64
// pipe is not far behind (3.0 us): the kernel reaches its bound only if the
// cotangent's bytes stream in while the exps run.  rbf_predict_vjp reads
// O((M + N) (D + C)) bytes and issues 4D + 16 + C FP64 instructions a pair:
// the FP64 pipe bounds it, and it needs enough independent exp chains on
// every SM to cover the DFMA latency.  rbf_gram_vjp_points reads the
// cotangent once and issues 3D + 17 FP64 instructions a pair: bytes bound it
// too, but at validation's shapes ((1 | 7, 200, 200), 0.1-0.7 us of bytes) a
// launch's latency is the floor.
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
// * Points cotangent: row reductions, one warp per row i, kPointRows rows a
//   block, grid (row tiles, B).  The block stages a tile of kPointTile scaled
//   columns zb_j in shared memory (one division per column and block, laid
//   out by dimension so a warp's reads are contiguous); each lane walks the
//   tile's columns lane, lane + 32, ... in order, and the warp adds its lanes'
//   sums by an xor butterfly.  A dense cotangent is read along j (coalesced);
//   read transposed, a warp's 32 loads fall in 32 sectors, which the L2 holds
//   at these sizes.
//
// Inputs are read through their strides (a stride-0 batch broadcasts one
// point set; a broadcast cotangent is read in place); the outputs are
// contiguous, (B, D) and (B, Na, D).  Templated on float and double; the
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
