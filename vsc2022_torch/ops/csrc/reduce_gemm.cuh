// Persistent, pipelined f32 tile product of the row reductions (row_max,
// count_above): a fused q . refs^T whose scores are folded into one value
// per query row (a max, a count) and never reach device memory.
//
// Arithmetic. Every score is the sequential sum over k = 0..D-1 of
// fmaf(q, r, acc) from +0.0f, the order of tile_gemm.cuh, so row_max and
// count_above see the scores of pool_writer and fused_topk bit for bit for
// the same (query, ref) pair. The depth is zero-filled up to a multiple of
// BK, and fmaf(0, 0, acc) == acc for every acc the chain can reach (it never
// holds -0.0f: it starts at +0.0f and an exact cancellation rounds to +0).
// No split-K, no TF32, no reassociation: the pooled prune
// (similarity.py, `totals == kept`) and the streaming verify need counts of
// exactly the scores the pool and the candidates hold.
//
// Work. A work item is a [128 query rows x 128 ref columns] tile, items are
// numbered row tile major (item = row_tile * col_tiles + col_tile), and the
// grid is one wave: the SMs times the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Block b walks the
// contiguous items [b*W/G, (b+1)*W/G) (ops/kernels.py:reduce_schedule), so
// the blocks' loads differ by at most one item whether the call has 1 query
// row or 9,000, and each block keeps its running value per row in registers
// across its column tiles; it flushes the value with one atomic per row
// when its range leaves a row tile and at its end.
//
// Block tile. 256 threads as 8 warps, 4 over the rows x 2 over the
// columns; a thread holds an 8 x 8 register tile, rows w_r*32 + ty + 4i
// and columns w_c*64 + tx + 8j (ty < 4, tx < 8). Shared memory keeps the
// operands k-contiguous, as in global memory, rows padded to BK + 4
// floats: a thread reads a float4 along k for each of its rows and columns
// and runs those 4 k-steps in order, 256 FMAs for 16 reads. Lanes 8p..8p+7
// (a quarter-warp) take 2 ty x 4 tx, so each of their reads touches 2 rows
// or 4 adjacent columns, in distinct bank groups: the H100 serves such a
// load in one shared-memory cycle, where 8 columns per quarter-warp take
// two (tools/smem_probe.py).
//
// Pipeline. A ring of STAGES k-slices in dynamic shared memory, filled by
// cp.async: 16-byte copies when D % 4 == 0 and both operands are 16-byte
// aligned, 4-byte copies otherwise (the path's D = 511 and 1025 rows are
// not aligned; the corpus is never copied into a padded buffer). The ring
// runs over the block's whole sequence of (item, k-slice) steps, across
// item boundaries, with one barrier per slice: STAGES - 1 slices are in
// flight while one is multiplied.
//
// Registers. The k-contiguous fragments (8 + 8 float4 per 4 k-steps) and
// the 64 accumulators take the thread's 255 registers, so an SM holds one
// block (8 warps); a 64-deep slice keeps the barriers to one per 4,096
// FMAs a thread. Tuned on the H100 (PERF.md, section 6).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace vsc {
namespace reduce {

constexpr int BM = 128;        // query rows per work item
constexpr int BN = 128;        // ref columns per work item
constexpr int THREADS = 256;   // 8 warps: 4 over the rows x 2 over the columns
constexpr int MIN_BLOCKS = 1;  // blocks per SM the register budget allows
constexpr int TM = 8;          // rows per thread
constexpr int TN = 8;          // columns per thread
constexpr int BK = 64;         // depth per ring stage
constexpr int STAGES = 3;      // ring depth
constexpr int LD = BK + 4;     // padded row of a stage, in floats
constexpr int STAGE_FLOATS = (BM + BN) * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + ROWS) x k-slice [k0, k0 + BK) of a row-major
// [*, d] operand into `dst` (ROWS rows of LD floats); rows >= lim and
// k >= d read as zeros.
template <int ROWS, bool kVec>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int lim, int d, int row0, int k0) {
  // Consecutive threads copy consecutive 16- or 4-byte pieces of a row.
  constexpr int PIECES = kVec ? BK / 4 : BK;  // per row
  constexpr int STEP = THREADS / PIECES;      // rows per pass of the block
  static_assert(THREADS % PIECES == 0 && ROWS % STEP == 0, "copy shape");
  const int c = threadIdx.x % PIECES, r = threadIdx.x / PIECES;
  const int k = k0 + (kVec ? 4 * c : c);
  const bool k_ok = k < d;
  const float* p = src + (size_t)(row0 + r) * d + k;
  const size_t stride = (size_t)STEP * d;
#pragma unroll
  for (int e = 0; e < ROWS / STEP; ++e) {
    const bool ok = k_ok && row0 + r + STEP * e < lim;
    float* to = dst + (r + STEP * e) * LD + (kVec ? 4 * c : c);
    if constexpr (kVec)
      cp_async16(to, ok ? p + e * stride : src, ok);
    else
      cp_async4(to, ok ? p + e * stride : src, ok);
  }
}

// acc[i][j] += the BK k-steps of one stage, in k order.
__device__ __forceinline__ void multiply_slice(const float* stage, int row,
                                               int col, float acc[TM][TN]) {
  const float* a_base = stage + row * LD;
  const float* b_base = stage + (BM + col) * LD;
#pragma unroll
  for (int kq = 0; kq < BK; kq += 4) {
    float4 b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(b_base + 8 * j * LD + kq);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(a_base + 4 * i * LD + kq);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float v = acc[i][j];
        v = fmaf(a.x, b[j].x, v);
        v = fmaf(a.y, b[j].y, v);
        v = fmaf(a.z, b[j].z, v);
        acc[i][j] = fmaf(a.w, b[j].w, v);
      }
    }
  }
}

// The reduction of a row's scores is given by Op:
//   using T;                        the per-row value (float max, int count)
//   T identity() const;             the value of no column
//   T fold(T v, float score) const; one more column
//   T combine(T a, T b) const;      two partial values (commutative)
//   void commit(int row, T v) const; one atomic per row and flush
//
// Folds one finished tile into `run`: per row i, the thread's valid columns,
// then the 8 lanes of the row (tx: lane bits 0, 1 and 4), and lane tx keeps
// row i == tx. Columns at or past n_valid are skipped only in the tile that
// straddles n_valid.
template <class Op, bool kMasked>
__device__ __forceinline__ void fold_tile(const Op& op, float acc[TM][TN],
                                          int valid_cols, int tx,
                                          typename Op::T& run) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    typename Op::T v = op.identity();
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (!kMasked || 8 * j < valid_cols) v = op.fold(v, acc[i][j]);
    v = op.combine(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = op.combine(v, __shfl_xor_sync(0xffffffffu, v, 2));
    v = op.combine(v, __shfl_xor_sync(0xffffffffu, v, 16));
    if (tx == i) run = op.combine(run, v);
  }
}

template <class Op, bool kVec>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    reduce_kernel(const float* __restrict__ q, const float* __restrict__ refs,
                  int m, int d, int n_valid, Op op) {
  extern __shared__ __align__(16) float ring[];
  __shared__ typename Op::T partial[BM];  // the second column half at a flush

  const int col_tiles = (n_valid + BN - 1) / BN;
  const unsigned long long items =
      (unsigned long long)((m + BM - 1) / BM) * col_tiles;
  const long long begin = (long long)(items * blockIdx.x / gridDim.x);
  const long long end = (long long)(items * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  const int kt_n = (d + BK - 1) / BK;
  const int steps = (int)(end - begin) * kt_n;  // < 2^31 (launch checks)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp >> 2;
  const int tx = 4 * (lane >> 4) + (lane & 3);               // 0..7
  const int ty = 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);  // 0..3
  const int row = (warp & 3) * 32 + ty;  // + 4i
  const int col = wc * 64 + tx;          // + 8j

  // Consumer item (rt, ct); producer step (lrt, lct, lkt).
  int rt = (int)(begin / col_tiles), ct = (int)(begin % col_tiles);
  int lrt = rt, lct = ct, lkt = 0;
  auto load_step = [&](int stage) {
    float* dst = ring + stage * STAGE_FLOATS;
    load_rows<BM, kVec>(dst, q, m, d, lrt * BM, lkt * BK);
    load_rows<BN, kVec>(dst + BM * LD, refs, n_valid, d, lct * BN, lkt * BK);
    if (++lkt == kt_n) {
      lkt = 0;
      if (++lct == col_tiles) {
        lct = 0;
        ++lrt;
      }
    }
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < steps) load_step(p);
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  typename Op::T run = op.identity();
  int cstage = 0, ckt = 0;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's copies)
    __syncthreads();              // ... everyone's; step s - 1 is consumed
    if (s + STAGES - 1 < steps)   // into the stage step s - 1 used
      load_step(cstage == 0 ? STAGES - 1 : cstage - 1);
    cp_async_commit();
    multiply_slice(ring + cstage * STAGE_FLOATS, row, col, acc);
    cstage = cstage + 1 == STAGES ? 0 : cstage + 1;
    if (++ckt < kt_n) continue;

    // Item (rt, ct) is complete.
    ckt = 0;
    const int valid_cols = n_valid - (ct * BN + col);
    if (ct * BN + BN <= n_valid)
      fold_tile<Op, false>(op, acc, valid_cols, tx, run);
    else
      fold_tile<Op, true>(op, acc, valid_cols, tx, run);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const int next_rt = ct + 1 == col_tiles ? rt + 1 : rt;
    if (next_rt != rt || s + 1 == steps) {
      // Flush row tile rt. Lane tx holds row `row + 4*tx` of its column
      // half; the halves meet in shared memory. The next write to
      // `partial` comes after at least one more barrier of the loop.
      const int lrow = row + 4 * tx;
      if (wc == 1) partial[lrow] = run;
      __syncthreads();
      if (wc == 0 && rt * BM + lrow < m)
        op.commit(rt * BM + lrow, op.combine(run, partial[lrow]));
      run = op.identity();
    }
    ct = ct + 1 == col_tiles ? 0 : ct + 1;
    rt = next_rt;
  }
}

template <class Op, bool kVec>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      reduce_kernel<Op, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(reduce_kernel<Op, kVec>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Blocks of the kernel an SM holds at once (0: it cannot launch).
template <class Op>
int resident_blocks(int device, int vec, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = vec ? configure<Op, true>() : configure<Op, false>();
  if (err != cudaSuccess) return (int)err;
  void (*kernel)(const float*, const float*, int, int, int, Op) =
      vec ? &reduce_kernel<Op, true> : &reduce_kernel<Op, false>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, THREADS, SMEM_BYTES);
}

// Whether the 16-byte copies may be used: D % 4 == 0, both bases aligned.
inline bool vec_ok(const float* q, const float* refs, int d) {
  return d % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(refs)) &
          15) == 0;
}

// Launch `grid` blocks over the items of an [m, n_valid] call; nothing when
// there are no items.
template <class Op>
cudaError_t launch(const float* q, const float* refs, int m, int d,
                   int n_valid, int vec, int grid, const Op& op,
                   cudaStream_t s) {
  if (m <= 0 || n_valid <= 0) return cudaSuccess;
  if (grid <= 0 || d <= 0 || (vec && !vec_ok(q, refs, d)))
    return cudaErrorInvalidValue;
  // At least one item per block, and a block's steps count in an int.
  const unsigned long long items =
      (unsigned long long)((m + BM - 1) / BM) * ((n_valid + BN - 1) / BN);
  if ((unsigned long long)grid > items ||
      (items / grid + 1) * ((d + BK - 1) / BK) > (unsigned long long)INT_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = vec ? configure<Op, true>() : configure<Op, false>();
  if (err != cudaSuccess) return err;
  if (vec)
    reduce_kernel<Op, true><<<grid, THREADS, SMEM_BYTES, s>>>(q, refs, m, d,
                                                              n_valid, op);
  else
    reduce_kernel<Op, false><<<grid, THREADS, SMEM_BYTES, s>>>(q, refs, m, d,
                                                               n_valid, op);
  return cudaGetLastError();
}

}  // namespace reduce
}  // namespace vsc
