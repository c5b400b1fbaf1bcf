// Persistent, pipelined f32 tile product of the retrieval kernels that keep
// no score: row_max, count_above (one value per query row: a max, a count)
// and fused_topk (a top-kappa set per query row), over f32 operands. Their
// [M, N] scores never reach device memory; each kernel is this product plus
// an epilogue that consumes every finished tile.
//
// Arithmetic. Every score is the sequential sum over k = 0..D-1 of
// fmaf(q, r, acc) from +0.0f, the order of tile_gemm.cuh, so these kernels
// see the scores of the f32 pool_writer bit for bit for the same (query,
// ref) pair.
// The depth is zero-filled up to a multiple of BK, and fmaf(0, 0, acc) ==
// acc for every acc the chain can reach (it never holds -0.0f: it starts
// at +0.0f and an exact cancellation rounds to +0). No split-K, no TF32, no
// reassociation: the pooled prune (similarity.py, `totals == kept`) and
// the streaming verify need counts of exactly the scores the pool and the
// candidates hold. The bf16 and int8 kernels run the tensor-core product of
// wgmma_gemm.cuh instead, all of one dtype on it, for the same reason.
//
// Work. A work item is a [128 query rows x 128 ref columns] tile (one
// winner-pool segment per row), items are numbered row tile major (item =
// row_tile * col_tiles + col_tile), and the grid is one wave: the SMs times
// the blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Block b walks the contiguous items [b*W/G, (b+1)*W/G)
// (ops/kernels.py:reduce_schedule), so the blocks' loads differ by at most
// one item whether the call has 1 query row or 9,000. The epilogue sees
// each item as it completes and is told when the block's range leaves a
// row tile and when it ends: the row reductions keep a running value per
// row in registers and flush it there with one atomic per row.
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
// Pipeline. A ring of f32 k-slices in dynamic shared memory (3 stages for
// the row reductions, 2 for fused_topk, whose sets take the room of the
// third). f32 operands fill it by cp.async: 16-byte copies when D % 4 == 0
// and both operands are 16-byte aligned, 4-byte copies otherwise (the path's
// D = 511 and 1025 rows are not aligned; the corpus is never copied into a
// padded buffer). The ring runs over the block's whole sequence of (item,
// k-slice) steps, across item boundaries, with one barrier per slice: all but
// one of the stages are in flight while one is multiplied, and while the
// epilogue runs.
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
#include <type_traits>

#include "block_list.cuh"

namespace vsc {
namespace reduce {

constexpr int BM = 128;        // query rows per work item
constexpr int BN = 128;        // ref columns per work item
constexpr int THREADS = 256;   // 8 warps: 4 over the rows x 2 over the columns
constexpr int MIN_BLOCKS = 1;  // blocks per SM the register budget allows
constexpr int TM = 8;          // rows per thread
constexpr int TN = 8;          // columns per thread
constexpr int BK = 64;         // depth per ring stage
constexpr int STAGES = 3;      // ring depth of the row reductions
constexpr int LD = BK + 4;     // padded row of a stage, in floats
constexpr int STAGE_FLOATS = (BM + BN) * LD;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
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
// [*, d] f32 operand into `dst` (ROWS rows of LD floats); rows >= lim and
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

// acc[i][j] += the BK k-steps of one stage, in k order: query rows from
// `a_stage`, corpus rows from `b_stage` (each rows of LD floats).
__device__ __forceinline__ void multiply_slice(const float* a_stage,
                                               const float* b_stage, int row,
                                               int col, float acc[TM][TN]) {
  const float* a_base = a_stage + row * LD;
  const float* b_base = b_stage + col * LD;
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

// Bytes of the ring of an epilogue's kernel: E::kStages stages, each the
// query rows and then the corpus rows of one k-slice.
template <class E>
constexpr int ring_bytes() {
  return E::kStages * STAGE_FLOATS * (int)sizeof(float);
}

// A thread's place in the block tile: it holds rows `row + 4i` and columns
// `col + 8j` of every item.
struct Tile {
  int warp, lane;
  int wc;   // column half (warps 4-7 take columns 64..127)
  int tx;   // 0..7: lane bits 0, 1 and 4
  int row;  // (warp % 4) * 32 + ty, ty 0..3: lane bits 2 and 3
  int col;  // wc * 64 + tx
};

// The launch's work: W = items = row_tiles * col_tiles.
struct Work {
  int m, col_tiles;
  unsigned long long items;
};

// The epilogue E consumes the finished items. Every thread of the block
// calls each hook (they may synchronize the block):
//   kStages         the ring's depth (>= 2); dynamic shared memory past the
//                   ring (the launch's `extra` bytes) is the epilogue's
//   struct State;   per thread, in registers across the whole loop
//   struct Smem;    in static shared memory beside the ring
//   void begin(State&, Smem&, const Tile&, const Work&) const;
//   template <bool kMasked>            kMasked: the item straddles n_valid;
//   void item(State&, Smem&, const Tile&, const Work&, float acc[TM][TN],
//             int rt, int ct, int valid_cols) const;
//                                      columns col + 8j are valid where
//                                      8j < valid_cols
//   void flush(State&, Smem&, const Tile&, const Work&, int rt) const;
//                                      the block leaves row tile rt (or ends)

// The row reductions' epilogue, for an Op that gives
//   using T;                        the per-row value (float max, int count)
//   T identity() const;             the value of no column
//   T fold(T v, float score) const; one more column
//   T combine(T a, T b) const;      two partial values (commutative)
//   void commit(int row, T v) const; one atomic per row and flush
// Each finished tile folds into `run`: per row i, the thread's valid
// columns, then the 8 lanes of the row (tx: lane bits 0, 1 and 4), and lane
// tx keeps row i == tx. Columns at or past n_valid are skipped only in the
// tile that straddles n_valid.
template <class Op>
struct RowFold {
  static constexpr int kStages = STAGES;
  Op op;
  using State = typename Op::T;
  struct Smem {
    typename Op::T partial[BM];  // the second column half at a flush
  };

  __device__ __forceinline__ void begin(State& run, Smem&, const Tile&,
                                        const Work&) const {
    run = op.identity();
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(State& run, Smem&, const Tile& t,
                                       const Work&, float acc[TM][TN], int,
                                       int, int valid_cols) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      typename Op::T v = op.identity();
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (!kMasked || 8 * j < valid_cols) v = op.fold(v, acc[i][j]);
      v = op.combine(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = op.combine(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = op.combine(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (t.tx == i) run = op.combine(run, v);
    }
  }

  // Lane tx holds row `row + 4*tx` of its column half; the halves meet in
  // shared memory. The next write to `partial` comes after at least one
  // more barrier of the loop.
  __device__ __forceinline__ void flush(State& run, Smem& sm, const Tile& t,
                                        const Work& w, int rt) const {
    const int lrow = t.row + 4 * t.tx;
    if (t.wc == 1) sm.partial[lrow] = run;
    __syncthreads();
    if (t.wc == 0 && rt * BM + lrow < w.m)
      op.commit(rt * BM + lrow, op.combine(run, sm.partial[lrow]));
    run = op.identity();
  }
};

// Epilogue E over a list of corpus blocks (block_list.cuh): the launch's
// column tile c is corpus tile list.corpus_tile(c), whose rows the product
// loads and whose number E's item() sees; Work.col_tiles and the items stay
// the launch's (the listed blocks' tiles). A kernel of its own (the product
// below instantiated for it), so the full-corpus kernels keep their code.
template <class E>
struct Blocks {
  static constexpr int kStages = E::kStages;
  using State = typename E::State;
  using Smem = typename E::Smem;
  E ep;
  BlockList list;

  __device__ __forceinline__ void begin(State& st, Smem& sm, const Tile& t,
                                        const Work& w) const {
    ep.begin(st, sm, t, w);
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(State& st, Smem& sm, const Tile& t,
                                       const Work& w, float acc[TM][TN], int rt,
                                       int ct, int valid_cols) const {
    ep.template item<kMasked>(st, sm, t, w, acc, rt, ct, valid_cols);
  }

  __device__ __forceinline__ void flush(State& st, Smem& sm, const Tile& t,
                                        const Work& w, int rt) const {
    ep.flush(st, sm, t, w, rt);
  }
};

template <class E>
struct is_blocks : std::false_type {};
template <class E>
struct is_blocks<Blocks<E>> : std::true_type {};

// kVec: 16-byte copies of both operands (vec_ok), else 4-byte ones.
template <class E, bool kVec>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    reduce_kernel(const float* __restrict__ q, const float* refs, int m, int d,
                  int n_valid, E ep) {
  extern __shared__ __align__(16) float ring[];
  __shared__ typename E::Smem esm;

  // The kernel over a block list (Blocks<E>) takes the list's tiles and
  // loads corpus tile list.corpus_tile(c) for its column tile c; the
  // full-corpus kernels compile the code they had (if constexpr).
  int col_tiles = (n_valid + BN - 1) / BN;
  if constexpr (is_blocks<E>::value) col_tiles = ep.list.launch_tiles();
  const unsigned long long items =
      (unsigned long long)((m + BM - 1) / BM) * col_tiles;
  const long long begin = (long long)(items * blockIdx.x / gridDim.x);
  const long long end = (long long)(items * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  const int kt_n = (d + BK - 1) / BK;
  const int steps = (int)(end - begin) * kt_n;  // < 2^31 (launch checks)
  const Work work = {m, col_tiles, items};

  Tile t;
  t.warp = threadIdx.x >> 5;
  t.lane = threadIdx.x & 31;
  t.wc = t.warp >> 2;
  t.tx = 4 * (t.lane >> 4) + (t.lane & 3);                  // 0..7
  const int ty = 2 * ((t.lane >> 3) & 1) + ((t.lane >> 2) & 1);  // 0..3
  t.row = (t.warp & 3) * 32 + ty;  // + 4i
  t.col = t.wc * 64 + t.tx;        // + 8j

  constexpr int kStages = E::kStages;
  // Consumer item (rt, ct); producer step (lrt, lct, lkt).
  int rt = (int)(begin / col_tiles), ct = (int)(begin % col_tiles);
  int lrt = rt, lct = ct, lkt = 0;
  auto load_step = [&](int stage) {
    float* dst = ring + stage * STAGE_FLOATS;
    load_rows<BM, kVec>(dst, q, m, d, lrt * BM, lkt * BK);
    if constexpr (is_blocks<E>::value)
      load_rows<BN, kVec>(dst + BM * LD, refs, n_valid, d,
                          ep.list.corpus_tile(lct) * BN, lkt * BK);
    else
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
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < steps) load_step(p);
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  typename E::State st;
  ep.begin(st, esm, t, work);
  int cstage = 0, ckt = 0;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's copies)
    __syncthreads();               // ... everyone's; step s - 1 is consumed
    const bool ahead = s + kStages - 1 < steps;
    if (ahead)  // into the stage step s - 1 used
      load_step(cstage == 0 ? kStages - 1 : cstage - 1);
    cp_async_commit();
    multiply_slice(ring + cstage * STAGE_FLOATS,
                   ring + cstage * STAGE_FLOATS + BM * LD, t.row, t.col, acc);
    cstage = cstage + 1 == kStages ? 0 : cstage + 1;
    if (++ckt < kt_n) continue;

    // Item (rt, ct) is complete.
    ckt = 0;
    if constexpr (is_blocks<E>::value) {  // its corpus tile
      const int cct = ep.list.corpus_tile(ct);
      const int valid_cols = n_valid - (cct * BN + t.col);
      if (cct * BN + BN <= n_valid)
        ep.template item<false>(st, esm, t, work, acc, rt, cct, valid_cols);
      else
        ep.template item<true>(st, esm, t, work, acc, rt, cct, valid_cols);
    } else {
      const int valid_cols = n_valid - (ct * BN + t.col);
      if (ct * BN + BN <= n_valid)
        ep.template item<false>(st, esm, t, work, acc, rt, ct, valid_cols);
      else
        ep.template item<true>(st, esm, t, work, acc, rt, ct, valid_cols);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const int next_rt = ct + 1 == col_tiles ? rt + 1 : rt;
    if (next_rt != rt || s + 1 == steps) ep.flush(st, esm, t, work, rt);
    ct = ct + 1 == col_tiles ? 0 : ct + 1;
    rt = next_rt;
  }
}

template <class E, bool kVec>
cudaError_t configure(int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      reduce_kernel<E, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(reduce_kernel<E, kVec>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <class E, bool kVec>
int resident_blocks_of(int device, int extra, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = ring_bytes<E>() + extra;
  err = configure<E, kVec>(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reduce_kernel<E, kVec>, THREADS, smem);
}

// Blocks of the kernel an SM holds at once with `extra` bytes of dynamic
// shared memory past the ring (0: it cannot launch): f32 rows with 16-byte
// copies if vec.
template <class E>
int resident_blocks(int device, int vec, int extra, int* blocks_per_sm) {
  return vec ? resident_blocks_of<E, true>(device, extra, blocks_per_sm)
             : resident_blocks_of<E, false>(device, extra, blocks_per_sm);
}

// Whether the 16-byte copies may be used: a row is a whole number of 16-byte
// pieces (D % 4 == 0) and both bases are aligned.
inline bool vec_ok(const float* q, const float* refs, int d) {
  return d % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(refs)) &
          15) == 0;
}

// Launch `grid` blocks of the kernel on the items of an [m, n_valid] call,
// with `extra` bytes of dynamic shared memory past the ring; nothing when
// there are no items.
template <class E, bool kVec>
cudaError_t launch_on(const float* q, const float* refs, int m, int d,
                      int n_valid, int grid, const E& ep, int extra,
                      cudaStream_t s) {
  if (m <= 0 || n_valid <= 0) return cudaSuccess;
  if (grid <= 0 || d <= 0) return cudaErrorInvalidValue;
  // At least one item per block, and a block's steps count in an int.
  unsigned long long col_tiles = (n_valid + BN - 1) / BN;
  if constexpr (is_blocks<E>::value) col_tiles = ep.list.launch_tiles();
  const unsigned long long items = (unsigned long long)((m + BM - 1) / BM) * col_tiles;
  if ((unsigned long long)grid > items ||
      (items / grid + 1) * ((d + BK - 1) / BK) > (unsigned long long)INT_MAX)
    return cudaErrorInvalidValue;
  const int smem = ring_bytes<E>() + extra;
  cudaError_t err = configure<E, kVec>(smem);
  if (err != cudaSuccess) return err;
  reduce_kernel<E, kVec><<<grid, THREADS, smem, s>>>(q, refs, m, d, n_valid, ep);
  return cudaGetLastError();
}

// f32 rows: 16-byte copies if vec (vec_ok).
template <class E>
cudaError_t launch(const float* q, const float* refs, int m, int d,
                   int n_valid, int vec, int grid, const E& ep, int extra,
                   cudaStream_t s) {
  if (vec && !vec_ok(q, refs, d)) return cudaErrorInvalidValue;
  return vec ? launch_on<E, true>(q, refs, m, d, n_valid, grid, ep, extra, s)
             : launch_on<E, false>(q, refs, m, d, n_valid, grid, ep, extra, s);
}

// The same over the corpus blocks of `ids` (n of them, col_block rows each,
// col_block a multiple of BN): E's kernel over the list (Blocks<E>). An
// empty list launches nothing; the caller has set the outputs.
template <class E>
cudaError_t launch_blocks(const float* q, const float* refs, int m, int d,
                          int n_valid, const int* ids, int n, int col_block,
                          int vec, int grid, const E& ep, int extra,
                          cudaStream_t s) {
  if (n < 0 || col_block <= 0 || col_block % BN != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  return launch(q, refs, m, d, n_valid, vec, grid,
                Blocks<E>{ep, BlockList{ids, n, col_block / BN}}, extra, s);
}

}  // namespace reduce
}  // namespace vsc
