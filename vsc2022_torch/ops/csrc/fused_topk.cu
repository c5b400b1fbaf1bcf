// fused_topk: fused q . refs^T plus each query row's top-kappa of the winner
// pool, without the pool or the scores ever reaching device memory.
//
// Replaces vsc2022_tpu/ops/pallas_kernels.py:fused_topk
// (_topk_collect_kernel), the candidate collection of the searcher's
// streaming mode (similarity.py:streaming_topk). The winner pool is
// pool_writer's: the best 2 of every 128-column segment, the first maximum
// on ties, columns >= n_valid at -inf. Contract, stricter than the TPU
// kernel's: the kappa best winners under the order (value descending, global
// column ascending). The TPU kernel keeps the same candidate set but breaks
// ties at the kappa boundary by the order in which it visits the winners
// (strict '>' min-replacement, pallas_kernels.py:591-605). End to end the
// difference is invisible: the searcher's count-verify makes global_topk
// exact, tie order included.
//
// Bound: operations. 2*M*N*D flops ([9000 x 240,000 x 512] is 2.2 TFLOP,
// ~33 ms at 67 TFLOP/s f32); the bytes (q and refs once, M*kappa*8 out) are
// far below. So the product is the one of row_max and count_above
// (reduce_gemm.cuh: one wave of persistent blocks over evenly split
// (128-row, 128-column) items, cp.async ring of 64-deep slices, 8 x 8
// register tiles), with this kernel's epilogue on each item. An item's 128
// columns are exactly one pool segment, so its winners are pool_writer's bit
// for bit: the same fmaf chain per score, the same (value, column) order.
//
// The epilogue is latency-bound work on which all 8 warps stall together
// (one block per SM, two warps per scheduler), so it is kept short:
//   1. Each thread takes the best 2 of its 8 columns for each of its 8 rows
//      with selects, and a reduce-scatter over the row group's 8 lanes (7
//      exchanges) leaves lane tx with row tx's best 2 of its column half.
//   2. The halves meet in shared memory (one barrier); lanes l and l + 16 of
//      warp w merge row 16w + l's halves, and lane l compares the segment's
//      best winner with the worst entry of the row's kappa-set: after the
//      first segments almost every row stops at that compare.
//   3. A winner that enters replaces the worst entry, and lane l rescans the
//      row's set alone. The 16 rows of a warp insert at once, with no
//      shuffle and no barrier (a warp-wide rescan per row, one row after
//      another, was the slowest part of the first build: PERF.md, section
//      6).
// The sets sit in shared memory past the ring (kappa + 1 words a row, so
// the 16 lanes read 16 banks), which leaves room for a 2-stage ring only:
// 64-deep slices still keep one slice in flight per 4,096 FMAs a thread,
// and the rescans stay on chip. A block copies its sets to the output when
// its range leaves a row tile. Above kappa = 64 the sets do not fit and live
// in the output itself (global memory), with the same code.
//
// Output of one launch: [M, S, kappa] values and ids, unordered, unfilled
// slots at (-inf, INT_MAX). S ("pieces") is the largest number of blocks
// whose ranges touch one row tile; a block writes its piece of row tile rt
// into slot (b - the first block of rt). The wrapper (ops/kernels.py:
// fused_topk) computes S and the grid from the same schedule and orders the
// rows best-first with ordered_topk over [M, S * kappa], the counterpart of
// the JAX wrapper's lax.top_k after its kernel.
//
// The bf16 variant (vsc_fused_topk_bf16) is the streaming collection over a
// bf16 corpus (the JAX searcher's bf16 x bf16 block scores with f32
// accumulation, similarity.py:271; the port's server stages bf16 by
// default). Bound: operations, 2*M*N*D at 989 TFLOP/s ([9000 x 240,000 x
// 512] is 2.2 TFLOP, 2.2 ms). It is the tensor-core product of
// wgmma_gemm.cuh (TMA, mbarrier ring, wgmma m64n256k16, bf16 in, f32
// accumulation; the corpus read from HBM about once per group of query
// tiles), the product count_above.bf16, row_max.bf16 and pool_writer.bf16
// run, so the streaming verify compares candidates and counts of the same
// bits, and its winners are pool_writer.bf16's. (The f32 fmaf chain on
// widened operands, this variant's earlier design, cannot pass 67/989 =
// 6.8% of the bf16 bound.) Its epilogue, TcTopK below, stalls the tensor
// cores while it runs, so it is kept short:
//   1. A 256-column tile holds exactly two pool segments, whose winners
//      for rows row0 and row0 + 8 the quad takes with wgmma_gemm.cuh's
//      segment_top2 (selects over each thread's 32 values per segment and
//      row, two xor shuffles), as pool_writer.bf16 does.
//   2. Lane 0 of the quad offers row0's two segments to the row's kappa-set,
//      lane 1 row0 + 8's. Shared memory holds each row's admission
//      threshold, the set's worst (value, column) and its slot: after the
//      first tiles of a piece almost every segment stops at that compare.
//      A winner that enters replaces the worst entry and the lane rescans
//      the row's set (while the set fills, the slots are taken in order,
//      with no scan).
//   3. The sets of a group of 8 query tiles cannot stay on chip beside the
//      4-stage ring (1,024 rows x 33 words x 8 bytes = 270 KB). Two
//      placements: TcTopK<true> keeps them in shared memory with a 3-stage
//      ring and groups of 2 query tiles (256 rows of sets, kappa <= 38),
//      and reads the corpus once per 2 query tiles; TcTopK<false> keeps the
//      group of 8 and the 4-stage ring and holds the sets in the [M, S,
//      kappa] output, in this block's slot. The first is 1.6x faster at
//      the serving shape (6.2 against 9.8 ms on an H100, PERF.md section
//      6): its pieces are 4x longer, so their thresholds rise further and
//      fewer winners enter, and its rescans stay on chip, which outweighs
//      4x the corpus reads. The searcher takes it wherever kappa fits and
//      the second above (ops/kernels.py fused_topk).
// Slots: S is the most blocks whose ranges touch one group, and a block
// writes its pieces of a group into slot b - (the first block of the
// group) (ops/kernels.py wgmma_pieces). Rows take a multiple of 8 values
// (ops/kernels.py pad_columns).
//
// The int8 variant (vsc_fused_topk_int8) is the streaming collection over
// an int8 (SQ8) corpus (the JAX searcher's block scores on the IP8 branch,
// XLA: the codes widened into an f32 dot at HIGHEST, one scale multiply
// per column, vsc2022_tpu/ops/similarity.py:259-283). It is TcTopK, with
// the same two placements of the sets, on wgmma_gemm.cuh's int8 corpus
// policy (the f32 queries split into three exact bf16 terms, three wgmma
// passes over the codes widened in shared memory, each finished score
// scaled once before the selection); its winners are pool_writer.int8's
// and count_above.int8 counts its scores, bit for bit. Bound: operations,
// 3 x 2*M*N*D at 989 TFLOP/s ([9000 x 240,000 x 512] is 6.7 ms). Codes
// rows take a multiple of 16 values.
//
// L2 (vsc_fused_topk_l2, vsc_fused_topk_bf16_l2; launch keys
// fused_topk.l2 and fused_topk.bf16.l2): the streaming collection of a
// searcher with metric="L2" (JAX: streaming_topk's block scores, XLA,
// vsc2022_tpu/ops/similarity.py:253-280). The same products and
// epilogues behind l2_goodness.cuh's step: each score becomes (2 s -
// rs[j]) - qs[i] before the segment winners are taken, so the candidates
// are what count_above's L2 variant of the product counts, bit for bit.
#include <type_traits>

#include "l2_goodness.cuh"
#include "reduce_gemm.cuh"
#include "wgmma_gemm.cuh"

using vsc::Top2;
using vsc::better;
using vsc::merge;
using vsc::pick;
using vsc::shfl_xor_top2;
using namespace vsc::reduce;

namespace {

constexpr int kRowsPerWarp = BM / (THREADS / 32);  // 16

struct Slot {
  float v;
  int i;
  int s;
};

// The worst slot of one row's kappa-set, scanned by the lane that owns the
// row: the first of the worst entries (the lowest slot on equal entries,
// which only the unfilled sentinels are).
__device__ __forceinline__ Slot worst_slot(const float* sv, const int* si,
                                           int kappa) {
  Slot w = {sv[0], si[0], 0};
  for (int s = 1; s < kappa; ++s) {
    const float v = sv[s];
    const int i = si[s];
    if (better(w.v, w.i, v, i)) w = {v, i, s};
  }
  return w;
}

// The 8 lanes of a row group (tx: lane bits 0, 1 and 4) each hold a top-2
// of rows 0..7; afterwards lane tx holds the merged top-2 of row tx. A
// reduce-scatter: each round hands half of the rows to the partner lane, 7
// row exchanges in all where a butterfly per row takes 24.
__device__ __forceinline__ Top2 reduce_scatter(Top2 (&b)[TM], int tx) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // tx bit 2 is lane bit 4
    const bool hi = tx & 4;
    b[k] = merge(pick(hi, b[k + 4], b[k]),
                 shfl_xor_top2(pick(hi, b[k], b[k + 4]), 16));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = tx & 2;
    b[k] = merge(pick(hi, b[k + 2], b[k]),
                 shfl_xor_top2(pick(hi, b[k], b[k + 2]), 2));
  }
  const bool hi = tx & 1;
  return merge(pick(hi, b[1], b[0]), shfl_xor_top2(pick(hi, b[0], b[1]), 1));
}

// Up to this kappa the sets live in shared memory past the ring: 65 KB at
// kappa = 64 beside the 136 KB 2-stage ring and 5.5 KB of `Smem`. A row's
// set takes kappa + 1 words, so the 16 lanes that scan 16 rows at once
// read 16 banks.
constexpr int kSmemKappaMax = 64;

constexpr int smem_set_bytes(int kappa) {
  return BM * (kappa + 1) * 8;
}

// The top-kappa epilogue of reduce_gemm.cuh's product.
struct TopK {
  static constexpr int kStages = 2;
  float* out_v;
  int* out_i;
  int kappa;
  int pieces;    // S: slots per row
  bool in_smem;  // the sets in shared memory (kappa <= kSmemKappaMax)
  int ring_floats;  // where they start: the ring's size (ring_bytes / 4)

  struct State {};  // nothing in registers across the loop
  struct Smem {
    Top2 half[2][BM];  // per column half, the best 2 of a row's segment
    Slot worst[BM];    // the worst entry of each row's kappa-set
  };

  // The slot of this block's piece of row tile rt: b minus the first block
  // whose range holds an item of rt, the one holding item rt * col_tiles
  // (kernels.topk_first_block).
  __device__ __forceinline__ int slot(const Work& w, int rt) const {
    const unsigned long long first =
        (((unsigned long long)rt * w.col_tiles + 1) * gridDim.x - 1) / w.items;
    return (int)(blockIdx.x - first);
  }

  // Values, then ids, of tile row r's set: in shared memory past the ring,
  // or this block's slot of the output.
  __device__ __forceinline__ float* set_v(const Work& w, int rt, int r) const {
    if (in_smem) {
      extern __shared__ __align__(16) float dyn[];
      return dyn + ring_floats + r * (kappa + 1);
    }
    return out_v + ((size_t)(rt * BM + r) * pieces + slot(w, rt)) * kappa;
  }
  __device__ __forceinline__ int* set_i(const Work& w, int rt, int r) const {
    if (in_smem)
      return reinterpret_cast<int*>(set_v(w, rt, r) + BM * (kappa + 1));
    return out_i + ((size_t)(rt * BM + r) * pieces + slot(w, rt)) * kappa;
  }

  // Warp w owns rows 16w..16w+15 of `worst` and of the sets: no barrier.
  __device__ __forceinline__ void reset(Smem& sm, const Tile& t,
                                        const Work& w) const {
    const int base_row = kRowsPerWarp * t.warp;
    if (t.lane < kRowsPerWarp)
      sm.worst[base_row + t.lane] = {-CUDART_INF_F, INT_MAX, 0};
    if (in_smem) {
      for (int r = base_row; r < base_row + kRowsPerWarp; ++r) {
        float* sv = set_v(w, 0, r);
        int* si = set_i(w, 0, r);
        for (int s = t.lane; s < kappa; s += 32) {
          sv[s] = -CUDART_INF_F;
          si[s] = INT_MAX;
        }
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void begin(State&, Smem& sm, const Tile& t,
                                        const Work& w) const {
    reset(sm, t, w);
  }

  // The block leaves row tile rt: shared-memory sets go to the output.
  __device__ __forceinline__ void flush(State&, Smem& sm, const Tile& t,
                                        const Work& w, int rt) const {
    if (in_smem) {
      __syncwarp();  // each row's lane has written its set
      const int base_row = kRowsPerWarp * t.warp;
      const int piece = slot(w, rt);
      for (int r = base_row; r < base_row + kRowsPerWarp; ++r) {
        if (rt * BM + r >= w.m) break;
        const float* sv = set_v(w, rt, r);
        const int* si = set_i(w, rt, r);
        const size_t at = ((size_t)(rt * BM + r) * pieces + piece) * kappa;
        for (int s = t.lane; s < kappa; s += 32) {
          out_v[at + s] = sv[s];
          out_i[at + s] = si[s];
        }
      }
    }
    reset(sm, t, w);
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(State&, Smem& sm, const Tile& t,
                                       const Work& w, float acc[TM][TN],
                                       int rt, int ct, int valid_cols) const {
    const int col0 = ct * BN + t.col;
    Top2 b[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      b[i] = {-CUDART_INF_F, INT_MAX, -CUDART_INF_F, INT_MAX};
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // Columns come in ascending order, so a strict '>' keeps the lower
        // column on equal values (the pool order); -inf never enters.
        // Selects, not branches: the 8 rows' chains interleave.
        const float v =
            !kMasked || 8 * j < valid_cols ? acc[i][j] : -CUDART_INF_F;
        const bool first = v > b[i].v1, second = v > b[i].v2;
        b[i].v2 = first ? b[i].v1 : second ? v : b[i].v2;
        b[i].i2 = first ? b[i].i1 : second ? col0 + 8 * j : b[i].i2;
        b[i].v1 = first ? v : b[i].v1;
        b[i].i1 = first ? col0 + 8 * j : b[i].i1;
      }
    }
    sm.half[t.wc][t.row + 4 * t.tx] = reduce_scatter(b, t.tx);
    // `half` is written again only after the next item's slice barriers.
    __syncthreads();
    collect(sm, t, w, rt);
  }

  // Warp w folds the segment winners of rows 16w..16w+15 into their sets:
  // lanes l and l + 16 merge row 16w + l's halves, and lane l inserts them.
  // Lane l alone reads and writes that row's set and worst entry.
  __device__ __forceinline__ void collect(Smem& sm, const Tile& t,
                                          const Work& w, int rt) const {
    const int r = kRowsPerWarp * t.warp + (t.lane & (kRowsPerWarp - 1));
    Top2 top = sm.half[t.lane >> 4][r];
    top = merge(top, shfl_xor_top2(top, 16));
    if (t.lane >= kRowsPerWarp || rt * BM + r >= w.m) return;
    Slot worst = sm.worst[r];
    if (!(top.v1 > -CUDART_INF_F) || !better(top.v1, top.i1, worst.v, worst.i))
      return;
    float* sv = set_v(w, rt, r);
    int* si = set_i(w, rt, r);
    // The winners come best first: once one is no better than the set's
    // worst entry, neither is the next.
    for (int c = 0; c < 2; ++c) {
      const float v = c == 0 ? top.v1 : top.v2;
      const int i = c == 0 ? top.i1 : top.i2;
      if (!(v > -CUDART_INF_F) || !better(v, i, worst.v, worst.i)) break;
      sv[worst.s] = v;
      si[worst.s] = i;
      worst = worst_slot(sv, si, kappa);
    }
    sm.worst[r] = worst;
  }
};

__global__ void fill_sets(float* out_v, int* out_i, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out_v[i] = -CUDART_INF_F;
    out_i[i] = INT_MAX;
  }
}

// Every slot of the [m, pieces, kappa] output unfilled, on stream s.
cudaError_t fill_output(float* out_v, int* out_i, int m, int pieces, int kappa,
                        cudaStream_t s) {
  const size_t total = (size_t)m * pieces * kappa;
  const size_t fill_blocks = (total + 255) / 256;
  fill_sets<<<(unsigned)(fill_blocks < 4096 ? fill_blocks : 4096), 256, 0, s>>>(
      out_v, out_i, total);
  return cudaGetLastError();
}

// ---- the bf16 variant: the top-kappa epilogue of wgmma_gemm.cuh ------------

// Up to this kappa the sets fit in shared memory: 2 query tiles x 128 rows
// x (kappa + 1) x 8 bytes beside the 3-stage ring.
constexpr int kTcSmemKappaMax = 38;

template <bool kSmemSets>
struct TcTopK {
  static constexpr int kStages = kSmemSets ? 3 : vsc::wg::kStages;
  static constexpr int kGroup = kSmemSets ? 2 : vsc::wg::kGroup;
  float* out_v;
  int* out_i;
  int m, kappa, pieces;
  int items, per_group;  // the launch's work items, and one group's

  struct Smem {
    Slot worst[kGroup][vsc::wg::BM];  // each row's threshold: its set's worst
  };

  // Shared memory of the sets past Smem at this kappa.
  static constexpr int set_bytes(int k) {
    return kSmemSets ? kGroup * vsc::wg::BM * (k + 1) * 8 : 0;
  }

  // This block's slot among the blocks that touch the item's group: b minus
  // the block holding the group's first item (kernels.topk_first_block).
  __device__ __forceinline__ int piece(const vsc::wg::Item& it) const {
    const long long first =
        (((long long)it.group * per_group + 1) * gridDim.x - 1) / items;
    return (int)(blockIdx.x - first);
  }

  // Row r of query tile t's set in shared memory (kSmemSets): values
  // [kGroup][BM][kappa + 1] past Smem, then the ids; kappa + 1 words a row,
  // so the owner lanes of a warp read distinct banks.
  __device__ __forceinline__ float* smem_v(Smem& s, int t, int r) const {
    return reinterpret_cast<float*>(&s + 1) + (t * vsc::wg::BM + r) * (kappa + 1);
  }
  __device__ __forceinline__ int* smem_i(Smem& s, int t, int r) const {
    return reinterpret_cast<int*>(smem_v(s, kGroup, 0)) +
           (t * vsc::wg::BM + r) * (kappa + 1);
  }

  __device__ __forceinline__ size_t out_at(int row, int slot) const {
    return ((size_t)row * pieces + slot) * kappa;
  }

  // The sets are empty: every row admits any finite winner, into slot 0.
  __device__ __forceinline__ void begin(Smem& s, const vsc::wg::Lane& l) const {
    if (l.quad >= 2) return;
    for (int t = 0; t < kGroup; ++t)
      s.worst[t][l.row0 + 8 * l.quad] = {-CUDART_INF_F, INT_MAX, 0};
  }

  // Offers one segment's winners (best first) to a row's set; w is the
  // set's worst entry, or (-inf, INT_MAX, next free slot) while it fills.
  __device__ __forceinline__ void offer(Slot& w, const Top2& t, float* sv,
                                        int* si) const {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float v = c == 0 ? t.v1 : t.v2;
      const int i = c == 0 ? t.i1 : t.i2;
      if (!(v > -CUDART_INF_F) || !better(v, i, w.v, w.i)) return;
      sv[w.s] = v;
      si[w.s] = i;
      if (w.v == -CUDART_INF_F && w.s + 1 < kappa)
        ++w.s;
      else
        w = worst_slot(sv, si, kappa);
    }
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem& s, const vsc::wg::Lane& l,
                                       const float (&acc)[vsc::wg::kAcc],
                                       const vsc::wg::Item& it,
                                       int valid_cols) const {
    Top2 b[2][2];  // [row row0 + 8h][segment]
    vsc::wg::segment_top2<kMasked>(acc, l, it.c_tile, valid_cols, b);
    if (l.quad >= 2) return;
    const bool hi = l.quad == 1;
    const int r = l.row0 + 8 * l.quad;
    const int row = it.q_tile * vsc::wg::BM + r;
    if (row >= m) return;
    Slot w = s.worst[it.slot][r];
    const Top2 t0 = pick(hi, b[1][0], b[0][0]), t1 = pick(hi, b[1][1], b[0][1]);
    if (!(t0.v1 > -CUDART_INF_F && better(t0.v1, t0.i1, w.v, w.i)) &&
        !(t1.v1 > -CUDART_INF_F && better(t1.v1, t1.i1, w.v, w.i)))
      return;
    float* sv;
    int* si;
    if (kSmemSets) {
      sv = smem_v(s, it.slot, r);
      si = smem_i(s, it.slot, r);
    } else {
      const size_t at = out_at(row, piece(it));
      sv = out_v + at;
      si = out_i + at;
    }
    offer(w, t0, sv, si);
    offer(w, t1, sv, si);
    s.worst[it.slot][r] = w;
  }

  // The block leaves the item's group: shared-memory sets go to the output
  // (their filled slots; the rest is unfilled there already), and every
  // row's set starts empty again.
  __device__ __forceinline__ void flush(Smem& s, const vsc::wg::Lane& l,
                                        const vsc::wg::Item& it) const {
    if (l.quad >= 2) return;
    const int r = l.row0 + 8 * l.quad;
    const int slot = kSmemSets ? piece(it) : 0;
    for (int t = 0; t < it.tiles; ++t) {
      Slot& w = s.worst[t][r];
      const int row = (it.group * kGroup + t) * vsc::wg::BM + r;
      if (kSmemSets && row < m) {
        const int n = w.v == -CUDART_INF_F ? w.s : kappa;
        const float* sv = smem_v(s, t, r);
        const int* si = smem_i(s, t, r);
        const size_t at = out_at(row, slot);
        for (int k = 0; k < n; ++k) {
          out_v[at + k] = sv[k];
          out_i[at + k] = si[k];
        }
      }
      w = {-CUDART_INF_F, INT_MAX, 0};
    }
  }
};

// The epilogue of a launch with that placement over the items of plan p;
// `launch` runs it over its corpus (ep, shared-memory bytes of the sets).
template <bool kSmemSets, class Launch>
int run_tc_topk(const vsc::wg::Plan& p, int m, int kappa, int pieces, float* out_v,
                int* out_i, Launch launch) {
  using E = TcTopK<kSmemSets>;
  return (int)launch(E{out_v, out_i, m, kappa, pieces, p.items, p.c_tiles * E::kGroup},
                     E::set_bytes(kappa));
}

// Output filled, then the placement smem_sets selects over the items of
// plan p (the call's, or its block list's: vsc::wg::plan), over the corpus
// `launch` (a generic lambda: (epilogue, extra shared bytes)) takes.
template <class Launch>
int tc_topk(int device, int m, int n, int n_valid, const vsc::wg::Plan& p, int kappa,
            int smem_sets, int pieces, float* out_v, int* out_i, cudaStream_t s,
            Launch launch) {
  if (m <= 0) return 0;
  if (kappa <= 0 || pieces <= 0 || n_valid < 0 || n_valid > n ||
      (smem_sets && kappa > kTcSmemKappaMax))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = fill_output(out_v, out_i, m, pieces, kappa, s);
  if (err != cudaSuccess) return (int)err;
  return smem_sets ? run_tc_topk<true>(p, m, kappa, pieces, out_v, out_i, launch)
                   : run_tc_topk<false>(p, m, kappa, pieces, out_v, out_i, launch);
}

// The epilogue as it is (tc_topk_occupancy's default wrapper).
template <class E>
using AsIs = E;

// Blocks an SM holds at once of the placement smem_sets selects over
// corpus C (W<E>: the epilogue E as its kernel takes it).
template <class C, template <class> class W = AsIs>
int tc_topk_occupancy(int device, int smem_sets, int kappa, int* blocks_per_sm) {
  if (smem_sets && (kappa <= 0 || kappa > kTcSmemKappaMax))
    return (int)cudaErrorInvalidValue;
  return smem_sets ? vsc::wg::resident_blocks<W<TcTopK<true>>, C>(
                         device, blocks_per_sm, TcTopK<true>::set_bytes(kappa))
                   : vsc::wg::resident_blocks<W<TcTopK<false>>, C>(device, blocks_per_sm);
}

}  // namespace

// Blocks of the fused_topk kernel one SM holds at once (16-byte copies if
// vec).
extern "C" int vsc_fused_topk_occupancy(int device, int vec,
                                        int* blocks_per_sm) {
  return vsc::reduce::resident_blocks<TopK>(
      device, vec, smem_set_bytes(kSmemKappaMax), blocks_per_sm);
}

// q [m, d], refs [n, d] f32 row-major on the device; out_v / out_i are
// [m, pieces, kappa]. `grid` persistent blocks (one wave: SMs x
// vsc_fused_topk_occupancy, at most the work items) and `vec` as for
// vsc_row_max; `pieces` is S for that grid (ops/kernels.py:topk_pieces),
// 1 when there is no work item. Returns cudaGetLastError() after the
// launches.
extern "C" int vsc_fused_topk(int device, const float* q, const float* refs,
                              int m, int n, int d, int n_valid, int kappa,
                              int vec, int grid, int pieces, float* out_v,
                              int* out_i, void* stream) {
  if (m <= 0) return 0;
  if (kappa <= 0 || pieces <= 0 || n_valid < 0 || n_valid > n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fill_output(out_v, out_i, m, pieces, kappa, s);
  if (err != cudaSuccess) return (int)err;
  const bool in_smem = kappa <= kSmemKappaMax;
  const int ring = ring_bytes<TopK>();
  return (int)vsc::reduce::launch(
      q, refs, m, d, n_valid, vec, grid,
      TopK{out_v, out_i, kappa, pieces, in_smem, ring / 4},
      in_smem ? smem_set_bytes(kappa) : 0, s);
}

// Blocks of the bf16 kernel (tensor cores) one SM holds at once: its grid
// is SMs x this, at most the work items of ops/kernels.py wgmma_tiles.
// smem_sets selects the placement with the sets in shared memory (kappa <=
// 38); 0, the one with the sets in the output.
extern "C" int vsc_fused_topk_bf16_occupancy(int device, int smem_sets,
                                             int kappa, int* blocks_per_sm) {
  return tc_topk_occupancy<vsc::wg::Bf16Corpus>(device, smem_sets, kappa, blocks_per_sm);
}

// Bytes of dynamic shared memory one block of the bf16 kernel takes in the
// placement smem_sets selects, at this kappa (-1: that placement does not
// take it).
extern "C" int vsc_fused_topk_bf16_smem_bytes(int smem_sets, int kappa) {
  if (kappa <= 0 || (smem_sets && kappa > kTcSmemKappaMax)) return -1;
  return smem_sets
             ? vsc::wg::smem_bytes<TcTopK<true>>(TcTopK<true>::set_bytes(kappa))
             : vsc::wg::smem_bytes<TcTopK<false>>(TcTopK<false>::set_bytes(kappa));
}

// The bf16 variant: q [m, d] and refs [n, d] bf16 row-major, d % 8 == 0
// (zero pad columns past the data's width) and both bases 16-byte aligned;
// out_v / out_i are [m, pieces, kappa]; `grid` persistent blocks and
// `pieces` = S for that grid and placement (ops/kernels.py wgmma_pieces).
extern "C" int vsc_fused_topk_bf16(int device, const __nv_bfloat16* q,
                                   const __nv_bfloat16* refs, int m, int n,
                                   int d, int n_valid, int kappa, int smem_sets,
                                   int grid, int pieces, float* out_v,
                                   int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc_topk(device, m, n, n_valid, vsc::wg::plan(m, n_valid, d), kappa, smem_sets,
                 pieces, out_v, out_i, s, [&](const auto& ep, int extra) {
                   return vsc::wg::launch(q, refs, m, d, n_valid, grid, ep, s, extra);
                 });
}

// Blocks of the int8 kernel (tensor cores) one SM holds at once, as for
// vsc_fused_topk_bf16_occupancy.
extern "C" int vsc_fused_topk_int8_occupancy(int device, int smem_sets,
                                             int kappa, int* blocks_per_sm) {
  return tc_topk_occupancy<vsc::wg::I8Corpus>(device, smem_sets, kappa, blocks_per_sm);
}

// The int8 variant (SQ8 corpus): terms [3, m, d] bf16 (the f32 queries
// split, ops/kernels.py split_bf16x3), codes [n, d] int8 row-major, d a
// multiple of 16 (zero pad columns past the data's width), both bases
// 16-byte aligned, scale [n] f32; the rest as for vsc_fused_topk_bf16 (the
// same plan: ops/kernels.py wgmma_pieces).
extern "C" int vsc_fused_topk_int8(int device, const __nv_bfloat16* terms,
                                   const int8_t* codes, const float* scale,
                                   int m, int n, int d, int n_valid, int kappa,
                                   int smem_sets, int grid, int pieces,
                                   float* out_v, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc_topk(device, m, n, n_valid, vsc::wg::plan(m, n_valid, d), kappa, smem_sets,
                 pieces, out_v, out_i, s, [&](const auto& ep, int extra) {
                   return vsc::wg::launch_int8(terms, codes, scale, m, d, n_valid,
                                               grid, ep, s, extra);
                 });
}

// Blocks of the f32 L2 kernel one SM holds at once (16-byte copies if vec).
extern "C" int vsc_fused_topk_l2_occupancy(int device, int vec,
                                           int* blocks_per_sm) {
  return vsc::reduce::resident_blocks<vsc::reduce::L2<TopK>>(
      device, vec, smem_set_bytes(kSmemKappaMax), blocks_per_sm);
}

// The f32 L2 variant: vsc_fused_topk's arguments with qs [m] and rs [n] f32
// (the squared norms) after refs; the top-kappa of the goodness scores.
extern "C" int vsc_fused_topk_l2(int device, const float* q, const float* refs,
                                 const float* qs, const float* rs, int m, int n,
                                 int d, int n_valid, int kappa, int vec, int grid,
                                 int pieces, float* out_v, int* out_i,
                                 void* stream) {
  if (m <= 0) return 0;
  if (kappa <= 0 || pieces <= 0 || n_valid < 0 || n_valid > n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fill_output(out_v, out_i, m, pieces, kappa, s);
  if (err != cudaSuccess) return (int)err;
  const bool in_smem = kappa <= kSmemKappaMax;
  const int ring = ring_bytes<TopK>();
  return (int)vsc::reduce::launch(
      q, refs, m, d, n_valid, vec, grid,
      vsc::reduce::L2<TopK>{TopK{out_v, out_i, kappa, pieces, in_smem, ring / 4}, qs,
                            rs},
      in_smem ? smem_set_bytes(kappa) : 0, s);
}

// Blocks of the bf16 L2 kernel (tensor cores) one SM holds at once.
extern "C" int vsc_fused_topk_bf16_l2_occupancy(int device, int smem_sets,
                                                int kappa, int* blocks_per_sm) {
  using vsc::wg::L2;
  if (smem_sets && (kappa <= 0 || kappa > kTcSmemKappaMax))
    return (int)cudaErrorInvalidValue;
  return smem_sets ? vsc::wg::resident_blocks<L2<TcTopK<true>>>(
                         device, blocks_per_sm, TcTopK<true>::set_bytes(kappa))
                   : vsc::wg::resident_blocks<L2<TcTopK<false>>>(device, blocks_per_sm);
}

// The bf16 L2 variant: vsc_fused_topk_bf16's arguments with qs [m] and rs
// [n] f32 after refs.
extern "C" int vsc_fused_topk_bf16_l2(int device, const __nv_bfloat16* q,
                                      const __nv_bfloat16* refs, const float* qs,
                                      const float* rs, int m, int n, int d,
                                      int n_valid, int kappa, int smem_sets,
                                      int grid, int pieces, float* out_v,
                                      int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc_topk(device, m, n, n_valid, vsc::wg::plan(m, n_valid, d), kappa, smem_sets,
                 pieces, out_v, out_i, s, [&](const auto& ep, int extra) {
                   using E = std::decay_t<decltype(ep)>;
                   return vsc::wg::launch(q, refs, m, d, n_valid, grid,
                                          vsc::wg::L2<E>{ep, qs, rs, m}, s, extra);
                 });
}

// ---- the block-subset variants (block_list.cuh: the IVF tier's candidates) -
//
// fused_topk over the corpus blocks `blocks` (n_blocks ascending, distinct
// block ids, col_block rows each, on the device): each row's top-kappa of
// the listed blocks' segment winners (columns < n_valid), ids in the whole
// corpus's numbering, on the product and epilogue of the full-corpus kernel
// of the dtype: its result on a corpus of the listed blocks' rows, bit for
// bit. The JAX tier collects its probed blocks with XLA (vsc2022_tpu/ops/
// similarity.py:191-230, streaming_topk with block_ids). Bound: operations,
// 2*M*(n_blocks * col_block)*D at the dtype's peak (x3 for int8). The
// output, S and the grid count the list's tiles (ops/kernels.py fused_topk
// with blocks); an empty list leaves every slot unfilled.

extern "C" int vsc_fused_topk_blocks_occupancy(int device, int vec, int* blocks_per_sm) {
  return vsc::reduce::resident_blocks<vsc::reduce::Blocks<TopK>>(
      device, vec, smem_set_bytes(kSmemKappaMax), blocks_per_sm);
}

// vsc_fused_topk's arguments with the block list after n_valid; col_block a
// multiple of 128.
extern "C" int vsc_fused_topk_blocks(int device, const float* q, const float* refs,
                                     int m, int n, int d, int n_valid, const int* blocks,
                                     int n_blocks, int col_block, int kappa, int vec,
                                     int grid, int pieces, float* out_v, int* out_i,
                                     void* stream) {
  if (m <= 0) return 0;
  if (kappa <= 0 || pieces <= 0 || n_valid < 0 || n_valid > n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fill_output(out_v, out_i, m, pieces, kappa, s);
  if (err != cudaSuccess) return (int)err;
  const bool in_smem = kappa <= kSmemKappaMax;
  const int ring = ring_bytes<TopK>();
  return (int)vsc::reduce::launch_blocks(
      q, refs, m, d, n_valid, blocks, n_blocks, col_block, vec, grid,
      TopK{out_v, out_i, kappa, pieces, in_smem, ring / 4},
      in_smem ? smem_set_bytes(kappa) : 0, s);
}

extern "C" int vsc_fused_topk_bf16_blocks_occupancy(int device, int smem_sets,
                                                    int kappa, int* blocks_per_sm) {
  return tc_topk_occupancy<vsc::wg::Bf16Corpus, vsc::wg::Blocks>(device, smem_sets,
                                                                 kappa, blocks_per_sm);
}

// vsc_fused_topk_bf16's arguments with the block list after n_valid;
// col_block a multiple of 256.
extern "C" int vsc_fused_topk_bf16_blocks(int device, const __nv_bfloat16* q,
                                          const __nv_bfloat16* refs, int m, int n,
                                          int d, int n_valid, const int* blocks,
                                          int n_blocks, int col_block, int kappa,
                                          int smem_sets, int grid, int pieces,
                                          float* out_v, int* out_i, void* stream) {
  vsc::BlockList list;
  if (!vsc::wg::block_list(&list, blocks, n_blocks, col_block))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc_topk(device, m, n, n_valid, vsc::wg::plan(m, n_valid, d, list), kappa,
                 smem_sets, pieces, out_v, out_i, s, [&](const auto& ep, int extra) {
                   return vsc::wg::launch_blocks(q, refs, m, d, n_valid, list, grid, ep,
                                                 s, extra);
                 });
}

extern "C" int vsc_fused_topk_int8_blocks_occupancy(int device, int smem_sets,
                                                    int kappa, int* blocks_per_sm) {
  return tc_topk_occupancy<vsc::wg::I8Corpus, vsc::wg::Blocks>(device, smem_sets,
                                                               kappa, blocks_per_sm);
}

// vsc_fused_topk_int8's arguments with the block list after n_valid;
// col_block a multiple of 256.
extern "C" int vsc_fused_topk_int8_blocks(int device, const __nv_bfloat16* terms,
                                          const int8_t* codes, const float* scale,
                                          int m, int n, int d, int n_valid,
                                          const int* blocks, int n_blocks,
                                          int col_block, int kappa, int smem_sets,
                                          int grid, int pieces, float* out_v,
                                          int* out_i, void* stream) {
  vsc::BlockList list;
  if (!vsc::wg::block_list(&list, blocks, n_blocks, col_block))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc_topk(device, m, n, n_valid, vsc::wg::plan(m, n_valid, d, list), kappa,
                 smem_sets, pieces, out_v, out_i, s, [&](const auto& ep, int extra) {
                   return vsc::wg::launch_blocks_int8(terms, codes, scale, m, d, n_valid,
                                                      list, grid, ep, s, extra);
                 });
}
