// scores: q . refs^T over the first n_valid columns, written out [M,
// n_valid] f32; scores_above: only the entries at or above each row's
// floor. Both on the tensor-core product of wgmma_gemm.cuh, over a bf16
// corpus (.bf16) or an int8 one (.int8).
//
// Not a port of a Pallas kernel. The searchers re-search a few query rows
// over the whole corpus (ops/similarity.py _corpus_above: rows whose
// candidates or pool may miss an entry >= tau). The JAX searcher scores
// them with the block product its streaming collection runs
// (vsc2022_tpu/ops/similarity.py:259 block_scores, through
// _repair_rows_topk_packed), so a re-searched pair scores as its
// candidates do. Over a bf16 corpus the port's kernels score on the tensor
// cores, whose sums differ from any f32 chain in the last bits: a
// re-search by torch.matmul would give a row's pairs other scores than the
// kernels gave its neighbours, and the pooled and streaming collections,
// which re-search different rows, would rank near-equal pairs apart. This
// kernel is that product with an epilogue that writes each score, so a
// re-searched pair scores as row_max.bf16, count_above.bf16,
// pool_writer.bf16 and fused_topk.bf16 score it, bit for bit (a tensor-core
// score does not depend on its row's place in the tile).
//
// Bound: bytes at the re-search's shapes. A call of ~134 rows over the
// SSCD corpus ([134 x 1,000,020 x 512]) reads 1.0 GB of corpus and writes
// 0.54 GB of scores (0.46 ms at 3.35 TB/s) for 0.14 ms of operations at
// 989 TFLOP/s. Design: wgmma_gemm.cuh (TMA, 4-stage mbarrier ring, wgmma
// m64n256k16, groups of 8 query tiles). Each consumer thread stores its
// accumulators right from registers: for each of its two rows and 32
// column pairs one 8-byte store where the row's offset allows it (else two
// 4-byte ones), so a warp writes 8 rows x 32 contiguous bytes per store;
// rows >= M and columns >= n_valid are not written. Rows take a multiple
// of 8 values (ops/kernels.py pad_columns). The searchers no longer call it:
// it stays as the dense reference of scores_above.bf16.
//
// scores_above.bf16 (vsc_scores_above_bf16): the re-search over a bf16
// corpus. The searcher keeps only the entries at or above a floor per
// row (tau less its margin), and the final cut sorts them by (score, q, r),
// so it needs neither the dense [M, n_valid] matrix nor any order. This
// epilogue on the same product emits each entry (i, j < n_valid) with
// s = q_i . r_j >= floor[i] once, as (s, i, j), in no order: s is the
// accumulator scores.bf16 stores at (i, j), bit for bit, and the test is
// the f32 >= that torch does on those values, so the set is nonzero(
// scores.bf16 >= floor[:, None]). Bound: operations at the re-search's
// shapes (~3,700 rows x 240,000 x 512 at serving is 0.91 TFLOP, 0.92 ms
// at 989 TFLOP/s; the corpus comes from HBM about once per group of 8
// query tiles, ~0.25 GB), where the dense epilogue wrote 4 bytes a score
// for the caller to throw away. Design: per finished 128 x 256 tile each
// consumer thread loads its two rows' floors and counts its 128
// accumulators that pass; a shuffle scan gives each lane of the warp its
// offset and the warp's total (nothing more when nothing passes, the
// common case). Each warp stages its entries in a batch of 256 in shared
// memory and reserves output slots for a whole batch with one 64-bit
// atomicAdd on the launch's counter, then copies it out in order, when
// the next item's entries would not fit and when the block leaves a
// group or ends (an item with more than a batch, as tau = -inf gives,
// goes straight out under one atomicAdd of its own). One atomicAdd per
// warp and item, the first design, cost up to 1.7x the product alone on
// the serving re-search's rows, where most warp-items hold an entry;
// batching the reservations and stores took most of that back
// (tools/bench_scores_above.py). Writes
// past the capacity are dropped but counted, so after the launch the
// counter holds the exact total and the wrapper (ops/kernels.py
// scores_above) launches again with that capacity when it ran out. The
// batches take 24 KB of shared memory beside the 4-stage ring (one block
// per SM, as every bf16 kernel); the plan is scores.bf16's (groups of 8
// query tiles: one corpus pass per 1,024 query rows).
//
// int8 (vsc_scores_int8 and vsc_scores_above_int8, launch keys scores.int8
// and scores_above.int8): the re-search over an int8 (SQ8) corpus, JAX's
// block product on the IP8 branch (_corpus_rows_topk_packed,
// vsc2022_tpu/ops/similarity.py:1806). The int8 kernels score on
// wgmma_gemm.cuh's int8 corpus policy (three exact bf16 passes of the
// split f32 queries over the codes widened in shared memory, the scale
// once per finished score); torch.matmul would sum in another order, so
// a re-searched pair would score a few ulps from its neighbours' kernel
// scores and the two collections, which re-search different rows, could
// rank near-equal pairs apart. These are the two epilogues above on that
// policy: a re-searched pair scores as row_max.int8, count_above.int8,
// pool_writer.int8 and fused_topk.int8 score it, bit for bit. The
// searchers re-search with scores_above.int8, one launch over every
// re-searched row, as over bf16; scores.int8 stays as its dense
// reference. Bound: operations, 3 x 2*M*N*D at 989 TFLOP/s (~3,700 rows x
// 240,000 x 512 at serving is 2.8 ms); the codes are 1 byte a value.
//
// L2 (vsc_scores_above_bf16_l2, launch key scores_above.bf16.l2): the
// re-search of a searcher with metric="L2" over a bf16 corpus (JAX: the
// block product's goodness, XLA, vsc2022_tpu/ops/similarity.py:253-280).
// The above-floor epilogue behind l2_goodness.cuh's step: each emitted
// entry is the goodness (2 s - rs[j]) - qs[i] that the L2 pool,
// candidates and counts of the product score, bit for bit, and the set
// is nonzero(((2 scores.bf16 - rs) - qs) >= floor), which torch's
// elementwise f32 operations give from the dense scores.
#include "l2_goodness.cuh"
#include "wgmma_gemm.cuh"

using namespace vsc;

namespace {

// The score epilogue (either corpus): no state across items.
struct TcScores {
  static constexpr int kStages = wg::kStages, kGroup = wg::kGroup;
  float* out;
  int m, n_valid;
  struct Smem {};

  __device__ __forceinline__ void begin(Smem&, const wg::Lane&) const {}

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem&, const wg::Lane& l,
                                       const float (&acc)[wg::kAcc],
                                       const wg::Item& it, int valid_cols) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = it.q_tile * wg::BM + l.row0 + 8 * h;
      if (row >= m) continue;
      const size_t base = (size_t)row * n_valid + (size_t)it.c_tile * wg::BN;
      float* dst = out + base;
      const bool pairs = (base & 1) == 0;  // columns col0 + 8j are even
#pragma unroll
      for (int j = 0; j < wg::kAcc / 4; ++j) {
        const int col = 8 * j + l.col0;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (!kMasked || col + 1 < valid_cols) {
          if (pairs) {
            *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
          } else {
            dst[col] = v0;
            dst[col + 1] = v1;
          }
        } else if (col < valid_cols) {
          dst[col] = v0;
        }
      }
    }
  }

  __device__ __forceinline__ void flush(Smem&, const wg::Lane&,
                                        const wg::Item&) const {}
};

// The above-floor epilogue (either corpus). acc[k] is row row0 + 8 * ((k >> 1) & 1),
// column 8 * (k / 4) + col0 + (k & 1) of the tile. Each consumer warp
// stages its entries in a batch of its own in shared memory and reserves
// output slots for a whole batch with one atomicAdd (drain), when the next
// item's entries would not fit and when the block leaves a group or ends;
// an item whose entries alone exceed a batch (tau = -inf) goes straight
// out under one atomicAdd of its own.
struct TcScoresAbove {
  static constexpr int kStages = wg::kStages, kGroup = wg::kGroup;
  static constexpr int kWarps = 4 * wg::kConsumers;  // consumer warps
  static constexpr int kBatch = 256;                  // entries a warp stages
  const float* floors;
  int m;
  long long cap;
  float* out_s;
  int* out_r;
  int* out_c;
  unsigned long long* count;
  struct Smem {
    float s[kWarps][kBatch];
    int r[kWarps][kBatch];
    int c[kWarps][kBatch];
    int fill[kWarps];
  };

  __device__ __forceinline__ void begin(Smem& sm, const wg::Lane&) const {
    if ((threadIdx.x & 31) == 0) sm.fill[threadIdx.x >> 5] = 0;
    __syncwarp();
  }

  template <bool kMasked>
  static __device__ __forceinline__ bool passes(const float (&acc)[wg::kAcc],
                                                const float (&fl)[2],
                                                const wg::Lane& l, int k,
                                                int valid_cols) {
    return (!kMasked || 8 * (k / 4) + l.col0 + (k & 1) < valid_cols) &&
           acc[k] >= fl[(k >> 1) & 1];
  }

  // n slots for the warp's entries: lane 0 reserves them, every lane gets
  // the first.
  __device__ __forceinline__ long long reserve(int n) const {
    unsigned long long base = 0;
    if ((threadIdx.x & 31) == 0) base = atomicAdd(count, (unsigned long long)n);
    return (long long)__shfl_sync(0xffffffffu, base, 0);
  }

  // The warp's staged entries out, in order (whole sectors), and its batch
  // emptied. Every lane of the warp calls it.
  __device__ __forceinline__ void drain(Smem& sm) const {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, n = sm.fill[w];
    if (n == 0) return;
    const long long base = reserve(n);
    for (int i = lane; i < n && base + i < cap; i += 32) {
      out_s[base + i] = sm.s[w][i];
      out_r[base + i] = sm.r[w][i];
      out_c[base + i] = sm.c[w][i];
    }
    __syncwarp();
    if (lane == 0) sm.fill[w] = 0;
    __syncwarp();
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem& sm, const wg::Lane& l,
                                       const float (&acc)[wg::kAcc],
                                       const wg::Item& it, int valid_cols) const {
    int row[2];
    float fl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = it.q_tile * wg::BM + l.row0 + 8 * h;
      fl[h] = row[h] < m ? floors[row[h]] : CUDART_NAN_F;  // NaN: nothing passes
    }
    int mine = 0;
#pragma unroll
    for (int k = 0; k < wg::kAcc; ++k) mine += passes<kMasked>(acc, fl, l, k, valid_cols);
    // The warp's inclusive scan of its lanes' counts; lane 31 holds the total.
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (total == 0) return;
    const int cbase = it.c_tile * wg::BN;
    if (total > kBatch) {  // straight out
      long long pos = reserve(total) + (incl - mine);
#pragma unroll
      for (int k = 0; k < wg::kAcc; ++k) {
        if (passes<kMasked>(acc, fl, l, k, valid_cols)) {
          if (pos < cap) {
            out_s[pos] = acc[k];
            out_r[pos] = row[(k >> 1) & 1];
            out_c[pos] = cbase + 8 * (k / 4) + l.col0 + (k & 1);
          }
          ++pos;
        }
      }
      return;
    }
    if (sm.fill[w] + total > kBatch) drain(sm);
    const int fill = sm.fill[w];
    int pos = fill + incl - mine;
#pragma unroll
    for (int k = 0; k < wg::kAcc; ++k) {
      if (passes<kMasked>(acc, fl, l, k, valid_cols)) {
        sm.s[w][pos] = acc[k];
        sm.r[w][pos] = row[(k >> 1) & 1];
        sm.c[w][pos] = cbase + 8 * (k / 4) + l.col0 + (k & 1);
        ++pos;
      }
    }
    __syncwarp();
    if (lane == 0) sm.fill[w] = fill + total;
    __syncwarp();
  }

  __device__ __forceinline__ void flush(Smem& sm, const wg::Lane&,
                                        const wg::Item&) const {
    drain(sm);
  }
};

}  // namespace

// Blocks of the kernel one SM holds at once: its grid is SMs x this, at
// most the work items of ops/kernels.py wgmma_tiles.
extern "C" int vsc_scores_bf16_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcScores>(device, blocks_per_sm);
}

// q [m, d] and refs [n, d] bf16 row-major, d % 8 == 0 (zero pad columns
// past the data's width) and both bases 16-byte aligned; out is
// [m, n_valid] f32; `grid` persistent blocks.
extern "C" int vsc_scores_bf16(int device, const __nv_bfloat16* q,
                               const __nv_bfloat16* refs, int m, int n, int d,
                               int n_valid, int grid, float* out, void* stream) {
  if (m <= 0 || n_valid <= 0) return 0;
  if (n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch(q, refs, m, d, n_valid, grid,
                         TcScores{out, m, n_valid},
                         static_cast<cudaStream_t>(stream));
}

// Blocks of the above-floor kernel one SM holds at once (its grid: SMs x
// this, at most the work items of ops/kernels.py wgmma_tiles).
extern "C" int vsc_scores_above_bf16_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcScoresAbove>(device, blocks_per_sm);
}

// q [m, d] and refs [n, d] bf16 as for vsc_scores_bf16, floors [m] f32;
// out_s [cap] f32, out_r and out_c [cap] int32; count: one unsigned 64-bit
// counter, zeroed here. After the launch count holds the number of entries
// (i, j < n_valid) with q_i . refs_j >= floors[i]; the first min(count, cap)
// of them, in no order, are (out_s, out_r, out_c)[0, min(count, cap)).
extern "C" int vsc_scores_above_bf16(int device, const __nv_bfloat16* q,
                                     const __nv_bfloat16* refs, const float* floors,
                                     int m, int n, int d, int n_valid, int grid,
                                     long long cap, float* out_s, int* out_r,
                                     int* out_c, unsigned long long* count,
                                     void* stream) {
  if (m < 0 || n_valid < 0 || n_valid > n || cap < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch(q, refs, m, d, n_valid, grid,
                         TcScoresAbove{floors, m, cap, out_s, out_r, out_c, count}, s);
}

// Blocks of the int8 kernels (tensor cores) one SM holds at once.
extern "C" int vsc_scores_int8_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcScores, wg::I8Corpus>(device, blocks_per_sm);
}

extern "C" int vsc_scores_above_int8_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcScoresAbove, wg::I8Corpus>(device, blocks_per_sm);
}

// The int8 variants (SQ8 corpus): terms [3, m, d] bf16 (the f32 queries
// split, ops/kernels.py split_bf16x3), codes [n, d] int8 row-major, d a
// multiple of 16 (zero pad columns past the data's width), both bases
// 16-byte aligned, scale [n] f32; a score is (q . codes[j]) * scale[j].
// The rest as for vsc_scores_bf16 and vsc_scores_above_bf16.
extern "C" int vsc_scores_int8(int device, const __nv_bfloat16* terms,
                               const int8_t* codes, const float* scale, int m,
                               int n, int d, int n_valid, int grid, float* out,
                               void* stream) {
  if (m <= 0 || n_valid <= 0) return 0;
  if (n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_int8(terms, codes, scale, m, d, n_valid, grid,
                              TcScores{out, m, n_valid},
                              static_cast<cudaStream_t>(stream));
}

extern "C" int vsc_scores_above_int8(int device, const __nv_bfloat16* terms,
                                     const int8_t* codes, const float* scale,
                                     const float* floors, int m, int n, int d,
                                     int n_valid, int grid, long long cap,
                                     float* out_s, int* out_r, int* out_c,
                                     unsigned long long* count, void* stream) {
  if (m < 0 || n_valid < 0 || n_valid > n || cap < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_int8(terms, codes, scale, m, d, n_valid, grid,
                              TcScoresAbove{floors, m, cap, out_s, out_r, out_c, count},
                              s);
}

// Blocks of the L2 above-floor kernel one SM holds at once.
extern "C" int vsc_scores_above_bf16_l2_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<wg::L2<TcScoresAbove>>(device, blocks_per_sm);
}

// The L2 variant: vsc_scores_above_bf16's arguments with qs [m] and rs [n]
// f32 (the squared norms) after refs; the entries are goodness scores.
extern "C" int vsc_scores_above_bf16_l2(int device, const __nv_bfloat16* q,
                                        const __nv_bfloat16* refs, const float* qs,
                                        const float* rs, const float* floors, int m,
                                        int n, int d, int n_valid, int grid,
                                        long long cap, float* out_s, int* out_r,
                                        int* out_c, unsigned long long* count,
                                        void* stream) {
  if (m < 0 || n_valid < 0 || n_valid > n || cap < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch(
      q, refs, m, d, n_valid, grid,
      wg::L2<TcScoresAbove>{{floors, m, cap, out_s, out_r, out_c, count}, qs, rs, m}, s);
}
