// scores: q . refs^T over the first n_valid columns, written out [M,
// n_valid] f32, on the bf16 tensor-core product, or (scores.int8) on the
// int8 kernels' f32 chain.
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
// of 8 values (ops/kernels.py pad_columns).
//
// int8 (vsc_scores_int8, launch key scores.int8): the re-search over an
// int8 (SQ8) corpus, JAX's block product on the IP8 branch
// (_corpus_rows_topk_packed, vsc2022_tpu/ops/similarity.py:1806). The
// int8 kernels score on the f32 fmaf chain over exactly widened codes,
// one scale multiply per finished score; torch.matmul would sum in
// another order, so a re-searched pair would score a few ulps from its
// neighbours' kernel scores and the two collections, which re-search
// different rows, could rank near-equal pairs apart. This kernel is
// reduce_gemm.cuh's int8 product (I8Corpus: codes by 16-byte cp.async
// into a ring of their own, each 64-deep slice widened once into an f32
// stage, the scale in its finish hook), the one row_max.int8,
// count_above.int8 and fused_topk.int8 run, with an epilogue that stores
// each score (I8ScoreStore): a re-searched pair scores as those three and
// pool_writer.int8 (tile_gemm.cuh, the same chain) score it, bit for bit.
// Bound: operations, 2*M*N*D at 67 TFLOP/s: a 128-row chunk of the SSCD
// re-search ([128 x 1,000,020 x 512]) is 0.13 TFLOP, 1.96 ms, for 0.52 GB
// of codes read and 0.51 GB of scores written (0.31 ms at 3.35 TB/s).
// Design: the persistent, pipelined schedule of reduce_gemm.cuh (one wave
// of blocks walking 128 x 128 items row tile major, the ring running
// across items), so copies overlap the FMAs; the searcher hands it row
// chunks of a multiple of 128 rows (ops/similarity.py _row_chunk), so its
// items are full. The epilogue keeps no state: each thread stores its 8 x
// 8 scores from registers, and for each (i, j) the 8 lanes tx of a warp's
// 4 rows cover 8 adjacent columns, whole 32-byte sectors wherever the
// row's offset is a multiple of 8 floats; rows >= M and columns >= n_valid
// are not written.
#include "reduce_gemm.cuh"
#include "wgmma_gemm.cuh"

using namespace vsc;

namespace {

// The score epilogue: no state across items.
struct Bf16Scores {
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

// The int8 scores' epilogue on reduce_gemm.cuh (its epilogue contract):
// no state across items; each finished item's scores, already scaled
// (I8Corpus::finish), go to out[row * n_valid + col].
struct I8ScoreStore {
  static constexpr int kStages = reduce::STAGES;
  float* out;
  int n_valid;
  struct State {};
  struct Smem {};

  __device__ __forceinline__ void begin(State&, Smem&, const reduce::Tile&,
                                        const reduce::Work&) const {}

  template <bool kMasked>
  __device__ __forceinline__ void item(State&, Smem&, const reduce::Tile& t,
                                       const reduce::Work& w,
                                       float acc[reduce::TM][reduce::TN],
                                       int rt, int ct, int valid_cols) const {
#pragma unroll
    for (int i = 0; i < reduce::TM; ++i) {
      const int row = rt * reduce::BM + t.row + 4 * i;
      if (row >= w.m) continue;
      float* dst = out + (size_t)row * n_valid + (size_t)ct * reduce::BN + t.col;
#pragma unroll
      for (int j = 0; j < reduce::TN; ++j)
        if (!kMasked || 8 * j < valid_cols) dst[8 * j] = acc[i][j];
    }
  }

  __device__ __forceinline__ void flush(State&, Smem&, const reduce::Tile&,
                                        const reduce::Work&, int) const {}
};

}  // namespace

// Blocks of the int8 kernel one SM holds at once (its grid: SMs x this,
// at most the work items of ops/kernels.py reduce_tiles).
extern "C" int vsc_scores_int8_occupancy(int device, int* blocks_per_sm) {
  return reduce::resident_blocks_int8<I8ScoreStore>(device, 0, blocks_per_sm);
}

// The int8 variant: q [m, d] f32 and codes [n, d] int8 row-major, d a
// multiple of 16 (zero pad columns past the data's width), both bases
// 16-byte aligned, scale [n] f32; out is [m, n_valid] f32, out[i, j] =
// (q[i] . codes[j]) * scale[j]; `grid` persistent blocks (one wave, at
// most the work items), as for vsc_row_max_int8.
extern "C" int vsc_scores_int8(int device, const float* q, const int8_t* codes,
                               const float* scale, int m, int n, int d,
                               int n_valid, int grid, float* out,
                               void* stream) {
  if (m <= 0 || n_valid <= 0) return 0;
  if (n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce::launch_int8(q, codes, scale, m, d, n_valid, grid,
                                  I8ScoreStore{out, n_valid}, 0,
                                  static_cast<cudaStream_t>(stream));
}

// Blocks of the kernel one SM holds at once: its grid is SMs x this, at
// most the work items of ops/kernels.py wgmma_tiles.
extern "C" int vsc_scores_bf16_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<Bf16Scores>(device, blocks_per_sm);
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
                         Bf16Scores{out, m, n_valid},
                         static_cast<cudaStream_t>(stream));
}
