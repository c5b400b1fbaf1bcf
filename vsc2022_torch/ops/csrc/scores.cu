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
// tile_gemm.cuh's product (pool_writer.int8's) with the column hook
// (ColumnScale) and an epilogue that writes each score: a re-searched
// pair scores as row_max.int8, count_above.int8, pool_writer.int8 and
// fused_topk.int8 score it, bit for bit. Bound: bytes at the re-search's
// shapes (the [M, n_valid] f32 scores written; ~480 rows over the SSCD
// corpus write 1.9 GB); one block per 64 x 128 tile, each lane storing
// its 4 columns of a row as one 16-byte store where the row's offset
// allows it.
#include <climits>

#include "tile_gemm.cuh"
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

// The int8 scores: one block per [64 x 128] tile of [m, n_valid].
__global__ void __launch_bounds__(THREADS)
    scores_int8_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ codes, ColumnScale scaled,
                       int m, int n_valid, int d, int n_row_tiles,
                       float* __restrict__ out) {
  __shared__ TileSmem sm;
  const int row0 = (blockIdx.x % n_row_tiles) * BM;
  const int col0 = (blockIdx.x / n_row_tiles) * BN;
  float acc[ROWS_PER_WARP][COLS_PER_LANE];
  tile_product(q, codes, m, n_valid, d, row0, col0, sm, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = col0 + lane * COLS_PER_LANE;
  scaled.apply(acc, col);
  if (col >= n_valid) return;
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = row0 + warp * ROWS_PER_WARP + r;
    if (row >= m) break;
    float* dst = out + (size_t)row * n_valid + col;
    if (col + COLS_PER_LANE <= n_valid &&
        (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS_PER_LANE; ++c)
        if (col + c < n_valid) dst[c] = acc[r][c];
    }
  }
}

}  // namespace

// The int8 variant: q [m, d] f32, codes [n, d] int8 and scale [n] f32,
// row-major on the device; out is [m, n_valid] f32, out[i, j] =
// (q[i] . codes[j]) * scale[j].
extern "C" int vsc_scores_int8(int device, const float* q, const int8_t* codes,
                               const float* scale, int m, int n, int d,
                               int n_valid, float* out, void* stream) {
  if (m <= 0 || n_valid <= 0) return 0;
  if (n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_row_tiles = (m + BM - 1) / BM;
  const long long blocks = (long long)n_row_tiles * ((n_valid + BN - 1) / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  scores_int8_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q, codes, ColumnScale{scale, n}, m, n_valid, d, n_row_tiles, out);
  return (int)cudaGetLastError();
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
