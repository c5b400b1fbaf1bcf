// A list of corpus blocks: the schedule of the block-subset variants of
// count_above and fused_topk (launch keys count_above[.bf16|.int8].blocks,
// fused_topk[.bf16|.int8].blocks), the IVF pruned tier's candidate and count
// passes (ops/ivf.py).
//
// Replaces no Pallas kernel: the JAX IVF tier scans its block subset with
// XLA (vsc2022_tpu/ops/similarity.py:191-230 streaming_topk and :427-483
// streaming_count_above with block_ids; the Pallas gate at :225-230 excludes
// block_ids). The port's count-verify needs the candidates, the counts and
// the re-search of a dtype to score on one product, bit for bit, so the
// subset runs on that product: the same kernels, whose schedule walks the
// listed blocks' tiles instead of the whole corpus.
//
// A block is col_block corpus rows (the searcher's column block: 8,192 at
// scale), `tiles` corpus tiles of the product (col_block / 128 for
// reduce_gemm.cuh, col_block / 256 for wgmma_gemm.cuh). Tile c of a launch
// over the list is corpus tile ids[c / tiles] * tiles + c % tiles: the
// product loads that tile's rows in place (no copy of the probed rows), and
// the epilogue sees the corpus tile, so ids, n_valid masking and the scale
// of an int8 row stay in the whole corpus's numbering. A score does not
// depend on where its tile sits in the schedule (the fmaf chain runs in k
// order; wgmma takes the same k-slices), so a subset kernel gives the
// full-corpus kernel's result on a corpus made of the listed blocks' rows,
// bit for bit. Bound: what the full-corpus kernel's is, over the listed
// blocks' columns.
#pragma once

#include <cuda_runtime.h>

namespace vsc {

struct BlockList {
  const int* ids;  // n ascending, distinct block ids, on the device
  int n;
  int tiles;       // corpus tiles a block

  __host__ __device__ __forceinline__ int launch_tiles() const { return n * tiles; }

  __device__ __forceinline__ int corpus_tile(int c) const {
    const int b = c / tiles;
    return __ldg(ids + b) * tiles + (c - b * tiles);
  }
};

}  // namespace vsc
