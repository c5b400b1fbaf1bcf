// Metric L2 on the retrieval kernels (FAISS METRIC_L2): every score of the
// product becomes the goodness g = (2 s - rs[j]) - qs[i], the negated
// squared distance -||q_i - r_j||^2, where s = q_i . r_j is the product's
// f32 accumulator, rs[j] = ||r_j||^2 one f32 value per corpus row and
// qs[i] = ||q_i||^2 one per query row, both computed by the caller.
//
// Replaces no Pallas kernel: the Pallas kernels are gated to inner product
// (vsc2022_tpu/ops/similarity.py:229, :566), and the JAX searcher scores L2
// with XLA in four places (the block scores :253-280, streaming_count_above
// :453-468, the pool :704-725, the repair counts :1130-1150), each as
// `2.0 * s - rs[None, :] - q_sq[:, None]`. Here it is an epilogue step of
// the kernels' own products, in f32 and in that order, each operation
// rounded once (no contraction into an FMA: 2 s is exact, so fma(2, s, -rs)
// would round the same, but the intrinsics say so), before the epilogue
// folds the tile. So an L2 kernel of one product scores a (q, r) pair as
// every other L2 kernel of that product does, bit for bit (the pooled prune
// and the streaming verify compare those bits), and the searcher's
// re-searches take the same expression on the same rs and qs.
//
// Cost: one f32 load per corpus column and one per query row of each
// finished tile, against the 2 D operations per score of the product, with
// two subtractions per score. The wrappers below leave the inner
// epilogues, their products and the inner-product kernels' code as they
// were: an L2 kernel is a new instantiation, its epilogue the IP one
// behind this step. Columns at or past n_valid read no rs (the epilogues
// skip them or take them as -inf) and query rows >= M no qs.
#pragma once

#include "reduce_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace vsc {

__device__ __forceinline__ float l2_goodness(float s, float rs, float qs) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, s), rs), qs);
}

namespace reduce {

// The L2 step before epilogue E of reduce_gemm.cuh (the f32 row_max,
// count_above and fused_topk): a thread's rows row + 4i, columns col + 8j.
template <class E>
struct L2 {
  static constexpr int kStages = E::kStages;
  using State = typename E::State;
  using Smem = typename E::Smem;
  E ep;
  const float* qs;  // [m]
  const float* rs;  // [>= n_valid]

  __device__ __forceinline__ void begin(State& st, Smem& sm, const Tile& t,
                                        const Work& w) const {
    ep.begin(st, sm, t, w);
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(State& st, Smem& sm, const Tile& t,
                                       const Work& w, float acc[TM][TN], int rt,
                                       int ct, int valid_cols) const {
    float q[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = rt * BM + t.row + 4 * i;
      q[i] = row < w.m ? qs[row] : 0.f;
    }
    const float* r = rs + (size_t)ct * BN + t.col;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float rj = !kMasked || 8 * j < valid_cols ? r[8 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j] = l2_goodness(acc[i][j], rj, q[i]);
    }
    ep.template item<kMasked>(st, sm, t, w, acc, rt, ct, valid_cols);
  }

  __device__ __forceinline__ void flush(State& st, Smem& sm, const Tile& t,
                                        const Work& w, int rt) const {
    ep.flush(st, sm, t, w, rt);
  }
};

}  // namespace reduce

namespace wg {

// The L2 step before epilogue E of the tensor-core product (bf16 corpora:
// row_max, count_above, pool_writer, fused_topk and scores_above): a
// consumer thread's rows row0 and row0 + 8, columns 8j + col0 + {0, 1}
// (wgmma_gemm.cuh Lane). It changes the accumulators in place, as
// I8Corpus::finish does: the next item's first wgmma overwrites them. rs
// is 8-byte aligned (ops/kernels.py checks it): a pair of columns is one
// load. With one load per column the compiler kept scores_above's 128
// accumulators on the stack (1,028 bytes of spill stores); with pairs it
// spills 8 bytes there and nothing in the other four (ptxas, sm_90a,
// within the 168 registers a thread of a 384-thread block).
template <class E>
struct L2 {
  static constexpr int kStages = E::kStages, kGroup = E::kGroup;
  using Smem = typename E::Smem;
  E ep;
  const float* qs;  // [m]
  const float* rs;  // [>= n_valid]
  int m;

  __device__ __forceinline__ void begin(Smem& s, const Lane& l) const { ep.begin(s, l); }

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem& s, const Lane& l, float (&acc)[kAcc],
                                       const Item& it, int valid_cols) const {
    const int row = it.q_tile * BM + l.row0;
    const float q0 = row < m ? qs[row] : 0.f;
    const float q1 = row + 8 < m ? qs[row + 8] : 0.f;
    const float* r = rs + (size_t)it.c_tile * BN;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      // Columns col and col + 1 in one 8-byte load (col is even).
      const int col = 8 * j + l.col0;
      float2 rj = make_float2(0.f, 0.f);
      if (!kMasked || col + 1 < valid_cols)
        rj = *reinterpret_cast<const float2*>(r + col);
      else if (col < valid_cols)
        rj.x = r[col];
      acc[4 * j] = l2_goodness(acc[4 * j], rj.x, q0);
      acc[4 * j + 1] = l2_goodness(acc[4 * j + 1], rj.y, q0);
      acc[4 * j + 2] = l2_goodness(acc[4 * j + 2], rj.x, q1);
      acc[4 * j + 3] = l2_goodness(acc[4 * j + 3], rj.y, q1);
    }
    ep.template item<kMasked>(s, l, acc, it, valid_cols);
  }

  __device__ __forceinline__ void flush(Smem& s, const Lane& l, const Item& it) const {
    ep.flush(s, l, it);
  }
};

}  // namespace wg
}  // namespace vsc
