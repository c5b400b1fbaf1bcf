// The winner-pool contract: the best 2 entries of one 128-column segment of
// one query row, under the pool's order (larger value first, then the lower
// column). Top2, better and merge are the contract itself, shared with
// fused_topk.cu, which reduces its segments in reduce_gemm.cuh's layout.
//
// In pool_writer a row's 128 scores of a tile live in one warp
// (tile_gemm.cuh: lane l holds columns 4l..4l+3), so segment_top2 is a
// per-lane insert over 4 columns and a butterfly merge over the 32 lanes;
// every lane ends with the result.
#pragma once

#include <climits>

#include "tile_gemm.cuh"

namespace vsc {

struct Top2 {
  float v1;
  int i1;
  float v2;
  int i2;
};

// The pool comparator: larger value first, then the lower column.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void insert(Top2& t, float v, int i) {
  if (better(v, i, t.v1, t.i1)) {
    t.v2 = t.v1;
    t.i2 = t.i1;
    t.v1 = v;
    t.i1 = i;
  } else if (better(v, i, t.v2, t.i2)) {
    t.v2 = v;
    t.i2 = i;
  }
}

// Top-2 of the union of two disjoint sorted top-2 sets. Each field is
// selected on its own (no reference to a selected struct).
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = better(a.v1, a.i1, b.v1, b.i1);
  const float wv2 = a_wins ? a.v2 : b.v2;
  const int wi2 = a_wins ? a.i2 : b.i2;
  const float lv1 = a_wins ? b.v1 : a.v1;
  const int li1 = a_wins ? b.i1 : a.i1;
  const bool l_second = better(lv1, li1, wv2, wi2);
  Top2 r;
  r.v1 = a_wins ? a.v1 : b.v1;
  r.i1 = a_wins ? a.i1 : b.i1;
  r.v2 = l_second ? lv1 : wv2;
  r.i2 = l_second ? li1 : wi2;
  return r;
}

// Best 2 of one row's segment [col0, col0 + 128): ``row_acc`` is the lane's
// 4 scores of that row; columns >= n_valid score -inf. Every lane of the warp
// must call it and every lane gets the result.
__device__ __forceinline__ Top2 segment_top2(const float (&row_acc)[COLS_PER_LANE],
                                             int col0, int n_valid, int lane) {
  Top2 t = {-CUDART_INF_F, INT_MAX, -CUDART_INF_F, INT_MAX};
#pragma unroll
  for (int c = 0; c < COLS_PER_LANE; ++c) {
    const int col = col0 + lane * COLS_PER_LANE + c;
    insert(t, col < n_valid ? row_acc[c] : -CUDART_INF_F, col);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.v1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
    o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
    o.v2 = __shfl_xor_sync(0xffffffffu, t.v2, off);
    o.i2 = __shfl_xor_sync(0xffffffffu, t.i2, off);
    t = merge(t, o);
  }
  return t;
}

}  // namespace vsc
