// The winner-pool contract: the best 2 entries of one 128-column segment of
// one query row, under the pool's order (larger value first, then the lower
// column). Top2, better, insert and merge are the contract itself, shared by
// every kernel that takes a segment's winners: pool_writer (the f32 tile
// product of tile_gemm.cuh and, in bf16, the tensor-core product of
// wgmma_gemm.cuh, whose segment_top2 takes them from an accumulator tile)
// and fused_topk (both products).
#pragma once

#include <cuda_runtime.h>

#include <climits>

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

__device__ __forceinline__ Top2 shfl_xor_top2(const Top2& t, int mask) {
  constexpr unsigned kFull = 0xffffffffu;
  return {__shfl_xor_sync(kFull, t.v1, mask), __shfl_xor_sync(kFull, t.i1, mask),
          __shfl_xor_sync(kFull, t.v2, mask), __shfl_xor_sync(kFull, t.i2, mask)};
}

// a if c else b, field by field (no reference to a selected struct).
__device__ __forceinline__ Top2 pick(bool c, const Top2& a, const Top2& b) {
  return {c ? a.v1 : b.v1, c ? a.i1 : b.i1, c ? a.v2 : b.v2, c ? a.i2 : b.i2};
}

}  // namespace vsc
