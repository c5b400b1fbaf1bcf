// The f32 tile product of pool_writer, the only kernel on it. row_max,
// count_above and fused_topk run the pipelined persistent product of
// reduce_gemm.cuh, with the same arithmetic per score (the bf16 and int8
// kernels run the tensor-core product of wgmma_gemm.cuh instead).
//
// One block of 256 threads computes a [BM x BN] = [64 query rows x 128 ref
// columns] tile of q . refs^T in full f32 FMA on the CUDA cores (the JAX
// kernels run at Precision.HIGHEST; no TF32). The depth D streams through
// shared memory BK values at a time. Warp w owns rows 8w..8w+7 of the tile
// and lane l owns columns 4l..4l+3, so a thread holds an 8 x 4 register tile
// and each row's 128 scores live in one warp: the pool's per-segment top 2
// is a warp reduction, with no second pass through shared memory.
//
// Every score is the sequential sum over k = 0..D-1 of fmaf(q, r, acc), the
// order of reduce_gemm.cuh too, so the pool, the top-kappa candidates, the
// corpus count and the row max see bit-identical scores for the same
// (query, ref) pair.
//
// Simple first: no cp.async, TMA or wgmma, one shared-memory stage.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace vsc {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int ROWS_PER_WARP = 8;
constexpr int COLS_PER_LANE = 4;

struct __align__(16) TileSmem {
  float a[BK][BM + 4];  // q tile, transposed: a[k][row]
  float b[BK][BN + 4];  // refs tile, transposed: b[k][col]
};

// acc[r][c] = sum_k q[row0 + 8*warp + r][k] * refs[col0 + 4*lane + c][k].
// Rows >= m and columns >= n read as zeros. Every thread of the block must
// call this (it synchronizes the block).
__device__ __forceinline__ void tile_product(
    const float* __restrict__ q, const float* __restrict__ refs, int m, int n,
    int d, int row0, int col0, TileSmem& sm,
    float acc[ROWS_PER_WARP][COLS_PER_LANE]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
    for (int c = 0; c < COLS_PER_LANE; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      sm.a[kk][r] = (gr < m && gk < d) ? q[(size_t)gr * d + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int c = e / BK, kk = e % BK;
      const int gc = col0 + c, gk = k0 + kk;
      sm.b[kk][c] = (gc < n && gk < d) ? refs[(size_t)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.a[kk][warp * ROWS_PER_WARP]);
      const float4 a1 = *reinterpret_cast<const float4*>(
          &sm.a[kk][warp * ROWS_PER_WARP + 4]);
      const float4 b =
          *reinterpret_cast<const float4*>(&sm.b[kk][lane * COLS_PER_LANE]);
      const float av[ROWS_PER_WARP] = {a0.x, a0.y, a0.z, a0.w,
                                       a1.x, a1.y, a1.z, a1.w};
      const float bv[COLS_PER_LANE] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
        for (int c = 0; c < COLS_PER_LANE; ++c)
          acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

}  // namespace vsc
