// The f32 tile product of pool_writer and pool_writer.int8, the only
// kernels on it. row_max, count_above, fused_topk, their .int8 variants and
// scores.int8 run the pipelined persistent product of reduce_gemm.cuh, with
// the same arithmetic per score (the bf16 kernels run the tensor-core
// product of wgmma_gemm.cuh instead).
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
// int8 corpora (SQ8: pool_writer.int8): the corpus operand is int8 codes,
// each widened exactly to f32 as it is copied into shared memory, so the
// chain is the f32 chain on codes.float(), and the scores of
// reduce_gemm.cuh's int8 kernels bit for bit; the kernel applies the
// corpus row's scale to each finished score (ColumnScale).
//
// Simple first: no cp.async, TMA or wgmma, one shared-memory stage.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

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

// acc[r][c] = sum_k q[row0 + 8*warp + r][k] * refs[col0 + 4*lane + c][k],
// refs f32 or int8 (widened exactly). Rows >= m and columns >= n read as
// zeros. Every thread of the block must call this (it synchronizes the
// block).
template <class T>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ q, const T* __restrict__ refs, int m, int n,
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
      sm.b[kk][c] =
          (gc < n && gk < d) ? static_cast<float>(refs[(size_t)gc * d + gk]) : 0.f;
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

// The per-column hook of an int8 corpus: a finished score times its
// corpus row's scale, once (an L2 corpus's 2 q.r - |r|^2 would be another
// hook of this form). Columns >= n read scale 0; the kernels mask columns
// >= n_valid after it.
struct ColumnScale {
  const float* scale;  // [n]
  int n;
  __device__ __forceinline__ void apply(float (&acc)[ROWS_PER_WARP][COLS_PER_LANE],
                                        int col0) const {
#pragma unroll
    for (int c = 0; c < COLS_PER_LANE; ++c) {
      const float s = col0 + c < n ? scale[col0 + c] : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r][c] *= s;
    }
  }
};

}  // namespace vsc
