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
// Output of one launch: per (row, column split) a kappa-set, [M, splits,
// kappa] values and ids, unordered, unfilled slots at (-inf, INT_MAX). The
// wrapper (ops/kernels.py:fused_topk) merges the splits and orders the rows
// best-first with one torch.sort over [M, splits * kappa], the counterpart
// of the JAX wrapper's lax.top_k after its kernel.
//
// Bound: operations. 2*M*N*D flops ([9000 x 240,000 x 512] is 2.2 TFLOP,
// ~33 ms at 67 TFLOP/s f32); the bytes (q and refs once, M*kappa*8 out) are
// far below. Design: the tile product is tile_gemm.cuh's, the one that
// count_above and pool_writer use, so the three kernels give bit-identical
// scores: the streaming verify compares kept-above-tau (tau from these
// scores) with count_above's exact count, and one score rounded differently
// would flag a complete row for a corpus re-search. A block owns a 64-row
// tile and a range of 128-column segments (column splits fill the card when
// the rows are few). After each segment's product, warp w reduces its 8 rows'
// segments to their best 2 (segment_top2.cuh) and folds them into the rows'
// kappa-sets by replacing the set's worst entry. The worst entry's (value,
// id, slot) stays in registers, so a winner no better than it is skipped
// with one compare: after the first segments almost every winner is. Slot s
// of a set belongs to lane s % 32: the lane that replaces a slot is the lane
// that rescans it, so the warp needs no barrier, only a shuffle reduction.
// The kappa-sets live in shared memory up to kappa = 192 (96 KB a block) and
// in the output itself (global memory) above that.
#include <climits>

#include "segment_top2.cuh"

using namespace vsc;

namespace {

constexpr int kSmemKappaMax = 192;

struct Slot {
  float v;
  int i;
  int s;
};

// Whether slot a is worse than slot b: b better under the pool order, the
// lower slot on equal entries (only the unfilled sentinels are equal).
__device__ __forceinline__ bool worse(const Slot& a, const Slot& b) {
  return better(b.v, b.i, a.v, a.i) || (a.v == b.v && a.i == b.i && a.s < b.s);
}

// The worst slot of one row's kappa-set. Each lane scans its own slots
// lane, lane + 32, ...; every lane gets the result.
__device__ __forceinline__ Slot worst_slot(const float* sv, const int* si,
                                           int kappa, int lane) {
  Slot w = {CUDART_INF_F, -1, INT_MAX};  // better than any slot
  for (int s = lane; s < kappa; s += 32) {
    const Slot c = {sv[s], si[s], s};
    if (worse(c, w)) w = c;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Slot o;
    o.v = __shfl_xor_sync(0xffffffffu, w.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, w.i, off);
    o.s = __shfl_xor_sync(0xffffffffu, w.s, off);
    if (worse(o, w)) w = o;
  }
  return w;
}

__global__ void __launch_bounds__(THREADS)
    fused_topk_kernel(const float* __restrict__ q,
                      const float* __restrict__ refs, int m, int n, int d,
                      int n_valid, int kappa, int splits, int tiles_per_split,
                      bool sets_in_smem, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  __shared__ TileSmem sm;
  extern __shared__ float set_smem[];
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_tiles = (n_valid + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Row r of the tile keeps its set at set_v + r * stride.
  float* set_v;
  int* set_i;
  size_t stride;
  if (sets_in_smem) {
    set_v = set_smem;
    set_i = reinterpret_cast<int*>(set_smem + BM * kappa);
    stride = kappa;
  } else {
    const size_t base = ((size_t)row0 * splits + split) * kappa;
    set_v = out_v + base;
    set_i = out_i + base;
    stride = (size_t)splits * kappa;
  }

  float min_v[ROWS_PER_WARP];
  int min_i[ROWS_PER_WARP];
  int min_s[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    min_v[r] = -CUDART_INF_F;
    min_i[r] = INT_MAX;
    min_s[r] = 0;
    const int local = warp * ROWS_PER_WARP + r;
    if (row0 + local < m) {
      for (int s = lane; s < kappa; s += 32) {
        set_v[local * stride + s] = -CUDART_INF_F;
        set_i[local * stride + s] = INT_MAX;
      }
    }
  }

  float acc[ROWS_PER_WARP][COLS_PER_LANE];
  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * BN;
    tile_product(q, refs, m, n, d, row0, col0, sm, acc);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const Top2 top = segment_top2(acc[r], col0, n_valid, lane);
      const int local = warp * ROWS_PER_WARP + r;
      if (row0 + local >= m) continue;  // uniform across the warp
      float* sv = set_v + local * stride;
      int* si = set_i + local * stride;
      // The winners come best first: once one is no better than the set's
      // worst entry, neither is the next.
      for (int c = 0; c < 2; ++c) {
        const float v = c == 0 ? top.v1 : top.v2;
        const int i = c == 0 ? top.i1 : top.i2;
        if (!(v > -CUDART_INF_F) || !better(v, i, min_v[r], min_i[r])) break;
        if (lane == (min_s[r] & 31)) {
          sv[min_s[r]] = v;
          si[min_s[r]] = i;
        }
        const Slot w = worst_slot(sv, si, kappa, lane);
        min_v[r] = w.v;
        min_i[r] = w.i;
        min_s[r] = w.s;
      }
    }
  }

  if (sets_in_smem) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int local = warp * ROWS_PER_WARP + r;
      const int row = row0 + local;
      if (row >= m) continue;
      const size_t o = ((size_t)row * splits + split) * kappa;
      for (int s = lane; s < kappa; s += 32) {
        out_v[o + s] = set_v[local * stride + s];
        out_i[o + s] = set_i[local * stride + s];
      }
    }
  }
}

}  // namespace

// q [m, d], refs [n, d] f32 row-major on the device; out_v / out_i are
// [m, splits, kappa] (the caller picks splits >= 1, at most the number of
// 128-column segments below n_valid, or 1 when there are none). Returns
// cudaGetLastError() after the launch.
extern "C" int vsc_fused_topk(int device, const float* q, const float* refs,
                              int m, int n, int d, int n_valid, int kappa,
                              int splits, float* out_v, int* out_i,
                              void* stream) {
  if (m <= 0) return 0;
  if (kappa <= 0 || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_valid + BN - 1) / BN;
  const int tiles_per_split = n_tiles > 0 ? (n_tiles + splits - 1) / splits : 0;
  const bool sets_in_smem = kappa <= kSmemKappaMax;
  const size_t smem = sets_in_smem ? (size_t)BM * kappa * 8 : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_topk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + BM - 1) / BM, splits);
  fused_topk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, refs, m, n, d, n_valid, kappa, splits, tiles_per_split, sets_in_smem,
      out_v, out_i);
  return (int)cudaGetLastError();
}
