// count_above: exact per-row count of q . refs^T >= tau over the first
// n_valid columns.
//
// Replaces vsc2022_tpu/ops/pallas_kernels.py:fused_count_above
// (_count_above_kernel); the JAX searcher's production count
// (similarity.py:streaming_count_above) has the same contract. The port's
// searcher counts every query row in the streaming collection (thousands of
// rows) and only the ambiguous rows in the pooled one (hundreds of rows, or
// one video's 60).
//
// Bound: operations. 2*M*N*D flops in full f32 FMA ([9000 x 240,000 x 512]
// is 2.2 TFLOP, ~33 ms at 67 TFLOP/s); refs are read once per 128-row tile.
// Design (reduce_gemm.cuh): one wave of persistent blocks splits the (row
// tile, column tile) items evenly, so a call of 60 rows fills the card as
// well as one of 9,000; each block counts over its range in registers and
// the partial counts combine with one int32 atomicAdd per row and block
// (exact, order-free). The tile product is a 3-stage cp.async ring of
// 64-deep slices feeding 8 x 8 register tiles. Its scores are the f32
// pool_writer's and fused_topk's bit for bit, which the pooled prune (a row
// is complete when this count equals its kept entries) and the streaming
// verify rely on.
//
// Over a bf16 corpus (the JAX searcher's streaming_count_above on bf16
// operands with f32 accumulation) both collections count with
// vsc_count_above_bf16 (launch key count_above.bf16): the tensor-core
// product of wgmma_gemm.cuh (TMA, 4-stage mbarrier ring, wgmma m64n256k16)
// with a count epilogue, the product every bf16 kernel runs. So the
// streaming verify (kept == count) counts the scores of fused_topk.bf16's
// candidates, and the pooled prune those of pool_writer.bf16's pool, bit
// for bit; the pooled count runs on the ambiguous rows alone, each at
// another place in its query tile than in the pool's launch, and a wgmma
// score does not depend on its row's place (tests/test_torch_cuda.py holds
// a permuted row subset against the full call). Bound: operations, 2*M*N*D
// at 989 TFLOP/s ([9000 x 240,000 x 512] is 2.2 TFLOP, 2.2 ms), the
// operands 2 bytes a value and the corpus read from HBM about once per
// group of 8 query tiles. The epilogue is short, so it runs near
// row_max.bf16's rate: per finished 128 x 256 tile each thread counts its
// columns >= tau (columns at or past n_valid left out, so tau = -inf
// counts every valid column), the quad sums them with two shuffles, and
// the owner adds them to the group's running count per row in shared
// memory; a block commits each row once per group it leaves with one
// atomicAdd, and rows >= M never. Rows take a multiple of 8 values
// (ops/kernels.py pad_columns).
//
// Over an int8 (SQ8) corpus both collections count with
// vsc_count_above_int8 (launch key count_above.int8; JAX:
// streaming_count_above and the repair counts on the IP8 branch, XLA,
// vsc2022_tpu/ops/similarity.py:459-472, 1135-1150): the same epilogue on
// wgmma_gemm.cuh's int8 corpus policy (three exact bf16 passes of the
// split f32 queries over the widened codes, each score scaled once before
// the compare), the product of pool_writer.int8, fused_topk.int8 and the
// re-search's scores_above.int8, so it counts the scores of the int8 pool
// and candidates bit for bit. Bound: operations, 3 x 2*M*N*D at 989
// TFLOP/s ([7682 x 31,004 x 1025] at DnS is 1.48 ms); the corpus bytes are
// a quarter of f32's. Codes rows take a multiple of 16 values.
//
// The L2 variants (vsc_count_above_l2, vsc_count_above_bf16_l2; launch
// keys count_above.l2 and count_above.bf16.l2) count the goodness scores
// (2 s - rs[j]) - qs[i] >= tau of a searcher with metric="L2" (JAX:
// streaming_count_above and the repair counts, XLA,
// vsc2022_tpu/ops/similarity.py:453-468, :1130-1150): the same products and
// epilogues behind l2_goodness.cuh's step, so they count the goodness that
// the L2 pool and candidates of their product hold, bit for bit. Bound as
// for the IP kernels.
#include "l2_goodness.cuh"
#include "reduce_gemm.cuh"
#include "wgmma_gemm.cuh"

using namespace vsc;

namespace {

struct CountAbove {
  using T = int;
  float tau;
  int* out;
  __device__ __forceinline__ T identity() const { return 0; }
  __device__ __forceinline__ T fold(T v, float score) const {
    return v + (score >= tau);
  }
  __device__ __forceinline__ T combine(T a, T b) const { return a + b; }
  __device__ __forceinline__ void commit(int row, T v) const {
    if (v > 0) atomicAdd(out + row, v);
  }
};

// The count epilogue of the tensor-core product (wgmma_gemm.cuh, either
// corpus): each owner thread keeps rows row0 and row0 + 8 of every query
// tile of the group in shared memory.
struct TcCount {
  static constexpr int kStages = wg::kStages, kGroup = wg::kGroup;
  float tau;
  int* out;
  int m;
  struct Smem {
    int run[wg::kGroup][wg::BM];
  };

  __device__ __forceinline__ void begin(Smem& s, const wg::Lane& l) const {
    if (!l.owner) return;
    for (int t = 0; t < kGroup; ++t) s.run[t][l.row0] = s.run[t][l.row0 + 8] = 0;
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem& s, const wg::Lane& l,
                                       const float (&acc)[wg::kAcc],
                                       const wg::Item& it, int valid_cols) const {
    int c0 = 0, c1 = 0;
#pragma unroll
    for (int j = 0; j < wg::kAcc / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!kMasked || 8 * j + l.col0 + e < valid_cols) {
          c0 += acc[4 * j + e] >= tau;
          c1 += acc[4 * j + 2 + e] >= tau;
        }
      }
    }
    c0 += __shfl_xor_sync(0xffffffffu, c0, 1);
    c1 += __shfl_xor_sync(0xffffffffu, c1, 1);
    c0 += __shfl_xor_sync(0xffffffffu, c0, 2);
    c1 += __shfl_xor_sync(0xffffffffu, c1, 2);
    if (l.owner) {
      s.run[it.slot][l.row0] += c0;
      s.run[it.slot][l.row0 + 8] += c1;
    }
  }

  __device__ __forceinline__ void flush(Smem& s, const wg::Lane& l,
                                        const wg::Item& it) const {
    if (!l.owner) return;
    for (int t = 0; t < it.tiles; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = l.row0 + 8 * h;
        const int row = (it.group * kGroup + t) * wg::BM + r;
        const int v = s.run[t][r];
        if (row < m && v > 0) atomicAdd(out + row, v);
        s.run[t][r] = 0;
      }
    }
  }
};

}  // namespace

// Blocks of the count_above kernel one SM holds at once (16-byte copies if
// vec).
extern "C" int vsc_count_above_occupancy(int device, int vec,
                                         int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::RowFold<CountAbove>>(
      device, vec, 0, blocks_per_sm);
}

// q [m, d], refs [n, d] f32 row-major on the device; out is [m] int32.
// `grid` and `vec` as for vsc_row_max.
extern "C" int vsc_count_above(int device, const float* q, const float* refs,
                               int m, int n, int d, float tau, int n_valid,
                               int vec, int grid, int* out, void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce::launch(q, refs, m, d, n_valid, vec, grid,
                             reduce::RowFold<CountAbove>{{tau, out}}, 0, s);
}

// Blocks of the bf16 kernel (tensor cores) one SM holds at once (its grid:
// SMs x this, at most the work items of ops/kernels.py wgmma_tiles).
extern "C" int vsc_count_above_bf16_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcCount>(device, blocks_per_sm);
}

// Bytes of dynamic shared memory one block of that kernel takes.
extern "C" int vsc_count_above_bf16_smem_bytes() {
  return wg::smem_bytes<TcCount>();
}

// The bf16 variant: q [m, d] and refs [n, d] bf16 row-major, d % 8 == 0
// (zero pad columns past the data's width) and both bases 16-byte aligned;
// out is [m] int32; `grid` persistent blocks.
extern "C" int vsc_count_above_bf16(int device, const __nv_bfloat16* q,
                                    const __nv_bfloat16* refs, int m, int n,
                                    int d, float tau, int n_valid, int grid,
                                    int* out, void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch(q, refs, m, d, n_valid, grid, TcCount{tau, out, m}, s);
}

// Blocks of the int8 kernel (tensor cores) one SM holds at once.
extern "C" int vsc_count_above_int8_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcCount, wg::I8Corpus>(device, blocks_per_sm);
}

// The int8 variant (SQ8 corpus): terms [3, m, d] bf16 (the f32 queries
// split, ops/kernels.py split_bf16x3), codes [n, d] int8 row-major, d a
// multiple of 16 (zero pad columns past the data's width), both bases
// 16-byte aligned, scale [n] f32 (a score is (q . codes[j]) * scale[j]);
// out and `grid` as for vsc_count_above_bf16.
extern "C" int vsc_count_above_int8(int device, const __nv_bfloat16* terms,
                                    const int8_t* codes, const float* scale,
                                    int m, int n, int d, float tau,
                                    int n_valid, int grid, int* out,
                                    void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_int8(terms, codes, scale, m, d, n_valid, grid,
                              TcCount{tau, out, m}, s);
}

// Blocks of the f32 L2 kernel one SM holds at once (16-byte copies if vec).
extern "C" int vsc_count_above_l2_occupancy(int device, int vec,
                                            int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::L2<reduce::RowFold<CountAbove>>>(
      device, vec, 0, blocks_per_sm);
}

// The f32 L2 variant: vsc_count_above's arguments with qs [m] and rs [n]
// f32 (the squared norms) after refs; counts (2 q.r - rs) - qs >= tau.
extern "C" int vsc_count_above_l2(int device, const float* q, const float* refs,
                                  const float* qs, const float* rs, int m, int n,
                                  int d, float tau, int n_valid, int vec, int grid,
                                  int* out, void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce::launch(
      q, refs, m, d, n_valid, vec, grid,
      reduce::L2<reduce::RowFold<CountAbove>>{{{tau, out}}, qs, rs}, 0, s);
}

// Blocks of the bf16 L2 kernel (tensor cores) one SM holds at once.
extern "C" int vsc_count_above_bf16_l2_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<wg::L2<TcCount>>(device, blocks_per_sm);
}

// The bf16 L2 variant: vsc_count_above_bf16's arguments with qs [m] and rs
// [n] f32 after refs.
extern "C" int vsc_count_above_bf16_l2(int device, const __nv_bfloat16* q,
                                       const __nv_bfloat16* refs, const float* qs,
                                       const float* rs, int m, int n, int d,
                                       float tau, int n_valid, int grid, int* out,
                                       void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch(q, refs, m, d, n_valid, grid,
                         wg::L2<TcCount>{{tau, out, m}, qs, rs, m}, s);
}

// ---- the block-subset variants (block_list.cuh: the IVF tier's count) -----
//
// count_above over the corpus blocks `blocks` (n_blocks ascending, distinct
// block ids, col_block rows each, on the device): the per-row count of the
// listed blocks' columns (< n_valid) with q . r >= tau, on the product and
// epilogue of the full-corpus kernel of the dtype, so it counts the scores
// that kernel (and fused_topk's subset variant) sees, bit for bit. The JAX
// tier counts its certified blocks with XLA (vsc2022_tpu/ops/ivf.py
// _subset_counts: streaming_count_above with block_ids,
// vsc2022_tpu/ops/similarity.py:427-483). Bound: operations, 2*M*(n_blocks *
// col_block)*D at the dtype's peak (x3 for int8). An empty list counts 0.

// Blocks of the f32 subset kernel one SM holds at once (16-byte copies if
// vec).
extern "C" int vsc_count_above_blocks_occupancy(int device, int vec,
                                                int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::Blocks<reduce::RowFold<CountAbove>>>(
      device, vec, 0, blocks_per_sm);
}

// vsc_count_above's arguments with the block list after n_valid; col_block
// a multiple of 128.
extern "C" int vsc_count_above_blocks(int device, const float* q, const float* refs,
                                      int m, int n, int d, float tau, int n_valid,
                                      const int* blocks, int n_blocks, int col_block,
                                      int vec, int grid, int* out, void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce::launch_blocks(q, refs, m, d, n_valid, blocks, n_blocks, col_block,
                                    vec, grid, reduce::RowFold<CountAbove>{{tau, out}},
                                    0, s);
}

extern "C" int vsc_count_above_bf16_blocks_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<wg::Blocks<TcCount>>(device, blocks_per_sm);
}

// vsc_count_above_bf16's arguments with the block list after n_valid;
// col_block a multiple of 256.
extern "C" int vsc_count_above_bf16_blocks(int device, const __nv_bfloat16* q,
                                           const __nv_bfloat16* refs, int m, int n,
                                           int d, float tau, int n_valid,
                                           const int* blocks, int n_blocks,
                                           int col_block, int grid, int* out,
                                           void* stream) {
  if (m <= 0) return 0;
  BlockList list;
  if (n_valid < 0 || n_valid > n || !wg::block_list(&list, blocks, n_blocks, col_block))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_blocks(q, refs, m, d, n_valid, list, grid,
                                TcCount{tau, out, m}, s);
}

extern "C" int vsc_count_above_int8_blocks_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<wg::Blocks<TcCount>, wg::I8Corpus>(device, blocks_per_sm);
}

// vsc_count_above_int8's arguments with the block list after n_valid;
// col_block a multiple of 256.
extern "C" int vsc_count_above_int8_blocks(int device, const __nv_bfloat16* terms,
                                           const int8_t* codes, const float* scale,
                                           int m, int n, int d, float tau, int n_valid,
                                           const int* blocks, int n_blocks,
                                           int col_block, int grid, int* out,
                                           void* stream) {
  if (m <= 0) return 0;
  BlockList list;
  if (n_valid < 0 || n_valid > n || !wg::block_list(&list, blocks, n_blocks, col_block))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_blocks_int8(terms, codes, scale, m, d, n_valid, list, grid,
                                     TcCount{tau, out, m}, s);
}
