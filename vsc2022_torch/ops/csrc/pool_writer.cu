// pool_writer: fused q . refs^T plus the best 2 of every 128-column segment.
//
// Replaces vsc2022_tpu/ops/pallas_kernels.py:pool_writer (_pool_writer_kernel)
// and pool_writer_band (_pool_band_kernel): both compute the same winner pool.
// Output: values [M, N/128, 2] f32 (best first) and global column ids
// [M, N/128, 2] i32, per segment in natural order. Ties go to the lower
// column; columns >= n_valid score -inf (their ids are don't-care). The
// TPU kernels' band-major layout, f32 placement matmul and -3e38 sentinel
// were Mosaic artifacts and are not carried over.
//
// f32 (vsc_pool_writer). Bound: operations. 2*M*N*D flops ([9000 x
// 1,000,064 x 512] is 9.2 TFLOP, ~137 ms at 67 TFLOP/s f32), against ~3 GB
// of refs + pool traffic (~1 ms). Design (tile_gemm.cuh): one block owns a
// [64 rows x 128 columns] tile, i.e. whole segments, so the segment
// reduction happens in registers and warp shuffles right after the product;
// the [M, N] scores never reach device memory. Blocks walk the row tiles
// fastest, so consecutive blocks reuse the same 256 KB refs segment out of
// L2. Every score is the f32 fmaf chain of reduce_gemm.cuh, so the pool is
// what the f32 row_max, count_above and fused_topk score, bit for bit.
//
// bf16 (vsc_pool_writer_bf16) replaces the Pallas kernels' bf16 branch
// (pallas_kernels.py:228-230 and :389-391: bf16 operands in one native
// pass, f32 accumulation), the pooled collection over a bf16 corpus. Bound:
// operations, 2*M*N*D at 989 TFLOP/s ([9000 x 1,000,020 x 512] is 9.2
// TFLOP, 9.3 ms). It is the tensor-core product of wgmma_gemm.cuh (TMA into
// a 4-stage mbarrier ring, wgmma m64n256k16, bf16 in, f32 accumulation; the
// corpus read from HBM about once per group of 8 query tiles), the product
// of every bf16 kernel, with a pool epilogue: a 256-column tile holds two
// whole segments, whose winners the quad takes with segment_top2 (the one
// fused_topk.bf16 takes its candidates with), and its four lanes store
// them: lane 0 row0's values, lane 1 its ids, lanes 2 and 3 those of row
// row0 + 8, each as one 16-byte piece (the two segments' 2 slots) where
// the row's offset allows it, else two 8-byte ones. The epilogue keeps no
// state across items. So the pool's best winner is row_max.bf16, its
// winners ordered are fused_topk.bf16's, and count_above.bf16 counts its
// scores: the pooled prune (a row is complete when the corpus count equals
// its kept entries) compares the same bits. The stores are ~1.1 GB at SSCD
// (9000 x 7,872 segments x 16 bytes), scattered one row N/128 x 8 bytes
// apart, well under the operations bound.
//
// int8 (vsc_pool_writer_int8, launch key pool_writer.int8) is the pooled
// collection over an int8 (SQ8) corpus; the Pallas kernels are gated off
// for int8 and JAX builds that pool with XLA (pool_build_xla on the IP8
// branch, vsc2022_tpu/ops/similarity.py:704-735: codes widened into an
// f32 dot at HIGHEST, one scale multiply per column). Here it is the same
// pool epilogue on wgmma_gemm.cuh's int8 corpus policy (three exact bf16
// passes of the split f32 queries over the codes widened in shared memory,
// each score scaled once before the segment reduction), so the pool is
// what row_max.int8, count_above.int8, fused_topk.int8 and
// scores_above.int8 score, bit for bit. Bound: operations, 3 x 2*M*N*D at
// 989 TFLOP/s ([9000 x 1,000,020 x 512] is 28.0 ms); its corpus bytes are
// a quarter of f32's.
//
// Work (bf16 and int8): the plan covers the corpus tiles up to n_valid (wg::plan). The
// kernel writes segments [0, min(2 x those tiles, N/128)): with N/128 odd,
// the last tile's second segment lies past the output and is not written.
// The segments past them (zero rows the searcher pads the corpus with)
// score -inf; the wrapper fills them (ops/kernels.py pool_segments). Rows
// take a multiple of 8 values, codes rows of 16 (ops/kernels.py
// pad_columns).
//
// L2 (vsc_pool_writer_l2, vsc_pool_writer_bf16_l2; launch keys
// pool_writer.l2 and pool_writer.bf16.l2): the pooled collection of a
// searcher with metric="L2" (JAX builds that pool with XLA on goodness
// scores, vsc2022_tpu/ops/similarity.py:704-725). Each score of the tile
// becomes (2 s - rs[j]) - qs[i] (l2_goodness.cuh) before the segment
// reduction: the f32 kernel in a kernel of its own (pool_writer_l2_kernel,
// so that pool_writer_kernel's code stays as it was), the bf16 one behind
// the tensor-core pool epilogue. The pool is then what the L2 row_max,
// count_above and fused_topk of its product score, bit for bit.
#include <climits>

#include "l2_goodness.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

using namespace vsc;

namespace {

// Best 2 of one row's segment [col0, col0 + 128) in tile_gemm.cuh's layout:
// ``row_acc`` is the lane's 4 scores of that row; columns >= n_valid score
// -inf. Every lane of the warp must call it and every lane gets the result.
__device__ __forceinline__ Top2 warp_top2(const float (&row_acc)[COLS_PER_LANE],
                                          int col0, int n_valid, int lane) {
  Top2 t = {-CUDART_INF_F, INT_MAX, -CUDART_INF_F, INT_MAX};
#pragma unroll
  for (int c = 0; c < COLS_PER_LANE; ++c) {
    const int col = col0 + lane * COLS_PER_LANE + c;
    insert(t, col < n_valid ? row_acc[c] : -CUDART_INF_F, col);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t = merge(t, shfl_xor_top2(t, off));
  return t;
}

__global__ void __launch_bounds__(THREADS)
    pool_writer_kernel(const float* __restrict__ q,
                       const float* __restrict__ refs, int m, int n, int d,
                       int n_valid, int n_row_tiles, float* __restrict__ out_v,
                       int* __restrict__ out_i) {
  __shared__ TileSmem sm;
  const int rt = blockIdx.x % n_row_tiles;
  const int seg = blockIdx.x / n_row_tiles;
  const int row0 = rt * BM;
  const int col0 = seg * BN;
  const int n_seg = n / BN;

  float acc[ROWS_PER_WARP][COLS_PER_LANE];
  tile_product(q, refs, m, n, d, row0, col0, sm, acc);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const Top2 t = warp_top2(acc[r], col0, n_valid, lane);
    const int row = row0 + warp * ROWS_PER_WARP + r;
    if (lane == r && row < m) {
      const size_t o = ((size_t)row * n_seg + seg) * 2;
      out_v[o] = t.v1;
      out_v[o + 1] = t.v2;
      out_i[o] = t.i1;
      out_i[o + 1] = t.i2;
    }
  }
}

// pool_writer_kernel with each score of the tile taken to its L2 goodness
// (2 s - rs[j]) - qs[i] before the segment reduction.
__global__ void __launch_bounds__(THREADS)
    pool_writer_l2_kernel(const float* __restrict__ q,
                          const float* __restrict__ refs,
                          const float* __restrict__ qs,
                          const float* __restrict__ rs, int m, int n, int d,
                          int n_valid, int n_row_tiles, float* __restrict__ out_v,
                          int* __restrict__ out_i) {
  __shared__ TileSmem sm;
  const int rt = blockIdx.x % n_row_tiles;
  const int seg = blockIdx.x / n_row_tiles;
  const int row0 = rt * BM;
  const int col0 = seg * BN;
  const int n_seg = n / BN;

  float acc[ROWS_PER_WARP][COLS_PER_LANE];
  tile_product(q, refs, m, n, d, row0, col0, sm, acc);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < COLS_PER_LANE; ++c) {
    const int col = col0 + lane * COLS_PER_LANE + c;
    const float rj = col < n_valid ? rs[col] : 0.f;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = row0 + warp * ROWS_PER_WARP + r;
      acc[r][c] = l2_goodness(acc[r][c], rj, row < m ? qs[row] : 0.f);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const Top2 t = warp_top2(acc[r], col0, n_valid, lane);
    const int row = row0 + warp * ROWS_PER_WARP + r;
    if (lane == r && row < m) {
      const size_t o = ((size_t)row * n_seg + seg) * 2;
      out_v[o] = t.v1;
      out_v[o + 1] = t.v2;
      out_i[o] = t.i1;
      out_i[o + 1] = t.i2;
    }
  }
}

// The pool epilogue of the tensor-core product (wgmma_gemm.cuh, either
// corpus): no state across items, so begin and flush have nothing to do.
struct TcPool {
  static constexpr int kStages = wg::kStages, kGroup = wg::kGroup;
  float* out_v;
  int* out_i;
  int m, n_seg;
  struct Smem {};

  __device__ __forceinline__ void begin(Smem&, const wg::Lane&) const {}

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem&, const wg::Lane& l,
                                       const float (&acc)[wg::kAcc],
                                       const wg::Item& it, int valid_cols) const {
    Top2 b[2][2];  // [row row0 + 8h][segment]
    wg::segment_top2<kMasked>(acc, l, it.c_tile, valid_cols, b);
    const bool hi = l.quad >= 2, ids = l.quad & 1;
    const int row = it.q_tile * wg::BM + l.row0 + (hi ? 8 : 0);
    if (row >= m) return;
    const Top2 t0 = pick(hi, b[1][0], b[0][0]), t1 = pick(hi, b[1][1], b[0][1]);
    const int seg = 2 * it.c_tile;
    const size_t o = ((size_t)row * n_seg + seg) * 2;  // even: 8-byte aligned
    // Values or ids of the two segments, as 32-bit words.
    const uint32_t w0 = ids ? (uint32_t)t0.i1 : __float_as_uint(t0.v1);
    const uint32_t w1 = ids ? (uint32_t)t0.i2 : __float_as_uint(t0.v2);
    const uint32_t w2 = ids ? (uint32_t)t1.i1 : __float_as_uint(t1.v1);
    const uint32_t w3 = ids ? (uint32_t)t1.i2 : __float_as_uint(t1.v2);
    uint32_t* out = ids ? reinterpret_cast<uint32_t*>(out_i)
                        : reinterpret_cast<uint32_t*>(out_v);
    if (seg + 1 >= n_seg) {  // the second segment lies past the output
      *reinterpret_cast<uint2*>(out + o) = make_uint2(w0, w1);
    } else if ((o & 3) == 0) {
      *reinterpret_cast<uint4*>(out + o) = make_uint4(w0, w1, w2, w3);
    } else {
      *reinterpret_cast<uint2*>(out + o) = make_uint2(w0, w1);
      *reinterpret_cast<uint2*>(out + o + 2) = make_uint2(w2, w3);
    }
  }

  __device__ __forceinline__ void flush(Smem&, const wg::Lane&,
                                        const wg::Item&) const {}
};

}  // namespace

// q [m, d], refs [n, d] (n a multiple of 128), both f32 row-major on the
// device. Returns cudaGetLastError() after the launch.
extern "C" int vsc_pool_writer(int device, const float* q, const float* refs,
                               int m, int n, int d, int n_valid, float* out_v,
                               int* out_i, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_row_tiles = (m + BM - 1) / BM;
  const long long blocks = (long long)n_row_tiles * (n / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  pool_writer_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q, refs, m, n, d, n_valid, n_row_tiles, out_v, out_i);
  return (int)cudaGetLastError();
}

// Blocks of the bf16 kernel (tensor cores) one SM holds at once: its grid is
// SMs x this, at most the work items of ops/kernels.py wgmma_tiles.
extern "C" int vsc_pool_writer_bf16_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcPool>(device, blocks_per_sm);
}

// Bytes of dynamic shared memory one block of that kernel takes.
extern "C" int vsc_pool_writer_bf16_smem_bytes() {
  return wg::smem_bytes<TcPool>();
}

// The bf16 variant: q [m, d] and refs [n, d] bf16 row-major, n a multiple
// of 128, d % 8 == 0 (zero pad columns past the data's width) and both
// bases 16-byte aligned; out_v / out_i are [m, n/128, 2]; `grid` persistent
// blocks. Writes the segments ops/kernels.py pool_segments says it writes.
extern "C" int vsc_pool_writer_bf16(int device, const __nv_bfloat16* q,
                                    const __nv_bfloat16* refs, int m, int n,
                                    int d, int n_valid, int grid, float* out_v,
                                    int* out_i, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n % BN || n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch(q, refs, m, d, n_valid, grid,
                         TcPool{out_v, out_i, m, n / BN},
                         static_cast<cudaStream_t>(stream));
}

// Blocks of the int8 kernel (tensor cores) one SM holds at once.
extern "C" int vsc_pool_writer_int8_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcPool, wg::I8Corpus>(device, blocks_per_sm);
}

// The int8 variant (SQ8 corpus): terms [3, m, d] bf16 (the f32 queries
// split, ops/kernels.py split_bf16x3), codes [n, d] int8 and scale [n] f32
// row-major on the device, n a multiple of 128, d a multiple of 16 (zero
// pad columns past the data's width), both bases 16-byte aligned; a score
// is (q . codes[j]) * scale[j]. Output, `grid` and the segments written as
// for vsc_pool_writer_bf16.
extern "C" int vsc_pool_writer_int8(int device, const __nv_bfloat16* terms,
                                    const int8_t* codes, const float* scale,
                                    int m, int n, int d, int n_valid, int grid,
                                    float* out_v, int* out_i, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n % BN || n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_int8(terms, codes, scale, m, d, n_valid, grid,
                              TcPool{out_v, out_i, m, n / BN},
                              static_cast<cudaStream_t>(stream));
}

// The f32 L2 variant: vsc_pool_writer's arguments with qs [m] and rs [n]
// f32 (the squared norms) after refs; the pool of the goodness scores.
extern "C" int vsc_pool_writer_l2(int device, const float* q, const float* refs,
                                  const float* qs, const float* rs, int m, int n,
                                  int d, int n_valid, float* out_v, int* out_i,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_row_tiles = (m + BM - 1) / BM;
  const long long blocks = (long long)n_row_tiles * (n / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  pool_writer_l2_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      q, refs, qs, rs, m, n, d, n_valid, n_row_tiles, out_v, out_i);
  return (int)cudaGetLastError();
}

// Blocks of the bf16 L2 kernel (tensor cores) one SM holds at once.
extern "C" int vsc_pool_writer_bf16_l2_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<wg::L2<TcPool>>(device, blocks_per_sm);
}

// The bf16 L2 variant: vsc_pool_writer_bf16's arguments with qs [m] and rs
// [n] f32 after refs.
extern "C" int vsc_pool_writer_bf16_l2(int device, const __nv_bfloat16* q,
                                       const __nv_bfloat16* refs, const float* qs,
                                       const float* rs, int m, int n, int d,
                                       int n_valid, int grid, float* out_v,
                                       int* out_i, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n % BN || n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch(q, refs, m, d, n_valid, grid,
                         wg::L2<TcPool>{{out_v, out_i, m, n / BN}, qs, rs, m},
                         static_cast<cudaStream_t>(stream));
}
