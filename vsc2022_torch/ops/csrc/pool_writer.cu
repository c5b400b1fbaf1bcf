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
// Bound: operations. 2*M*N*D flops ([9000 x 1,000,064 x 512] is 9.2 TFLOP,
// ~137 ms at 67 TFLOP/s f32), against ~3 GB of refs + pool traffic (~1 ms).
// Design: one block owns a [64 rows x 128 columns] tile, i.e. whole
// segments, so the segment reduction happens in registers and warp
// shuffles right after the product; the [M, N] scores never reach device
// memory. Blocks walk the row tiles fastest, so consecutive blocks reuse
// the same 256 KB refs segment out of L2.
//
// The bf16 variant (vsc_pool_writer_bf16) replaces the Pallas kernels' bf16
// branch (pallas_kernels.py:228-230 and :389-391: bf16 operands in one
// native pass, f32 accumulation), which the JAX searcher takes over a bf16
// corpus and pool_writer(precision="default") takes by rounding f32 inputs.
// Bound: operations, 2*M*N*D; against the bf16 tensor-core peak (989
// TFLOP/s) its share is low by design: the operands are widened to f32 as
// they are staged (tile_gemm.cuh) and the f32 kernel's fmaf chain runs on
// them, so its pool is the f32 kernel's on the widened inputs bit for bit,
// and the bf16 count_above and fused_topk see the same scores. The refs
// move half the bytes.
#include <climits>

#include "segment_top2.cuh"

using namespace vsc;

namespace {

template <class T>
__global__ void __launch_bounds__(THREADS)
    pool_writer_kernel(const T* __restrict__ q,
                       const T* __restrict__ refs, int m, int n, int d,
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
    const Top2 t = segment_top2(acc[r], col0, n_valid, lane);
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

template <class T>
int run_pool_writer(int device, const T* q, const T* refs, int m, int n,
                    int d, int n_valid, float* out_v, int* out_i,
                    void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_row_tiles = (m + BM - 1) / BM;
  const long long blocks = (long long)n_row_tiles * (n / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  pool_writer_kernel<T><<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      q, refs, m, n, d, n_valid, n_row_tiles, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// q [m, d], refs [n, d] (n a multiple of 128), both f32 row-major on the
// device. Returns cudaGetLastError() after the launch.
extern "C" int vsc_pool_writer(int device, const float* q, const float* refs,
                               int m, int n, int d, int n_valid, float* out_v,
                               int* out_i, void* stream) {
  return run_pool_writer(device, q, refs, m, n, d, n_valid, out_v, out_i,
                         stream);
}

// The bf16 variant: q and refs bf16, the rest as vsc_pool_writer.
extern "C" int vsc_pool_writer_bf16(int device, const __nv_bfloat16* q,
                                    const __nv_bfloat16* refs, int m, int n,
                                    int d, int n_valid, float* out_v,
                                    int* out_i, void* stream) {
  return run_pool_writer(device, q, refs, m, n, d, n_valid, out_v, out_i,
                         stream);
}
