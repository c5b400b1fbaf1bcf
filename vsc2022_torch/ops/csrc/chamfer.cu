// chamfer: the DnS fine similarity of a batch of (query, ref) video pairs.
//
//   out[b, i, j] = (1/9) sum_a max_c <qf[b, i, a], rf[b, j, c]>
//
// over the 9 regions a (query) and c (ref) of frame i and frame j, averaged
// with (1/9) sum_c max_a <.,.> when `symmetric`. No rescale: the caller
// fuses it with the coarse similarity. Zero-pad frames give 0 exactly.
//
// Replaces vsc2022_tpu/ops/pallas_kernels.py:chamfer_fine_sims
// (_chamfer_kernel), the fused chamfer of every DnS alignment batch.
//
// Bound: operations. 2 * B * (NQ*9) * (NR*9) * D flops in full f32 FMA (the
// DnS path runs at "highest": no TF32), against the f32 CUDA-core peak; one
// 64 x 64 pair at D = 512 is 0.34 GFLOP, 5 us at 67 TFLOP/s. The bytes are
// small: the inputs are read once per tile (NR/16 or NQ/16 times) and the
// output is B*NQ*NR floats, so 81 products share each output float.
//
// Design. The XLA formulation materializes the [B, NQ, 9, 9, NR] region-pair
// product in device memory (7.8 GB at a 512-pair bucket); here it lives in
// registers only. The TPU kernel's 64-frame tiles and the region-major
// reordering of rf per tile are Mosaic layout artifacts and are not carried
// over. A block owns one pair b and a 16 x 16 tile of frame pairs, so the 9
// regions of a frame never split across blocks: thread (ti, tj) keeps the
// whole 9 x 9 region product of query frame ti and ref frame tj in 81
// accumulators, and both chamfer reductions (max over one region axis, mean
// over the other) run in that thread with no shuffle and no shared memory.
// D streams through shared memory 16 values at a time in a two-stage
// cp.async ring (the next slice loads while this one is multiplied);
// frames beyond NQ or NR are zero-filled by the copy and never written, so
// any bucket shape works. Every product is the sequential fmaf sum over k.
// Simple first: no wgmma, TMA or persistent schedule.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int R = 9;                // regions per frame
constexpr int FT = 16;              // frames per tile, each side
constexpr int THREADS = FT * FT;    // one thread per (query frame, ref frame)
constexpr int ROWS = FT * R;        // region rows per tile, each side
constexpr int BK = 16;              // depth per stage
constexpr int LD = BK + 4;          // padded row: conflict-free float4 reads
constexpr int CHUNKS = BK / 4;      // 16-byte copies per row per stage
constexpr int MAX_GRID_Z = 65535;

struct __align__(16) Smem {
  float q[2][ROWS * LD];
  float r[2][ROWS * LD];
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows [0, ROWS) of a tile are frames f0 .. f0+15 x regions 0..8, contiguous
// in global memory from `base`; rows of frames >= n_frames read as zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int f0, int n_frames, int d,
                                          int k0) {
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += THREADS) {
    const int row = e / CHUNKS, chunk = e % CHUNKS;
    const int k = k0 + 4 * chunk;
    const bool valid = (f0 + row / R < n_frames) && (k < d);
    const float* src = valid ? base + (size_t)row * d + k : base;
    cp_async16(dst + row * LD + 4 * chunk, src, valid);
  }
}

__global__ void __launch_bounds__(THREADS)
    chamfer_kernel(const float* __restrict__ qf, const float* __restrict__ rf,
                   int nq, int nr, int d, int symmetric,
                   float* __restrict__ out) {
  __shared__ Smem sm;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * FT, j0 = blockIdx.x * FT;
  const int ti = threadIdx.x / FT, tj = threadIdx.x % FT;
  const float* qbase = qf + ((size_t)b * nq + i0) * R * d;
  const float* rbase = rf + ((size_t)b * nr + j0) * R * d;

  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[a][c] = 0.f;

  const int n_k = (d + BK - 1) / BK;
  load_tile(sm.q[0], qbase, i0, nq, d, 0);
  load_tile(sm.r[0], rbase, j0, nr, d, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < n_k) {
      load_tile(sm.q[s ^ 1], qbase, i0, nq, d, (kt + 1) * BK);
      load_tile(sm.r[s ^ 1], rbase, j0, nr, d, (kt + 1) * BK);
    }
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const float* qs = sm.q[s] + ti * R * LD;
    const float* rs = sm.r[s] + tj * R * LD;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 qa[R];
#pragma unroll
      for (int a = 0; a < R; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + a * LD + k4);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float4 rc = *reinterpret_cast<const float4*>(rs + c * LD + k4);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          float v = acc[a][c];
          v = fmaf(qa[a].x, rc.x, v);
          v = fmaf(qa[a].y, rc.y, v);
          v = fmaf(qa[a].z, rc.z, v);
          acc[a][c] = fmaf(qa[a].w, rc.w, v);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite stage s ^ 1
  }

  const int i = i0 + ti, j = j0 + tj;
  if (i >= nq || j >= nr) return;
  float sum_a = 0.f;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    float m = acc[a][0];
#pragma unroll
    for (int c = 1; c < R; ++c) m = fmaxf(m, acc[a][c]);
    sum_a += m;
  }
  float fg = sum_a / R;
  if (symmetric) {
    float sum_c = 0.f;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float m = acc[0][c];
#pragma unroll
      for (int a = 1; a < R; ++a) m = fmaxf(m, acc[a][c]);
      sum_c += m;
    }
    fg = (fg + sum_c / R) / 2.f;
  }
  out[((size_t)b * nq + i) * nr + j] = fg;
}

}  // namespace

// qf [b, nq, regions, d], rf [b, nr, regions, d] f32 row-major on the device
// (16-byte aligned, d a multiple of 4, regions == 9); out is [b, nq, nr] f32.
extern "C" int vsc_chamfer(int device, const float* qf, const float* rf,
                           int b, int nq, int nr, int regions, int d,
                           int symmetric, float* out, void* stream) {
  if (regions != R || d % 4 != 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (b <= 0 || nq <= 0 || nr <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < b; b0 += MAX_GRID_Z) {
    const int nb = b - b0 < MAX_GRID_Z ? b - b0 : MAX_GRID_Z;
    const dim3 grid((nr + FT - 1) / FT, (nq + FT - 1) / FT, nb);
    chamfer_kernel<<<grid, THREADS, 0, s>>>(
        qf + (size_t)b0 * nq * R * d, rf + (size_t)b0 * nr * R * d, nq, nr, d,
        symmetric, out + (size_t)b0 * nq * nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
