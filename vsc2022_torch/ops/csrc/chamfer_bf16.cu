// chamfer.bf16: the DnS fine similarity at precision="default", on the
// tensor cores.
//
//   out[b, i, j] = (1/9) sum_a max_c <qf[b, i, a], rf[b, j, c]>
//
// over the 9 regions a (query) and c (ref) of frame i and frame j, averaged
// with (1/9) sum_c max_a <.,.> when `symmetric`; no rescale. Operands are
// bf16 (rounded to nearest even by the caller), each region product the f32
// sum of the exact bf16 x bf16 products. Zero-pad frames give 0 exactly.
//
// Replaces the bf16 branch of vsc2022_tpu/ops/pallas_kernels.py
// _chamfer_kernel (the MXU product of bf16 operands with f32 accumulation),
// reached through chamfer_fine_sims(precision="default").
//
// Bound: operations. 2 * B * (NQ*9) * (NR*9) * D flops at the bf16
// tensor-core peak; the largest DnS call (B 256 x NQ 128 x NR 128, D 512)
// is 348 GFLOP, 0.352 ms at 989 TFLOP/s, against 0.185 ms for its bytes.
//
// Design. The region-pair product never leaves the SM. A block owns one
// pair b, 16 query frames and 32 ref frames: the block product of its 144
// query rows (region-major: row a*16 + q) by its 288 ref rows (c*32 + n).
// Warp c owns ref region c: nine m16 tiles (one per query region a, the 16
// frames) by four n8 tiles (region c, the 32 frames), 144 f32 accumulators
// a thread, from mma.sync.m16n8k16 on bf16 fragments (ldmatrix from
// shared memory) with f32 accumulation: each ref fragment serves 9 query
// tiles, each query fragment 4 ref tiles. A thread holds the same 16
// (query frame, ref frame) positions in all nine of its warp's tiles. D
// streams through a 3-stage cp.async ring of 32-deep slices (rows padded
// to 80 bytes: conflict-free ldmatrix); frames past NQ or NR and k >= D
// are zero-filled by the copy, so any NQ, NR and D % 8 == 0 work, and
// frames past the end are never written. Both chamfer reductions cross
// the warps: after the product each warp stores its fragments (16-byte
// stores, 166 KB for the 81 region tiles, over the ring's memory), and
// each thread then reduces whole frame pairs from there: max over c, sum
// over a, / 9, and with `symmetric` max over a, sum over c, / 9, halved,
// as chamfer.cu does. Simple first: no TMA, wgmma or persistent schedule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int R = 9;                 // regions per frame
constexpr int QF = 16;               // query frames per block: one m16 tile a region
constexpr int RF = 32;               // ref frames per block
constexpr int NT = RF / 8;           // n8 tiles a region
constexpr int THREADS = 32 * R;      // warp c owns ref region c
constexpr int A_ROWS = R * QF;       // 144 query rows, region-major
constexpr int B_ROWS = R * RF;       // 288 ref rows, region-major
constexpr int BK = 32;               // bf16 depth of a ring stage
constexpr int LDS = BK + 8;          // padded row: 80 bytes
constexpr int CHUNKS = BK / 8;       // 16-byte copies per row per stage
constexpr int STAGES = 3;
constexpr int STAGE_ELEMS = (A_ROWS + B_ROWS) * LDS;
constexpr int PAIRS = QF * RF;       // frame pairs per block
constexpr int MAX_GRID_Z = 65535;
constexpr size_t PIPE_BYTES = (size_t)STAGES * STAGE_ELEMS * sizeof(__nv_bfloat16);
constexpr size_t EPI_BYTES = (size_t)R * R * PAIRS * sizeof(float);
constexpr size_t SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// acc += A (16 x 16, row) * B (16 x 8, col), bf16 in, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float* acc, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One ring stage: k in [k0, k0 + BK) of the block's query rows (a*QF + q:
// frame q, region a) and ref rows (c*RF + n), from [frames, R, d] rows at
// qbase and rbase; frames >= nq_left / nr_left and k >= d read as zeros.
__device__ __forceinline__ void load_stage(__nv_bfloat16* st, const __nv_bfloat16* qbase,
                                           const __nv_bfloat16* rbase, int nq_left,
                                           int nr_left, int d, int k0) {
  for (int e = threadIdx.x; e < (A_ROWS + B_ROWS) * CHUNKS; e += THREADS) {
    const int row = e / CHUNKS, chunk = e % CHUNKS;
    const int k = k0 + 8 * chunk;
    const __nv_bfloat16* src;
    bool valid;
    if (row < A_ROWS) {
      const int a = row / QF, q = row % QF;
      valid = q < nq_left && k < d;
      src = qbase + ((size_t)q * R + a) * d + k;
    } else {
      const int c = (row - A_ROWS) / RF, n = (row - A_ROWS) % RF;
      valid = n < nr_left && k < d;
      src = rbase + ((size_t)n * R + c) * d + k;
    }
    cp_async16(st + row * LDS + 8 * chunk, valid ? src : qbase, valid);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    chamfer_bf16_kernel(const __nv_bfloat16* __restrict__ qf,
                        const __nv_bfloat16* __restrict__ rf, int nq, int nr, int d,
                        int symmetric, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * QF, j0 = blockIdx.x * RF;
  const int c = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qbase = qf + ((size_t)b * nq + i0) * R * d;
  const __nv_bfloat16* rbase = rf + ((size_t)b * nr + j0) * R * d;
  const int nq_left = nq - i0, nr_left = nr - j0;

  float acc[R][NT][4];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][t][e] = 0.f;

  // ldmatrix.x4 row addresses: lane l gives row l % 8 of matrix l / 8.
  // Query tile (16 rows x k16): matrices (rows 0-7, k lo), (rows 8-15,
  // k lo), (rows 0-7, k hi), (rows 8-15, k hi) = fragment registers a0-a3.
  // Two ref tiles (8 rows x k16 each): (tile 2p, k lo), (2p, k hi),
  // (2p+1, k lo), (2p+1, k hi) = b0, b1 of tile 2p, then of tile 2p+1.
  const int mi = lane >> 3, mr = lane & 7;
  const int a_off = ((mi & 1) * 8 + mr) * LDS + (mi >> 1) * 8;
  const int b_off = (A_ROWS + c * RF + (mi >> 1) * 8 + mr) * LDS + (mi & 1) * 8;

  const int n_k = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage(ring + s * STAGE_ELEMS, qbase, rbase, nq_left, nr_left, d, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < n_k)
      load_stage(ring + (next % STAGES) * STAGE_ELEMS, qbase, rbase, nq_left, nr_left, d,
                 next * BK);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    const __nv_bfloat16* st = ring + (kt % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bfr[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p)
        ldmatrix_x4(bfr[2 * p][0], bfr[2 * p][1], bfr[2 * p + 1][0], bfr[2 * p + 1][1],
                    st + b_off + 16 * p * LDS + kk);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        uint32_t afr[4];
        ldmatrix_x4(afr[0], afr[1], afr[2], afr[3], st + a_off + a * QF * LDS + kk);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_bf16(acc[a][t], afr, bfr[t]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes S

  // S[(c*R + a)*PAIRS + j]: warp c's tile (a, t) fragments, j = t*128 +
  // lane*4 + e for accumulator e of a lane, whose frame pair is (query
  // g + 8*(e >> 1), ref t*8 + 2*(lane % 4) + (e & 1)), g = lane / 4.
  float* S = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<float4*>(S + (c * R + a) * PAIRS + t * 128 + lane * 4) =
          make_float4(acc[a][t][0], acc[a][t][1], acc[a][t][2], acc[a][t][3]);
  __syncthreads();

  for (int j = threadIdx.x; j < PAIRS; j += THREADS) {
    const int t = j / 128, l = (j / 4) % 32, e = j % 4;
    const int i = i0 + l / 4 + 8 * (e >> 1);
    const int n = j0 + t * 8 + 2 * (l % 4) + (e & 1);
    if (i >= nq || n >= nr) continue;
    float sum_a = 0.f;
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float m = S[a * PAIRS + j];
#pragma unroll
      for (int cc = 1; cc < R; ++cc) m = fmaxf(m, S[(cc * R + a) * PAIRS + j]);
      sum_a += m;
    }
    float fg = sum_a / R;
    if (symmetric) {
      float sum_c = 0.f;
#pragma unroll
      for (int cc = 0; cc < R; ++cc) {
        float m = S[cc * R * PAIRS + j];
#pragma unroll
        for (int a = 1; a < R; ++a) m = fmaxf(m, S[(cc * R + a) * PAIRS + j]);
        sum_c += m;
      }
      fg = (fg + sum_c / R) / 2.f;
    }
    out[((size_t)b * nq + i) * nr + n] = fg;
  }
}

cudaError_t configure() {
  return cudaFuncSetAttribute(chamfer_bf16_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
}

}  // namespace

// Resident blocks per SM (chip_smoke.py logs the plan).
extern "C" int vsc_chamfer_bf16_occupancy(int device, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, chamfer_bf16_kernel,
                                                        THREADS, SMEM_BYTES);
  return (int)err;
}

// qf [b, nq, regions, d], rf [b, nr, regions, d] bf16 row-major on the
// device (16-byte aligned, d a multiple of 8, regions == 9); out is
// [b, nq, nr] f32.
extern "C" int vsc_chamfer_bf16(int device, const __nv_bfloat16* qf,
                                const __nv_bfloat16* rf, int b, int nq, int nr,
                                int regions, int d, int symmetric, float* out,
                                void* stream) {
  if (regions != R || d % 8 != 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (b <= 0 || nq <= 0 || nr <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < b; b0 += MAX_GRID_Z) {
    const int nb = b - b0 < MAX_GRID_Z ? b - b0 : MAX_GRID_Z;
    const dim3 grid((nr + RF - 1) / RF, (nq + QF - 1) / QF, nb);
    chamfer_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        qf + (size_t)b0 * nq * R * d, rf + (size_t)b0 * nr * R * d, nq, nr, d, symmetric,
        out + (size_t)b0 * nq * nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
