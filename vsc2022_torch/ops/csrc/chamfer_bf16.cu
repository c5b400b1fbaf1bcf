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
// Design (TMA, wgmma, persistent; the plan's mirror is ops/kernels.py
// chamfer_bf16_plan). A work item is one pair b, QT = 128 query frames and
// RT = 16 ref frames, numbered pair major, then query tile, then ref tile;
// block k of the grid (one block per SM) takes items k, k + grid, ..., so
// the blocks work on consecutive items, a few pairs at a time, and a pair's
// query slab (1.2 MB at D = 512) is read from HBM about once and from L2
// by each of its items. (Contiguous ranges of items per block kept 132
// pairs' slabs live, more than L2, and ran the largest call in 0.933 ms
// against 0.518.) Three warpgroups: the producer's first thread issues
// every TMA load (setmaxnreg 40), the two consumers (setmaxnreg 232), 64
// query frames each, run wgmma. The ref tile is the B operand, its 144
// rows region-major (row c*16 + n), and stays resident in shared memory for
// all nine query regions: one slice of 144 rows x 64 k (18 KB, 128-byte
// swizzle) per 64 columns of D, each loaded by TMA as nine boxes of 16
// frames x 64 k from a 4-D tensor map over rf [B, NR, 9, D], so frames
// past NR read as zeros and never as pair b + 1's. The query k-slices (128
// frames x 64 k of region a, 16 KB) go through a 4-stage mbarrier ring.
// For each query region a the consumers run one k-loop of
// wgmma.m64n144k16 (72 f32 accumulators a thread; the first k-step
// overwrites them, scale-d 0), committing a k-slice at a time and waiting
// for the one before, whose stages they then release. A thread's
// accumulator columns are 8j + 2(lane % 4) + {0, 1}, so with columns
// c*16 + n it holds the same 4 ref frames (and 2 query frames) for all
// nine c: after each pass it adds max_c to its 8 sums and folds the pass
// into its 72 running max_a, all in registers (152 live floats); after
// pass 8 it writes its 8 outputs. No region tile is staged and nothing
// crosses warps. The last pass releases each ref slice as it passes it,
// so the producer refills it with the next item's slice at once and the
// reload hides behind the product. Past the resident limit (D > 512: nine
// slices and the ring exceed 227 KB) the ref slices stream through a ring
// of 8 slots once a pass instead. RT = 8 (N = 72, resident to D = 1,088)
// was the other way there: it reads the query slab from L2 once per 8 ref
// frames, as many bytes per flop as streaming RT = 16, for a second
// instruction shape, so it was not taken.
//
// What holds it near 68% of the bound at the largest call (PERF.md section
// 6): each consumer's k-loop is one chain of dependent wgmma on one
// accumulator, two chains a block. A variant that gave the consumers of a
// call with NQ <= 64 half the ref tile each (m64n72k16, no rows of zeros)
// took as long a k-step as m64n144k16, so gained 8% on that call only, and
// a 5-stage ring changed nothing: the chains' latency, not bytes, sets the
// pace, and a third chain has no registers (a consumer thread holds 152
// live floats under its 232).
//
// Numerics: the tensor cores sum each k16 step in their own order; every
// partial sum of integer inputs is below 2^24, so those are exact, and unit
// rows land within a few f32 roundings of the plain version. The sums over
// a and over c run in region order, / 9, halved when symmetric, as
// chamfer.cu; the result need not be the previous (mma.sync) kernel's bit
// for bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "wgmma_gemm.cuh"

namespace {

namespace wg = vsc::wg;

constexpr int R = 9;                       // regions per frame
constexpr int RT = 16;                     // ref frames a work item
constexpr int QT = 128;                    // query frames a work item, 64 a consumer
constexpr int N = R * RT;                  // ref rows of the B operand: 144
constexpr int kAcc = N / 2;                // f32 accumulators a consumer thread: 72
constexpr int kPairs = kAcc / R;           // (query, ref) frame pairs a thread: 8
constexpr int BK = 64;                     // k-slice: 128 bytes of bf16, one swizzle row
constexpr int kStages = 4;                 // query ring
constexpr int Q_STAGE = QT * BK * 2;       // 16 KB
constexpr int BOX = RT * BK * 2;           // one region's 16 frames of a slice, 2 KB
constexpr int SLICE = R * BOX;             // one k-slice of the ref tile, 18 KB
constexpr int THREADS = 384;               // consumers 0, 1; producer 2
constexpr int kConsumerThreads = 256;
constexpr int kAlign = 1024;               // the 128-byte swizzle repeats per 1 KB
constexpr int kMaxSmem = 232448;           // an H100 block's dynamic shared memory

// Dynamic shared memory for `slots` ref slices: alignment slack, the query
// ring, the slices, and a full and an empty barrier for each stage and slot.
constexpr int smem_bytes(int slots) {
  return kAlign + kStages * Q_STAGE + slots * SLICE +
         (2 * kStages + 2 * slots) * (int)sizeof(uint64_t);
}
constexpr int kMaxSlots = (kMaxSmem - smem_bytes(0)) / (SLICE + 2 * (int)sizeof(uint64_t));
static_assert(kMaxSlots == 8 && smem_bytes(kMaxSlots) <= kMaxSmem, "eight 18 KB slices");

struct Plan {
  long long items;       // b * q_tiles * r_tiles
  int nq, nr, q_tiles, r_tiles, kt_n;
  int slots;             // ref slices in shared memory (== kt_n when resident)
  int resident;          // 1: the ref tile is loaded once an item
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int k0,
                                            int region, int frame0, int pair,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(region), "r"(frame0), "r"(pair),
      "r"(wg::smem_u32(bar))
      : "memory");
}

template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous product (its registers change under the asm).
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] . B[144 x 16]^T; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n144k16(float (&d)[72], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void advance(int& slot, unsigned& phase, int slots) {
  if (++slot == slots) {
    slot = 0;
    phase ^= 1;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    chamfer_bf16_kernel(__grid_constant__ const CUtensorMap tq,
                        __grid_constant__ const CUtensorMap tr, Plan p, int symmetric,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  unsigned char* qring = smem_raw + ((kAlign - (raw & (kAlign - 1))) & (kAlign - 1));
  unsigned char* slices = qring + kStages * Q_STAGE;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(slices + p.slots * SLICE);
  uint64_t* empty_q = full_q + kStages;
  uint64_t* full_r = empty_q + kStages;
  uint64_t* empty_r = full_r + p.slots;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full_q[s], 1);
      wg::mbar_init(&empty_q[s], kConsumerThreads);
    }
    for (int s = 0; s < p.slots; ++s) {
      wg::mbar_init(&full_r[s], 1);
      wg::mbar_init(&empty_r[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_pair = p.q_tiles * p.r_tiles;
  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumerThreads) {
      int qs = 0, rs = 0;
      unsigned qph = 0, rph = 0;
      for (long long i = blockIdx.x; i < p.items; i += gridDim.x) {
        const int b = (int)(i / per_pair);
        const int local = (int)(i - (long long)b * per_pair);
        const int q0 = local / p.r_tiles * QT, r0 = local % p.r_tiles * RT;
        for (int a = 0; a < R; ++a) {
          for (int kt = 0; kt < p.kt_n; ++kt) {
            if (!p.resident || a == 0) {
              wg::mbar_wait(&empty_r[rs], rph ^ 1);
              wg::mbar_expect_tx(&full_r[rs], SLICE);
              unsigned char* dst = slices + rs * SLICE;
#pragma unroll 1
              for (int c = 0; c < R; ++c)
                tma_load_4d(dst + c * BOX, &tr, kt * BK, c, r0, b, &full_r[rs]);
              advance(rs, rph, p.slots);
            }
            wg::mbar_wait(&empty_q[qs], qph ^ 1);
            wg::mbar_expect_tx(&full_q[qs], Q_STAGE);
            tma_load_4d(qring + qs * Q_STAGE, &tq, kt * BK, a, q0, b, &full_q[qs]);
            advance(qs, qph, kStages);
          }
        }
      }
    }
  } else {
    // ---- consumers: nine k-loops an item, the reductions in registers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // of its 64
    const int col0 = 2 * (lane & 3);
    const uint32_t a_off = warpgroup * 64 * BK * 2;  // its 64 query rows
    // acc[c * kPairs + q]: ref region c of the thread's pair q = 4jj + 2h + e,
    // query frame row + 8h, ref frame 8jj + col0 + e (wgmma's column 16c +
    // 8jj + col0 + e). mx: the running max over a; sum: over a of max_c.
    float acc[kAcc], mx[kAcc], sum[kPairs];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
    int qs = 0, rs = 0;
    unsigned qph = 0, rph = 0;
    for (long long i = blockIdx.x; i < p.items; i += gridDim.x) {
      const int b = (int)(i / per_pair);
      const int local = (int)(i - (long long)b * per_pair);
      const int q0 = local / p.r_tiles * QT, r0 = local % p.r_tiles * RT;
#pragma unroll
      for (int k = 0; k < kAcc; ++k) mx[k] = -CUDART_INF_F;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) sum[q] = 0.f;
      for (int a = 0; a < R; ++a) {
        // The ref slices are released after their last use: every pass
        // when they stream, the last pass when resident.
        const bool release_r = !p.resident || a == R - 1;
        int prev_q = -1, prev_r = -1;
        for (int kt = 0; kt < p.kt_n; ++kt) {
          const int slot = p.resident ? kt : rs;
          wg::mbar_wait(&full_r[slot], rph);
          wg::mbar_wait(&full_q[qs], qph);
          const uint32_t qa = wg::smem_u32(qring + qs * Q_STAGE) + a_off;
          const uint32_t rb = wg::smem_u32(slices + slot * SLICE);
          wg::wgmma_fence();
          fence_acc(acc);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // 16 values = 32 bytes a step
            wgmma_m64n144k16(acc, wg::sw128_desc(qa + 32 * kk), wg::sw128_desc(rb + 32 * kk),
                             kt > 0 || kk > 0);
          wg::wgmma_commit();
          if (prev_q >= 0) {
            wgmma_wait<1>();  // the previous k-slice is done with its stages
            wg::mbar_arrive(&empty_q[prev_q]);
            if (prev_r >= 0) wg::mbar_arrive(&empty_r[prev_r]);
          }
          prev_q = qs;
          prev_r = release_r ? slot : -1;
          advance(qs, qph, kStages);
          if (release_r) advance(rs, rph, p.slots);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        wg::mbar_arrive(&empty_q[prev_q]);
        if (prev_r >= 0) wg::mbar_arrive(&empty_r[prev_r]);
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          float m = acc[q];
#pragma unroll
          for (int c = 1; c < R; ++c) m = fmaxf(m, acc[c * kPairs + q]);
          sum[q] += m;
#pragma unroll
          for (int c = 0; c < R; ++c)
            mx[c * kPairs + q] = fmaxf(mx[c * kPairs + q], acc[c * kPairs + q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int fi = q0 + 64 * warpgroup + row + 8 * ((q >> 1) & 1);
        const int fj = r0 + 8 * (q >> 2) + col0 + (q & 1);
        if (fi < p.nq && fj < p.nr) {
          float fg = sum[q] / R;
          if (symmetric) {
            float sc = 0.f;
#pragma unroll
            for (int c = 0; c < R; ++c) sc += mx[c * kPairs + q];
            fg = (fg + sc / R) / 2.f;
          }
          out[((size_t)b * p.nq + fi) * p.nr + fj] = fg;
        }
      }
      __syncwarp();  // converged again before the next wgmma (.aligned)
    }
  }
}

cudaError_t configure(int slots) {
  return cudaFuncSetAttribute(chamfer_bf16_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(slots));
}

// Tensor map of [pairs, frames, 9, d] bf16 rows, read in boxes of
// (64 k, one region, box_frames frames, one pair) with the 128-byte
// swizzle; whatever lies past d or past `frames` of the pair reads as zero.
bool encode(CUtensorMap* map, const __nv_bfloat16* base, int pairs, int frames, int d,
            int box_frames) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)d * sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)R, (cuuint64_t)frames,
                              (cuuint64_t)pairs};
  const cuuint64_t strides[3] = {row, row * R, row * R * frames};
  const cuuint32_t box[4] = {(cuuint32_t)BK, 1, (cuuint32_t)box_frames, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Validates a call of at least one item and fills `p`; `slots` >= kt_n
// keeps the ref tile resident (in kt_n slices), fewer (at least 2) stream it.
cudaError_t plan(int b, int nq, int nr, int d, int slots, Plan* p) {
  p->nq = nq;
  p->nr = nr;
  p->q_tiles = (nq + QT - 1) / QT;
  p->r_tiles = (nr + RT - 1) / RT;
  p->kt_n = (d + BK - 1) / BK;
  p->items = (long long)b * p->q_tiles * p->r_tiles;
  p->resident = slots >= p->kt_n;
  p->slots = p->resident ? p->kt_n : slots;
  if ((!p->resident && p->slots < 2) || p->slots > kMaxSlots ||
      (long long)p->q_tiles * p->r_tiles > INT_MAX)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

int launch(int device, const __nv_bfloat16* qf, const __nv_bfloat16* rf, int b, int nq,
           int nr, int regions, int d, int symmetric, int grid, int slots, float* out,
           void* stream) {
  if (regions != R || d % 8 != 0 || d <= 0 ||
      ((reinterpret_cast<uintptr_t>(qf) | reinterpret_cast<uintptr_t>(rf)) & 15))
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || nq <= 0 || nr <= 0) return 0;
  Plan p;
  cudaError_t err = plan(b, nq, nr, d, slots, &p);
  if (err != cudaSuccess) return (int)err;
  if (grid <= 0 || grid > p.items) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tr;
  if (!encode(&tq, qf, b, nq, d, QT) || !encode(&tr, rf, b, nr, d, RT))
    return (int)cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(p.slots);
  if (err != cudaSuccess) return (int)err;
  chamfer_bf16_kernel<<<grid, THREADS, smem_bytes(p.slots), static_cast<cudaStream_t>(stream)>>>(
      tq, tr, p, symmetric, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's resources (chip_smoke.py logs them): resident blocks per SM
// at `slots` ref slices, registers and local (spill) bytes a thread.
extern "C" int vsc_chamfer_bf16_attributes(int device, int slots, int* blocks_per_sm,
                                           int* regs, int* local_bytes) {
  if (slots < 1 || slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(slots);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, chamfer_bf16_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, chamfer_bf16_kernel,
                                                        THREADS, smem_bytes(slots));
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Dynamic shared memory of a launch with `slots` ref slices (the plan's
// mirror, kernels.chamfer_bf16_smem_bytes, must agree).
extern "C" int vsc_chamfer_bf16_smem_bytes(int slots) { return smem_bytes(slots); }

// qf [b, nq, regions, d], rf [b, nr, regions, d] bf16 row-major on the
// device (16-byte aligned, d a multiple of 8, regions == 9); out is
// [b, nq, nr] f32. `grid` persistent blocks (1 to the work items) and
// `slots` ref slices, as kernels.chamfer_bf16_plan gives them: the plan
// lives there alone.
extern "C" int vsc_chamfer_bf16(int device, const __nv_bfloat16* qf, const __nv_bfloat16* rf,
                                int b, int nq, int nr, int regions, int d, int symmetric,
                                int grid, int slots, float* out, void* stream) {
  return launch(device, qf, rf, b, nq, nr, regions, d, symmetric, grid, slots, out, stream);
}
