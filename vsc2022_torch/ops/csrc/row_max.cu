// row_max: max over the first n_valid columns of q . refs^T, per query row.
//
// Replaces vsc2022_tpu/ops/pallas_kernels.py:fused_row_max (_row_max_kernel),
// the k=1 noise-NN of score normalization.
//
// Bound: operations. 2*M*N*D flops in full f32 FMA ([9000 x 250,020 x 511]
// is 2.3 TFLOP, ~34 ms at 67 TFLOP/s); the bytes (q and refs once, M floats
// out) are far below. Design (reduce_gemm.cuh): the TPU grid carried the
// running max across column tiles in order on one core; here one wave of
// persistent blocks splits the (row tile, column tile) items evenly, each
// block keeps its running max per row in registers over its range, and the
// partial maxima combine with atomicMax on the monotone uint32 key of the
// f32 (the key of vsc2022_tpu/ops/similarity.py:_f32_sort_key), which is
// exact and independent of the order the blocks finish in. The tile product
// is a 3-stage cp.async ring of 64-deep slices feeding 8 x 8 register
// tiles (256 FMAs for 16 shared loads), so the FMAs, not the shared-memory
// reads or the fill, bound the inner loop. Its scores are pool_writer's bit
// for bit: the row max equals the pool's best winner.
//
// The bf16 variant (vsc_row_max_bf16) is the noise-NN over a bf16 corpus
// (score_norm(dtype="bfloat16") and the serving bias): fused_row_max has no
// bf16 branch, and the JAX searcher computes it with XLA on bf16 operands
// with f32 accumulation (similarity.py:271), one MXU pass on a TPU. Here it
// is the tensor-core product of wgmma_gemm.cuh (TMA into a 4-stage mbarrier
// ring, wgmma m64n256k16, bf16 in, f32 accumulation) with a row-max
// epilogue. (Widening the operands into the f32 fmaf chain of
// reduce_gemm.cuh, the bf16 kernels' first design, cannot pass 67/989 =
// 6.8% of the bf16 bound.) Bound: operations, 2*M*N*D at 989 TFLOP/s ([9000 x
// 250,020 x 511] is 2.3 TFLOP, 2.3 ms); the operands are 2 bytes a value
// and the corpus comes from HBM about once per group of 8 query tiles (the
// row-tile order would stream it once per 128 query rows: 71 x 256 MB at
// SSCD, 5.4 ms of HBM time). It reaches about half the bound on the H100
// (PERF.md, section 6). Keeping one slice's wgmma in flight while the
// next is issued changed nothing there, so the wait per slice is not what
// bounds it; the candidates are the L2 traffic of the tile (each 128 x 256
// item reads its q and corpus slices through L2: 384 KB at D = 512, ~6 TB/s
// at the measured rate, which a 2-block cluster multicasting the corpus
// tile would cut by a third) and the epilogue, during which the tensor
// cores idle. The epilogue
// takes each thread's maximum over its accumulator columns (columns at or
// past n_valid at -inf: the corpus's zero rows score 0, which would beat an
// all-negative row), then the quad's (shuffles xor 1, 2), and folds it
// into the group's running maximum in shared memory; the owner thread
// commits it with one atomicMax on the monotone key per row and group, and
// query rows >= M are never committed. The tensor cores sum in their own
// order: the scores are exact on integer inputs, within a few f32 rounding
// steps of the f32 kernel on the widened inputs elsewhere, and bit for bit
// those of the other bf16 kernels on the same product (count_above.bf16,
// pool_writer.bf16, fused_topk.bf16): the row max is the pool's best
// winner and fused_topk.bf16's best value, which chip_smoke.py checks on
// every bf16 path's inputs. Rows take a multiple
// of 8 values (ops/kernels.py pad_columns).
//
// The int8 variant (vsc_row_max_int8) is the noise-NN over an int8 (SQ8)
// corpus (score normalization's noise corpus and the serving bias under
// --int8): the JAX searcher's k = 1 streaming top-k over int8 storage, XLA
// with the codes widened into an f32 dot at HIGHEST and one scale multiply
// per column (vsc2022_tpu/ops/similarity.py:259-283, the IP8 branch). It
// is the row-max epilogue on wgmma_gemm.cuh's int8 corpus policy: the f32
// queries split into three exact bf16 terms, three wgmma passes over the
// codes widened to bf16 in shared memory, each finished score scaled once
// before the max. Bound: operations, 3 x 2*M*N*D at 989 TFLOP/s ([9000 x
// 250,020 x 511] is 6.98 ms); the corpus bytes are a quarter of f32's. Its
// scores are those of the other .int8 kernels bit for bit, and with unit
// scales and bf16-exact queries those of row_max.bf16 on the widened
// codes (the mid and lo passes add zeros).
//
// The L2 variants (vsc_row_max_l2, vsc_row_max_bf16_l2; launch keys
// row_max.l2 and row_max.bf16.l2) are the noise-NN of a searcher with
// metric="L2" (the JAX searcher's row_nn, a k = 1 streaming top-k over XLA
// goodness scores, vsc2022_tpu/ops/similarity.py:253-280): the same
// products and row-max epilogues behind l2_goodness.cuh's step, each score
// (2 s - rs[j]) - qs[i] before the max. The goodness is <= 0 up to
// rounding; the ordered keys above are monotone over every f32, negative
// values and -inf included, so the max is exact as for inner products.
// Bound as for the IP kernels (the per-column and per-row loads are M + N
// floats).
#include "l2_goodness.cuh"
#include "reduce_gemm.cuh"
#include "wgmma_gemm.cuh"

using namespace vsc;

namespace {

__device__ __forceinline__ unsigned f32_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_f32(unsigned k) {
  return __uint_as_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
}

// Key of -inf: the value of a row with no valid column.
constexpr unsigned kNegInfKey = 0x007fffffu;

__global__ void fill_keys(unsigned* keys, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) keys[i] = kNegInfKey;
}

__global__ void keys_to_f32(const unsigned* keys, float* out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) out[i] = key_f32(keys[i]);
}

struct RowMax {
  using T = float;
  unsigned* keys;
  __device__ __forceinline__ T identity() const { return -CUDART_INF_F; }
  __device__ __forceinline__ T fold(T v, float score) const {
    return fmaxf(v, score);
  }
  __device__ __forceinline__ T combine(T a, T b) const { return fmaxf(a, b); }
  __device__ __forceinline__ void commit(int row, T v) const {
    atomicMax(keys + row, f32_key(v));
  }
};

// The row-max epilogue of the tensor-core product (wgmma_gemm.cuh, either
// corpus): each owner thread keeps rows row0 and row0 + 8 of every query
// tile of the group in shared memory.
struct TcRowMax {
  static constexpr int kStages = wg::kStages, kGroup = wg::kGroup;
  unsigned* keys;
  int m;
  struct Smem {
    float run[wg::kGroup][wg::BM];
  };

  __device__ __forceinline__ void begin(Smem& s, const wg::Lane& l) const {
    if (!l.owner) return;
    for (int t = 0; t < wg::kGroup; ++t)
      s.run[t][l.row0] = s.run[t][l.row0 + 8] = -CUDART_INF_F;
  }

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem& s, const wg::Lane& l,
                                       const float (&acc)[wg::kAcc],
                                       const wg::Item& it, int valid_cols) const {
    float v0 = -CUDART_INF_F, v1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < wg::kAcc / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!kMasked || 8 * j + l.col0 + e < valid_cols) {
          v0 = fmaxf(v0, acc[4 * j + e]);
          v1 = fmaxf(v1, acc[4 * j + 2 + e]);
        }
      }
    }
    v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 1));
    v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 1));
    v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 2));
    v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 2));
    if (l.owner) {
      s.run[it.slot][l.row0] = fmaxf(s.run[it.slot][l.row0], v0);
      s.run[it.slot][l.row0 + 8] = fmaxf(s.run[it.slot][l.row0 + 8], v1);
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
        const float v = s.run[t][r];
        if (row < m && v != -CUDART_INF_F) atomicMax(keys + row, f32_key(v));
        s.run[t][r] = -CUDART_INF_F;
      }
    }
  }
};

// Fills the keys, runs `launch` (the product with the row-max epilogue) and
// turns the keys into f32.
template <class Launch>
int run_row_max(int device, int m, int n, int n_valid, unsigned* keys,
                float* out, void* stream, Launch launch) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fill_blocks = (m + 255) / 256;
  fill_keys<<<fill_blocks, 256, 0, s>>>(keys, m);
  err = launch(s);
  if (err != cudaSuccess) return (int)err;
  keys_to_f32<<<fill_blocks, 256, 0, s>>>(keys, out, m);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the row_max kernel one SM holds at once (16-byte copies if vec).
extern "C" int vsc_row_max_occupancy(int device, int vec, int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::RowFold<RowMax>>(
      device, vec, 0, blocks_per_sm);
}

// q [m, d], refs [n, d] f32 row-major on the device; keys is [m] uint32
// scratch, out is [m] f32. `grid` persistent blocks (one wave: SMs x
// vsc_row_max_occupancy, at most the work items); vec selects the 16-byte
// copies (d % 4 == 0, both bases 16-byte aligned).
extern "C" int vsc_row_max(int device, const float* q, const float* refs,
                           int m, int n, int d, int n_valid, int vec,
                           int grid, unsigned* keys, float* out,
                           void* stream) {
  return run_row_max(device, m, n, n_valid, keys, out, stream,
                     [&](cudaStream_t s) {
                       return reduce::launch(q, refs, m, d, n_valid, vec, grid,
                                             reduce::RowFold<RowMax>{{keys}}, 0,
                                             s);
                     });
}

// Blocks of the bf16 kernel one SM holds at once (its grid: SMs x this,
// at most the work items of ops/kernels.py wgmma_items).
extern "C" int vsc_row_max_bf16_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcRowMax>(device, blocks_per_sm);
}

// The bf16 variant: q [m, d] and refs [n, d] bf16 row-major, d % 8 == 0
// (zero pad columns past the data's width) and both bases 16-byte aligned;
// keys is [m] uint32 scratch, out is [m] f32; `grid` persistent blocks.
extern "C" int vsc_row_max_bf16(int device, const __nv_bfloat16* q,
                                const __nv_bfloat16* refs, int m, int n,
                                int d, int n_valid, int grid, unsigned* keys,
                                float* out, void* stream) {
  return run_row_max(device, m, n, n_valid, keys, out, stream,
                     [&](cudaStream_t s) {
                       return wg::launch(q, refs, m, d, n_valid, grid,
                                         TcRowMax{keys, m}, s);
                     });
}

// Blocks of the int8 kernel (tensor cores) one SM holds at once.
extern "C" int vsc_row_max_int8_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<TcRowMax, wg::I8Corpus>(device, blocks_per_sm);
}

// The int8 variant (SQ8 corpus): terms [3, m, d] bf16 (the f32 queries
// split, ops/kernels.py split_bf16x3), codes [n, d] int8 row-major, d a
// multiple of 16 (zero pad columns past the data's width), both bases
// 16-byte aligned, scale [n] f32 (a score is (q . codes[j]) * scale[j]);
// keys, out and `grid` as for vsc_row_max_bf16.
extern "C" int vsc_row_max_int8(int device, const __nv_bfloat16* terms,
                                const int8_t* codes, const float* scale, int m,
                                int n, int d, int n_valid, int grid,
                                unsigned* keys, float* out, void* stream) {
  return run_row_max(device, m, n, n_valid, keys, out, stream,
                     [&](cudaStream_t s) {
                       return wg::launch_int8(terms, codes, scale, m, d, n_valid,
                                              grid, TcRowMax{keys, m}, s);
                     });
}

// Blocks of the f32 L2 kernel one SM holds at once (16-byte copies if vec).
extern "C" int vsc_row_max_l2_occupancy(int device, int vec, int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::L2<reduce::RowFold<RowMax>>>(
      device, vec, 0, blocks_per_sm);
}

// The f32 L2 variant: vsc_row_max's arguments with qs [m] and rs [n] f32
// (the squared norms of the query and corpus rows) after refs; out holds
// each row's best goodness (2 q.r - rs) - qs.
extern "C" int vsc_row_max_l2(int device, const float* q, const float* refs,
                              const float* qs, const float* rs, int m, int n,
                              int d, int n_valid, int vec, int grid,
                              unsigned* keys, float* out, void* stream) {
  return run_row_max(device, m, n, n_valid, keys, out, stream,
                     [&](cudaStream_t s) {
                       return reduce::launch(
                           q, refs, m, d, n_valid, vec, grid,
                           reduce::L2<reduce::RowFold<RowMax>>{{{keys}}, qs, rs},
                           0, s);
                     });
}

// Blocks of the bf16 L2 kernel (tensor cores) one SM holds at once.
extern "C" int vsc_row_max_bf16_l2_occupancy(int device, int* blocks_per_sm) {
  return wg::resident_blocks<wg::L2<TcRowMax>>(device, blocks_per_sm);
}

// The bf16 L2 variant: vsc_row_max_bf16's arguments with qs [m] and rs [n]
// f32 after refs.
extern "C" int vsc_row_max_bf16_l2(int device, const __nv_bfloat16* q,
                                   const __nv_bfloat16* refs, const float* qs,
                                   const float* rs, int m, int n, int d,
                                   int n_valid, int grid, unsigned* keys,
                                   float* out, void* stream) {
  return run_row_max(device, m, n, n_valid, keys, out, stream,
                     [&](cudaStream_t s) {
                       return wg::launch(q, refs, m, d, n_valid, grid,
                                         wg::L2<TcRowMax>{{keys, m}, qs, rs, m}, s);
                     });
}
