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
// with f32 accumulation (similarity.py:271), as the Pallas pool_writer's
// bf16 branch does the pool (pallas_kernels.py:228-230). Bound: operations,
// 2*M*N*D; against the bf16 tensor-core peak (989 TFLOP/s) its share is low
// by design, since it runs the f32 kernel's CUDA-core fmaf chain on the
// widened operands (reduce_gemm.cuh), so its scores equal the f32 kernel's
// on the widened inputs, and those of the other three bf16 kernels, bit for
// bit. The operands move half the bytes; their loads go through registers.
#include "reduce_gemm.cuh"

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

template <class T>
int run_row_max(int device, const T* q, const T* refs, int m, int n, int d,
                int n_valid, int vec, int grid, unsigned* keys, float* out,
                void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fill_blocks = (m + 255) / 256;
  fill_keys<<<fill_blocks, 256, 0, s>>>(keys, m);
  err = reduce::launch(q, refs, m, d, n_valid, vec, grid,
                       reduce::RowFold<RowMax>{{keys}}, 0, s);
  if (err != cudaSuccess) return (int)err;
  keys_to_f32<<<fill_blocks, 256, 0, s>>>(keys, out, m);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the row_max kernel one SM holds at once (16-byte copies if vec).
extern "C" int vsc_row_max_occupancy(int device, int vec, int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::RowFold<RowMax>, float>(
      device, vec, 0, blocks_per_sm);
}

// The same for the bf16 variant (16-byte loads if vec).
extern "C" int vsc_row_max_bf16_occupancy(int device, int vec,
                                          int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::RowFold<RowMax>, __nv_bfloat16>(
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
  return run_row_max(device, q, refs, m, n, d, n_valid, vec, grid, keys, out,
                     stream);
}

// The bf16 variant: q and refs bf16 (d % 8 == 0 and both bases 16-byte
// aligned for vec), the rest as vsc_row_max.
extern "C" int vsc_row_max_bf16(int device, const __nv_bfloat16* q,
                                const __nv_bfloat16* refs, int m, int n,
                                int d, int n_valid, int vec, int grid,
                                unsigned* keys, float* out, void* stream) {
  return run_row_max(device, q, refs, m, n, d, n_valid, vec, grid, keys, out,
                     stream);
}
