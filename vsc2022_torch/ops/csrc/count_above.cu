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
// 64-deep slices feeding 8 x 8 register tiles. Its scores are pool_writer's
// and fused_topk's bit for bit, which the pooled prune (a row is complete
// when this count equals its kept entries) and the streaming verify rely on.
//
// The bf16 variant (vsc_count_above_bf16) is the count over a bf16 corpus:
// the JAX searcher's streaming_count_above on bf16 operands with f32
// accumulation, which the bf16 pool and candidates are verified with. Bound:
// operations, 2*M*N*D, low against the bf16 tensor-core peak by design: it
// runs the f32 kernel's fmaf chain on the widened operands (reduce_gemm.cuh),
// so it counts exactly the scores the bf16 pool_writer and fused_topk hold.
// At D = 1025 (the DnS coarse corpus with its bias column) the rows start
// only 2-byte aligned and take 2-byte loads.
#include "reduce_gemm.cuh"

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

template <class T>
int run_count_above(int device, const T* q, const T* refs, int m, int n,
                    int d, float tau, int n_valid, int vec, int grid, int* out,
                    void* stream) {
  if (m <= 0) return 0;
  if (n_valid < 0 || n_valid > n) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  err = reduce::launch(q, refs, m, d, n_valid, vec, grid,
                       reduce::RowFold<CountAbove>{{tau, out}}, 0, s);
  return (int)err;
}

}  // namespace

// Blocks of the count_above kernel one SM holds at once (16-byte copies if
// vec).
extern "C" int vsc_count_above_occupancy(int device, int vec,
                                         int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::RowFold<CountAbove>, float>(
      device, vec, 0, blocks_per_sm);
}

// The same for the bf16 variant (16-byte loads if vec).
extern "C" int vsc_count_above_bf16_occupancy(int device, int vec,
                                              int* blocks_per_sm) {
  return reduce::resident_blocks<reduce::RowFold<CountAbove>, __nv_bfloat16>(
      device, vec, 0, blocks_per_sm);
}

// q [m, d], refs [n, d] f32 row-major on the device; out is [m] int32.
// `grid` and `vec` as for vsc_row_max.
extern "C" int vsc_count_above(int device, const float* q, const float* refs,
                               int m, int n, int d, float tau, int n_valid,
                               int vec, int grid, int* out, void* stream) {
  return run_count_above(device, q, refs, m, n, d, tau, n_valid, vec, grid,
                         out, stream);
}

// The bf16 variant: q and refs bf16, the rest as vsc_count_above.
extern "C" int vsc_count_above_bf16(int device, const __nv_bfloat16* q,
                                    const __nv_bfloat16* refs, int m, int n,
                                    int d, float tau, int n_valid, int vec,
                                    int grid, int* out, void* stream) {
  return run_count_above(device, q, refs, m, n, d, tau, n_valid, vec, grid,
                         out, stream);
}
