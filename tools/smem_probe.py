#!/usr/bin/env python3
"""Measures the H100's shared-memory throughput for 16-byte loads (LDS.128)
under the access patterns the row-reduction kernels use.

    python3 tools/smem_probe.py      # needs one CUDA GPU and nvcc

Each pattern gives every lane of a warp a float4 index into shared memory;
two blocks of 1024 threads per SM (64 warps) each issue 4096 volatile
loads per thread, and the result is the SM clocks (clock64 inside the
kernel) per warp-wide load. It shows how the cost depends on the distinct
addresses each quarter-warp (8 lanes) reads, which set the lane layout of
reduce_gemm.cuh's row and column reads.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = r"""
#include <cuda_runtime.h>
extern "C" __global__ void probe(const int* idx_of_lane, int iters,
                                 long long* cycles, float* sink) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned addr = (unsigned)__cvta_generic_to_shared(&buf[idx_of_lane[lane]]);
  float acc = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      float x, y, z, w;
      asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(addr + u * 1024));
      acc += x + y + z + w;
    }
  }
  const long long t1 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  if (acc == 12345.f) sink[0] = acc;
}
extern "C" int run_probe(const int* idx, int iters, int blocks, long long* cycles,
                         float* sink) {
  probe<<<blocks, 1024>>>(idx, iters, cycles, sink);
  cudaError_t e = cudaDeviceSynchronize();
  return (int)e;
}
"""

PATTERNS = {
    # name: float4 index of each lane (a row is 5 float4s: LD = 20 floats)
    "32 distinct, consecutive (512 B)": [l for l in range(32)],
    "all lanes one address (16 B)": [0] * 32,
    "4 rows, one per quarter-warp (row reads, 64 B)": [5 * (l >> 3) for l in range(32)],
    "8 columns, each quarter all 8 (column reads, 128 B)": [5 * (l & 7) for l in range(32)],
    "8 columns, 2 per quarter (interleaved, 128 B)": [5 * ((l & 1) + 2 * (l >> 3)) for l in range(32)],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from vsc2022_torch.ops import _build

    out = REPO / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out / "probe.so"), str(out / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(out / "probe.so"))
    lib.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 2 * sms, 256  # two 1024-thread blocks per SM: 64 warps
    sink = torch.zeros(1, device="cuda")
    for name, idx in PATTERNS.items():
        idx_t = torch.tensor(idx, dtype=torch.int32, device="cuda")
        cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
        rc = lib.run_probe(idx_t.data_ptr(), iters, blocks, cycles.data_ptr(),
                           sink.data_ptr())
        if rc:
            print(f"launch failed: {rc}", file=sys.stderr)
            return 1
        loads_per_warp = iters * 16
        warps_per_sm = 64
        cyc = float(cycles.float().mean())
        per_sm_clock = warps_per_sm * loads_per_warp / cyc  # warp-loads per clock
        print(f"{name}: {1 / per_sm_clock:.2f} SM clocks per warp-wide LDS.128 "
              f"({cyc:.0f} cycles for {loads_per_warp} loads x {warps_per_sm} warps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
