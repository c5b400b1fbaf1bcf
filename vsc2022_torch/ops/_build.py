"""Build and load the hand kernels of ``ops/csrc`` (CUDA C++ for sm_90a).

Each ``*.cu`` source compiles to an object with its own ``nvcc`` (all
started together), the objects link into one shared library with a
plain C interface, and ``ctypes`` loads it. The library lands under
``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so the first use after any source change rebuilds
and every later use loads the cached file. Nothing here runs at import
time: the CPU-only test environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the hand "
        "kernels are built from vsc2022_torch/ops/csrc at first use"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvsc_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the library for them exists; returns
    its path. ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    report (registers, shared memory, spills) for each source."""
    out = library_path()
    if out.is_file() and not verbose:
        return out
    nvcc = _nvcc()
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        failed = []
        for src, proc in zip(sources, procs):
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log.rstrip()}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: concurrent builds agree
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    argtypes = {
        "pool_writer": [i, p, p, i, i, i, i, p, p, p],
        "row_max": [i, p, p, i, i, i, i, i, i, p, p, p],
        "row_max_occupancy": [i, i, p],
        "count_above": [i, p, p, i, i, i, f, i, i, i, p, p],
        "count_above_occupancy": [i, i, p],
        "fused_topk": [i, p, p, i, i, i, i, i, i, i, i, p, p, p],
        "fused_topk_occupancy": [i, i, p],
    }
    # The bf16 kernels, all on the tensor-core product of wgmma_gemm.cuh,
    # take no copy width; fused_topk's takes its sets' placement (and, for
    # its occupancy, κ), pool_writer's a grid. scores_bf16 writes the
    # product out; scores_above_bf16, the re-search's, takes a floor per
    # row and a 64-bit capacity.
    argtypes["row_max_bf16"] = [i, p, p, i, i, i, i, i, p, p, p]
    argtypes["count_above_bf16"] = [i, p, p, i, i, i, f, i, i, p, p]
    argtypes["pool_writer_bf16"] = [i, p, p, i, i, i, i, i, p, p, p]
    argtypes["fused_topk_bf16"] = [i, p, p, i, i, i, i, i, i, i, i, p, p, p]
    argtypes["scores_bf16"] = [i, p, p, i, i, i, i, i, p, p]
    argtypes["scores_above_bf16"] = [i, p, p, p, i, i, i, i, i, l, p, p, p, p, p]
    for name in ("row_max", "count_above", "pool_writer", "scores", "scores_above"):
        argtypes[f"{name}_bf16_occupancy"] = [i, p]
    argtypes["fused_topk_bf16_occupancy"] = [i, i, i, p]
    # Their blocks' dynamic shared memory (bytes), for chip_smoke.py's plans.
    argtypes["count_above_bf16_smem_bytes"] = []
    argtypes["pool_writer_bf16_smem_bytes"] = []
    argtypes["fused_topk_bf16_smem_bytes"] = [i, i]
    # The int8 (SQ8) kernels, on the same tensor-core product, take the
    # split query terms [3, M, D] (bf16), int8 codes and their f32 scales,
    # and otherwise the arguments of their bf16 kernels.
    argtypes["row_max_int8"] = [i, p, p, p, i, i, i, i, i, p, p, p]
    argtypes["count_above_int8"] = [i, p, p, p, i, i, i, f, i, i, p, p]
    argtypes["fused_topk_int8"] = [i, p, p, p, i, i, i, i, i, i, i, i, p, p, p]
    argtypes["pool_writer_int8"] = [i, p, p, p, i, i, i, i, i, p, p, p]
    argtypes["scores_int8"] = [i, p, p, p, i, i, i, i, i, p, p]
    argtypes["scores_above_int8"] = [i, p, p, p, p, i, i, i, i, i, l, p, p, p, p, p]
    for name in ("row_max", "count_above", "pool_writer", "scores", "scores_above"):
        argtypes[f"{name}_int8_occupancy"] = [i, p]
    argtypes["fused_topk_int8_occupancy"] = [i, i, i, p]
    # The L2 variants (metric="L2", f32 and bf16): their IP kernel's
    # arguments with the squared norms of the query rows and of the corpus
    # rows (two f32 pointers) after refs, and their own occupancy.
    for name in ("row_max", "count_above", "pool_writer", "fused_topk", "row_max_bf16",
                 "count_above_bf16", "pool_writer_bf16", "fused_topk_bf16",
                 "scores_above_bf16"):
        ip = argtypes[name]
        argtypes[name + "_l2"] = ip[:3] + [p, p] + ip[3:]
        if name != "pool_writer":
            argtypes[name + "_l2_occupancy"] = argtypes[name + "_occupancy"]
    # The block-subset variants of count_above and fused_topk (IP): their
    # full-corpus kernel's arguments with the block list (ids, count,
    # col_block) after n_valid, and their own occupancy.
    for name in ("count_above", "count_above_bf16", "count_above_int8", "fused_topk",
                 "fused_topk_bf16", "fused_topk_int8"):
        full = argtypes[name]
        # n_valid follows tau in count_above; seven arguments follow it in fused_topk.
        at = full.index(f) + 2 if name.startswith("count") else len(full) - 7
        argtypes[name + "_blocks"] = full[:at] + [p, i, i] + full[at:]
        argtypes[name + "_blocks_occupancy"] = argtypes[name + "_occupancy"]
    argtypes["chamfer"] = [i, p, p, i, i, i, i, i, i, p, p]
    # The bf16 chamfer (tensor cores) takes the same arguments, and its
    # plan's grid and ref slices (kernels.chamfer_bf16_plan) before out.
    argtypes["chamfer_bf16"] = [i, p, p, i, i, i, i, i, i, i, i, p, p]
    argtypes["chamfer_bf16_attributes"] = [i, i, p, p, p]
    argtypes["chamfer_bf16_smem_bytes"] = [i]
    for name, types in argtypes.items():
        fn = getattr(lib, f"vsc_{name}")
        fn.argtypes = types
        fn.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib
