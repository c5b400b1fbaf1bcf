#!/usr/bin/env python3
"""Times the port's bf16 DnS chamfer (chamfer.bf16) at the shapes the DnS
path gives it, beside the f32 chamfer, its plain version, one library call
and its bound.

    python3 tools/bench_chamfer.py              # needs one CUDA GPU
    python3 tools/bench_chamfer.py --reps 10 --ptxas

The shapes are the 9 chamfer calls [B, NQ, NR] of `chip_smoke.py` phase
5's DnS path (its `chamfer calls` line), at D = 512 with 9 regions, on
unit-norm region rows made on the card from a seed and rounded to bf16
(symmetric, as the path). For each shape: chamfer.bf16 within
chip_smoke.BF16_TC_ATOL of its plain version (the widened f32 chamfer),
then the kernel, the f32 chamfer on the same rows widened (``f32_ms``), the
plain version, the library call (one bf16 ``torch.bmm`` with f32 output,
amax and mean: chip_smoke.chamfer_library) and the bound (chip_smoke
.chamfer_bound: operations at the bf16 tensor-core peak), and the sums over
the 9 shapes. The kernel's plan (kernels.chamfer_bf16_plan: items,
resident or streamed, grid) and its resources (resident blocks per SM,
registers, local bytes a thread) are printed where the tree has them;
``--ptxas`` also compiles chamfer_bf16.cu alone with ``-Xptxas -v`` and
prints the compiler's report (registers, spills). The last lines are the
card's name and power limit and one JSON object with every shape's
numbers.

Copied into a tree of an earlier commit (beside its vsc2022_torch/ and
chip_smoke.py, e.g. under build/), it times that tree's kernels, skipping
what the tree lacks: the parent and the change can share one call, in
turns.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# [B, NQ, NR] of the DnS path's chamfer calls (chip_smoke.py phase 5).
SHAPES = [
    (6, 32, 64), (11, 32, 128), (5, 64, 32), (14, 64, 64), (86, 64, 128),
    (9, 128, 32), (68, 128, 64), (256, 128, 128), (45, 128, 128),
]
D = 512


def ptxas_report(_build) -> None:
    """chamfer_bf16.cu compiled alone with -Xptxas -v: its report."""
    out = _build.BUILD_DIR / "ptxas_chamfer_bf16.o"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(_build.CSRC / "chamfer_bf16.cu"), "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    print(f"[ptxas chamfer_bf16.cu, rc {proc.returncode}]\n{proc.stdout.rstrip()}",
          flush=True)


def resources(kernels, dev) -> dict:
    """Resident blocks per SM, registers and local bytes a thread (trees
    that export them)."""
    if not hasattr(kernels, "CHAMFER_MAX_SLOTS"):
        return {}
    blocks, regs, local = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = kernels._build.library().vsc_chamfer_bf16_attributes(
        dev.index, kernels.CHAMFER_MAX_SLOTS, ctypes.byref(blocks), ctypes.byref(regs),
        ctypes.byref(local))
    if rc != 0:
        return {}
    return {"blocks_per_sm": blocks.value, "registers": regs.value,
            "local_bytes": local.value}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5, help="timed launches per shape")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's report for chamfer_bf16.cu")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from vsc2022_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.ptxas:
        ptxas_report(_build)
    _build.library()
    res = resources(kernels, dev)
    if res:
        print(f"chamfer.bf16 resources: {json.dumps(res)}", flush=True)
    lib_kw, lib_what = cs.chamfer_library_bf16_kw(torch, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fields = ("ms", "f32_ms", "plain_ms", "library_ms", "bound_ms")
    total = dict.fromkeys(fields, 0.0)
    rows = []
    for b, nq, nr in SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(b * 10_000 + nq * 100 + nr)
        qf = torch.randn((b, nq, 9, D), generator=g, device=dev)
        rf = torch.randn((b, nr, 9, D), generator=g, device=dev)
        qb = (qf / qf.norm(dim=3, keepdim=True)).to(torch.bfloat16)
        rb = (rf / rf.norm(dim=3, keepdim=True)).to(torch.bfloat16)
        del qf, rf
        qw, rw = qb.float(), rb.float()
        err = float((kernels.chamfer_fine_sims(qb, rb, True)
                     - kernels.chamfer_fine_sims_plain(qb, rb, True)).abs().max())
        cs.check(err <= cs.BF16_TC_ATOL, f"chamfer.bf16 [{b}, {nq}, {nr}]: err {err}")
        row = {"shape": [b, nq, nr, D], "max_abs_err": err}
        row["ms"] = cs.cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qb, rb, True),
                               args.reps)
        row["f32_ms"] = cs.cuda_ms(torch, lambda: kernels.chamfer_fine_sims(qw, rw, True),
                                   args.reps)
        row["plain_ms"] = cs.cuda_ms(
            torch, lambda: kernels.chamfer_fine_sims_plain(qb, rb, True), 2)
        row["library_ms"] = cs.cuda_ms(
            torch, lambda: cs.chamfer_library(torch, qb, rb, True, **lib_kw), 2)
        row["bound_ms"], row["bound_by"] = cs.chamfer_bound(b, nq, nr, D, bf16=True)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if hasattr(kernels, "chamfer_bf16_plan"):
            row["plan"] = kernels.chamfer_bf16_plan(b, nq, nr, D, sms)._asdict()
        for k in fields:
            total[k] += row[k]
        rows.append(row)
        print(f"chamfer.bf16 [B={b}, NQ={nq}, NR={nr}, D={D}]: kernel {row['ms']:.3f} ms "
              f"({100 * row['share_of_bound']:.1f}% of the bound {row['bound_ms']:.3f}), "
              f"f32 chamfer {row['f32_ms']:.3f}, plain {row['plain_ms']:.3f}, library "
              f"{row['library_ms']:.3f} ({lib_what}); max abs err {err:.3g}"
              + (f"; plan {json.dumps(row['plan'])}" if "plan" in row else ""), flush=True)
        del qb, rb, qw, rw
        torch.cuda.empty_cache()
    print(f"chamfer.bf16 all {len(SHAPES)} shapes: kernel {total['ms']:.3f} ms "
          f"({100 * total['bound_ms'] / total['ms']:.1f}% of the bound "
          f"{total['bound_ms']:.3f}), f32 chamfer {total['f32_ms']:.3f}, plain "
          f"{total['plain_ms']:.3f}, library {total['library_ms']:.3f}")
    print(cs.nvidia_smi_line())
    print(json.dumps({"shapes": rows, "total": total, "resources": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
