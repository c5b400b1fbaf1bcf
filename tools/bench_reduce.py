#!/usr/bin/env python3
"""Times the port's row_max, count_above, fused_topk and pool_writer
kernels (and, with --int8, scores.int8) at the shapes its paths give them,
beside their bound and one PyTorch library call.

    python3 tools/bench_reduce.py             # needs one CUDA GPU
    python3 tools/bench_reduce.py --reps 5 --only row_max
    python3 tools/bench_reduce.py --int8 [--only scores]

Inputs are unit-norm random rows made on the card from a seed, with the
paths' widths (D = 511 after score normalization's dimension drop, 512
with the bias column, 1024 and 1025 on the DnS track) and the corpus
zero-padded to whole 128-row segments as the searcher stages it. For each
shape: the kernel against the library call (row max and top-κ values
within 1e-5, counts within 2), the first 256 rows bit-identical to the
pool_writer kernel's winners (row_max: the best one; fused_topk: all κ,
ids included), then kernel, library and bound ms. Builds the kernels
first and prints nvcc's register and spill report, each kernel's resident
blocks per SM, and fused_topk's grid and pieces (S) per shape. The last
lines are the card's name and power limit and one JSON object with every
shape's numbers. `chip_smoke.py` measures the same kernels on the paths'
own inputs.

``--bf16`` times the bf16 variants instead, on the same rows rounded to
bf16, beside the f32 kernel on the widened rows (``f32_ms``). All four run
on the tensor-core product of wgmma_gemm.cuh, on a corpus staged as the
searcher stages it (kernels.pad_columns) with the queries padded inside
the timed call: within chip_smoke.BF16_TC_ATOL of the f32 kernel (counts
within 2), and on the first 256 rows bit for bit against each other
(chip_smoke.pool_identity on every kernel's inputs, and
chip_smoke.stream_pair_identity on fused_topk's). fused_topk.bf16 is timed
with its kappa-sets in shared memory (the searcher's placement at κ = 32:
``ms``) and in its output (``ms_output_sets``). The library call is a
cuBLAS bf16 ``torch.matmul`` plus the same reduction, and the bound takes
the bf16 tensor-core peak and 2-byte operands. The tensor-core plans
(grid, group, S, corpus passes) are printed.

``--int8`` times the int8 (SQ8) variants instead: f32 queries against the
same rows quantized on the card (int8 codes padded to 16 columns, one f32
scale a row), the four of them and scores.int8 (the dense product, the
reference of the re-search's scores_above.int8, which
tools/bench_scores_above.py --int8 times) at the row chunks the int8
re-search once took (128 rows at SSCD, 512 at serving, the DnS search's
1,662 re-searched rows, and 134 and 559). All run on the tensor-core
product of wgmma_gemm.cuh with the int8 corpus policy (the queries split
into three exact bf16 terms, three passes over the codes widened in
shared memory). Each is timed beside the f32 kernel on the widened codes
(``f32_ms``, the f32 CUDA-core chain the int8 kernels ran on before;
scores.int8 has none), the bf16 kernel on the widened codes and the
queries rounded to bf16 (``bf16_ms``: one pass where int8 takes three)
and chip_smoke.py's library yardstick (cuBLAS f32 over the codes widened
in the timed call, times the scales), within chip_smoke.FLOAT_ATOL of it
(counts within 2); on the first 256 rows they are held bit for bit
against each other (chip_smoke.pool_identity) and, with every scale 1
and bf16-exact queries, against their bf16 kernels
(chip_smoke.unit_scale_identity). The bound is the 3-pass one: 3 x
2*M*N*D at the bf16 tensor-core peak, against 4-byte queries, 1-byte
codes and 4-byte scales; each kernel's resident blocks per SM and grid
are printed.

Copied into a tree of the parent commit (beside its vsc2022_torch/ and
chip_smoke.py), it times that tree's kernels, skipping the occupancy and
plan reports and the checks that tree lacks: parent and change can share
one call. Which bf16 variants run on the tensor cores is the kernels
module's TENSOR_CORE_KERNELS; the parent's pool_writer.bf16, on the CUDA
cores, is held bit for bit against the f32 kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# (kernel, path, query rows, valid ref rows, D)
SHAPES = [
    ("row_max", "sscd", 9000, 250_020, 511),
    ("row_max", "dns", 7682, 7_248, 1024),
    ("row_max", "serving", 9000, 60_000, 511),
    ("count_above", "sscd", 894, 1_000_020, 512),
    ("count_above", "dns", 7682, 31_004, 1025),
    ("count_above", "serving", 9000, 240_000, 512),
    ("count_above", "serving, one video", 60, 240_000, 512),
    ("fused_topk", "serving", 9000, 240_000, 512),
    ("fused_topk", "dns", 7682, 31_004, 1025),
    ("fused_topk", "serving, one video", 60, 240_000, 512),
    ("pool_writer", "sscd", 9000, 1_000_020, 512),
    # scores.int8 (--int8 only): the int8 re-search's former row chunks.
    ("scores", "sscd", 128, 1_000_020, 512),
    ("scores", "serving", 512, 240_000, 512),
    ("scores", "dns", 1662, 31_004, 1025),
    ("scores", "sscd, unrounded chunk", 134, 1_000_020, 512),
    ("scores", "serving, unrounded chunk", 559, 240_000, 512),
]
TAU = 0.15  # ~3.4 sigma of unit-norm scores at D = 512
KAPPA = 32  # the searcher's candidates per query row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="timed launches per shape")
    ap.add_argument("--only", choices=("row_max", "count_above", "fused_topk",
                                       "pool_writer", "scores"),
                    help="time one kernel only (scores: with --int8)")
    dtype = ap.add_mutually_exclusive_group()
    dtype.add_argument("--bf16", action="store_true",
                       help="time the bf16 variants against the f32 kernels")
    dtype.add_argument("--int8", action="store_true",
                       help="time the int8 variants against the f32 kernels")
    args = ap.parse_args()
    if args.only == "scores" and not args.int8:
        ap.error("--only scores times scores.int8: add --int8")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from vsc2022_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(verbose=True)
    lib = _build.library()
    tol = getattr(cs, "BF16_TC_ATOL", getattr(cs, "BF16_ROW_MAX_ATOL", 1e-5))
    _report_plans(torch, cs, kernels, lib, dev, args.bf16, args.int8)

    rows = []
    for name, path, m, n_valid, d in SHAPES:
        if (args.only and name != args.only) or (name == "scores" and not args.int8):
            continue
        if args.int8:
            rows.append(_bench_int8(torch, cs, kernels, name, path, m, n_valid, d,
                                    args.reps))
            continue
        g = torch.Generator(device=dev)
        g.manual_seed(m + n_valid + d)
        q = torch.randn((m, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        r = torch.zeros((-(-n_valid // 128) * 128, d), device=dev)
        r[:n_valid] = torch.randn((n_valid, d), generator=g, device=dev)
        r[:n_valid] /= r[:n_valid].norm(dim=1, keepdim=True)
        if args.bf16:
            q, r = q.to(torch.bfloat16), r.to(torch.bfloat16)
        # The kernels of wgmma_gemm.cuh read the searcher's padded copy.
        tensor_cores = args.bf16 and _on_tensor_cores(kernels, name)
        rk = kernels.pad_columns(r) if tensor_cores else r
        run = _call(kernels, name, q, rk, n_valid)
        lib_call = _library(torch, cs, name, q, r, n_valid)
        label = name + (".bf16" if args.bf16 else "")
        if args.bf16:
            # Against the f32 kernel on the widened rows: bit for bit, or
            # within the tolerance on the tensor cores.
            run_f32 = _call(kernels, name, q.float(), r.float(), n_valid)
            got, want = run(), run_f32()
            if name in ("fused_topk", "pool_writer"):
                got, want = got[0], want[0]
            if tensor_cores:
                err = float((got.double() - want.double()).abs()
                            .nan_to_num(0.0).max())
                cs.check(err <= (2 if name == "count_above" else tol),
                         f"{label} {path}: off the f32 kernel on the widened rows by {err}")
            else:
                cs.check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                         f"{label} {path}: differs from the f32 kernel on the widened rows")
                err = 0.0
        else:
            got, want = run(), lib_call()
            if name in ("fused_topk", "pool_writer"):
                got = got[0]
            err = float((got.double() - want.double()).abs().nan_to_num(0.0).max())
            cs.check(err <= (2 if name == "count_above" else cs.FLOAT_ATOL),
                     f"{name} {path}: off the library by {err}")
        head = q[:256].contiguous()
        if tensor_cores and name == "fused_topk":
            cs.stream_pair_identity(torch, kernels, head, r, n_valid, KAPPA,
                                    f"bench {path}")
        elif tensor_cores and _on_tensor_cores(kernels, "pool_writer"):
            cs.pool_identity(torch, kernels, head, r, n_valid, f"bench {path}")
        elif not tensor_cores:
            _pool_check(torch, cs, kernels, name, head, r, n_valid, path, d)
        kernels.reset_launches()
        ms = cs.cuda_ms(torch, run, args.reps)
        library_ms = cs.cuda_ms(torch, lib_call, 2)
        out_bytes = {"fused_topk": 8 * m * KAPPA,
                     "pool_writer": 16 * m * (r.shape[0] // 128)}.get(name, 4 * m)
        bound_ms, bound_by = cs.bound(m, n_valid, r.shape[0], d, out_bytes,
                                      bf16=args.bf16)
        row = {"kernel": label, "path": path,
               "shape": [m, n_valid, d], "ms": ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms, "max_abs_err": err}
        if args.bf16:
            row["f32_ms"] = cs.cuda_ms(torch, run_f32, args.reps)
        if tensor_cores and name == "fused_topk":
            # The placement the searcher does not take at KAPPA.
            smem_sets = KAPPA > kernels.WGMMA_SMEM_SETS_KAPPA_MAX
            other = _other_placement(kernels, q, rk, n_valid, smem_sets)
            cs.check(all(torch.equal(a, b) for a, b in zip(other(), run())),
                     f"{label} {path}: the two placements of the sets differ")
            row["ms_smem_sets" if smem_sets else "ms_output_sets"] = cs.cuda_ms(
                torch, other, args.reps)
        rows.append(row)
        print(f"{label} {path} [{m} x {n_valid} x {d}]: kernel {ms:.3f} ms, "
              + "".join(f"{key[3:].replace('_', ' ')} {row[key]:.3f} ms, "
                        for key in ("ms_smem_sets", "ms_output_sets") if key in row)
              + (f"f32 kernel {row['f32_ms']:.3f} ms, " if args.bf16 else "")
              + f"library {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound", flush=True)
        del q, r, rk
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line())
    print(json.dumps({"shapes": rows}))
    return 0


def _unit_rows(torch, m, d, g, dev):
    x = torch.randn((m, d), generator=g, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _bench_int8(torch, cs, kernels, name, path, m, n_valid, d, reps):
    """One shape of ``--int8``: the int8 kernel over unit rows quantized on
    the card (rows past n_valid zero codes at scale 0, as the searcher pads
    its corpus), checked, then timed beside the f32 kernel on the widened
    codes, the library yardstick and the bound. Returns its row."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(m + n_valid + d)
    q = _unit_rows(torch, m, d, g, dev)
    n = -(-n_valid // 128) * 128
    codes = torch.zeros((n, kernels.padded_width(d, kernels.I8_ROW_ALIGN)),
                        dtype=torch.int8, device=dev)
    scale = torch.zeros(n, device=dev)
    step = 1 << 17
    for a in range(0, n_valid, step):  # SQ8, a block of rows at a time
        r = _unit_rows(torch, min(step, n_valid - a), d, g, dev)
        sc = r.abs().amax(1) / r.new_tensor(127.0)
        codes[a:a + r.shape[0], :d] = torch.round(r / sc[:, None]).clamp_(-127, 127)
        scale[a:a + r.shape[0]] = sc
    del r
    kw = {"scale": scale}
    run = _call(kernels, name, q, codes, n_valid, **kw)
    lib_call = _library(torch, cs, name, q, codes, n_valid, scale)
    label = name + ".int8"
    got, want = run(), lib_call()
    if name in ("fused_topk", "pool_writer"):
        got = got[0]
    err = float((got.double() - want.double()).abs().nan_to_num(0.0).max())
    cs.check(err <= (2 if name == "count_above" else cs.FLOAT_ATOL),
             f"{label} {path}: off the library by {err}")
    del got, want
    head = q[:256].contiguous()
    cs.pool_identity(torch, kernels, head, codes, n_valid, f"bench {path}", **kw)
    args = {"count_above": (head, codes, TAU, n_valid),
            "fused_topk": (head, codes, n_valid, KAPPA)}.get(name, (head, codes, n_valid))
    cs.unit_scale_identity(torch, kernels, name, args, f"bench {path}")
    torch.cuda.empty_cache()
    grid = 0
    lib = kernels._build.library()
    occupancy = getattr(lib, f"vsc_{name}_int8_occupancy", None)
    if hasattr(kernels, "_int8_grid") and occupancy is not None:
        extra = (1, KAPPA) if len(occupancy.argtypes) == 4 else ()  # fused_topk's sets
        grid = kernels._int8_grid(f"{name}_int8", q, n_valid, *extra)
    ms = cs.cuda_ms(torch, run, reps)
    library_ms = cs.cuda_ms(torch, lib_call, 2)
    out_bytes = {"fused_topk": 8 * m * KAPPA, "pool_writer": 16 * m * (n // 128),
                 "scores": 4 * m * n_valid}.get(name, 4 * m)
    bound_ms, bound_by = cs.bound(m, n_valid, n, d, out_bytes, int8=True)
    row = {"kernel": label, "path": path, "shape": [m, n_valid, d], "ms": ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms, "max_abs_err": err, "grid": grid}
    if name != "scores":  # the f32 re-search is torch.matmul: no f32 kernel
        wide = codes[:, :d].float().contiguous()
        row["f32_ms"] = cs.cuda_ms(torch, _call(kernels, name, q, wide, n_valid), reps)
        del wide
    wide, qb = codes[:, :d].to(torch.bfloat16).contiguous(), q.to(torch.bfloat16)
    row["bf16_ms"] = cs.cuda_ms(torch, _call(kernels, name, qb, wide, n_valid), reps)
    del wide, qb
    print(f"{label} {path} [{m} x {n_valid} x {d}]: kernel {ms:.3f} ms"
          + (f" (grid {grid})" if grid else "") + ", "
          + (f"f32 kernel {row['f32_ms']:.3f} ms, " if "f32_ms" in row else "")
          + f"bf16 kernel {row['bf16_ms']:.3f} ms, "
          + f"library {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.1f}% of the bound", flush=True)
    del q, codes, scale, head
    torch.cuda.empty_cache()
    return row


# The bf16 variants on the tensor cores in a tree whose kernels module
# has no TENSOR_CORE_KERNELS: the parent commit's, where pool_writer.bf16
# alone still ran on the CUDA cores.
PARENT_TENSOR_CORE_KERNELS = ("row_max", "count_above", "fused_topk")


def _on_tensor_cores(kernels, name):
    return name in getattr(kernels, "TENSOR_CORE_KERNELS", PARENT_TENSOR_CORE_KERNELS)


def _report_plans(torch, cs, kernels, lib, dev, bf16, int8=False):
    """Resident blocks per SM of the kernels of reduce_gemm.cuh timed, and
    the tensor-core plans (grid, group, S, corpus passes) at the paths'
    shapes."""
    probe = torch.empty(0, device=dev)
    if int8:
        for name in ("row_max", "count_above", "pool_writer", "fused_topk", "scores",
                     "scores_above"):
            fn = getattr(lib, f"vsc_{name}_int8_occupancy", None)
            if fn is None:
                continue
            blocks = ctypes.c_int(0)
            extra = (1, KAPPA) if len(fn.argtypes) == 4 else ()  # fused_topk's sets
            rc = fn(0, *extra, ctypes.addressof(blocks))
            cs.check(rc == 0, f"{name}.int8 occupancy query failed ({rc})")
            print(f"{name}.int8: {blocks.value} resident blocks per SM", flush=True)
        return
    if bf16 and hasattr(kernels, "wgmma_grid"):
        slots = kernels._wgmma_slots(probe)
        for _, path, m, n_valid, _ in SHAPES[:3]:
            grid = kernels.wgmma_grid(m, n_valid, slots)
            print(f"row_max_bf16 {path}: grid {grid}, group "
                  f"{kernels.WGMMA_GROUP} query tiles, corpus read "
                  f"{kernels.wgmma_corpus_passes(m, n_valid, grid):.2f} times",
                  flush=True)
    if bf16:
        for kernel, path, m, n_valid, _ in SHAPES:
            if kernel == "row_max" or not _on_tensor_cores(kernels, kernel):
                continue
            name = kernel + "_bf16"
            for smem_sets in ((0, 1) if kernel == "fused_topk" else (None,)):
                extra = () if smem_sets is None else (smem_sets, KAPPA if smem_sets else 0)
                group = kernels.WGMMA_SMEM_SETS_GROUP if smem_sets else kernels.WGMMA_GROUP
                grid = kernels.wgmma_grid(m, n_valid,
                                          kernels._wgmma_slots(probe, name, *extra))
                plan = f"{name} {path}: grid {grid}, group {group} query tiles"
                if smem_sets is not None:
                    grid, pieces = kernels.wgmma_topk_grid(m, n_valid, KAPPA, grid, group)
                    plan += (f", sets in {'shared memory' if smem_sets else 'the output'}"
                             f", S = {pieces}")
                print(f"{plan}, corpus read "
                      f"{kernels.wgmma_corpus_passes(m, n_valid, grid, group):.2f} times",
                      flush=True)
    # The kernels of reduce_gemm.cuh timed (no bf16 one runs on it).
    names = () if bf16 else ("row_max", "count_above", "fused_topk")
    for name in names:
        if not hasattr(lib, f"vsc_{name}_occupancy"):
            continue
        for vec in (0, 1):
            blocks = ctypes.c_int(0)
            rc = getattr(lib, f"vsc_{name}_occupancy")(0, vec, ctypes.addressof(blocks))
            cs.check(rc == 0, f"{name} occupancy query failed ({rc})")
            print(f"{name} ({'16' if vec else '4'}-byte copies): "
                  f"{blocks.value} resident blocks per SM", flush=True)


def _pool_check(torch, cs, kernels, name, head, r, n_valid, path, d):
    """The first 256 rows against the pool_writer kernel's winners, bit for
    bit: row_max the best one (within the tolerance for the tensor-core
    row_max.bf16), fused_topk all κ, ids included. The counts are held by
    chip_smoke's phase 2."""
    if name in ("count_above", "pool_writer"):
        return
    pv, pi = kernels.pool_writer(head, r, n_valid)
    if name == "fused_topk":
        want = kernels.ordered_topk(pv.view(head.shape[0], -1),
                                    pi.view(head.shape[0], -1), KAPPA)
        got = kernels.fused_topk(head, r, n_valid, KAPPA)
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{path} [D={d}]: fused_topk differs from pool_writer's winners")
        return
    best = pv.view(head.shape[0], -1).amax(1)
    got = kernels.row_max(head, kernels.pad_columns(r) if head.dtype == torch.bfloat16
                          else r, n_valid)
    if head.dtype == torch.bfloat16:
        cs.check(float((got - best).abs().max()) <= 1e-5,
                 f"{path} [D={d}]: row_max.bf16 off pool_writer's best winner")
    else:
        cs.check(torch.equal(got.view(torch.int32), best.view(torch.int32)),
                 f"{path} [D={d}]: row_max differs from pool_writer's best winner")


def _call(kernels, name, q, r, n_valid, **kw):
    """The kernel's wrapper on (q, r) at the bench's τ and κ; ``kw``: int8
    codes' ``scale``."""
    if name == "row_max":
        return lambda: kernels.row_max(q, r, n_valid, **kw)
    if name == "pool_writer":
        return lambda: kernels.pool_writer(q, r, n_valid, **kw)
    if name == "count_above":
        return lambda: kernels.count_above(q, r, TAU, n_valid, **kw)
    if name == "scores":
        return lambda: kernels.scores(q, r, n_valid, **kw)
    return lambda: kernels.fused_topk(q, r, n_valid, KAPPA, **kw)


def _other_placement(kernels, q, r, n_valid, smem_sets):
    """fused_topk.bf16 on (q, r) at κ = KAPPA with its sets placed as
    given: in shared memory (smem_sets) or in its output."""
    # The parent commit's name of the tensor-core fused_topk helper.
    tc = getattr(kernels, "_fused_topk_tc", None) or kernels._fused_topk_bf16
    return lambda: tc(q, r, n_valid, KAPPA, smem_sets)


def _library(torch, cs, name, q, r, n_valid, scale=None):
    """One PyTorch call per chunk computing the same function (timing
    only): cuBLAS torch.matmul in q's dtype plus the reduction; over int8
    codes (``scale``), f32 over the codes widened in the timed call, times
    the scales."""
    if name == "row_max":
        return lambda: cs.row_max_library(torch, q, r, n_valid, scale)
    if name == "count_above":
        return lambda: cs.count_above_library(torch, q, r, TAU, n_valid, scale)
    if name == "pool_writer":
        return lambda: cs.pool_library(torch, q, r, n_valid, scale)
    if name == "scores":
        d = q.shape[1]
        return lambda: torch.matmul(q, r[:n_valid, :d].float().T) * scale[:n_valid]
    return lambda: cs.topk_library(torch, q, r, n_valid, KAPPA, scale)


if __name__ == "__main__":
    sys.exit(main())
