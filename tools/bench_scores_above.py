#!/usr/bin/env python3
"""Where scores_above.bf16's (and scores_above.int8's) time goes at the
re-search's shapes.

    python3 tools/bench_scores_above.py               # needs one CUDA GPU
    python3 tools/bench_scores_above.py --tree build/old --reps 5
    python3 tools/bench_scores_above.py --int8

For the shapes the bf16 paths re-search (serving's ~3,665 rows and its
first 512 over 240,000 corpus rows, the DnS search's 1,668 rows over
31,004 at D = 1,032, SSCD's 480 rows over 1,000,020), on unit-norm random
rows made on the card from a seed and rounded to bf16, with per-row floors
that keep no entry, 2, 68 or 200 a row (the score of that rank: entries
spread over the whole corpus), and 68 a row with one row in eight at
-inf (every entry of those rows): the entries, whether the kernel's set
and scores are those of nonzero(scores.bf16 >= floor) bit for bit, the
kernel alone (back-to-back launches into a capacity that holds them, no
counter read) and the wrapper (``kernels.scores_above``, its one sync
included), both in ms from CUDA events. Beside them, on the same rows:
dense scores.bf16, count_above.bf16 (the same product with a count
epilogue) and ``torch.mm`` with f32 output (the same scores). ``--tree``
times the kernels of a copy of ``vsc2022_torch/`` under another
directory (an earlier version's, copied under the gitignored ``build/``):
each tree builds its own library, so two trees compared in turns in one
call share one card. The last lines are the card's name and power limit
and one JSON object with every number.

``--int8`` times scores_above.int8 instead, the re-search over an int8
(SQ8) corpus: the same shapes (the DnS corpus as codes of 1,040 columns),
f32 unit-norm queries against the corpus rows quantized on the card (int8
codes padded to 16 columns, one f32 scale a row), its entries held
against nonzero(scores.int8 >= floor) bit for bit. Beside it: dense
scores.int8, count_above.int8, the dense route the int8 re-search took
before (scores.int8 over chunks of 512 rows, then nonzero) and the
library's same scores (cuBLAS f32 over the codes widened in the timed
call, times the scales).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# (label, query rows, valid corpus rows, D): the bf16 paths' re-searches.
SHAPES = [
    ("serving", 3665, 240_000, 512),
    ("serving, first 512 rows", 512, 240_000, 512),
    ("DnS", 1668, 31_004, 1032),
    ("SSCD", 480, 1_000_020, 512),
]
# Entries a row the floors keep (None: every row's floor +inf).
DENSITIES = (None, 2, 68, 200)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(REPO),
                    help="directory holding the vsc2022_torch/ to time")
    ap.add_argument("--reps", type=int, default=5, help="timed launches per case")
    ap.add_argument("--int8", action="store_true",
                    help="time scores_above.int8 over SQ8 codes instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from vsc2022_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _build.library()

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    tag = "int8" if args.int8 else "bf16"
    for label, m, n_valid, d in SHAPES:
        n = -(-n_valid // 8192) * 8192  # the staged corpus's rows
        q = torch.randn((m, d), generator=g, device=dev)
        r = torch.randn((n, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        r /= r.norm(dim=1, keepdim=True)
        r[n_valid:] = 0
        if args.int8:  # SQ8 codes (the DnS width 1025 pads to 1,040) and scales
            d = 1025 if d == 1032 else d
            q, r = q[:, :d].contiguous(), r[:, :d]
            scale = r.abs().amax(1) / r.new_tensor(127.0)
            inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
            codes = torch.zeros((n, kernels.padded_width(d, kernels.I8_ROW_ALIGN)),
                                dtype=torch.int8, device=dev)
            codes[:, :d] = torch.round(r * inv[:, None]).clamp_(-127, 127)
            r, kw = codes, {"scale": scale}
            del inv
            operands = (kernels.split_bf16x3(kernels.pad_columns(q, kernels.I8_ROW_ALIGN)),
                        r, scale)
            depth = r.shape[1]
        else:
            q, r = q.bfloat16(), r.bfloat16()
            kw, operands, depth = {}, (q, r), d
        dense = kernels.scores(q, r, n_valid, **kw)
        ranked = torch.topk(dense, max(k for k in DENSITIES if k), dim=1).values
        floors = {f"{k} a row" if k else "none": (ranked[:, k - 1] if k else
                  torch.full((m,), float("inf"), device=dev)).contiguous()
                  for k in DENSITIES}
        floors["68 a row, 1 in 8 at -inf"] = torch.where(
            torch.arange(m, device=dev) % 8 == 0, float("-inf"), ranked[:, 67]).contiguous()
        grid = kernels.wgmma_grid(m, n_valid, kernels._wgmma_slots(q, f"scores_above_{tag}"))
        stream = torch.cuda.current_stream(dev).cuda_stream
        cases = {}
        for name, floor in floors.items():
            rr, cc = torch.nonzero(dense >= floor[:, None], as_tuple=True)
            cap = rr.numel()
            s, gr, gc = kernels.scores_above(q, r, n_valid, floor, capacity=cap, **kw)
            key, order = torch.sort(gr.long() * (1 << 32) + gc.long())
            exact = (s.numel() == cap and torch.equal(key, rr * (1 << 32) + cc)
                     and torch.equal(s[order].view(torch.int32),
                                     dense[rr, cc].view(torch.int32)))
            out = [torch.empty(max(cap, 1), dtype=t, device=dev)
                   for t in (torch.float32, torch.int32, torch.int32)]
            count = torch.empty(1, dtype=torch.int64, device=dev)

            def launch(floor=floor, cap=cap, out=out, count=count):
                rc = getattr(lib, f"vsc_scores_above_{tag}")(
                    dev.index or 0, *(t.data_ptr() for t in operands), floor.data_ptr(),
                    m, n, depth, n_valid, grid, cap, *(t.data_ptr() for t in out),
                    count.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"vsc_scores_above_{tag} failed ({rc})")

            cases[name] = {
                "entries": cap, "exact": bool(exact), "kernel_ms": ms(launch),
                "wrapper_ms": ms(lambda floor=floor, cap=cap: kernels.scores_above(
                    q, r, n_valid, floor, capacity=cap, **kw)),
            }
            del out, rr, cc, s, gr, gc
        row = {
            "shape": label, "m": m, "n_valid": n_valid, "d": d, "cases": cases,
            "dense_scores_ms": ms(lambda: kernels.scores(q, r, n_valid, **kw)),
            "count_above_ms": ms(lambda: kernels.count_above(q, r, 0.1, n_valid, **kw)),
        }
        if args.int8:
            floor = floors["68 a row"]

            def dense_route():  # scores.int8 in chunks of 512 rows, then nonzero
                parts = []
                for a in range(0, m, 512):
                    sc = kernels.scores(q[a:a + 512], r, n_valid, **kw)
                    rr, cc = torch.nonzero(sc >= floor[a:a + 512, None], as_tuple=True)
                    parts.append((sc[rr, cc], rr + a, cc))
                return parts

            row["dense_route_ms"] = ms(dense_route)
            row["library_ms"] = ms(lambda: torch.matmul(q, r[:n_valid, :d].float().T)
                                   * scale[:n_valid])
        else:
            row["mm_f32_out_ms"] = ms(lambda: torch.mm(q, r[:n_valid].T,
                                                       out_dtype=torch.float32))
        print(f"{args.tree} {label} [{m} x {n_valid} x {d}]: {json.dumps(row)}", flush=True)
        rows.append(row)
        del dense, ranked, floors, q, r, operands
        torch.cuda.empty_cache()
    if not all(c["exact"] for row in rows for c in row["cases"].values()):
        print(f"scores_above.{tag} differs from nonzero(scores.{tag} >= floor)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "unknown")
    print(json.dumps({"tree": args.tree, "dtype": tag, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
