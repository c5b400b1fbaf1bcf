#!/usr/bin/env python3
"""The f32 corpus re-search (``SimilaritySearcher._corpus_above`` over an
f32 corpus) at the SSCD path's shape, for one or more trees of the port.

    python3 tools/bench_f32_research.py                      # this tree; one CUDA GPU
    python3 tools/bench_f32_research.py --tree build/old --tree .
    python3 tools/bench_f32_research.py --tree build/old --tree .:65536 --tree .:262144

The shape is ``chip_smoke.py`` phase 4's: 485 re-searched query rows
against 1,000,020 corpus rows at D = 513 (the score-normalized width),
unit-norm random rows made on the card from a seed, τ = 0.17 (about 57
entries a row). Each ``--tree`` (the root of a checkout; an earlier
version unpacked under the gitignored ``build/``) runs in a process of its
own, in turns: A B B A for two trees (A B C C B A for three, ...); a
tree given as ``path:cols`` sets the re-search's columns a call
(``ops/similarity.F32_RESEARCH_COLS``) first. ``--profile`` adds, per run,
one more call under ``torch.profiler``: the device time by kernel name (the
8 largest). Per run: the re-search's ms (CUDA
events around the call, after a warm-up; the median of 5), the entries it
kept, its row max against the f32 ``row_max`` kernel on the same rows
(equal bit for bit where the re-search sums in the kernels' order), and
the scores of the entries. The parent compares the trees' entries: the
same (row, column) set, and how many scores differ. The last lines are the
card's name and power limit and one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROWS, CORPUS, DIM, TAU, REPS = 485, 1_000_020, 513, 0.17, 5


def device_kernels(torch, fn, top: int = 8) -> list:
    """[(kernel name, calls, device ms)] of one fn() under torch.profiler,
    the ``top`` largest by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, getattr(e, "device_time_total", 0.0) / 1e3)
            for e in prof.key_averages() if getattr(e, "device_time_total", 0.0) > 0]
    return sorted(rows, key=lambda r: -r[2])[:top]


def child(spec: str, out: str, profile: bool = False) -> None:
    tree, _, cols = spec.partition(":")
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from vsc2022_torch.ops import kernels, similarity
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    if cols:
        similarity.F32_RESEARCH_COLS = int(cols)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    refs = torch.randn((CORPUS, DIM), generator=g, device=dev)
    refs /= refs.norm(dim=1, keepdim=True)
    q = torch.randn((ROWS, DIM), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    searcher = SimilaritySearcher(refs.cpu().numpy(), device=dev)
    del refs
    staged = searcher._refs[: searcher.n_refs]
    times = []
    for i in range(REPS + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        s, rr, cc = searcher._corpus_above(q, TAU, 0)
        end.record()
        end.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    rmax = kernels.row_max(q, staged, searcher.n_refs)
    keep = s >= TAU
    order = torch.argsort(rr[keep] * CORPUS + cc[keep])
    entries = {"rows": rr[keep][order].cpu().numpy(), "cols": cc[keep][order].cpu().numpy(),
               "scores": s[keep][order].cpu().numpy()}
    # The row max of the re-search's scores: every row keeps its best entry.
    best = torch.full((ROWS,), float("-inf"), device=dev).scatter_reduce(
        0, rr, s, "amax")
    np.savez(out, **entries)
    kernels_ms = (device_kernels(torch, lambda: searcher._corpus_above(q, TAU, 0))
                  if profile else None)
    print(json.dumps({
        "tree": spec, "ms": sorted(times)[len(times) // 2], "ms_all": times,
        "entries": int(keep.sum()), "rows_with_entries": int((best > TAU).sum()),
        "row_max_equal": bool(torch.equal(best[best > TAU], rmax[best > TAU])),
        "kernels": kernels_ms,
    }))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", help="a checkout's root (repeatable)")
    ap.add_argument("--profile", action="store_true",
                    help="add each run's device time by kernel (torch.profiler)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.out, args.profile)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    trees = args.tree or ["."]
    order = trees + trees[::-1] if len(trees) > 1 else trees
    os.makedirs("build", exist_ok=True)
    runs, outs = [], {}
    for i, tree in enumerate(order):
        out = os.path.abspath(f"build/f32_research_{i}.npz")
        proc = subprocess.run([sys.executable, __file__, "--child", tree, "--out", out]
                              + (["--profile"] if args.profile else []),
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
        outs.setdefault(tree, out)
    compare = {}
    a = np.load(outs[trees[0]])
    for tree in trees[1:]:  # each against the first
        b = np.load(outs[tree])
        same_set = (a["rows"].shape == b["rows"].shape and np.array_equal(a["rows"], b["rows"])
                    and np.array_equal(a["cols"], b["cols"]))
        compare[tree] = {"same_entries": bool(same_set),
                         "scores_differ": int((a["scores"] != b["scores"]).sum())
                         if same_set else None}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())
    except OSError:
        print("nvidia-smi: not found")
    print(json.dumps({"shape": [ROWS, CORPUS, DIM], "tau": TAU, "runs": runs,
                      "compare": compare}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
