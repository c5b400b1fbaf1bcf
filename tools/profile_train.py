#!/usr/bin/env python3
"""Where a training step's time goes on the card: the SSCD step at full
width (ResNet-50, 224 x 224 views, batch 64) and a DnS distillation step
(fg att, 64 pairs of 4 x 9 x 3840), each after two warm-up steps, under
torch.profiler.

    python3 tools/profile_train.py [--steps 3] [--device cuda]

Prints the card's name and power limit; for each trainer the wall
seconds a step (host clock between device syncs, without the profiler and
under it), the device's busy seconds a step (the union of its kernels'
intervals in the trace) and its idle share under the profiler, and the device time by kind of kernel (convolution, matrix
product, elementwise and reductions, optimizer, copies) with the ten
largest kernels. Distillation is timed both as the CLI feeds it (batches
gathered from the synthetic pair corpus on the host and copied in) and on
a batch already on the card. ``--device cpu`` rehearses the script (host
times only).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

KINDS = (  # (kind, substrings of a kernel's name), first match wins
    ("convolution", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop", "winograd",
                     "xmma", "sm90_xmma", "nchw", "nhwc")),
    ("matrix product", ("gemm", "cutlass", "cublas")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise and reductions", ("elementwise", "reduce", "vectorized", "index", "cat",
                                    "softmax", "max", "sum", "norm", "pool")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(dev, step, steps: int) -> dict:
    """``step()`` ``steps`` times, then ``steps`` times more under the
    profiler, after two warm-up calls: wall seconds a step (without and
    with the profiler), the device's busy seconds a step and its idle
    share within the profiled window, device time by kind."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(2):
        step()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync(dev)
    plain = (time.perf_counter() - t0) / steps
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync(dev)
        wall = (time.perf_counter() - t0) / steps
    # The card's kernels and copies; user annotations (an optimizer step's
    # range) span kernels and are left out.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0, None
    for a, b in spans:  # the union of the kernels' intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_kind, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0) + us
        by_name[e.name] = by_name.get(e.name, 0) + us
    busy_s = busy / 1e6 / steps
    out = {"wall_s_per_step": plain, "profiled_wall_s_per_step": wall,
           "device_busy_s_per_step": busy_s if kernels else None,
           "idle_share": 1 - busy_s / wall if kernels else None,
           "device_ms_per_step_by_kind": {k: v / 1e3 / steps for k, v in
                                          sorted(by_kind.items(), key=lambda kv: -kv[1])},
           "top_kernels_ms_per_step": [(n[:90], v / 1e3 / steps) for n, v in
                                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--batch_size", type=int, default=64)
    args = ap.parse_args()

    from vsc2022_torch.device import resolve_device
    from vsc2022_torch.models.sscd import SSCDModel
    from vsc2022_torch.train import cli, dns_distill
    from vsc2022_torch.train.augment import two_views
    from vsc2022_torch.train.sscd_train import create_train_state, make_train_step

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(line.stdout.strip().splitlines()[0] if line.stdout.strip() else "unknown")
        torch.backends.cuda.matmul.allow_tf32 = False
    report = {"device": str(dev), "steps": args.steps}

    size, b = args.image_size, args.batch_size
    rng = np.random.RandomState(0)
    frames = torch.from_numpy((rng.rand(b, size, size, 3) * 255).astype(np.uint8)).to(dev)
    model = SSCDModel()
    state = create_train_state(model, 1e-4, 1e-2, seed=0, device=dev)
    sscd_step = make_train_step(model)
    g = torch.Generator().manual_seed(1)

    def sscd():
        view_a, view_b = two_views(g, frames, size)
        sscd_step(state, {"view_a": view_a, "view_b": view_b})

    report["sscd"] = profile(dev, sscd, args.steps)
    report["sscd"]["frames_per_s"] = b / report["sscd"]["wall_s_per_step"]
    del model, state, sscd_step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    dargs = cli.parser.parse_args(["--objective", "dns_distill", "--synthetic", "64",
                                   "--batch_size", "64", "--checkpoint_out", "-"])
    source = cli.distill_batches(dargs)
    module = dns_distill.build_student_module("fg", "att")
    dstate = dns_distill.create_distill_state(module, 1e-3, seed=0, device=dev)
    dstep = dns_distill.make_distill_step(module, "fg")
    gathers = []

    def distill_cli():
        t0 = time.perf_counter()
        batch = next(source)
        gathers.append(time.perf_counter() - t0)
        dstep(dstate, batch)

    report["distill_cli"] = profile(dev, distill_cli, args.steps)
    report["distill_cli"]["host_gather_s_per_step"] = float(np.mean(gathers[-args.steps:]))
    resident = {k: torch.from_numpy(v).to(dev) for k, v in next(source).items()}
    report["distill_resident"] = profile(dev, lambda: dstep(dstate, resident), args.steps)
    for key in ("distill_cli", "distill_resident"):
        report[key]["pairs_per_s"] = 64 / report[key]["wall_s_per_step"]
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
