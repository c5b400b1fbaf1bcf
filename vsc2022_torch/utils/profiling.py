"""Optional ``torch.profiler`` hook (counterpart of
``vsc2022_tpu/utils/profiling.py``). Any entry point wraps its hot
section:

    with maybe_profile(args.profile_dir, device):
        ...

which writes a chrome trace (trace.json) and a table of the top ops by
self device time (CPU time without a GPU) in summary.txt when a
directory is given, and does nothing otherwise.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


def maybe_profile(profile_dir: Optional[str], device: torch.device):
    if not profile_dir:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    sort_by = "self_cpu_time_total"
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        sort_by = "self_device_time_total"
    os.makedirs(profile_dir, exist_ok=True)

    def export(prof):
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        with open(os.path.join(profile_dir, "summary.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort_by, row_limit=30))

    return torch.profiler.profile(activities=activities, on_trace_ready=export)
