#!/usr/bin/env python3
"""Descriptor-model training CLI (counterpart of
``vsc2022_tpu/train/cli.py``): SSCD-style self-supervised fine-tuning on
video frames, or DnS student distillation (``--objective dns_distill``).

    python -m vsc2022_torch.train.cli --synthetic 256 --steps 10 \\
        --batch_size 64 --image_size 224 --checkpoint_out sscd.npz
    python -m vsc2022_torch.train.cli --objective dns_distill --student fg \\
        --fg_type att --synthetic 256 --checkpoint_out fg_att.npz

The JAX CLI's flags, plus ``--device`` (``cuda``, the default, raises
where there is no card; ``cuda:N``; ``cpu``). Frames come from a video
directory (host decode, ``--dataset_path``) or ``--synthetic N`` frames
made from ``np.random.RandomState(seed)`` exactly as the JAX CLI makes
them (so are the synthetic distillation pairs), and both views are made
on the device (``train/augment.py``). Checkpoints are the JAX package's
npz trees (``{"params", "batch_stats"}`` for SSCD, the student's
``{"params": ...}``): ``--checkpoint_path`` of the inference CLI and of
``dns_index`` loads them in either package, and ``--init_checkpoint``
takes either package's.

On a machine with several cards, ``--device cuda`` trains data parallel
with one rank a card, started here on localhost (the counterpart of JAX
using every local device): the global batch splits over the ranks, and
rank 0 alone logs and writes the checkpoint. Distillation falls back to
one card where the batch does not divide by the cards, as JAX's does.
"""

from __future__ import annotations

import argparse
import json
import logging
import multiprocessing
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from vsc2022_torch.device import device_flag, resolve_device

logger = logging.getLogger("train")

parser = argparse.ArgumentParser()
parser.add_argument(
    "--objective", choices=["sscd", "dns_distill"], default="sscd",
    help="sscd: self-supervised descriptor training on frames. "
    "dns_distill: train a DnS student to match a teacher's video-pair "
    "similarity (Distill-and-Select).",
)
parser.add_argument("--student", choices=["cg", "fg"], default="fg")
parser.add_argument("--fg_type", choices=["att", "bin"], default="att")
parser.add_argument(
    "--distill_pairs", default=None,
    help="npz with arrays q_regions [N,T,9,3840], r_regions, teacher_sim "
    "[N] — the distillation dataset (teacher similarities precomputed "
    "by any fine-grained model).",
)
parser.add_argument(
    "--frames_per_video", type=int, default=4,
    help="frames per synthetic distillation pair",
)
parser.add_argument("--dataset_path", help="Directory of videos", default=None)
parser.add_argument(
    "--synthetic", type=int, default=0,
    help="Train on N synthetic frames (smoke test / benchmark) instead "
    "of decoding videos.",
)
parser.add_argument("--steps", type=int, default=100)
parser.add_argument("--batch_size", type=int, default=64)
parser.add_argument("--image_size", type=int, default=224)
parser.add_argument("--learning_rate", type=float, default=1e-4)
parser.add_argument("--weight_decay", type=float, default=1e-2)
parser.add_argument("--fps", type=float, default=1.0)
parser.add_argument("--ffmpeg_path", default="ffmpeg")
parser.add_argument(
    "--init_checkpoint", default=None,
    help="npz variable tree to fine-tune from (random init otherwise)",
)
parser.add_argument("--checkpoint_out", required=True)
parser.add_argument("--checkpoint_every", type=int, default=500)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--log_every", type=int, default=10)
parser.add_argument(
    "--device", type=device_flag, default="cuda",
    help="cuda (the default: every card, one rank a card; raises when no "
    "GPU is present), cuda:N (that card alone) or cpu.",
)


def frame_source(args, rank: int = 0, world: int = 1):
    """Yield this rank's uint8 frame batches [B / world, S, S, 3] forever:
    synthetic frames as the JAX CLI draws them (the global batch, sliced),
    or decoded videos (a rank decodes its share of the videos)."""
    size, b = args.image_size, args.batch_size // world
    if args.synthetic:
        rng = np.random.RandomState(args.seed)
        frames = (rng.rand(args.synthetic, size, size, 3) * 255).astype(np.uint8)
        while True:
            idx = rng.randint(0, args.synthetic, size=args.batch_size)
            yield frames[idx[rank * b:(rank + 1) * b]]
    else:
        from functools import partial

        from vsc2022_torch.inference.pipeline import VideoDataset, _prefetch
        from vsc2022_torch.inference.video_reader import FFMpegVideoReader

        dataset = VideoDataset(
            path=args.dataset_path,
            reader_factory=partial(FFMpegVideoReader, required_fps=args.fps,
                                   ffmpeg_path=args.ffmpeg_path),
            distributed_rank=rank, distributed_world_size=world,
        )
        buf = []
        while True:
            for _, frames, _ in _prefetch(dataset.iter_decoded()):
                # Nearest sampling to a uniform square on the host, as JAX.
                n, h, w, _ = frames.shape
                ys = (np.arange(size) * h) // size
                xs = (np.arange(size) * w) // size
                buf.extend(frames[:, ys][:, :, xs])
                while len(buf) >= b:
                    batch = np.stack(buf[:b])
                    del buf[:b]
                    yield batch


def distill_batches(args, rank: int = 0, world: int = 1):
    """Yield this rank's slice of the distillation batches forever (the
    npz file's, or synthetic pairs drawn as the JAX CLI draws them, the
    teacher's similarity the frame chamfer of each pair)."""
    from vsc2022_torch.models.dns import L3_IMAC_DIM, NUM_REGIONS
    from vsc2022_torch.train.dns_distill import _frame_chamfer

    rng = np.random.RandomState(args.seed)
    if args.distill_pairs:
        with np.load(args.distill_pairs) as data:
            q, r, sim = data["q_regions"], data["r_regions"], data["teacher_sim"]
    else:
        n, t = max(args.synthetic, args.batch_size), args.frames_per_video

        def regions(k):
            x = rng.randn(k, t, NUM_REGIONS, L3_IMAC_DIM).astype(np.float32)
            return x / np.linalg.norm(x, axis=-1, keepdims=True)

        q, r = regions(n), regions(n)
        for i in range(0, n, 2):  # half the pairs are noisy copies
            r[i] = q[i] + 0.05 * rng.randn(*q[i].shape).astype(np.float32)
            r[i] /= np.linalg.norm(r[i], axis=-1, keepdims=True)
        with torch.no_grad():
            sim = _frame_chamfer(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    b = args.batch_size // world
    while True:
        idx = rng.randint(0, q.shape[0], size=args.batch_size)[rank * b:(rank + 1) * b]
        yield {"q_regions": q[idx], "r_regions": r[idx], "teacher_sim": sim[idx]}


class _Meter:
    """Per-step losses and rates: the JAX CLI's log lines (its rate from the
    first step's start), and the summary's steady rate from the end of the
    first step (the warm-up) to the end of the last."""

    def __init__(self, args, device: torch.device, unit: str, lead: bool):
        self.args, self.device, self.unit, self.lead = args, device, unit, lead
        self.losses: List[torch.Tensor] = []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            self.base = torch.cuda.memory_allocated(device)
        self.t_start = time.perf_counter()
        self.t_warm = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def record(self, step: int, loss: torch.Tensor) -> None:
        args = self.args
        self.losses.append(loss)
        if step == 1:
            self._sync()
            self.t_warm = time.perf_counter()
        if self.lead and (step % args.log_every == 0 or step == args.steps):
            rate = step * args.batch_size / (time.perf_counter() - self.t_start)
            logger.info("step %d/%d loss %.4f (%.1f %s/s)", step, args.steps,
                        float(loss), rate, self.unit)

    def summary(self, ranks: int) -> dict:
        self._sync()
        end = time.perf_counter()
        args = self.args
        out = {
            "objective": args.objective, "device": str(self.device), "ranks": ranks,
            "steps": args.steps, "batch_size": args.batch_size,
            "losses": [float(x) for x in self.losses], "seconds": end - self.t_start,
            f"{self.unit}_per_s": args.steps * args.batch_size / (end - self.t_start),
            f"steady_{self.unit}_per_s": (
                (args.steps - 1) * args.batch_size / (end - self.t_warm)
                if args.steps > 1 else None),
        }
        if self.device.type == "cuda":
            out["device_name"] = torch.cuda.get_device_name(self.device)
            out["peak_mib"] = (torch.cuda.max_memory_allocated(self.device)
                               - self.base) / 2**20
        if self.lead:
            logger.info("summary %s", json.dumps(out))
        return out


def _checkpoint(args, step: int, lead: bool, tree_fn) -> None:
    from vsc2022_torch.utils.checkpoint import save_variables

    if lead and (step % args.checkpoint_every == 0 or step == args.steps):
        os.makedirs(os.path.dirname(args.checkpoint_out) or ".", exist_ok=True)
        save_variables(args.checkpoint_out, tree_fn())
        logger.info("Checkpoint written to %s", args.checkpoint_out)


def run_distillation(args, device: torch.device, mesh=None) -> dict:
    """Distil a student on ``device`` (one rank of ``mesh`` where given).
    Returns the summary, with the state under "state"."""
    from vsc2022_torch import convert
    from vsc2022_torch.parallel.mesh import process_index
    from vsc2022_torch.train.dns_distill import (
        build_student_module,
        create_distill_state,
        make_distill_step,
    )
    from vsc2022_torch.utils.checkpoint import load_variables

    world = mesh.size if mesh is not None else 1
    rank, lead = process_index(), process_index() == 0
    module = build_student_module(args.student, args.fg_type)
    variables = load_variables(args.init_checkpoint) if args.init_checkpoint else None
    state = create_distill_state(module, args.learning_rate, seed=args.seed,
                                 variables=variables, device=device)
    if variables is not None:
        logger.info("Initialized student from %s", args.init_checkpoint)
    qw = 0.1 if (args.student, args.fg_type) == ("fg", "bin") else 0.0
    step_fn = make_distill_step(module, args.student, quantization_weight=qw, mesh=mesh)
    logger.info("Distilling %s student on %d device(s)",
                args.student if args.student == "cg" else f"fg_{args.fg_type}", world)
    source = distill_batches(args, rank, world)
    meter = _Meter(args, device, "pairs", lead)
    for step in range(1, args.steps + 1):
        state, loss = step_fn(state, next(source))
        meter.record(step, loss)
        _checkpoint(args, step, lead, lambda: convert.dns_student_to_jax(
            module.state_dict(), args.student, args.fg_type))
    return dict(meter.summary(world), state=state)


def run_sscd(args, device: torch.device, mesh=None) -> dict:
    """SSCD training on ``device`` (one rank of ``mesh`` where given).
    Returns the summary, with the state under "state"."""
    from vsc2022_torch import convert
    from vsc2022_torch.models.sscd import SSCDModel
    from vsc2022_torch.parallel.mesh import process_index
    from vsc2022_torch.train.augment import augment, draw_views
    from vsc2022_torch.train.sscd_train import create_train_state, make_train_step
    from vsc2022_torch.utils.checkpoint import load_variables

    world = mesh.size if mesh is not None else 1
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not divide by the "
                         f"{world} ranks")
    rank, lead = process_index(), process_index() == 0
    model = SSCDModel()
    variables = load_variables(args.init_checkpoint) if args.init_checkpoint else None
    state = create_train_state(model, args.learning_rate, args.weight_decay,
                               seed=args.seed, variables=variables, device=device)
    if variables is not None:
        logger.info("Initialized from %s", args.init_checkpoint)
    step_fn = make_train_step(model, mesh)
    logger.info("Training on %d device(s)%s", world,
                f" (mesh {mesh!r})" if world > 1 else "")
    g = torch.Generator().manual_seed(args.seed + 1)
    size, b = args.image_size, args.batch_size // world
    source = frame_source(args, rank, world)
    meter = _Meter(args, device, "frames", lead)
    for step in range(1, args.steps + 1):
        frames = torch.from_numpy(next(source)).to(device)
        draws = [draw_views(g, args.batch_size, size, size).rows(rank * b, (rank + 1) * b)
                 for _ in range(2)]
        state, loss = step_fn(state, {"view_a": augment(frames, draws[0], size),
                                      "view_b": augment(frames, draws[1], size)})
        meter.record(step, loss)
        _checkpoint(args, step, lead, lambda: convert.sscd_to_jax(model.state_dict()))
    return dict(meter.summary(world), state=state)


def _train(args, device: torch.device, mesh=None) -> dict:
    run = run_distillation if args.objective == "dns_distill" else run_sscd
    return run(args, device, mesh)


def _configure_logging(rank: int = 0) -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            format="%(asctime)s %(levelname)-8s %(message)s",
            level=logging.INFO if rank == 0 else logging.WARNING,
            datefmt="%Y-%m-%d %H:%M:%S",
            stream=sys.stderr,
        )
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)


def _rank_main(args, rank: int, devices: List[str], port: int,
               backend: Optional[str] = None) -> None:
    """One data-parallel rank: joins the group on localhost:``port`` and
    trains on ``devices[rank]``."""
    from vsc2022_torch.parallel.mesh import (
        initialize_distributed,
        shutdown_distributed,
        train_mesh,
    )
    from vsc2022_torch.utils.procs import die_with_parent

    die_with_parent()
    _configure_logging(rank)
    dev = initialize_distributed(f"localhost:{port}", len(devices), rank,
                                 backend=backend, device=devices[rank])
    try:
        _train(args, dev, train_mesh(device=dev))
    finally:
        shutdown_distributed()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(args, devices: List[str], backend: Optional[str] = None) -> dict:
    """Train data parallel with one rank process on each of ``devices``
    (started with the spawn method; a rank dies with this process)."""
    logger.info("Training data parallel over %d ranks: %s", len(devices), devices)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(args, rank, devices, port, backend))
             for rank in range(len(devices))]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.pid is not None:  # started
                p.kill()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"training ranks failed: exit codes {codes}")
    return {"ranks": len(devices), "devices": devices}


def _rank_devices(args) -> Optional[List[str]]:
    """One rank a card when ``--device cuda`` meets several cards (and, for
    distillation, the batch divides by them, else one card as JAX);
    otherwise None (one process)."""
    if args.device != "cuda" or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    if args.objective == "dns_distill" and args.batch_size % n:
        logger.info("--batch_size %d does not divide by %d cards: one card",
                    args.batch_size, n)
        return None
    return [f"cuda:{i}" for i in range(n)]


def main(args) -> dict:
    """Train as the flags say. Returns the summary (losses, seconds, rates,
    the device's peak memory), with the state under "state", in one
    process; the ranks' count and devices when it started ranks."""
    if args.objective == "dns_distill":
        if not args.distill_pairs and not args.synthetic:
            raise Exception("Provide --distill_pairs or --synthetic N")
    elif not args.synthetic and not args.dataset_path:
        raise Exception("Provide --dataset_path or --synthetic N")
    devices = _rank_devices(args)
    if devices:
        return _spawn_ranks(args, devices)
    return _train(args, resolve_device(args.device))


if __name__ == "__main__":
    _configure_logging()
    main(parser.parse_args())
