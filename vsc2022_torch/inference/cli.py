#!/usr/bin/env python3
"""Descriptor inference CLI on the PyTorch/CUDA port (counterpart of
``vsc2022_tpu/inference/cli.py``).

    python -m vsc2022_torch.inference.cli --baseline sscd \\
        --torchscript_path sscd.torchscript.pt --dataset_path videos/ \\
        --output_file descriptors.npz [--compute_dtype bfloat16] [--fold_bn]

The JAX CLI's flags, choices and defaults, plus ``--device {cuda,cpu}``;
``--accelerator`` takes ``cpu``, ``cuda`` and ``tpu`` (``tpu`` and
``cuda`` select the card), and the card is the default. ``--baseline``
picks the model (SSCD ResNet-50 → 512, DINO ViT-S/16 → 768, the DnS
L3-iMAC extractor → 9·3840 region features, flattened), and its weights
come from ``--checkpoint_path`` (the JAX package's npz variable trees,
``utils/checkpoint.py``) or ``--torchscript_path`` (a TorchScript file's
state dict under the JAX package's key rules; SSCD and DINO). With
neither, the model is initialized from a seed with Flax's distributions
and a warning says the descriptors mean nothing.

Distribution: each worker owns its device and writes its shard of the
videos (``--distributed_rank`` / ``--distributed_size``, merged
afterwards), the reference's share-nothing scheme; ``--processes N``
spawns N local CPU workers and merges their outputs. A multi-host job
(``--coordinator host:port --num_processes N --process_id i``, one
process a host or a card) joins a ``torch.distributed`` group (NCCL on
cards, gloo on the CPU; ``vsc2022_torch.parallel.initialize_distributed``),
and each process takes the videos at ``index % N == i`` on its device
(``cuda`` is the card ``i % device_count``) and writes them to its own
``--output_file``; ``merge_feature_files`` merges the shards.
"""

import argparse
import enum
import logging
import multiprocessing
import os
import sys
import tempfile
import time
from functools import partial

import torch

from vsc2022_torch.device import add_device_flags, resolve_device
from vsc2022_torch.inference.transforms import InferenceTransforms

logger = logging.getLogger("inference")


class VideoReaderType(enum.Enum):
    FFMPEG = enum.auto()


class Baseline(enum.Enum):
    SSCD = enum.auto()
    DNS = enum.auto()
    DINO = enum.auto()


parser = argparse.ArgumentParser()
inference_parser = parser.add_argument_group("Inference")
inference_parser.add_argument(
    "--baseline", default="sscd", choices=[x.name.lower() for x in Baseline]
)
inference_parser.add_argument(
    "--checkpoint_path", default=None,
    help="npz variable tree (the JAX package's layout) for the selected model",
)
inference_parser.add_argument(
    "--torchscript_path", default=None,
    help="TorchScript weights for the selected model (SSCD or DINO)",
)
inference_parser.add_argument("--batch_size", type=int, default=32)
inference_parser.add_argument(
    "--fold_bn", action="store_true",
    help="Fold BatchNorm affines into the conv weights before inference "
    "(ResNet-family baselines). Descriptors match the unfolded model to "
    "float32 roundoff.",
)
inference_parser.add_argument(
    "--compute_dtype", choices=["float32", "bfloat16"], default="float32",
    help="bfloat16 runs the forward in bf16 (parameters and images); "
    "descriptors are stored as float32 (or fp16 with --store_fp16) either "
    "way, at bf16 resolution.",
)
inference_parser.add_argument("--distributed_rank", type=int, default=0)
inference_parser.add_argument("--distributed_size", type=int, default=1)
inference_parser.add_argument("--processes", type=int, default=1)
inference_parser.add_argument(
    "--transforms",
    choices=[x.name for x in InferenceTransforms],
    default="RESIZE_320_CENTER",
)
add_device_flags(inference_parser)
inference_parser.add_argument("--output_file", required=True)
inference_parser.add_argument("--scratch_path", required=False)
inference_parser.add_argument("--store_fp16", action="store_true")
inference_parser.add_argument(
    "--profile_dir", default=None,
    help="Write a torch.profiler trace of the extraction run.",
)
inference_parser.add_argument(
    "--resume", action="store_true",
    help="Skip videos already present in this worker's output file and "
    "append only the missing ones (per-video checkpointing).",
)

multihost_parser = parser.add_argument_group(
    "Multi-host",
    "Run one process per host (or card) and let torch.distributed connect "
    "them; the video shard follows process_id % num_processes, and each "
    "process writes its own --output_file.",
)
multihost_parser.add_argument(
    "--coordinator", default=None,
    help="coordinator address host:port (rank 0's torch.distributed rendezvous)",
)
multihost_parser.add_argument(
    "--num_processes", type=int, default=1,
    help="total number of processes in the job",
)
multihost_parser.add_argument(
    "--process_id", type=int, default=0,
    help="this process's index in [0, num_processes)",
)

dataset_parser = parser.add_argument_group("Dataset")
dataset_parser.add_argument("--dataset_path", required=True)
dataset_parser.add_argument("--fps", default=1, type=float)
dataset_parser.add_argument("--video_extensions", default="mp4")
dataset_parser.add_argument(
    "--video_reader", choices=[x.name for x in VideoReaderType], default="FFMPEG"
)
dataset_parser.add_argument("--ffmpeg_path", default="ffmpeg")
dataset_parser.add_argument(
    "--reference_compat_timestamps", action="store_true",
    help="Stamp every sampled frame with a 1-second span regardless of "
    "--fps, reproducing the reference reader bit-for-bit (it hardcodes "
    "1 s spans; only correct at fps=1). Default: spans scale with --fps.",
)


class _Flatten(torch.nn.Module):
    """L3-iMAC's [N, 9, 3840] region features as [N, 9·3840] rows, the
    2-D npz layout."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self.model(images)
        return out.reshape(out.shape[0], -1)


def build_model(args) -> torch.nn.Module:
    """The --baseline model on the host, with its weights (folded with
    --fold_bn): SSCD → [N, 512], DINO → [N, 768], DnS (L3-iMAC) →
    [N, 9·3840]."""
    from vsc2022_torch import convert
    from vsc2022_torch.models.dns import L3iMACExtractor
    from vsc2022_torch.models.fold import fold_batchnorm
    from vsc2022_torch.models.init import init_flax_like
    from vsc2022_torch.models.sscd import SSCDModel
    from vsc2022_torch.models.vit import DinoViT
    from vsc2022_torch.utils.checkpoint import load_variables

    baseline = Baseline[args.baseline.upper()]
    fold_bn = getattr(args, "fold_bn", False)
    if baseline == Baseline.SSCD:
        model = SSCDModel(fold_bn=fold_bn)
    elif baseline == Baseline.DINO:
        if fold_bn:
            raise ValueError("--fold_bn applies to ResNet-family "
                             "baselines only (DINO has no BatchNorm)")
        model = DinoViT()
    else:
        model = L3iMACExtractor(fold_bn=fold_bn)

    state = None
    if args.checkpoint_path:
        from_jax = {Baseline.SSCD: convert.sscd_from_jax,
                    Baseline.DINO: convert.dino_vit_from_jax,
                    Baseline.DNS: convert.l3imac_from_jax}[baseline]
        state = from_jax(load_variables(args.checkpoint_path))
    elif args.torchscript_path:
        if baseline == Baseline.DNS:
            raise ValueError(
                "DnS extractor conversion requires --checkpoint_path "
                "(an npz variable tree)"
            )
        state = convert.load_torchscript_state(args.torchscript_path)
        state = (convert.dino_vit_from_torch(state) if baseline == Baseline.DINO
                 else convert.sscd_from_torch(state))
    if state is None:
        logger.warning(
            "No weights given (--checkpoint_path/--torchscript_path); "
            "using random init — descriptors will be meaningless."
        )
        g = torch.Generator().manual_seed(0)
        if isinstance(model, DinoViT):
            model.init_weights(g)
        else:
            init_flax_like(model, g)
    else:
        if fold_bn and any(k.endswith(".running_mean") for k in state):
            # Loaded weights are unfolded; a folded tree loads as it is.
            state = fold_batchnorm(state)
        convert.load_into(model, state)
    if baseline == Baseline.DNS:
        model = _Flatten(model)
    return model.eval()


def _configure_logging() -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            format="%(asctime)s %(levelname)-8s %(message)s",
            level=logging.INFO,
            datefmt="%Y-%m-%d %H:%M:%S",
            stream=sys.stderr,
        )


def _spawned_worker(args, rank, world_size, output_filename):
    """A --processes worker: it dies with the spawner (a SIGKILLed spawner
    must not leave workers running)."""
    from vsc2022_torch.utils.procs import die_with_parent

    die_with_parent()
    _configure_logging()
    worker_process(args, rank, world_size, output_filename)


def worker_process(args, rank, world_size, output_filename) -> dict:
    """One worker: build the model, extract this rank's shard of the
    videos, write it to ``output_filename`` (with --resume, after the
    videos that file already holds). Returns the run's counts and stage
    seconds (also logged)."""
    from vsc2022_torch.inference.pipeline import DescriptorExtractor, VideoDataset
    from vsc2022_torch.inference.video_reader import FFMpegVideoReader
    from vsc2022_torch.storage import load_features, store_features
    from vsc2022_torch.utils.profiling import maybe_profile

    logger.info(f"Starting worker {rank} of {world_size}.")
    device = resolve_device(args.device)
    model = build_model(args)
    reader_factory = partial(
        FFMpegVideoReader,
        required_fps=args.fps,
        ffmpeg_path=args.ffmpeg_path,
        reference_compat_timestamps=getattr(args, "reference_compat_timestamps", False),
    )
    dataset = VideoDataset(
        path=args.dataset_path,
        reader_factory=reader_factory,
        extensions=args.video_extensions.split(","),
        distributed_rank=rank,
        distributed_world_size=world_size,
    )
    done_features = []
    if getattr(args, "resume", False) and os.path.exists(output_filename):
        done_features = load_features(output_filename)
        done_ids = {vf.video_id for vf in done_features}
        dataset.selected_videos = [
            (i, video) for (i, video) in dataset.selected_videos
            if os.path.basename(video).split(".")[0] not in done_ids
        ]
        logger.info("Resuming: %d videos already extracted, %d remaining",
                    len(done_ids), dataset.num_videos())
    extractor = DescriptorExtractor(
        model,
        transform=InferenceTransforms[args.transforms],
        batch_size=args.batch_size,
        compute_dtype=getattr(args, "compute_dtype", "float32"),
        device=device,
    )
    total = dataset.num_videos()
    done = [0]

    def progress():
        done[0] += 1
        if done[0] == total or done[0] % max(1, total // 10) == 0:
            logger.info(f"Worker {rank}: {done[0]} / {total} videos")

    t0 = time.perf_counter()
    with maybe_profile(getattr(args, "profile_dir", None), device):
        vfs = list(extractor.extract(dataset, store_fp16=args.store_fp16,
                                     progress=progress))
    extract_s = time.perf_counter() - t0
    logger.info(f"Storing worker {rank} outputs")
    t0 = time.perf_counter()
    all_features = done_features + vfs
    store_features(output_filename, all_features)
    stats = dict(extractor.last_stats, extract_s=extract_s,
                 store_s=time.perf_counter() - t0)
    logger.info("Worker %d stages: %s", rank,
                " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in stats.items()))
    logger.info(
        f"Wrote worker {rank} features for {len(all_features)} videos "
        f"({len(vfs)} new) to {output_filename}"
    )
    return stats


def main(args):
    """Run the extraction; returns the single worker's stage seconds (None
    when --processes spawns workers)."""
    n_hosts = args.num_processes or 1
    if args.processes > 1 and args.distributed_size > 1:
        raise Exception(
            "Set either --processes (single-machine distributed) or "
            "both --distributed_size and --distributed_rank (arbitrary "
            "distributed)"
        )
    if n_hosts > 1 and (args.processes > 1 or args.distributed_size > 1):
        raise Exception(
            "--num_processes (multi-host) excludes --processes and "
            "--distributed_rank/--distributed_size; pick one distribution "
            "scheme"
        )
    if n_hosts > 1:
        if not args.coordinator:
            raise Exception(
                "--num_processes > 1 requires --coordinator host:port "
                "(the torch.distributed rendezvous address)"
            )
        if not 0 <= args.process_id < n_hosts:
            raise Exception(f"--process_id {args.process_id} out of range [0, {n_hosts})")
    if args.processes > 1 and args.device != "cpu":
        raise Exception(
            "--processes > 1 is a CPU-decode fan-out; a card runs one "
            "process (use --distributed_rank/--distributed_size across cards)"
        )
    success, stats = False, None
    with tempfile.TemporaryDirectory() as tmp_path:
        os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
        scratch = args.scratch_path or tmp_path
        os.makedirs(scratch, exist_ok=True)
        if args.processes > 1:
            logger.info(f"Spawning {args.processes} processes")
            ctx = multiprocessing.get_context("spawn")
            worker_files = [os.path.join(scratch, f"{rank}.npz")
                            for rank in range(args.processes)]
            processes = [
                ctx.Process(target=_spawned_worker,
                            args=(args, rank, args.processes, worker_files[rank]))
                for rank in range(args.processes)
            ]
            try:
                for p in processes:
                    p.start()
                for p in processes:
                    p.join()
                success = all(p.exitcode == os.EX_OK for p in processes)
            finally:
                for p in processes:
                    p.kill()
            if success:
                from vsc2022_torch.inference.pipeline import merge_feature_files

                num = merge_feature_files(worker_files, args.output_file)
                logger.info(f"Features for {num} videos saved to {args.output_file}")
        elif n_hosts > 1:
            # One process of a multi-host job: this process's slice of the
            # videos, to its own output (merge the shards afterwards).
            from vsc2022_torch.parallel.mesh import initialize_distributed, shutdown_distributed

            logger.info(f"Joining distributed job as process {args.process_id} of "
                        f"{n_hosts} (coordinator: {args.coordinator})")
            initialize_distributed(args.coordinator, n_hosts, args.process_id,
                                   device=args.device)
            try:
                stats = worker_process(args, args.process_id, n_hosts, args.output_file)
            finally:
                shutdown_distributed()
            success = True
        else:
            stats = worker_process(args, args.distributed_rank, args.distributed_size,
                                   args.output_file)
            success = True

    if not success:
        logger.error("Inference FAILED!")
        raise SystemExit(1)
    logger.info("Inference succeeded.")
    return stats


if __name__ == "__main__":
    _configure_logging()
    main(parser.parse_args())
