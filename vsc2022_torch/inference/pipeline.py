"""Descriptor extraction engine: host decode → device preprocess and
forward (counterpart of ``vsc2022_tpu/inference/pipeline.py``).

Replaces the reference's torch DataLoader / TorchScript worker loop
(reference: vsc/baseline/inference_impl.py:72-239):

  * Videos are sharded round-robin ``i % world_size == rank`` across
    workers, as the reference shards them (inference_impl.py:105-109).
  * A background thread decodes the next videos into a bounded queue
    while the device runs the current batch.
  * Batches are fixed-size uint8 frame stacks (the last one of a video
    padded by repeating its last frame), copied from pinned host memory
    without blocking; preprocessing and the forward run on the device. A
    batch never spans videos, the reference's per-video contract
    (inference_impl.py:210-239).
  * Lag-1 pipelining: batch i+1 is dispatched before batch i's
    descriptors are read, so decode, copies and device compute overlap.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.inference.transforms import InferenceTransforms, preprocess
from vsc2022_torch.inference.video_reader import VideoReader
from vsc2022_torch.parallel.mesh import first_axis_sharding
from vsc2022_torch.storage import load_features, store_features
from vsc2022_torch.types import VideoFeature

logger = logging.getLogger(__name__)

ReaderFactory = Callable[[str], VideoReader]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class VideoDataset:
    """Globs, sorts and shards the video list
    (reference: vsc/baseline/inference_impl.py:94-109)."""

    path: str
    reader_factory: ReaderFactory
    extensions: Sequence[str] = ("mp4",)
    distributed_rank: int = 0
    distributed_world_size: int = 1

    def __post_init__(self):
        if not 0 <= self.distributed_rank < self.distributed_world_size:
            raise ValueError(f"rank {self.distributed_rank} of a world of "
                             f"{self.distributed_world_size}")
        if len(self.extensions) == 1:
            filenames = glob.glob(os.path.join(self.path, f"*.{self.extensions[0]}"))
        else:
            filenames = [
                fn for fn in glob.glob(os.path.join(self.path, "*.*"))
                if fn.rsplit(".", 1)[-1] in self.extensions
            ]
        self.videos = sorted(filenames)
        if not self.videos:
            raise Exception("No videos found!")
        self.selected_videos = [
            (i, video) for (i, video) in enumerate(self.videos)
            if (i % self.distributed_world_size) == self.distributed_rank
        ]

    def num_videos(self) -> int:
        return len(self.selected_videos)

    def iter_decoded(self) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
        """Yield (video_name, frames uint8 [N, H, W, 3], timestamps [N, 2])."""
        for _, video in self.selected_videos:
            name = os.path.basename(video).split(".")[0]
            frames: List[np.ndarray] = []
            timestamps: List[Tuple[float, float]] = []
            for start, end, frame in self.reader_factory(video).frames():
                frames.append(frame)
                timestamps.append((start, end))
            if not frames:
                logger.warning("No frames decoded for %s; skipping", video)
                continue
            yield name, np.stack(frames), np.asarray(timestamps, dtype=np.float64)


def _prefetch(source: Iterator, depth: int = 2) -> Iterator:
    """Run ``source`` in a daemon thread, keeping up to ``depth`` items
    ready; an exception there is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    error: List[BaseException] = []

    def worker():
        try:
            for item in source:
                q.put(item)
        except BaseException as e:  # decode errors reach the consumer
            error.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        yield item


@contextlib.contextmanager
def f32_numerics(device: torch.device):
    """The float32 numerics on the card (the extractor's forward, the
    training steps' forward and backward): cuDNN's deterministic
    algorithms, chosen without benchmarking (the same batch shape gives
    the same bits in every process), and no TF32 in convolutions or
    matmuls, so float32 computes in float32. The previous matmul setting
    comes back afterwards."""
    if device.type != "cuda":
        yield
        return
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


class DescriptorExtractor:
    """Batched inference over decoded videos on one device, or data
    parallel over a mesh's devices."""

    def __init__(
        self,
        model: torch.nn.Module,
        transform: InferenceTransforms,
        batch_size: int = 32,
        compute_dtype: str = "float32",
        mesh=None,
        device: DeviceLike = "cuda",
    ):
        """``model`` maps NCHW float images (ImageNet normalized) to
        [B, D] descriptors; the extractor owns it: it moves to ``device``
        (and to ``compute_dtype``) once, here, in place.
        ``compute_dtype="bfloat16"`` casts its parameters (and buffers)
        and the images to bf16; descriptors come back as float32 either
        way. ``mesh`` (``vsc2022_torch.parallel.Mesh``): data-parallel
        extraction, as the JAX package's: each batch splits into one equal
        slice per mesh entry (``batch_size`` must divide by the mesh
        size), each slice runs on its entry's device; the model is
        replicated once per distinct device (the first on the lead device,
        which stands for ``device``)."""
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                             f"got {compute_dtype!r}")
        self.mesh = mesh
        if mesh is not None:
            if mesh.spans_processes:
                raise ValueError("data-parallel extraction runs over one process's "
                                 "devices; a pod's ranks extract their own videos "
                                 "(the inference CLI's --num_processes)")
            if batch_size % mesh.size:
                raise ValueError(f"batch_size {batch_size} must divide by the mesh's "
                                 f"{mesh.size} devices")
            self.device = mesh.lead
        else:
            self.device = resolve_device(device)
        self.dtype = COMPUTE_DTYPES[compute_dtype]
        self.model = self._placed(model.eval(), self.device)
        # One replica per distinct device of the mesh (the model itself on
        # the lead device).
        self._replicas = {self.device: self.model}
        for dev in ([] if mesh is None else mesh.distinct()):
            if dev not in self._replicas:
                self._replicas[dev] = self._placed(copy.deepcopy(self.model), dev)
        self.transform = transform
        self.batch_size = batch_size
        # The last extract()'s counts and host seconds: decode (in the
        # prefetch thread, overlapped with the device) and the host's waits
        # for descriptors to come back.
        self.last_stats: dict = {}

    def _placed(self, model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
        memory_format = (torch.channels_last if device.type == "cuda"
                         else torch.contiguous_format)
        return model.to(device, self.dtype, memory_format=memory_format)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 [B, H, W, 3] on a device → float32 [B, D] there: preprocess
        (in float32, as the JAX package does), then the forward in the
        compute dtype, by the replica on that device."""
        with torch.inference_mode(), f32_numerics(frames.device):
            images = preprocess(frames, self.transform).permute(0, 3, 1, 2)
            return self._replicas[frames.device](images.to(self.dtype)).float()

    def _dispatch_batch(self, frames_u8: np.ndarray):
        """Dispatch one batch without waiting for it: the copy in, the
        forward and the copy out are queued on the device, and the result
        is read later (``_collect``). Returns (pending, n_valid_rows)."""
        n = frames_u8.shape[0]
        if n < self.batch_size:  # the fixed batch shape
            pad = np.repeat(frames_u8[-1:], self.batch_size - n, axis=0)
            frames_u8 = np.concatenate([frames_u8, pad], axis=0)
        host = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if self.device.type != "cuda":
            slices = [host] if self.mesh is None else first_axis_sharding(self.mesh)(host)
            return (torch.cat([self.forward(x) for x in slices]), None), n
        host = host.pin_memory()
        slices = ([host.to(self.device, non_blocking=True)] if self.mesh is None
                  else first_axis_sharding(self.mesh)(host))
        outs = [self.forward(frames) for frames in slices]
        result = torch.empty((self.batch_size, outs[0].shape[1]), dtype=outs[0].dtype,
                             pin_memory=True)
        step = outs[0].shape[0]
        for i, out in enumerate(outs):
            result[i * step : (i + 1) * step].copy_(out, non_blocking=True)
        done = []
        for dev in dict.fromkeys(out.device for out in outs):
            done.append(torch.cuda.Event())
            done[-1].record(torch.cuda.current_stream(dev))
        return (result, done), n

    def _collect(self, pending, n: int) -> np.ndarray:
        result, done = pending
        if done is not None:
            t0 = time.perf_counter()
            for event in done:
                event.synchronize()
            self.last_stats["wait_s"] += time.perf_counter() - t0
        return result.numpy()[:n].copy()

    def extract(
        self,
        dataset: VideoDataset,
        store_fp16: bool = False,
        progress: Optional[Callable[[], None]] = None,
    ) -> Iterable[VideoFeature]:
        """Streamed extraction with lag-1 pipelining: batch i+1 is
        dispatched before batch i's descriptors are read. A batch never
        spans videos."""
        bs = self.batch_size
        stats = self.last_stats = {"videos": 0, "frames": 0, "batches": 0,
                                   "decode_s": 0.0, "wait_s": 0.0}

        def decoded():
            videos = iter(dataset.iter_decoded())
            while True:
                t0 = time.perf_counter()
                item = next(videos, None)
                stats["decode_s"] += time.perf_counter() - t0
                if item is None:
                    return
                yield item

        def batches():
            for name, frames, timestamps in _prefetch(decoded()):
                stats["videos"] += 1
                stats["frames"] += frames.shape[0]
                n_batches = max(1, -(-frames.shape[0] // bs))
                stats["batches"] += n_batches
                for j in range(n_batches):
                    yield (name, timestamps, frames[j * bs:(j + 1) * bs],
                           j == n_batches - 1)

        parts: List[np.ndarray] = []

        def settle(entry) -> Optional[VideoFeature]:
            name, timestamps, pending, n, last = entry
            parts.append(self._collect(pending, n))
            if not last:
                return None
            feature = np.concatenate(parts, axis=0)
            parts.clear()
            if store_fp16:
                feature = feature.astype(np.float16)
            if progress is not None:
                progress()
            return VideoFeature(video_id=name, timestamps=timestamps, feature=feature)

        pending = None
        for name, timestamps, chunk, last in batches():
            dispatched, n = self._dispatch_batch(chunk)
            if pending is not None:
                done = settle(pending)
                if done is not None:
                    yield done
            pending = (name, timestamps, dispatched, n, last)
        if pending is not None:
            done = settle(pending)
            if done is not None:
                yield done


def merge_feature_files(filenames: List[str], output_filename: str) -> int:
    """(reference: vsc/baseline/inference_impl.py:242-247)"""
    features = []
    for fn in filenames:
        features.extend(load_features(fn))
    store_features(output_filename, features)
    return len(features)
