"""On-device image preprocessing (counterpart of
``vsc2022_tpu/inference/transforms.py``).

Decode stays on the host; resize, crop and normalize run on the device
over whole uint8 batches, so one packed uint8 batch crosses to it. The
reference preprocesses each frame on the CPU with torchvision (PIL
resize, ToTensor, ImageNet Normalize; reference:
vsc/baseline/inference_impl.py:39-69).

Transform modes match the reference enum (reference:
vsc/baseline/inference.py:28-34):
  RESIZE_288        aspect-preserving resize, short side → 288
  RESIZE_320_CENTER short side → 320, center crop 320×320
  RESIZE_224_SQUARE resize to 224×224

The resize is ``jax.image.resize``'s, rebuilt here: per axis a weight
matrix from ``scale_and_translate``'s kernel (the triangle for
"linear", Keys' cubic with a = −0.5 for "cubic", widened by the
downscale factor when antialiasing), normalized per output pixel, and
one product per resized axis. ``F.interpolate`` uses other weights
(bicubic a = −0.75; its antialiased bilinear differs in the last bits),
so it is not used.
"""

from __future__ import annotations

import enum
import functools
from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CROP = 320


class InferenceTransforms(enum.Enum):
    RESIZE_288 = enum.auto()
    RESIZE_320_CENTER = enum.auto()
    RESIZE_224_SQUARE = enum.auto()


def resized_dims(mode: InferenceTransforms, h: int, w: int) -> Tuple[int, int]:
    """Target (H, W) after the resize step (before any crop)."""
    if mode == InferenceTransforms.RESIZE_224_SQUARE:
        return 224, 224
    short = 288 if mode == InferenceTransforms.RESIZE_288 else 320
    if h <= w:
        return short, max(1, round(w * short / h))
    return max(1, round(h * short / w)), short


def output_dims(mode: InferenceTransforms, h: int, w: int) -> Tuple[int, int]:
    rh, rw = resized_dims(mode, h, w)
    if mode == InferenceTransforms.RESIZE_320_CENTER:
        return CROP, CROP
    return rh, rw


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str,
                   antialias: bool = True) -> torch.Tensor:
    """[in_size, out_size] f32 weights of one resized axis, as
    ``jax.image.resize`` computes them (its ``compute_weight_mat`` with
    scale out/in and no translation), on the host."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)  # a Python double, as in JAX
    kernel_scale = np.float32(max(inv_scale, 1.0) if antialias else 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None])
    weights = kernel(x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(torch.abs(total) > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@functools.lru_cache(maxsize=64)
def _weights_on(n_in: int, n_out: int, method: str, lo: int, size: int,
                device: torch.device) -> torch.Tensor:
    """Output pixels lo..lo+size of one axis' weights, on ``device``. Kept:
    a copy from pageable host memory waits for the device's queue, which
    would stall the extractor's pipelining on every batch."""
    return resize_weights(n_in, n_out, method)[:, lo:lo + size].to(device)


@functools.lru_cache(maxsize=8)
def _normalization_on(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def _resize_axis(x: torch.Tensor, dim: int, weights: torch.Tensor) -> torch.Tensor:
    """Contract axis ``dim`` of ``x`` with ``weights`` [in, out]."""
    return (x.movedim(dim, -1) @ weights).movedim(-1, dim)


def resize(x: torch.Tensor, sizes: Tuple[int, ...], dims: Tuple[int, ...],
           method: str) -> torch.Tensor:
    """``jax.image.resize(x, ..., method, antialias=True)`` over the axes
    ``dims`` to ``sizes``; an axis that keeps its size is left as it is
    (JAX skips it too: its kernels interpolate)."""
    for dim, size in zip(dims, sizes):
        if x.shape[dim] != size:
            x = _resize_axis(x, dim, _weights_on(x.shape[dim], size, method, 0, size,
                                                 x.device).to(x.dtype))
    return x


def preprocess(frames: torch.Tensor, mode: InferenceTransforms) -> torch.Tensor:
    """uint8 [B, H, W, 3] → normalized float32 [B, H', W', 3], on the
    frames' device. The center crop of RESIZE_320_CENTER is taken from the
    weight matrices (only the kept output pixels are computed: each output
    pixel depends on its own weights alone); a frame smaller than the crop
    is padded as the JAX package pads it (torchvision's CenterCrop)."""
    _, h, w, _ = frames.shape
    x = frames.to(torch.float32) / 255.0
    rh, rw = resized_dims(mode, h, w)
    crop = mode == InferenceTransforms.RESIZE_320_CENTER
    for dim, n_in, n_out in ((1, h, rh), (2, w, rw)):
        lo, size = 0, n_out
        if crop:
            lo, size = max((n_out - CROP) // 2, 0), min(CROP, n_out)
        if n_in == n_out:
            x = x.narrow(dim, lo, size)
        else:
            x = _resize_axis(x, dim, _weights_on(n_in, n_out, "linear", lo, size, x.device))
    if crop and (x.shape[1] != CROP or x.shape[2] != CROP):
        ph, pw = CROP - x.shape[1], CROP - x.shape[2]
        x = torch.nn.functional.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    mean, std = _normalization_on(x.device)
    return (x - mean) / std
