"""Device-side two-view augmentation for self-supervised descriptor
training (counterpart of ``vsc2022_tpu/train/augment.py``).

SSCD-style views: a random resized crop (55-100% of each side) sampled
to ``out_hw``² by a gather grid, a horizontal flip, brightness and
contrast jitter (0.7-1.3, the contrast about each view's own mean),
clipping to [0, 1] and ImageNet normalization. The host ships the uint8
frames once; both views are made on the device.

``jax.random`` cannot be reproduced in torch, so the module has two
parts: ``draw_views`` takes every random number from a
``torch.Generator`` (on the CPU, so that a seed gives the same views on
any device), and ``augment`` is a pure function of the frames and those
draws, with JAX's arithmetic: the crop side ``max(int(scale · h), 1)``
truncated, the offsets ``top % max(h − crop_h + 1, 1)`` from raw draws in
[0, h), and the grid ``top + (i · crop_h) // out_hw``. Tests hold
``augment`` against JAX's ``two_views`` fed the draws JAX takes from its
key.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from vsc2022_torch.inference.transforms import IMAGENET_MEAN, IMAGENET_STD

SCALE_RANGE = (0.55, 1.0)
JITTER_RANGE = (0.7, 1.3)


class ViewDraws(NamedTuple):
    """One view's random numbers, one entry a frame (CPU tensors)."""

    scale: torch.Tensor  # float32 in [0.55, 1)
    top: torch.Tensor  # int64 in [0, H)
    left: torch.Tensor  # int64 in [0, W)
    flip: torch.Tensor  # bool
    brightness: torch.Tensor  # float32 in [0.7, 1.3)
    contrast: torch.Tensor  # float32 in [0.7, 1.3)

    def rows(self, start: int, stop: int) -> "ViewDraws":
        """The draws of frames [start, stop) (a data-parallel rank's slice)."""
        return ViewDraws(*(t[start:stop] for t in self))


def _uniform(g: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    """n float32 draws in [lo, hi): the float32 sum may round up to ``hi``,
    so it is clamped to the float below it."""
    x = lo + (hi - lo) * torch.rand(n, generator=g)
    return torch.clamp(x, max=float(np.nextafter(np.float32(hi), np.float32(lo))))


def draw_views(g: torch.Generator, batch: int, height: int, width: int) -> ViewDraws:
    """One view's draws for ``batch`` frames of ``height`` x ``width``."""
    return ViewDraws(
        scale=_uniform(g, batch, *SCALE_RANGE),
        top=torch.randint(0, height, (batch,), generator=g),
        left=torch.randint(0, width, (batch,), generator=g),
        flip=torch.rand(batch, generator=g) < 0.5,
        brightness=_uniform(g, batch, *JITTER_RANGE),
        contrast=_uniform(g, batch, *JITTER_RANGE),
    )


def _grid(scale, raw, side: int, out_hw: int, device) -> torch.Tensor:
    """[B, out_hw] source rows (or columns) of each frame's crop."""
    crop = torch.clamp((scale * side).to(torch.int64), min=1)
    start = raw % torch.clamp(side - crop + 1, min=1)
    i = torch.arange(out_hw)
    return (start[:, None] + (i[None, :] * crop[:, None]) // out_hw).to(device)


def augment(frames: torch.Tensor, draws: ViewDraws, out_hw: int = 224) -> torch.Tensor:
    """One augmented, ImageNet-normalized view of uint8 frames [B, H, W, 3]
    (on any device) under ``draws``: NCHW float32 [B, 3, out_hw, out_hw]
    on the frames' device (channels-last in memory)."""
    b, h, w, _ = frames.shape
    dev = frames.device
    ys = _grid(draws.scale, draws.top, h, out_hw, dev)
    xs = _grid(draws.scale, draws.left, w, out_hw, dev)
    xs = torch.where(draws.flip.to(dev)[:, None], xs.flip(1), xs)
    idx = torch.arange(b, device=dev)[:, None, None]
    v = frames[idx, ys[:, :, None], xs[:, None, :]].float() / 255.0  # [B, S, S, 3]
    v = v * draws.brightness.to(dev)[:, None, None, None]
    mean = v.mean(dim=(1, 2), keepdim=True)
    v = (v - mean) * draws.contrast.to(dev)[:, None, None, None] + mean
    v = torch.clamp(v, 0.0, 1.0)
    v = (v - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(IMAGENET_STD, device=dev)
    return v.permute(0, 3, 1, 2)


def two_views(g: torch.Generator, frames: torch.Tensor,
              out_hw: int = 224) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two augmented views of each frame: view A's draws, then view B's,
    from ``g``."""
    b, h, w, _ = frames.shape
    draws_a, draws_b = draw_views(g, b, h, w), draw_views(g, b, h, w)
    return augment(frames, draws_a, out_hw), augment(frames, draws_b, out_hw)
