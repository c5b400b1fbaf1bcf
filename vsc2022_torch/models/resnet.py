"""ResNet-50 trunk (torchvision v1.5 semantics) and GeM pooling
(counterpart of ``vsc2022_tpu/models/resnet.py``).

Backbone of the SSCD descriptor model and of the DnS L3-iMAC extractor:
a 7×7/2 stem and a 3×3/2 max pool, then bottleneck blocks with the
stride on the 3×3 conv. Parameter names are torchvision's (``conv1``,
``bn1``, ``layer{1-4}.{i}.conv{1-3}`` / ``bn{1-3}``,
``layer{s}.0.downsample.{0,1}``), so a published SSCD or L3-iMAC trunk's
state dict loads with no key mapping. Tensors are NCHW (channels-last
memory works as well); the JAX package's explicit paddings (the stem's
3, the 3×3 convs' 1, the max pool's 1 filled with −inf) are torch's
symmetric ones. BatchNorm (``BatchNorm``, eps 1e-5) runs on its running
statistics in eval mode, exactly as ``nn.BatchNorm2d``; in train mode it
has Flax's semantics (``nn.BatchNorm(momentum=0.9)``, see its docstring).

``fold_bn=True`` is the inference-only layout of ``models/fold.py``:
every BatchNorm becomes a ``FoldedNorm`` (no parameters) and every conv
carries a bias.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vsc2022_torch.parallel.collectives import psum_grad


class FoldedNorm(nn.Module):
    """Stand-in for a BatchNorm whose affine was folded into the conv
    before it (``models/fold.py``): the identity, with no parameters."""

    def __init__(self, num_features: int = 0):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (the same parameters and buffers) whose training
    forward is Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, the JAX
    package's (``vsc2022_tpu/models/resnet.py``): the batch variance is
    E[x²] − E[x]² clipped at 0 (Flax's ``use_fast_variance``), the output
    (x − mean) · (rsqrt(var + eps) · weight) + bias, and the running
    variance moves with that biased variance (torch's moves with the
    unbiased one), by ``momentum`` 0.1 (Flax's 0.9). The statistics are
    sums of x and x² over (N, H, W); with ``sum_over_ranks`` set (the
    data-parallel training step sets it) those sums and the count are
    summed over the ranks of the process group first, so every rank
    normalizes with the global batch's statistics. In eval mode the
    forward is ``nn.BatchNorm2d``'s."""

    sum_over_ranks = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        dims = (0, 2, 3)
        sums = torch.cat([x.sum(dims), (x * x).sum(dims),
                          x.new_full((1,), x.numel() // c)])
        if self.sum_over_ranks:
            sums = psum_grad(sums)
        mean, mean2 = sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _norm(features: int, fold_bn: bool) -> nn.Module:
    return FoldedNorm(features) if fold_bn else BatchNorm(features)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 (×4), with a projection shortcut where
    the width or the stride changes."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 fold_bn: bool = False):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=fold_bn)
        self.bn1 = _norm(features, fold_bn)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1,
                               bias=fold_bn)
        self.bn2 = _norm(features, fold_bn)
        self.conv3 = nn.Conv2d(features, out, 1, bias=fold_bn)
        self.bn3 = _norm(out, fold_bn)
        self.downsample = None
        if in_features != out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_features, out, 1, stride=stride, bias=fold_bn),
                _norm(out, fold_bn),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """Returns the final [N, 2048, H/32, W/32] feature map; with
    ``return_intermediates`` also the four stage outputs (L3-iMAC).
    ``stage_sizes`` / ``stage_features`` default to ResNet-50; smaller
    ones serve tests. The stem is 64 wide whatever the stages, as in the
    JAX package."""

    def __init__(self, return_intermediates: bool = False,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stage_features: Sequence[int] = (64, 128, 256, 512),
                 fold_bn: bool = False):
        super().__init__()
        self.return_intermediates = return_intermediates
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=fold_bn)
        self.bn1 = _norm(64, fold_bn)
        width = 64
        for stage, (blocks, features) in enumerate(zip(stage_sizes, stage_features)):
            layer = []
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                layer.append(Bottleneck(width, features, stride, fold_bn))
                width = features * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)
        self.out_features = width

    def forward(self, x: torch.Tensor):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool2d(x, 3, stride=2, padding=1)
        stages = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            stages.append(x)
        if self.return_intermediates:
            return x, tuple(stages)
        return x


def gem_pool(x: torch.Tensor, p: float = 3.0, eps: float = 1e-6) -> torch.Tensor:
    """Generalized-mean pooling over the spatial dims of [N, C, H, W]:
    (mean(clamp(x, eps)^p))^(1/p) → [N, C]. The SSCD head's
    GlobalGeMPool2d (reference: vsc/baseline/adapt_sscd_model.py:64);
    p = 3 is SSCD's."""
    return x.clamp(min=eps).pow(p).mean(dim=(2, 3)).pow(1.0 / p)
