"""Seeded random initialization with Flax's default distributions.

Without weights the port's models are initialized from a seeded
``torch.Generator`` with the distributions Flax gives the JAX package's
modules: lecun-normal kernels (a normal truncated to [-2, 2] standard
deviations, scaled to variance 1 / fan_in), zero biases, and unit scales
with zero shifts for the norms (BatchNorm's running statistics at mean 0,
variance 1). The numbers differ from the JAX package's ``PRNGKey`` init:
tests carry weights across with ``vsc2022_torch.convert``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# Flax's truncated-normal variance scaling divides by the std of a unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_flax_like(module: nn.Module, g: torch.Generator) -> None:
    """Every Conv2d, Linear, BatchNorm2d and LayerNorm of ``module``, in
    ``modules()`` order, drawn from ``g`` as Flax initializes them."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
