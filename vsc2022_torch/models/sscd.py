"""SSCD descriptor model: ResNet-50 trunk → GeM (p = 3) → 2048→512
projection (counterpart of ``vsc2022_tpu/models/sscd.py``).

The reference's adapted ``sscd_disc_mixup`` TorchScript model is
backbone → GlobalGeMPool2d → Linear → [L2Norm stripped] (reference:
vsc/baseline/adapt_sscd_model.py:54-77); ``l2_normalize`` puts the L2
back. Parameter names are the adapted model's (``backbone.*``,
``project.*``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vsc2022_torch.models.resnet import ResNet50, gem_pool


class SSCDModel(nn.Module):
    """Frame descriptors: NCHW float images (ImageNet normalized) →
    [N, dims]. ``stage_sizes`` / ``stage_features`` default to ResNet-50;
    smaller ones serve tests."""

    def __init__(self, dims: int = 512, gem_p: float = 3.0,
                 l2_normalize: bool = False,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stage_features: Sequence[int] = (64, 128, 256, 512),
                 fold_bn: bool = False):
        super().__init__()
        self.gem_p = gem_p
        self.l2_normalize = l2_normalize
        self.backbone = ResNet50(stage_sizes=stage_sizes,
                                 stage_features=stage_features, fold_bn=fold_bn)
        self.project = nn.Linear(self.backbone.out_features, dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.project(gem_pool(self.backbone(x), p=self.gem_p))
        if self.l2_normalize:
            x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
        return x
