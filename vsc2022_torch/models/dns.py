"""DnS (Distill-and-Select) models: the L3-iMAC feature extractor, the
students and the ViSiL chamfer similarity (counterpart of
``vsc2022_tpu/models/dns.py``).

* L3-iMAC (``L3iMACExtractor``): the four stage outputs of a ResNet-50
  trunk, each max-pooled over a 3×3 region grid and L2-normalized,
  concatenated and L2-normalized again → [N, 9, 3840] region features.
* Fine-grained students (``fg``, ``att`` or ``bin``): a 3840→512 region
  reduction, L2, ViSiL ℓ2-attention over the 9 regions, and for ``bin``
  a 512×512 rotation whose sign gives the codes → [T, 9, 512].
* Coarse student (``cg``): reduction, L2, attention, the
  attention-weighted region pool, a 512→1024 projection and tanh →
  [T, 1024].

Parameter names follow the torch layout of the published students
(``reduction.{weight,bias}``, ``attention.context_vector.weight``,
``binarization.W``, ``project.{weight,bias}``), so their state dicts load
with no key mapping, and the modules script with ``torch.jit.script``
(carrying ``student_type`` / ``fg_type`` as the published ones do);
``vsc2022_torch.convert.dns_student_from_jax`` carries a Flax variable
tree across. Without weights the students are
initialized from a seeded ``torch.Generator`` with Flax's distributions
(lecun-normal kernels and context, zero biases, an orthogonal rotation):
the numbers differ from the JAX package's ``PRNGKey`` init.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.models.init import lecun_normal_
from vsc2022_torch.models.resnet import ResNet50

L3_IMAC_DIM = 3840  # 256 + 512 + 1024 + 2048
NUM_REGIONS = 9
REDUCED_DIM = 512
COARSE_DIM = 1024


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def _region_mac(x: torch.Tensor, grid: int = 3) -> torch.Tensor:
    """Adaptive grid×grid region max-pool: [N, C, H, W] → [N, grid², C],
    regions in row-major order. ``adaptive_max_pool2d``'s windows are the
    JAX package's: rows floor(i·H/grid) to ceil((i+1)·H/grid)."""
    pooled = nn.functional.adaptive_max_pool2d(x, grid)  # [N, C, grid, grid]
    return pooled.flatten(2).transpose(1, 2)


class L3iMACExtractor(nn.Module):
    """ResNet-50 L3-iMAC region features: NCHW images → [N, 9, 3840],
    L2-normalized. The trunk is ``backbone.*`` (torchvision names)."""

    def __init__(self, fold_bn: bool = False):
        super().__init__()
        self.backbone = ResNet50(return_intermediates=True, fold_bn=fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, stages = self.backbone(x)
        return _l2(torch.cat([_l2(_region_mac(s)) for s in stages], dim=-1))


class _RegionAttention(nn.Module):
    """ViSiL ℓ2-attention: per-region weight (x·c + 1)/2 in [0, 1] from a
    learned context vector taken at unit norm."""

    def __init__(self, dim: int = REDUCED_DIM):
        super().__init__()
        self.context_vector = nn.Linear(dim, 1, bias=False)

    def forward(self, regions: torch.Tensor):  # [..., R, D]
        c = self.context_vector.weight  # [1, D]
        c = c / torch.clamp(torch.linalg.norm(c), min=1e-12)
        weights = (regions @ c.T + 1.0) / 2.0  # [..., R, 1]
        return regions * weights, weights


class _Binarization(nn.Module):
    def __init__(self, dim: int = REDUCED_DIM):
        super().__init__()
        self.W = nn.Parameter(torch.empty(dim, dim))


class FineGrainedStudentModule(nn.Module):
    """Region reduction + attention (+ the rotation for ``bin``)."""

    def __init__(self, fg_type: str = "att"):
        super().__init__()
        if fg_type not in ("att", "bin"):
            raise ValueError(f"fg_type must be att|bin, got {fg_type!r}")
        self.student_type = "fg"
        self.fg_type = fg_type
        self.reduction = nn.Linear(L3_IMAC_DIM, REDUCED_DIM)
        self.attention = _RegionAttention()
        if fg_type == "bin":
            self.binarization = _Binarization()

    def forward(self, regions: torch.Tensor) -> torch.Tensor:  # [T, R, 3840]
        x, _ = self.attention(_l2(self.reduction(regions)))
        if hasattr(self, "binarization"):  # resolved when scripted
            x = x @ self.binarization.W  # sign taken downstream (x > 0)
        return x  # [T, R, 512]


class CoarseStudentModule(nn.Module):
    """Per-frame 1024-d coarse descriptor from region features."""

    def __init__(self, out_dim: int = COARSE_DIM):
        super().__init__()
        self.student_type = "cg"
        self.reduction = nn.Linear(L3_IMAC_DIM, REDUCED_DIM)
        self.attention = _RegionAttention()
        self.project = nn.Linear(REDUCED_DIM, out_dim)

    def forward(self, regions: torch.Tensor) -> torch.Tensor:
        # [T, 1, R·3840] or [T, R, 3840] → [T, R, 3840]
        x = regions.reshape(regions.shape[0], -1, self.reduction.in_features)
        x, weights = self.attention(_l2(self.reduction(x)))
        pooled = x.sum(dim=1) / torch.clamp(weights.sum(dim=1), min=1e-6)
        return torch.tanh(self.project(pooled))  # [T, 1024]


def _init_flax_like(module: nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in (getattr(module, "reduction", None), getattr(module, "project", None)):
            if lin is not None:
                lecun_normal_(lin.weight, lin.in_features, g)
                lin.bias.zero_()
        context = module.attention.context_vector.weight
        lecun_normal_(context, context.shape[1], g)
        if hasattr(module, "binarization"):
            nn.init.orthogonal_(module.binarization.W, generator=g)


def chamfer_similarity(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """ViSiL frame-to-frame similarity of one pair: mean over query
    regions of the max over ref regions of the region products.
    q [Tq, R, D], r [Tr, R, D] → [Tq, Tr]."""
    sims = torch.einsum("qad,rbd->qrab", q, r)
    return sims.amax(dim=-1).mean(dim=-1)


class DnSStudent:
    """A student module with its weights on a device, exposing the
    reference's TorchScript-model surface: ``student_type``, ``fg_type``,
    ``get_network_name()``, ``index_video(features)`` and, for fg
    students, ``student(query, ref)`` → [Tq, Tr] chamfer similarity."""

    def __init__(
        self,
        student_type: str,
        fg_type: Optional[str] = None,
        state_dict: Optional[Mapping] = None,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        if student_type not in ("cg", "fg"):
            raise ValueError(f"student_type must be cg|fg, got {student_type!r}")
        self.student_type = student_type
        self.fg_type = fg_type or ""
        if student_type == "cg":
            self.module = CoarseStudentModule()
        else:
            self.module = FineGrainedStudentModule(fg_type=fg_type)
        if state_dict is None:
            _init_flax_like(self.module, seed)
        else:
            self.module.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
            )
        self.device = resolve_device(device)
        self.module.to(self.device).eval()

    def get_network_name(self) -> str:
        if self.student_type == "cg":
            return "cg_student"
        return f"fg_{self.fg_type}_student"

    def index_video(self, features: np.ndarray) -> np.ndarray:
        """Re-encode one video's raw L3-iMAC rows, [T, 9·3840] (as stored
        in npz, any float type) or [T, 9, 3840]. The rows cross to the
        device in their stored type and become f32 there. Returns
        cg → [T, 1024], fg → [T, 9·512] (flattened) as f32."""
        x = torch.from_numpy(np.ascontiguousarray(features)).to(self.device)
        x = x.float().reshape(x.shape[0], NUM_REGIONS, L3_IMAC_DIM)
        with torch.no_grad():
            out = self.module(x)
        return out.reshape(out.shape[0], -1).cpu().numpy()

    def __call__(self, query: np.ndarray, ref: np.ndarray) -> np.ndarray:
        if self.student_type != "fg":
            raise ValueError("only fine-grained students compute similarity")

        def regions(a):
            t = torch.from_numpy(np.asarray(a, dtype=np.float32)).to(self.device)
            return t.reshape(t.shape[0], NUM_REGIONS, REDUCED_DIM)

        with torch.no_grad():
            return chamfer_similarity(regions(query), regions(ref)).cpu().numpy()
