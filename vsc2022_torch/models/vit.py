"""DINO ViT-S/16 with the copy-detection descriptor head (counterpart of
``vsc2022_tpu/models/vit.py``).

The DINO baseline's descriptor is the [CLS] token concatenated with the
GeM-pooled (p = 4) patch tokens → 2·384 = 768 dims (reference:
docs/baseline_dino.md:2-9). A pre-norm ViT: 16×16/16 patch conv, learned
position embedding, 12 blocks (dim 384, 6 heads, MLP ×4, erf GELU,
LayerNorm eps 1e-6), a final LayerNorm.

Parameter names are DINO's own (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.norm1`` / ``attn.qkv`` / ``attn.proj`` /
``norm2`` / ``mlp.fc1`` / ``mlp.fc2``, ``norm``), so a published DINO
state dict loads with no key mapping. Attention is Flax's
``MultiHeadDotProductAttention`` written out: the q, k and v
projections (the rows of ``qkv``), q scaled by 1/√head_dim, a softmax
over q·kᵀ, the weighted sum of v and the out projection.

At another input size the position embedding's grid is resampled with
``jax.image.resize``'s cubic (Keys, a = −0.5, antialiased), as the JAX
package resamples it; a patch count that is not a square raises there,
and here.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vsc2022_torch.inference.transforms import resize
from vsc2022_torch.models.init import init_flax_like


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Flax's default "SAME" padding: a side that the stride does not
        # divide is padded (low side first the smaller half).
        p = self.patch_size
        pads = []
        for size in (x.shape[3], x.shape[2]):
            total = max((-(-size // p) - 1) * p + p - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = nn.functional.pad(x, pads)
        return self.proj(x)


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q = qkv[0] / math.sqrt(d // h)
        weights = torch.softmax(q @ qkv[1].transpose(-2, -1), dim=-1)
        y = (weights @ qkv[2]).transpose(1, 2).reshape(b, n, d)
        return self.proj(y)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def interpolate_pos_embed(pos: torch.Tensor, num_patches: int) -> torch.Tensor:
    """Resample the grid part of a [1, 1+N, D] position embedding to
    ``num_patches`` (a square count) with JAX's cubic resize."""
    n = pos.shape[1] - 1
    if n == num_patches:
        return pos
    size, new_size = math.isqrt(n), math.isqrt(num_patches)
    if new_size * new_size != num_patches:
        raise ValueError(
            f"the position embedding resamples onto a square grid; "
            f"{num_patches} patches are not a square count")
    grid = pos[:, 1:].reshape(1, size, size, -1).float()
    grid = resize(grid, (new_size, new_size), (1, 2), "cubic").to(pos.dtype)
    return torch.cat([pos[:, :1], grid.reshape(1, num_patches, pos.shape[-1])], dim=1)


def vit_gem_pool(tokens: torch.Tensor, p: float = 4.0, eps: float = 1e-6) -> torch.Tensor:
    """GeM over the patch tokens [N, T, D] → [N, D]. DINO's copy-detection
    evaluation uses exponent 4 (facebookresearch/dino eval_copy_detection)."""
    return tokens.clamp(min=eps).pow(p).mean(dim=1).pow(1.0 / p)


class DinoViT(nn.Module):
    """ViT-S/16: NCHW float images → concat([CLS], GeM(patch tokens)),
    [N, 2·dim]. ``dim`` / ``depth`` / ``num_heads`` default to ViT-S/16;
    smaller ones serve tests."""

    def __init__(self, patch_size: int = 16, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, gem_p: float = 4.0):
        super().__init__()
        self.gem_p = gem_p
        self.patch_embed = _PatchEmbed(patch_size, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (224 // patch_size) ** 2 + 1, dim))
        self.blocks = nn.ModuleList(_Block(dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def init_weights(self, g: torch.Generator) -> None:
        """Flax's initializers: lecun-normal kernels, zero biases, unit
        LayerNorms, a zero [CLS] token and a N(0, 0.02) position embedding."""
        init_flax_like(self, g)
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embed(x)  # [N, D, gh, gw]
        tokens = patches.flatten(2).transpose(1, 2)
        num_patches = tokens.shape[1]
        cls = self.cls_token.expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + interpolate_pos_embed(self.pos_embed, num_patches)
        for block in self.blocks:
            tokens = block(tokens)
        tokens = self.norm(tokens)
        return torch.cat([tokens[:, 0], vit_gem_pool(tokens[:, 1:], p=self.gem_p)], dim=-1)
