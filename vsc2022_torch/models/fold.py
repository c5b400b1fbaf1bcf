"""Inference-time BatchNorm folding for the ResNet-family models
(counterpart of ``vsc2022_tpu/models/fold.py``, over the port's state
dicts).

At inference a BatchNorm is the affine ``y = (x − μ)·γ/√(σ²+ε) + β``;
every BN of the trunk follows a bias-free conv, so the affine folds into
it:

    W' = W · γ/√(σ²+ε)        (per output channel)
    b' = β − μ·γ/√(σ²+ε)

Usage::

    model = SSCDModel(fold_bn=True)                    # BN → FoldedNorm
    model.load_state_dict(fold_batchnorm(unfolded.state_dict()))

The fold is computed in float64 on the host and cast back to the
weights' dtype, so the folded model matches the unfolded one to float32
roundoff. The reference never folds (it runs the TorchScript artifact
as serialized, vsc/baseline/inference_impl.py:173).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

_BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _conv_partner(bn: str) -> Optional[str]:
    """The conv a BatchNorm module follows, by the trunk's naming:
    ``…bn{i}`` → ``…conv{i}``, ``…downsample.1`` → ``…downsample.0``."""
    parent, _, name = bn.rpartition(".")
    prefix = parent + "." if parent else ""
    if name.startswith("bn"):
        return prefix + "conv" + name[len("bn"):]
    if name == "1" and parent.endswith("downsample"):
        return prefix + "0"
    return None


@torch.no_grad()
def fold_batchnorm(state: Mapping[str, torch.Tensor], eps: float = 1e-5
                   ) -> Dict[str, torch.Tensor]:
    """Fold every (conv, BatchNorm) pair of a state dict into the conv.

    Returns a new state dict with the convs rescaled, conv biases added
    and the BatchNorm entries gone: the layout of the ``fold_bn=True``
    models. Raises if a BatchNorm has no conv before it to absorb it
    (nothing in the ResNet trunk does). ``eps`` is the models' BatchNorm
    epsilon."""
    out = dict(state)
    bns = sorted(k[: -len(".running_mean")] for k in state if k.endswith(".running_mean"))
    leftover = []
    for bn in bns:
        conv = _conv_partner(bn)
        if conv is None or conv + ".weight" not in state:
            leftover.append(bn)
            continue
        gamma, beta, mean, var = (
            torch.as_tensor(state[f"{bn}.{k}"]).double()
            for k in ("weight", "bias", "running_mean", "running_var"))
        scale = gamma / torch.sqrt(var + eps)
        w = torch.as_tensor(state[conv + ".weight"])
        out[conv + ".weight"] = (w.double() * scale.view(-1, 1, 1, 1)).to(w.dtype)
        out[conv + ".bias"] = (beta - mean * scale).to(w.dtype)
        for k in _BN_KEYS:
            out.pop(f"{bn}.{k}", None)
    if leftover:
        raise ValueError(f"BatchNorm without a foldable preceding conv: {leftover}")
    return out
