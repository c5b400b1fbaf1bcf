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

``s2d_stem`` relabels the stem's 7×7/2 kernel for the space-to-depth
stem (``ResNet50(stem_s2d=True)``), on a Flax variable tree as the JAX
package's ``s2d_stem`` does (the same arrays) or on a port state dict.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
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


def _s2d_kernel(w: np.ndarray) -> np.ndarray:
    """A 7×7 HWIO kernel [7, 7, c, f] → the VALID 4×4 kernel [4, 4, 4c, f]
    over the 2×2 space-to-depth input: zero-padded 7 → 8 at the leading
    edge, ``W2[a, b, (r, s, c), f] = Wpad[2a + r, 2b + s, c, f]``."""
    c, f = w.shape[2], w.shape[3]
    wpad = np.pad(w, ((1, 0), (1, 0), (0, 0), (0, 0)))
    w2 = wpad.reshape(4, 2, 4, 2, c, f).transpose(0, 2, 1, 3, 4, 5)
    return np.ascontiguousarray(w2.reshape(4, 4, 4 * c, f), dtype=w.dtype)


def s2d_stem(variables: Mapping) -> dict:
    """Transform the stem conv kernel for the space-to-depth stem
    (``stem_s2d=True`` models): the 7×7/2 3-channel kernel becomes the
    exact VALID 4×4/1 12-channel kernel over the 2×2 space-to-depth input
    (the MLPerf ResNet transform; JAX ``vsc2022_tpu/models/fold.py``).

    With the input padding shifted 3 → 4 (an even grid), the kernel
    zero-pads 7 → 8 at the leading edge, and ``W2[a, b, (r, s, c), f] =
    Wpad[2a + r, 2b + s, c, f]``, the channel order (r, s, c) matching the
    model's space-to-depth reshape. The same products relabelled, so the
    outputs match the standard stem to f32 reassociation roundoff.
    Composes with ``fold_batchnorm`` in either order (the bias is per
    output channel and untouched).

    ``variables``: a Flax variable tree (``{"params": ...}``, numpy; every
    ``conv1`` kernel of shape 7×7 relabelled, as JAX does) or a port state
    dict (torch names: every ``conv1.weight`` [f, c, 7, 7], OIHW)."""
    if "params" in variables:
        def walk(level):
            out = {}
            for name, sub in level.items():
                if not isinstance(sub, Mapping):
                    out[name] = sub
                elif name == "conv1" and "kernel" in sub and np.asarray(
                        sub["kernel"]).shape[:2] == (7, 7):
                    out[name] = {k: (_s2d_kernel(np.asarray(v)) if k == "kernel" else v)
                                 for k, v in sub.items()}
                else:
                    out[name] = walk(sub)
            return out

        return {k: (walk(v) if k == "params" else v) for k, v in variables.items()}
    out = dict(variables)
    for key, value in variables.items():
        if key.split(".")[-2:] == ["conv1", "weight"] and tuple(value.shape[2:]) == (7, 7):
            w = torch.as_tensor(value)
            hwio = w.detach().cpu().numpy().transpose(2, 3, 1, 0)
            out[key] = torch.from_numpy(np.ascontiguousarray(
                _s2d_kernel(hwio).transpose(3, 2, 0, 1))).to(w.device)
    return out
