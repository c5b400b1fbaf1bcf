"""SSCD-style contrastive training step (counterpart of
``vsc2022_tpu/train/sscd_train.py``).

The objective is the JAX package's: InfoNCE between two augmented views
over the global batch (the other samples of both views are the
negatives) plus SSCD's KoLeo entropy regularizer. A step runs two
train-mode forwards, view A and then view B, so BatchNorm's running
statistics move twice a step, as in JAX's ``loss_fn``; each view is
normalized with its own batch statistics (the views are never
concatenated into one forward). Then L2, the loss, backward and
``torch.optim.AdamW`` with ``optax.adamw``'s defaults (every parameter
decays, the decay scaled by the learning rate). On the card the forward
and backward run in float32 with TF32 off and cuDNN's deterministic
algorithms, as the extractor's forward does.

Data parallel (``mesh=`` a ``train_mesh`` over a pod's ranks, one rank a
card): each rank passes its own slice of the global batch, in rank
order. BatchNorm sums x and x² over the ranks before it normalizes, the
descriptors are gathered so that every rank computes the global loss,
and the gradients are summed over the ranks: JAX's global-array
semantics, so the step matches one process's on the whole batch within
rounding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.inference.pipeline import f32_numerics
from vsc2022_torch.models.resnet import BatchNorm
from vsc2022_torch.models.sscd import SSCDModel


@dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), its optimizer
    and the number of steps taken. A step updates it in place."""

    model: SSCDModel
    optimizer: torch.optim.Optimizer
    step: int = 0


def adamw(params, learning_rate: float, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate, weight_decay=weight_decay)``: b1 0.9, b2
    0.999, eps 1e-8 outside the square root, decoupled decay of every
    parameter scaled by the learning rate (optax's default decay, 1e-4)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(
    model: SSCDModel,
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-4,
    seed: int = 0,
    variables: Optional[Mapping] = None,
    device: DeviceLike = "cuda",
) -> TrainState:
    """``model`` on ``device`` in train mode, with AdamW (``adamw``), at step
    0. Its weights come from ``variables``, a Flax ``SSCDModel`` tree
    ``{"params", "batch_stats"}`` as the JAX package's checkpoints hold it
    (``convert.sscd_from_jax``; without "batch_stats" the init's statistics
    stay, as in the JAX CLI), or else from Flax's distributions drawn from
    ``seed`` (``models/init.py``; the numbers differ from JAX's
    ``PRNGKey(seed)`` init)."""
    from vsc2022_torch import convert
    from vsc2022_torch.models.init import init_flax_like

    if variables is None or "batch_stats" not in variables:
        init_flax_like(model, torch.Generator().manual_seed(seed))
    if variables is not None:
        if "batch_stats" not in variables:  # params alone: the init's statistics stay
            variables = dict(variables,
                             batch_stats=convert.sscd_to_jax(model.state_dict())["batch_stats"])
        convert.load_into(model, convert.sscd_from_jax(variables))
    model.to(resolve_device(device)).train()
    return TrainState(model, adamw(model.parameters(), learning_rate, weight_decay))


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def sscd_loss(
    desc_a: torch.Tensor,  # [B, D] L2-normalized descriptors, view A
    desc_b: torch.Tensor,  # [B, D] view B
    temperature: float = 0.05,
    entropy_weight: float = 30.0,
) -> torch.Tensor:
    """Symmetric InfoNCE over [B, 2B] logits (the other view, then the own
    view with its diagonal at −inf) plus KoLeo, −mean log of each view-A
    descriptor's distance to its nearest other one, at ``entropy_weight
    · 0.001``. ``amax`` splits a tie's gradient evenly, as ``jnp.max``."""
    b = desc_a.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=desc_a.device)
    labels = torch.arange(b, device=desc_a.device)

    def infonce(x, y):
        logits = torch.cat([x @ y.T / temperature,
                            (x @ x.T / temperature).masked_fill(eye, -torch.inf)], dim=1)
        return torch.logsumexp(logits, dim=1) - logits[labels, labels]

    loss = torch.mean(infonce(desc_a, desc_b) + infonce(desc_b, desc_a)) / 2.0
    sim = (desc_a @ desc_a.T).masked_fill(eye, -torch.inf)
    nn_dist_sq = torch.clamp(2.0 - 2.0 * sim.amax(dim=1), min=1e-6)
    koleo = -torch.mean(0.5 * torch.log(nn_dist_sq))
    return loss + entropy_weight * 0.001 * koleo


def _data_parallel(mesh) -> bool:
    """Whether ``mesh`` splits the batch over a pod's ranks (one entry a
    rank). A mesh of one process's devices must have one entry: training
    takes one rank a card."""
    if mesh is None or not mesh.spans_processes:
        if mesh is not None and mesh.size != 1:
            raise ValueError(f"data-parallel training takes one rank a card, not a "
                             f"mesh of one process's devices: {mesh!r}; start a rank a "
                             "card (initialize_distributed) and pass train_mesh()")
        return False
    if len(mesh.local) != 1:
        raise ValueError(f"a training mesh takes one entry a rank: {mesh!r}")
    return True


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device, non_blocking=True)


def make_train_step(
    model: SSCDModel,
    mesh=None,
    temperature: float = 0.05,
    entropy_weight: float = 30.0,
) -> Callable[[TrainState, Mapping], Tuple[TrainState, torch.Tensor]]:
    """The train step of ``model``: ``step(state, batch)`` with ``batch =
    {"view_a", "view_b"}`` (NCHW float views, ImageNet normalized, as
    ``augment.two_views`` makes them; numpy or tensors) returns ``(state,
    loss)``, the loss a 0-d tensor on the device (the global batch's under
    a mesh). ``state.model`` must be ``model``. The step leaves the
    gradients it applied in the parameters' ``.grad``. ``mesh``: None, or a
    ``train_mesh`` over a pod's ranks (each rank then passes its slice of
    the global batch)."""
    dp = _data_parallel(mesh)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sum_over_ranks = dp
    if dp:
        from vsc2022_torch.parallel.collectives import all_gather_grad, sum_grads_over_ranks

    def step(state: TrainState, batch: Mapping) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the step was built for another model than the state's")
        dev = next(model.parameters()).device
        view_a, view_b = (_as_tensor(batch[k], dev) for k in ("view_a", "view_b"))
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with f32_numerics(dev):
            desc_a, desc_b = _l2n(model(view_a)), _l2n(model(view_b))
            if dp:
                desc_a, desc_b = all_gather_grad(desc_a), all_gather_grad(desc_b)
            loss = sscd_loss(desc_a, desc_b, temperature, entropy_weight)
            loss.backward()
        if dp:
            sum_grads_over_ranks(model.parameters())
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step

