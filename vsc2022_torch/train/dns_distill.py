"""DnS student distillation (counterpart of
``vsc2022_tpu/train/dns_distill.py``).

A student learns to reproduce a fine-grained teacher's video-pair
similarity (the DnS paper's L1 objective), from batches of region
features with the teacher's similarity precomputed:

* fine-grained students (``fg``, ``att`` or ``bin``) score a pair by
  frame chamfer: the mean over query frames of the max over ref frames
  of the region chamfer (``_frame_chamfer``);
* the coarse student (``cg``) by the dot product of its frame
  descriptors mean-pooled over frames and L2-normalized;
* ``bin`` adds the quantization term pulling its codes toward ±1.

The students' forwards are per frame, so a batch [B, T, R, 3840] goes
through them as [B·T, R, 3840]. ``amax`` splits a tie's gradient evenly,
as ``jnp.max`` does. The optimizer is ``torch.optim.Adam`` with
``optax.adam``'s defaults. The JAX package scores the chamfer here with
an XLA ``einsum``, not a Pallas kernel, and so does the port: plain
PyTorch with autograd.

Data parallel (``mesh=`` a ``train_mesh`` over a pod's ranks): each rank
passes its slice of the global batch; the loss is the global batch's
mean (each rank's sums over the global counts), and the gradients are
summed over the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import torch
from torch import nn

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.inference.pipeline import f32_numerics
from vsc2022_torch.models.dns import (
    L3_IMAC_DIM,
    NUM_REGIONS,
    CoarseStudentModule,
    FineGrainedStudentModule,
)
from vsc2022_torch.train.sscd_train import _as_tensor, _data_parallel


@dataclass
class DistillState:
    """The student module, its optimizer and the number of steps taken. A
    step updates it in place."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def build_student_module(student_type: str, fg_type: str = "att") -> nn.Module:
    if student_type == "cg":
        return CoarseStudentModule()
    if student_type != "fg":
        raise ValueError(f"student_type must be cg|fg, got {student_type!r}")
    return FineGrainedStudentModule(fg_type=fg_type)


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8, no decay."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def create_distill_state(
    module: nn.Module,
    learning_rate: float = 1e-3,
    seed: int = 0,
    variables: Optional[Mapping] = None,
    device: DeviceLike = "cuda",
) -> DistillState:
    """``module`` on ``device`` with Adam (``adam``), at step 0. Its weights
    come from ``variables``, a Flax student tree ``{"params": ...}`` as the
    JAX package's distillation checkpoints hold it
    (``convert.dns_student_from_jax``), or else from Flax's distributions
    drawn from ``seed`` (the numbers differ from JAX's ``PRNGKey`` init)."""
    from vsc2022_torch.convert import dns_student_from_jax
    from vsc2022_torch.models.dns import _init_flax_like

    if variables is not None:
        state = dns_student_from_jax(variables, module.student_type,
                                     getattr(module, "fg_type", "att"))
        module.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    else:
        _init_flax_like(module, seed)
    module.to(resolve_device(device)).train()
    return DistillState(module, adam(module.parameters(), learning_rate))


def _frame_chamfer(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[..., Tq, R, D] x [..., Tr, R, D] → [...] video similarity: the mean
    over query frames of the max over ref frames of the region chamfer
    (mean over query regions of the max over ref regions)."""
    sims = torch.einsum("...qad,...rbd->...qrab", q, r)
    frame_sim = sims.amax(dim=-1).mean(dim=-1)  # [..., Tq, Tr]
    return frame_sim.amax(dim=-1).mean(dim=-1)


def _encode(module: nn.Module, regions: torch.Tensor) -> torch.Tensor:
    """[B, T, R, 3840] → the student's encodings [B, T, ...]."""
    b, t = regions.shape[:2]
    out = module(regions.reshape(b * t, NUM_REGIONS, L3_IMAC_DIM))
    return out.reshape(b, t, *out.shape[1:])


def _encoded_pair_similarity(enc_q, enc_r, student_type: str) -> torch.Tensor:
    """[B] video-pair similarities from student encodings."""
    if student_type == "cg":
        pq, pr = enc_q.mean(dim=1), enc_r.mean(dim=1)  # [B, 1024]
        pq = pq / torch.clamp(torch.linalg.norm(pq, dim=-1, keepdim=True), min=1e-12)
        pr = pr / torch.clamp(torch.linalg.norm(pr, dim=-1, keepdim=True), min=1e-12)
        return (pq * pr).sum(dim=-1)
    return _frame_chamfer(enc_q, enc_r)  # [B, T, R, 512] each


def student_pair_similarity(module: nn.Module, q_regions: torch.Tensor,
                            r_regions: torch.Tensor, student_type: str) -> torch.Tensor:
    """Batched video-pair similarity under the student: q_regions /
    r_regions [B, T, R, 3840] (one T a side per batch) → [B]."""
    return _encoded_pair_similarity(_encode(module, q_regions), _encode(module, r_regions),
                                    student_type)


def distill_loss(module: nn.Module, batch: Mapping, student_type: str,
                 quantization_weight: float = 0.0, world: int = 1) -> torch.Tensor:
    """The mean L1 distance of the student's pair similarities to
    ``batch["teacher_sim"]``, plus ``quantization_weight`` times the mean of
    | |code| − 1 | over both sides' encodings (halved), where it is
    positive. ``world``: the ranks the batch is one of ``world`` equal
    slices of (the sums divide by the global counts)."""
    enc_q = _encode(module, batch["q_regions"])
    enc_r = _encode(module, batch["r_regions"])
    sims = _encoded_pair_similarity(enc_q, enc_r, student_type)
    loss = torch.abs(sims - batch["teacher_sim"]).sum() / (sims.numel() * world)
    if quantization_weight > 0.0:
        quant = 0.5 * (torch.abs(torch.abs(enc_q) - 1.0).sum() / (enc_q.numel() * world)
                       + torch.abs(torch.abs(enc_r) - 1.0).sum() / (enc_r.numel() * world))
        loss = loss + quantization_weight * quant
    return loss


def make_distill_step(
    module: nn.Module,
    student_type: str,
    quantization_weight: float = 0.0,
    mesh=None,
) -> Callable[[DistillState, Mapping], Tuple[DistillState, torch.Tensor]]:
    """The distillation step of ``module``: ``step(state, batch)`` with
    ``batch = {"q_regions" [B, T, R, 3840], "r_regions" [B, T', R, 3840],
    "teacher_sim" [B]}`` (numpy or tensors) returns ``(state, loss)``, the
    loss a 0-d tensor on the device (the global batch's under a mesh).
    ``state.module`` must be ``module``; the step leaves the gradients it
    applied in the parameters' ``.grad``. ``quantization_weight`` > 0 adds
    the ±1 pull on fg_bin codes. ``mesh``: None, or a ``train_mesh`` over
    a pod's ranks (each rank then passes its slice of the global batch)."""
    dp = _data_parallel(mesh)
    world = mesh.size if dp else 1
    if dp:
        from vsc2022_torch.parallel.collectives import psum_grad, sum_grads_over_ranks

    def step(state: DistillState, batch: Mapping) -> Tuple[DistillState, torch.Tensor]:
        if state.module is not module:
            raise ValueError("the step was built for another module than the state's")
        dev = next(module.parameters()).device
        local = {k: _as_tensor(batch[k], dev).float()
                 for k in ("q_regions", "r_regions", "teacher_sim")}
        module.train()
        state.optimizer.zero_grad(set_to_none=True)
        with f32_numerics(dev):
            loss = distill_loss(module, local, student_type, quantization_weight, world)
            loss.backward()
        if dp:
            sum_grads_over_ranks(module.parameters())
            loss = psum_grad(loss.detach())
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step
