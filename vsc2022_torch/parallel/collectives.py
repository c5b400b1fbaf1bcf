"""The mesh's collectives: ``all_gather``, ``psum`` and ``pmax`` (JAX's
``jax.lax`` collectives over the corpus axis), and ``exchange``, the
point-to-point move of rows between ranks that a resharding needs.

Each takes the results of this process's shards (``parts``, on any of
its devices). Inside one process each part is copied to the lead device
and reduced there in plain torch. On a mesh that spans processes
(``Mesh.spans_processes``) the process's result then merges over the
``torch.distributed`` group, and every rank receives the same tensor:
``all_gather`` concatenates the ranks' results in rank order (mesh order:
a rank's entries are consecutive), with sizes that may differ from rank
to rank along the gathered dimension (they are exchanged first); ``psum``
sums integers and ``pmax`` takes maxima, so no float is ever summed
across ranks and every result is exact and the same on every rank.

Data-parallel training (``vsc2022_torch.train``) has two collectives of
its own, with gradients, over the whole group: ``all_gather_grad`` (the
ranks' rows, in rank order) and ``psum_grad`` (a float sum: BatchNorm's
sums of x and x², the gradients). A float sum depends on its order, so
training's results match one process's within rounding, not bit for bit;
every rank still receives the same bits (each entry is reduced once).

NCCL collectives take the card's tensors as they are. Under gloo a card's
tensor crosses to the host for the collective, and the result comes back
to the lead device: the kernels still run on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from vsc2022_torch.parallel.mesh import Mesh, process_count, process_index


def _on_lead(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [p.to(mesh.lead, non_blocking=True) for p in parts]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's backend takes it: on the host under gloo."""
    import torch.distributed as dist

    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        return t.cpu()
    return t


def _gather_sizes(n: int, device: torch.device) -> List[int]:
    """Every rank's ``n``, in rank order."""
    import torch.distributed as dist

    mine = _wire(torch.tensor([n], dtype=torch.int64, device=device))
    every = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(every, mine)
    return [int(x) for x in every]


def _gather_ranks(local: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``local`` concatenated along ``dim`` in rank order, on
    every rank (on ``local``'s device). The other dimensions agree."""
    import torch.distributed as dist

    sizes = _gather_sizes(local.shape[dim], local.device)
    prefix, suffix = local.shape[:dim], local.shape[dim + 1 :]
    width = 1
    for s in (*prefix, *suffix):
        width *= s
    flat = _wire(local.contiguous().view(-1))
    longest = max(sizes) * width
    if flat.numel() < longest:
        flat = torch.cat([flat, flat.new_zeros(longest - flat.numel())])
    every = [torch.empty_like(flat) for _ in sizes]
    dist.all_gather(every, flat)
    pieces = [f[: n * width].view(*prefix, n, *suffix) for f, n in zip(every, sizes)]
    return torch.cat(pieces, dim).to(local.device)


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 0,
               empty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shards' ``parts`` concatenated along ``dim`` in mesh order, on
    the lead device, on every rank. ``empty`` stands in for a process with
    no part (its shape gives the other dimensions)."""
    local = _on_lead(mesh, parts)
    if local:
        local = torch.cat(local, dim)
    elif empty is not None:
        local = empty.to(mesh.lead)
    else:
        raise ValueError("all_gather of no parts needs `empty`")
    if not mesh.spans_processes:
        return local
    return _gather_ranks(local, dim)


def _reduce(mesh: Mesh, local: torch.Tensor, op: str) -> torch.Tensor:
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist

    wire = _wire(local.contiguous())
    dist.all_reduce(wire, op=getattr(dist.ReduceOp, op))
    return wire.to(mesh.lead)


def psum(mesh: Mesh, parts: Sequence[torch.Tensor], empty: torch.Tensor) -> torch.Tensor:
    """The sum of the shards' integer ``parts`` (one shape), on every rank.
    ``empty``: a process's zeros where it has no part."""
    if empty.is_floating_point():
        raise TypeError("psum sums integers only: a float sum across ranks "
                        "would depend on their order")
    local = _on_lead(mesh, parts)
    local = torch.stack(local).sum(0).to(empty.dtype) if local else empty.to(mesh.lead)
    return _reduce(mesh, local, "SUM")


def pmax(mesh: Mesh, parts: Sequence[torch.Tensor], empty: torch.Tensor) -> torch.Tensor:
    """The elementwise max of the shards' ``parts`` (one shape), on every
    rank. ``empty``: a process's stand-in where it has no part (−inf)."""
    local = _on_lead(mesh, parts)
    local = torch.stack(local).amax(0) if local else empty.to(mesh.lead)
    return _reduce(mesh, local, "MAX")


def exchange(mesh: Mesh, send: Dict[int, torch.Tensor], recv: Dict[int, int],
             like: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Point-to-point rows between ranks, in one ``all_to_all``: ``send[r]``
    (rows along dim 0) goes to rank r, and ``recv[r]`` rows come from rank
    r; every rank passes the counts the others send it. Returns {rank:
    rows received}, on the lead device. ``like``: a tensor of the rows'
    dtype and trailing shape. This process's own rows are not exchanged
    (``send`` and ``recv`` leave it out)."""
    import torch.distributed as dist

    me, n = process_index(), process_count()
    trail = tuple(like.shape[1:])
    out_sizes = [0 if r == me else int(recv.get(r, 0)) for r in range(n)]
    blocks = [send[r] if r != me and r in send else None for r in range(n)]
    in_sizes = [0 if b is None else b.shape[0] for b in blocks]
    wire = _wire(torch.empty(0, device=mesh.lead)).device
    wire_in = torch.cat([b.to(wire) for b in blocks if b is not None]
                        or [torch.empty((0, *trail), dtype=like.dtype, device=wire)])
    wire_out = torch.empty((sum(out_sizes), *trail), dtype=like.dtype, device=wire)
    dist.all_to_all_single(wire_out, wire_in.contiguous(), out_sizes, in_sizes)
    got, at = {}, 0
    for r, k in enumerate(out_sizes):
        if k:
            got[r] = wire_out[at : at + k].to(mesh.lead)
        at += k
    return got


# ---- training's collectives, with gradients ---------------------------------------


def _sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The elementwise float sum of every rank's ``t``, on every rank (a new
    tensor on ``t``'s device)."""
    import torch.distributed as dist

    wire = _wire(t.detach().clone(memory_format=torch.contiguous_format))
    dist.all_reduce(wire, op=dist.ReduceOp.SUM)
    return wire.to(t.device)


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _sum_over_ranks(t)

    @staticmethod
    def backward(ctx, grad):
        # Each rank's gradient covers its own use of the sum: the
        # gradient of every rank's term is their sum.
        return _sum_over_ranks(grad)


def psum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t`` (one shape), on every rank; its
    backward sums the ranks' gradients too."""
    return _PsumGrad.apply(t)


class _AllGatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local):
        import torch.distributed as dist

        wire = _wire(local.detach().contiguous())
        every = [torch.empty_like(wire) for _ in range(process_count())]
        dist.all_gather(every, wire)
        ctx.rows = (process_index() * local.shape[0], local.shape[0])
        return torch.cat(every).to(local.device)

    @staticmethod
    def backward(ctx, grad):
        at, n = ctx.rows
        return grad[at : at + n]


def all_gather_grad(local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` rows (one shape on every rank) concatenated
    in rank order, on every rank. Every rank computes the same function
    of the gathered rows (the global loss), so the gradient of a rank's
    rows is its own slice of the output's gradient: no sum over ranks,
    which would scale it by their number."""
    return _AllGatherGrad.apply(local)


def sum_grads_over_ranks(params) -> None:
    """Replace each parameter's ``.grad`` by its sum over the ranks, in one
    collective (the grads flattened into one buffer). Parameters without a
    gradient count as zeros, so every rank passes the same buffer."""
    params = list(params)
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    flat = _sum_over_ranks(flat)
    at = 0
    for p in params:
        summed = flat[at : at + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = summed.clone()
        else:
            p.grad.copy_(summed)
        at += p.numel()
