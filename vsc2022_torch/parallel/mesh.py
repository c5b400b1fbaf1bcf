"""Device meshes, of one process or of a pod of processes (counterpart of
``vsc2022_tpu/parallel/mesh.py``).

The JAX package shards the reference corpus over a ``jax.sharding.Mesh``
of every chip and replicates the queries; partial top-k results merge
with an all-gather and the verify counts are summed over the shards. Here
a mesh is an ordered tuple of ``torch.device``s, one shard per entry, each
entry owned by a process (its rank). Inside one process a collective is a
copy of each shard's result to the lead device (the process's first
entry) followed by a plain reduction there: ``all_gather`` is
``torch.cat`` of the results moved ``non_blocking``, ``psum`` a sum,
``pmax`` a max. On a machine with several cards the copies go peer to
peer, as JAX's ``shard_map`` does on one host. A mesh whose entries belong
to several ranks (a pod, ``pod_mesh``) then merges the processes' results
over the ``torch.distributed`` group (``parallel/collectives.py``), so
every rank ends a collective with the same tensor.

Entries may repeat: ``Mesh(["cpu"] * 8)`` gives eight shards on the CPU
(the JAX tests' eight virtual devices), ``Mesh(["cuda:0"] * 4)`` four on
one card, where the shards' kernels queue on one stream. ``corpus_mesh``
takes every visible device of a kind, as ``jax.devices()`` does; after
``initialize_distributed`` it takes each rank's device, in rank order.

Multi-host: ``initialize_distributed`` joins the process group (NCCL
between ranks on separate cards, gloo on the CPU or where ranks share a
card: NCCL refuses two ranks on one card). A rank's device is its
``--device``: ``cuda:N`` as given, ``cuda`` the card ``process_id %
device_count``.

Training (``train_mesh``) is data parallel with one rank a card: the
batch splits over the ranks, BatchNorm's statistics and InfoNCE's
negatives cover the global batch, and the gradients are summed over the
ranks, JAX's global-array semantics. JAX's ``train_mesh`` also has a
"model" axis that splits the 2048→512 projection's columns; that is a
layout, not a capability, and the port leaves it out: the loss is the
same either way.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from vsc2022_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


def process_index() -> int:
    """This process's rank in the pod (0 outside one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The pod's process count (1 outside one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """A 1-D mesh: an ordered tuple of devices on the corpus axis, and the
    rank that owns each entry (``ranks``; by default this process owns
    every entry). The entries of a rank are consecutive, ranks in
    increasing order, and every rank of the pod owns one where the mesh
    spans several."""

    axis_names = ("corpus",)

    def __init__(self, devices: Sequence[DeviceLike], ranks: Optional[Sequence[int]] = None):
        me = process_index()
        ranks = tuple([me] * len(devices) if ranks is None else (int(r) for r in ranks))
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(ranks) != len(devices):
            raise ValueError(f"{len(devices)} devices but {len(ranks)} ranks")
        if any(b < a for a, b in zip(ranks, ranks[1:])):
            raise ValueError(f"a mesh's ranks must not decrease: {ranks}")
        self.ranks: Tuple[int, ...] = ranks
        self.spans_processes = len(set(ranks)) > 1
        if self.spans_processes and sorted(set(ranks)) != list(range(process_count())):
            raise ValueError(f"a pod mesh needs an entry on each of the "
                             f"{process_count()} ranks; it has ranks {sorted(set(ranks))}")
        # Another rank's devices are names only: they need not exist here.
        self.devices: Tuple[torch.device, ...] = tuple(
            resolve_device(d) if r == me else torch.device(d) for d, r in zip(devices, ranks))
        self.local: Tuple[int, ...] = tuple(s for s, r in enumerate(ranks) if r == me)
        if not self.local:
            raise ValueError(f"rank {me} owns no entry of the mesh")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device this process's results merge on: its first entry."""
        return self.devices[self.local[0]]

    def is_local(self, s: int) -> bool:
        """Whether this process owns entry s."""
        return self.ranks[s] == process_index()

    def distinct(self) -> List[torch.device]:
        """This process's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices[s] for s in self.local))

    def __repr__(self) -> str:
        if not self.spans_processes:
            return f"Mesh({[str(d) for d in self.devices]})"
        return f"Mesh({[f'{r}:{d}' for r, d in zip(self.ranks, self.devices)]})"


def on_device(dev: torch.device):
    """The context to launch ``dev``'s work in: ``dev`` the current card
    (a hand kernel's launch makes its tensors' card current; on leaving,
    the card that was current before is again), nothing on the CPU."""
    return torch.cuda.device(dev.index if dev.type == "cuda" else -1)


def _devices(kind: DeviceLike) -> List[torch.device]:
    """Every visible device of ``kind``'s type ("cuda": each card; "cpu":
    the one CPU device)."""
    dev = resolve_device(kind)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def local_device_count(device: DeviceLike = "cuda") -> int:
    return len(_devices(device))


def pod_mesh(local_devices: Sequence[DeviceLike]) -> Mesh:
    """The mesh of every rank's ``local_devices``, in rank order (each rank
    passes its own): the device lists are gathered once over the group.
    Outside a pod, ``Mesh(local_devices)``."""
    local = [str(resolve_device(d)) for d in local_devices]
    if process_count() == 1:
        return Mesh(local)
    import torch.distributed as dist

    every: List[Optional[List[str]]] = [None] * process_count()
    dist.all_gather_object(every, local)
    return Mesh([d for devs in every for d in devs],
                [r for r, devs in enumerate(every) for _ in devs])


def corpus_mesh(n_devices: Optional[int] = None, device: DeviceLike = "cuda") -> Mesh:
    """1-D mesh over the corpus-sharding axis: the first ``n_devices``
    visible devices of ``device``'s kind (all of them by default). In a
    pod, each rank's device (``device`` as this rank resolves it), in
    rank order, as ``jax.devices()`` spans every host's chips."""
    if process_count() > 1:
        mesh = pod_mesh([device])
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"Requested {n_devices} devices of a pod of {mesh.size}: "
                             "a pod mesh takes every rank's device")
        return mesh
    devices = _devices(device)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"Requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


def rank_device(device: DeviceLike, process_id: int) -> torch.device:
    """A pod rank's device: ``cuda:N`` and ``cpu`` as given; ``cuda`` (or
    None) the card ``process_id % device_count``, so that ranks on one
    host spread over its cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % max(torch.cuda.device_count(), 1))
    return resolve_device(dev)  # raises where there is no card


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Optional[torch.device]:
    """Multi-host initialization; a no-op for one process, as in JAX.
    Joins the ``torch.distributed`` group at ``tcp://coordinator_address``
    (rank 0 serves the rendezvous there) as rank ``process_id`` of
    ``num_processes``, and makes this rank's device (``rank_device``)
    the current card. ``backend``: "nccl" or "gloo"; None picks NCCL when
    the rank's device is a card and gloo on the CPU. Ranks that share a
    card must pass "gloo": NCCL refuses two ranks on one card. Returns the
    rank's device (None for one process)."""
    if num_processes is None or num_processes <= 1:
        return None
    if not coordinator_address:
        raise ValueError("num_processes > 1 requires a coordinator address "
                         "host:port (rank 0's rendezvous)")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range [0, {num_processes})")
    dev = rank_device(device, process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a card: pass backend='gloo' on the CPU")
    import torch.distributed as dist

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dev


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def train_mesh(n_devices: Optional[int] = None, device: DeviceLike = "cuda") -> Mesh:
    """The data-parallel training mesh (axis "data"): one entry a rank,
    each rank's ``device``, in rank order; outside a pod, the one device.
    ``n_devices``, when given, must be the number of ranks. The training
    step builders (``make_train_step``, ``make_distill_step``) take it as
    ``mesh=``."""
    mesh = pod_mesh([device])
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"Requested {n_devices} devices, but the group has "
                         f"{mesh.size} rank(s): a training mesh takes one device a rank")
    mesh.axis_names = ("data",)
    return mesh


def first_axis_size(mesh: Mesh) -> int:
    return mesh.size


def first_axis_sharding(mesh: Mesh) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """The split of a tensor's leading dim over the mesh's first axis (the
    convention for batch and pair data parallelism): a function that maps
    a tensor whose leading dim divides by the mesh size to its equal
    slices, slice i moved to entry i's device (non-blocking). One
    process's meshes only: a pod's ranks split their own data."""
    if mesh.spans_processes:
        raise ValueError("first_axis_sharding splits over one process's devices, "
                         "not a pod mesh")
    n = first_axis_size(mesh)

    def split(x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[0] % n:
            raise ValueError(f"leading dim {x.shape[0]} does not divide by the "
                             f"mesh's {n} entries")
        step = x.shape[0] // n
        return [x[i * step : (i + 1) * step].to(dev, non_blocking=True)
                for i, dev in enumerate(mesh.devices)]

    return split
