"""Device meshes of one process (counterpart of
``vsc2022_tpu/parallel/mesh.py``).

The JAX package shards the reference corpus over a ``jax.sharding.Mesh``
of every chip and replicates the queries; partial top-k results merge
with an all-gather and the verify counts are summed over the shards. Here
a mesh is one process holding an ordered tuple of ``torch.device``s, one
shard per entry, and a collective is a copy of each shard's result to the
lead device (the first entry) followed by a plain reduction there:
``all_gather`` is ``torch.cat`` of the results moved ``non_blocking``,
``psum`` a sum, ``pmax`` a max. On a machine with several cards the copies
go peer to peer, as JAX's ``shard_map`` does on one host.

Entries may repeat: ``Mesh(["cpu"] * 8)`` gives eight shards on the CPU
(the JAX tests' eight virtual devices), ``Mesh(["cuda:0"] * 4)`` four on
one card, where the shards' kernels queue on one stream. ``corpus_mesh``
takes every visible device of a kind, as ``jax.devices()`` does.

Multi-host initialization and the training mesh (``train_mesh``) are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from vsc2022_torch.device import DeviceLike, resolve_device


class Mesh:
    """A 1-D mesh: an ordered tuple of devices on the corpus axis."""

    axis_names = ("corpus",)

    def __init__(self, devices: Sequence[DeviceLike]):
        self.devices: Tuple[torch.device, ...] = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device results merge on: the first entry."""
        return self.devices[0]

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


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


def corpus_mesh(n_devices: Optional[int] = None, device: DeviceLike = "cuda") -> Mesh:
    """1-D mesh over the corpus-sharding axis: the first ``n_devices``
    visible devices of ``device``'s kind (all of them by default)."""
    devices = _devices(device)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"Requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host initialization; a no-op for one process, as in JAX."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError(
        "multi-host initialization (num_processes > 1) is not ported yet")


def first_axis_size(mesh: Mesh) -> int:
    return mesh.size


def first_axis_sharding(mesh: Mesh) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """The split of a tensor's leading dim over the mesh's first axis (the
    convention for batch and pair data parallelism): a function that maps
    a tensor whose leading dim divides by the mesh size to its equal
    slices, slice i moved to entry i's device (non-blocking)."""
    n = first_axis_size(mesh)

    def split(x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[0] % n:
            raise ValueError(f"leading dim {x.shape[0]} does not divide by the "
                             f"mesh's {n} entries")
        step = x.shape[0] // n
        return [x[i * step : (i + 1) * step].to(dev, non_blocking=True)
                for i, dev in enumerate(mesh.devices)]

    return split
