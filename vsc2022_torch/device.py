"""Device resolution for the port's entry points.

Everything runs on ``cuda`` unless the caller passes ``"cpu"``. Asking
for ``cuda`` on a machine without a GPU raises; nothing falls back to
the CPU on its own. ``cuda:N`` names a card: a pod's rank may take one
(``vsc2022_torch.parallel.mesh.rank_device``).
"""

from __future__ import annotations

import argparse
import re
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` (the default, also for ``None``; the current card),
    ``"cuda:N"`` or ``"cpu"`` as a ``torch.device``; raises when CUDA is
    asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


# The devices the JAX entry points' ``--accelerator`` values name here: the CPU,
# or the card (their ``tpu`` is this port's accelerator).
ACCELERATOR_DEVICES = {"cpu": "cpu", "cuda": "cuda", "tpu": "cuda"}


def device_flag(value: str) -> str:
    """The ``--device`` flag's type: ``cuda``, ``cuda:N`` or ``cpu``."""
    if value in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", value):
        return value
    raise argparse.ArgumentTypeError(f"invalid device {value!r}: cuda, cuda:N or cpu")


class _Unset(str):
    """The device flags' default, ``"cuda"``, told apart from a given
    ``cuda`` by its identity."""


_DEFAULT_DEVICE = _Unset("cuda")


class _DeviceFlag(argparse.Action):
    """``--device`` and ``--accelerator`` set one ``device``; a second
    flag that names another device is an error."""

    def __call__(self, parser, namespace, value, option_string=None):
        device = ACCELERATOR_DEVICES.get(value, value)
        if namespace.device is not _DEFAULT_DEVICE and namespace.device != device:
            parser.error(f"{option_string} {value} selects {device}, but an "
                         f"earlier flag selected {namespace.device}")
        namespace.device = device


def add_device_flags(parser: argparse.ArgumentParser) -> None:
    """``--device {cuda,cuda:N,cpu}`` and the JAX entry points'
    ``--accelerator {cpu,cuda,tpu}`` (``tpu`` and ``cuda`` select the
    card). Either sets ``args.device``, ``cuda`` when neither is given."""
    parser.add_argument(
        "--device", action=_DeviceFlag, type=device_flag,
        default=_DEFAULT_DEVICE,
        help="Device to run on: cuda (the default; raises when no GPU is "
        "present), cuda:N or cpu.",
    )
    parser.add_argument(
        "--accelerator", dest="device", action=_DeviceFlag,
        choices=tuple(ACCELERATOR_DEVICES), default=_DEFAULT_DEVICE,
        help="The JAX entry points' flag: cpu runs on the CPU, cuda or tpu on "
        "the card.",
    )
