"""Flat npz checkpoints of variable trees (the port's own copy of
``vsc2022_tpu/utils/checkpoint.py``).

A nested dict of arrays is stored as one npz with '/'-joined keys, so
the files one package writes the other reads: ``dns_index
--checkpoint_path`` takes such a tree in both.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_variables(path: str, variables: Any) -> None:
    np.savez(path, **_flatten(variables))


def load_variables(path: str) -> Any:
    with np.load(path, allow_pickle=False) as data:
        return _unflatten({k: data[k] for k in data.files})
