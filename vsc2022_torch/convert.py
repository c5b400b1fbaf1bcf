"""Carry state from the JAX package into the port.

Every function takes plain values (numpy arrays, dicts), so this module
imports nothing of JAX: the caller converts first, e.g.
``np.asarray(jax_searcher._refs)``, ``jax_params._asdict()`` or a Flax
variable tree mapped through ``np.asarray``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike
from vsc2022_torch.ops.similarity import SimilaritySearcher
from vsc2022_torch.ops.tn_align import TNParams


def searcher_from_arrays(
    refs: np.ndarray,
    n_valid: int,
    ref_sq: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
) -> SimilaritySearcher:
    """The port's searcher over the corpus a JAX ``SimilaritySearcher``
    stages: ``refs`` its padded ``_refs`` [N_pad, D], ``n_valid`` its
    ``_n_valid``, ``ref_sq`` its ``_ref_sq`` (all zeros for an f32 or
    bf16 IP corpus; anything else there is an L2 corpus, not ported yet).

    An int8 corpus (int8 ``refs``) carries its per-row scales in the
    ``ref_sq`` slot: its codes and scales are staged as they are
    (``SimilaritySearcher.from_int8``), not quantized again.

    A bf16 corpus arrives as an ``ml_dtypes.bfloat16`` array, which
    ``torch.from_numpy`` refuses: its bits are read through a 16-bit
    integer view and widened to f32, which is exact, and the searcher
    rounds them back to bf16, which returns the same bits (a bf16 value
    rounds to itself), so the corpus stages bit for bit."""
    refs = np.asarray(refs)
    n_valid = int(n_valid)
    if refs.ndim != 2 or not 0 <= n_valid <= refs.shape[0]:
        raise ValueError(f"refs {refs.shape} with n_valid {n_valid}")
    if refs.dtype == np.int8:
        if ref_sq is None or np.asarray(ref_sq).shape != (refs.shape[0],):
            raise ValueError("an int8 corpus needs its scales (ref_sq) [N_pad]")
        return SimilaritySearcher.from_int8(
            refs[:n_valid], np.asarray(ref_sq)[:n_valid], device=device
        )
    if ref_sq is not None and np.any(np.asarray(ref_sq) != 0):
        raise NotImplementedError(
            "a non-zero ref_sq beside f32 or bf16 rows means an L2 corpus, "
            "not ported yet"
        )
    if refs.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(refs[:n_valid]).view(np.int16))
        widened = bits.view(torch.bfloat16).float().numpy()
        return SimilaritySearcher(widened, dtype="bfloat16", device=device)
    if refs.dtype != np.float32:
        raise NotImplementedError(
            f"{refs.dtype} corpora are not ported yet (float32, bfloat16 and int8 only)"
        )
    return SimilaritySearcher(refs[:n_valid], device=device)


def tn_params_from_jax(params: Mapping) -> TNParams:
    """The port's ``TNParams`` from a JAX ``TNParams._asdict()``."""
    unknown = set(params) - set(TNParams._fields)
    if unknown:
        raise ValueError(f"unknown TN parameters: {sorted(unknown)}")
    return TNParams(**dict(params))


def dns_student_from_jax(
    variables: Mapping, student_type: str, fg_type: str = "att"
) -> Dict[str, np.ndarray]:
    """The port's DnS student state dict (numpy arrays, torch names) from
    a Flax ``DnSStudent`` variable tree ``{"params": {"reduction":
    {"kernel", "bias"}, "attention": {"context"}, "rotation"?,
    "project"?}}``, as ``save_variables`` writes it. Dense kernels
    [in, out] become Linear weights [out, in]; the context [512, 1]
    becomes ``attention.context_vector.weight`` [1, 512]; the rotation is
    used as ``x @ W`` on both sides, so it is taken as it is."""
    if student_type not in ("cg", "fg"):
        raise ValueError(f"student_type must be cg|fg, got {student_type!r}")
    params = variables["params"]

    def arr(x):
        return np.asarray(x, dtype=np.float32)

    state = {
        "reduction.weight": arr(params["reduction"]["kernel"]).T.copy(),
        "reduction.bias": arr(params["reduction"]["bias"]),
        "attention.context_vector.weight": arr(params["attention"]["context"]).T.copy(),
    }
    if student_type == "cg":
        state["project.weight"] = arr(params["project"]["kernel"]).T.copy()
        state["project.bias"] = arr(params["project"]["bias"])
    elif fg_type == "bin":
        state["binarization.W"] = arr(params["rotation"])
    return state
