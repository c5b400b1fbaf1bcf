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
    metric: str = "IP",
    precision: str = "highest",
) -> SimilaritySearcher:
    """The port's searcher over the corpus a JAX ``SimilaritySearcher``
    stages: ``refs`` its padded ``_refs`` [N_pad, D], ``n_valid`` its
    ``_n_valid``, ``ref_sq`` its ``_ref_sq``, ``metric`` and ``precision``
    its own. Under "IP" an f32 or bf16 corpus's ``ref_sq`` is all zeros
    (anything else there is an L2 corpus, and raises). Under "L2" the
    ``ref_sq`` holds the rows' squared norms, which the port's searcher
    takes as they are, so the two score every pair on the same norms.

    An int8 corpus (int8 ``refs``, IP only) carries its per-row scales in
    the ``ref_sq`` slot: its codes and scales are staged as they are
    (``SimilaritySearcher.from_int8``), not quantized again.

    A bf16 corpus arrives as an ``ml_dtypes.bfloat16`` array, which
    ``torch.from_numpy`` refuses: its bits are read through a 16-bit
    integer view and widened to f32, which is exact, and the searcher
    rounds them back to bf16, which returns the same bits (a bf16 value
    rounds to itself), so the corpus stages bit for bit. An f32 corpus
    at "default" stages in bf16, as the port's searcher stages it."""
    refs = np.asarray(refs)
    n_valid = int(n_valid)
    if refs.ndim != 2 or not 0 <= n_valid <= refs.shape[0]:
        raise ValueError(f"refs {refs.shape} with n_valid {n_valid}")
    if refs.dtype == np.int8:
        if ref_sq is None or np.asarray(ref_sq).shape != (refs.shape[0],):
            raise ValueError("an int8 corpus needs its scales (ref_sq) [N_pad]")
        if metric != "IP":
            raise NotImplementedError("int8 storage supports metric='IP' only")
        return SimilaritySearcher.from_int8(
            refs[:n_valid], np.asarray(ref_sq)[:n_valid], device=device,
            precision=precision,
        )
    if metric == "IP" and ref_sq is not None and np.any(np.asarray(ref_sq) != 0):
        raise ValueError(
            "a non-zero ref_sq beside f32 or bf16 rows means an L2 corpus: "
            "pass metric='L2'"
        )
    if metric == "L2" and (ref_sq is None or np.asarray(ref_sq).shape != (refs.shape[0],)):
        raise ValueError("an L2 corpus needs its squared norms (ref_sq) [N_pad]")
    if refs.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(refs[:n_valid]).view(np.int16))
        rows, dtype = bits.view(torch.bfloat16).float().numpy(), "bfloat16"
    elif refs.dtype == np.float32:
        rows, dtype = refs[:n_valid], "float32"
    else:
        raise NotImplementedError(
            f"{refs.dtype} corpora are not ported yet (float32, bfloat16 and int8 only)"
        )
    searcher = SimilaritySearcher(rows, metric=metric, precision=precision,
                                  dtype=dtype, device=device)
    if metric == "L2":
        # JAX's norms, as they are (its sum may round otherwise than _row_sq).
        searcher._ref_sq[:n_valid] = torch.from_numpy(
            np.array(ref_sq[:n_valid], dtype=np.float32)).to(searcher.device)
    return searcher


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
