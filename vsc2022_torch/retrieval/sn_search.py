"""Score-normalized search over flat arrays: the serving query path.

Counterpart of ``vsc2022_tpu/retrieval/sn_search.py``. The reference runs
score normalization and retrieval
as separate FAISS stages with host round trips between them (reference:
vsc/baseline/score_normalization.py:86-105 then vsc/index.py:142-165).
Here the queries cross to the device once: the noise-NN bias is the
``row_max`` kernel over the staged noise corpus, the −β·sim column is
appended on the device, and the bias-augmented queries go straight into
``global_topk``. References get their constant-1 column once, at stage
time (and at ``append_refs``).

The JAX searcher fuses bias, candidates, τ and counts into one dispatch
to save host↔device round trips; on the GPU each step is its own kernel
launch on one stream, with the same results.

``dtype="bfloat16"`` stages both corpora and the queries in bf16, as the
JAX fused path does: the bias column is rounded to bf16 with the queries
it is appended to, and ``last_q_sn`` holds that bf16 matrix, which the
serving localizer aligns with.

``dtype="int8"`` stages both corpora as int8 codes with per-row scales
(the SN references' constant-1 column quantized with its row, as in the
JAX package), while the queries and the bias column stay f32: the bias
is the ``row_max`` kernel's int8 variant over the noise codes, and
``last_q_sn`` is f32.

``mesh`` (``vsc2022_torch.parallel.Mesh``) shards both corpora over its
entries (``ShardedSimilaritySearcher``), as the JAX package's fused
sharded pipeline does: the bias is each noise shard's ``row_max``, the max
over the shards, appended on the lead device, and the bias-augmented
queries go into the sharded candidate phase. Over a pod mesh the max
runs over every rank's shards (``pmax``), so every rank appends the same
bias.

``ivf_nlist`` lays the reference corpus out for the IVF tier
(``IVFSimilaritySearcher``, ``ivf_nprobe`` its probe width; no mesh); the
noise corpus stays a plain searcher (its row max never prunes). As in JAX,
where an IVF searcher never takes the fused one-dispatch path, ``last_q_sn``
keeps the bias unrounded (f32 beside the staged query columns); the
searcher rounds it to the query dtype when it stages the queries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike
from vsc2022_torch.ops.ivf import IVFSimilaritySearcher
from vsc2022_torch.parallel.sharded_search import make_searcher


def _with_ones(rows) -> np.ndarray:
    rows = np.asarray(rows, dtype=np.float32)
    return np.concatenate([rows, np.ones((rows.shape[0], 1), np.float32)], axis=1)


class ScoreNormalizedSearcher:
    """Flat-array score-norm + global-top-k searcher."""

    def __init__(
        self,
        refs: np.ndarray,  # [N, D] reference frame descriptors
        noise: np.ndarray,  # [Nn, D] independent noise corpus
        beta: float = 1.2,
        precision: str = "highest",
        dtype: str = "float32",
        device: DeviceLike = "cuda",
        mesh=None,
        ivf_nlist: Optional[int] = None,
        ivf_nprobe: Optional[int] = None,
    ):
        """``mesh``: shard both corpora over it (its lead device stands for
        ``device``). ``ivf_nlist``, ``ivf_nprobe``: the reference corpus's
        IVF tier (module docstring)."""
        self.beta = beta
        noise = np.ascontiguousarray(noise, dtype=np.float32)
        self.searcher = make_searcher(_with_ones(refs), mesh, device,
                                      precision=precision, dtype=dtype,
                                      ivf_nlist=ivf_nlist, ivf_nprobe=ivf_nprobe)
        self.noise_searcher = make_searcher(noise, mesh, device,
                                            precision=precision, dtype=dtype)
        # The bias-augmented queries of the most recent global_topk, on the
        # device; serving localizes with them instead of a second noise-NN
        # pass. Single-threaded use only.
        self.last_q_sn: Optional[torch.Tensor] = None

    def append_refs(self, refs_transformed: np.ndarray) -> None:
        """Grow the staged corpus with reference rows already in the
        normalized space (dimension drop and L2 applied by the caller);
        the constant-1 column appends here. The noise corpus is fixed."""
        self.searcher.append_rows(_with_ones(refs_transformed))

    def keep_refs(self, keep_idx) -> None:
        """Shrink the staged corpus to exactly these surviving rows (the
        constant-1 column rides along)."""
        self.searcher.keep_rows(keep_idx)

    def normalize_queries(self, queries) -> torch.Tensor:
        """Stage the queries and append the −β·NN-similarity column, on
        the device: [M, D + 1] f32. Under bf16 the query columns hold the
        staged bf16 values and the bias stays f32, as JAX's concatenation
        promotes them."""
        ns = self.noise_searcher
        q = ns._stage_queries(queries)
        bias = ns.row_max(q)
        return torch.cat([q.float(), (-self.beta * bias)[:, None]], dim=1)

    def global_topk(
        self, queries, k: int, kappa: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        q_sn = self.normalize_queries(queries)
        s, ns = self.searcher, self.noise_searcher
        if len(q_sn) and k > 0 and s.n_refs and ns.n_refs and not isinstance(
                s, IVFSimilaritySearcher):
            # JAX's fused path (taken on these conditions, never by an IVF
            # searcher) rounds the bias to the query dtype and keeps that
            # matrix (f32 under int8).
            q_sn = q_sn.to(s.query_dtype)
        self.last_q_sn = q_sn
        return s.global_topk(q_sn, k, kappa=kappa)
