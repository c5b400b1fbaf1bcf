"""CSLS-style score normalization, computed on device (counterpart of
``vsc2022_tpu/retrieval/score_norm.py``).

Semantics (reference: vsc/baseline/score_normalization.py:31-105):

  bias(query) = −β · sim(query, nearest neighbor in noise corpus)

encoded as an extra descriptor dimension — queries get their bias
appended, references get a constant 1 appended — so that plain inner
product realizes the normalized similarity:

  [q  bias(q)] · [r  1] = sim(q, r) + bias(q)

The k=1 noise-NN search is the fused ``row_max`` kernel over the noise
corpus (one matmul + max-reduce pass; no [M, N] score matrix) rather
than a FAISS index build. Guards, the min-variance dimension drop
(``replace_dim``) and optional L2 normalization follow the reference
exactly.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Tuple

import numpy as np

from vsc2022_torch.device import DeviceLike
from vsc2022_torch.ops.similarity import SimilaritySearcher
from vsc2022_torch.types import VideoFeature

logger = logging.getLogger(__name__)


def transform_features(
    features: List[VideoFeature], transform: Callable[[np.ndarray], np.ndarray]
) -> List[VideoFeature]:
    return [
        dataclasses.replace(feature, feature=transform(feature.feature))
        for feature in features
    ]


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    """Row-wise L2 normalization (sklearn ``normalize`` equivalent;
    zero rows are left unchanged, matching sklearn)."""
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    norms = np.where(norms == 0, 1.0, norms)
    return x / norms


def check_independent_ids(ref_ids, noise_ids) -> None:
    """The eval-set rule check shared by the list pipeline and the
    serving index (reference: score_normalization.py:63-67)."""
    overlap = set(ref_ids) & set(noise_ids)
    if overlap:
        raise Exception(
            f"Noise corpus shares {len(overlap)} video(s) with the eval "
            "refs; VSC rules require score normalization against an "
            "independent dataset."
        )


def _check_independent(refs, score_norm_refs) -> None:
    check_independent_ids(
        (f.video_id for f in refs), (f.video_id for f in score_norm_refs)
    )


def min_variance_dim(noise_rows: np.ndarray) -> int:
    """The bias dimension's victim, chosen on the noise corpus
    (reference: score_normalization.py:68-79) — one definition shared
    by the list pipeline and the serving index."""
    return int(noise_rows.var(axis=0).argmin())


def _drop_min_variance_dim(feature_sets):
    """Free up one dimension for the bias by deleting the least
    informative one, chosen on the noise corpus (feature_sets[-1];
    reference: vsc/baseline/score_normalization.py:68-79)."""
    noise_rows = np.concatenate([f.feature for f in feature_sets[-1]], axis=0)
    victim = min_variance_dim(noise_rows)
    logger.info(f"Dropping min-variance dimension {victim}")
    drop = lambda f: np.delete(f, victim, axis=1)  # noqa: E731
    return [transform_features(fs, drop) for fs in feature_sets]


def _append_bias_dim(queries, all_similarity, beta):
    """Per-video split of the batched noise-NN result, appended as the
    −β·sim CSLS dimension."""
    out = []
    offset = 0
    for query in queries:
        sim = all_similarity[offset : offset + len(query)]
        offset += len(query)
        bias_col = (-beta * sim)[:, None].astype(query.feature.dtype)
        out.append(
            dataclasses.replace(
                query,
                feature=np.concatenate([query.feature, bias_col], axis=1),
            )
        )
    return out


def _append_ones_dim(refs):
    out = []
    for ref in refs:
        with_ones = np.concatenate(
            [ref.feature, np.ones_like(ref.feature[:, :1])], axis=1
        )
        out.append(dataclasses.replace(ref, feature=with_ones))
    return out


def score_normalize(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    score_norm_refs: List[VideoFeature],
    l2_normalize: bool = True,
    replace_dim: bool = True,
    beta: float = 1.0,
    dtype: str = "float32",
    device: DeviceLike = "cuda",
) -> Tuple[List[VideoFeature], List[VideoFeature]]:
    """Normalize queries and refs against the noise corpus
    ``score_norm_refs``; the noise-NN runs on ``device``, over a noise
    corpus staged in ``dtype`` (bf16: the queries too, so the biases
    come from bf16 products; int8: SQ8 codes with per-row scales against
    f32 queries; the appended column stays f32)."""
    _check_independent(refs, score_norm_refs)
    if score_norm_refs is not None and replace_dim:
        queries, refs, score_norm_refs = _drop_min_variance_dim(
            [queries, refs, score_norm_refs]
        )
    if l2_normalize:
        logger.info("L2-normalizing descriptor rows")
        queries, refs, score_norm_refs = [
            transform_features(x, l2_normalize_rows)
            for x in [queries, refs, score_norm_refs]
        ]

    logger.info(f"Score-normalizing with beta={beta}")
    noise_corpus = np.concatenate([ref.feature for ref in score_norm_refs], axis=0)
    searcher = SimilaritySearcher(
        noise_corpus.astype(np.float32), dtype=dtype, device=device
    )

    # One fused pass over ALL query frames: nearest-noise similarity
    # (the reference loops a FAISS search per video;
    # vsc/baseline/score_normalization.py:93-99).
    all_query_frames = np.concatenate(
        [q.feature for q in queries], axis=0
    ).astype(np.float32)
    all_similarity = searcher.row_nn(all_query_frames)

    return (
        _append_bias_dim(queries, all_similarity, beta),
        _append_ones_dim(refs),
    )
