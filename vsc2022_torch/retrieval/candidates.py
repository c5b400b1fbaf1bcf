"""Candidate generation: frame-level search → video-pair ranking
(counterpart of ``vsc2022_tpu/retrieval/candidates.py``).

Pipeline (reference behavior: vsc/candidates.py): search the frame
index, reduce each (query video, ref video) group of frame matches to
one score, and rank pairs best-first. Aggregations are vectorized over
each pair's match list; ``MaxScoreAggregation`` is the reference's
(and the challenge's) scoring rule, the others are framework
extensions for experimentation.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import numpy as np

from vsc2022_torch.device import DeviceLike
from vsc2022_torch.metrics import CandidatePair
from vsc2022_torch.retrieval.index import VideoIndex
from vsc2022_torch.types import PairMatches, VideoFeature


class ScoreAggregation(ABC):
    """Reduces one pair's frame-match scores to a single pair score."""

    @abstractmethod
    def aggregate(self, match: PairMatches) -> float:
        ...

    def score(self, match: PairMatches) -> CandidatePair:
        return CandidatePair(
            query_id=match.query_id,
            ref_id=match.ref_id,
            score=self.aggregate(match),
        )

    def _scores(self, match: PairMatches) -> np.ndarray:
        return np.fromiter(
            (m.score for m in match.matches), dtype=np.float64,
            count=len(match.matches),
        )


class MaxScoreAggregation(ScoreAggregation):
    """Pair score = best frame-match score (reference:
    vsc/candidates.py:24-26; what the VSC baselines use)."""

    def aggregate(self, match: PairMatches) -> float:
        return float(self._scores(match).max())


class SumScoreAggregation(ScoreAggregation):
    """Pair score = sum of frame-match scores: rewards pairs with many
    matching frames (extension; not used by the reference baselines)."""

    def aggregate(self, match: PairMatches) -> float:
        return float(self._scores(match).sum())


class TopKMeanScoreAggregation(ScoreAggregation):
    """Pair score = mean of the best k frame-match scores (extension)."""

    def __init__(self, k: int = 5):
        self.k = k

    def aggregate(self, match: PairMatches) -> float:
        scores = self._scores(match)
        k = min(self.k, scores.size)
        return float(np.sort(scores)[-k:].mean())


def rank_candidates(
    matches: List[PairMatches], aggregation: ScoreAggregation
) -> List[CandidatePair]:
    """Aggregate every pair and rank descending by score."""
    ranked = [aggregation.score(m) for m in matches]
    ranked.sort(key=lambda c: c.score, reverse=True)
    return ranked


class CandidateGeneration:
    """Owns the frame index over the reference corpus and turns query
    searches into ranked candidate pairs."""

    def __init__(
        self,
        references: List[VideoFeature],
        aggregation: ScoreAggregation,
        dtype: str = "float32",
        device: DeviceLike = "cuda",
        mesh=None,
    ):
        """``mesh``: shard the reference corpus over it (``VideoIndex``)."""
        self.aggregation = aggregation
        self.index = VideoIndex(
            references[0].dimensions(), dtype=dtype, device=device, mesh=mesh
        )
        self.index.add(references)

    def query(
        self, queries: List[VideoFeature], global_k: int
    ) -> List[CandidatePair]:
        matches = self.index.search(queries, global_k=global_k)
        return rank_candidates(matches, self.aggregation)
