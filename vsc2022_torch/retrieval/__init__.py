"""Retrieval: frame-level search index, candidate generation and score
normalization."""

from vsc2022_torch.retrieval.candidates import (  # noqa: F401
    CandidateGeneration,
    MaxScoreAggregation,
    ScoreAggregation,
    SumScoreAggregation,
    TopKMeanScoreAggregation,
)
from vsc2022_torch.retrieval.index import (  # noqa: F401
    ScoreNormalizedVideoIndex,
    VideoIndex,
)
