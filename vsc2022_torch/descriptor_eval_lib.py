"""Descriptor-track evaluation driver (counterpart of
``vsc2022_tpu/descriptor_eval_lib.py``).

Reproduces the reference evaluation protocol exactly (reference:
vsc/descriptor_eval_lib.py): retrieve 1200 frame hits per query video,
aggregate to video pairs by max frame score, keep the top 25 pairs per
query, then score the ranked pair list against ground truth with the
canonical µAP. The budgets are configurable here (the reference
hardcodes them) but default to the challenge protocol.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

from vsc2022_torch.device import DeviceLike
from vsc2022_torch.metrics import (
    AveragePrecision,
    CandidatePair,
    Dataset,
    Match,
    average_precision,
)
from vsc2022_torch.retrieval import CandidateGeneration, MaxScoreAggregation
from vsc2022_torch.storage import load_features

logger = logging.getLogger("descriptor_eval_lib")
logger.setLevel(logging.INFO)

# Challenge protocol budgets: ~K=20 per second over ~60-second videos,
# 25 aggregated pairs per query (reference: descriptor_eval_lib.py:23-24).
RETRIEVAL_CANDIDATES_PER_QUERY = 20 * 60
AGGREGATED_CANDIDATES_PER_QUERY = 25


@dataclasses.dataclass
class DescriptorEvalProtocol:
    """The descriptor-track retrieval protocol with its stage budgets."""

    retrieval_per_query: int = RETRIEVAL_CANDIDATES_PER_QUERY
    pairs_per_query: int = AGGREGATED_CANDIDATES_PER_QUERY
    dtype: str = "float32"  # the staged corpus: "float32", "bfloat16" or "int8"
    device: DeviceLike = "cuda"
    mesh: object = None  # a vsc2022_torch.parallel.Mesh to shard the corpus over

    def retrieve(self, query_features, ref_features) -> List[CandidatePair]:
        n_queries = len(query_features)
        budget = int(self.retrieval_per_query * n_queries)
        logger.info(f"Performing search for {budget} nearest vectors")
        generator = CandidateGeneration(
            ref_features, MaxScoreAggregation(), dtype=self.dtype,
            device=self.device, mesh=self.mesh,
        )
        candidates = generator.query(query_features, global_k=budget)
        logger.info(f"Got {len(candidates)} unique video pairs.")

        keep = int(self.pairs_per_query * n_queries)
        if len(candidates) > keep:
            logger.info(f"Limiting to {keep} highest score pairs.")
            candidates = candidates[:keep]
        return candidates


def evaluate_descriptor_track(
    query_feature_filename: str,
    ref_feature_filename: str,
    ground_truth_filename: Optional[str],
    protocol: Optional[DescriptorEvalProtocol] = None,
) -> Tuple[Optional[AveragePrecision], List[CandidatePair]]:
    logger.info("Starting Descriptor level eval")
    query_features = load_features(query_feature_filename, Dataset.QUERIES)
    logger.info(f"Loaded {len(query_features)} query features")
    ref_features = load_features(ref_feature_filename, Dataset.REFS)
    logger.info(f"Loaded {len(ref_features)} ref features")

    protocol = protocol or DescriptorEvalProtocol()
    candidates = protocol.retrieve(query_features, ref_features)

    if ground_truth_filename is None:
        return None, candidates

    gt_matches = Match.read_csv(ground_truth_filename, is_gt=True)
    gt_pairs = CandidatePair.from_matches(gt_matches)
    logger.info(f"Loaded ground truth from {ground_truth_filename}")
    ap = average_precision(gt_pairs, candidates)
    logger.info(f"Descriptor track micro-AP (uAP): {ap.ap:.4f}")
    return ap, candidates
