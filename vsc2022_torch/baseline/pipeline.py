"""Shared matching-pipeline stages for the baseline drivers.

Counterpart of ``vsc2022_tpu/baseline/pipeline.py``. Stage budgets are
the challenge protocol defaults (reference:
vsc/baseline/sscd_baseline.py:90-152). The metric report renders the
PR curves as the JAX package's does where matplotlib is installed, and
logs the files it could not write where it is not.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from vsc2022_torch.device import DeviceLike
from vsc2022_torch.localization import Localization
from vsc2022_torch.metrics import (
    AveragePrecision,
    CandidatePair,
    Match,
    average_precision,
    evaluate_matching_track,
)
from vsc2022_torch.retrieval import CandidateGeneration, MaxScoreAggregation
from vsc2022_torch.types import VideoFeature

logger = logging.getLogger(__name__)

RETRIEVE_PER_QUERY = 1200.0
CANDIDATES_PER_QUERY = 25.0
LOCALIZE_PER_QUERY = 5.0


@contextlib.contextmanager
def timed(stages: Dict[str, float], name: str, device: torch.device):
    """Record a stage's wall seconds in ``stages`` (device work included:
    it synchronizes before reading the clock)."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages[name] = time.perf_counter() - t0
    logger.info("stage %s: %.3f s", name, stages[name])


def retrieve_candidates(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    retrieve_per_query: float = RETRIEVE_PER_QUERY,
    candidates_per_query: float = CANDIDATES_PER_QUERY,
    dtype: str = "float32",
    device: DeviceLike = "cuda",
    mesh=None,
) -> List[CandidatePair]:
    """Global-k frame search (over a corpus staged in ``dtype``, sharded
    over ``mesh`` if one is given) + per-pair aggregation, truncated to the
    candidate budget."""
    logger.info("Retrieval: global top-k frame search")
    generator = CandidateGeneration(
        refs, MaxScoreAggregation(), dtype=dtype, device=device, mesh=mesh
    )
    candidates = generator.query(
        queries, global_k=int(retrieve_per_query * len(queries))
    )
    candidates = candidates[: int(candidates_per_query * len(queries))]
    logger.info("Candidate budget kept %d pairs", len(candidates))
    return candidates


def align_candidates(
    alignment: Localization, candidates: List[CandidatePair]
) -> List[Match]:
    """Temporal alignment of the whole candidate list in one
    ``localize_all`` call: the localizer buckets by padded shape, chunks
    to its device memory budget and logs per-chunk progress."""
    logger.info("Temporal alignment over %d candidate pairs", len(candidates))
    return alignment.localize_all(candidates)


def write_stage_artifacts(
    output_path: str,
    candidates: List[CandidatePair],
    matches: Optional[List[Match]] = None,
) -> Tuple[str, Optional[str]]:
    """Persist the stage outputs (the resume points of the pipeline)."""
    os.makedirs(output_path, exist_ok=True)
    candidate_file = os.path.join(output_path, "candidates.csv")
    CandidatePair.write_csv(candidates, candidate_file)
    match_file = None
    if matches is not None:
        match_file = os.path.join(output_path, "matches.csv")
        Match.write_csv(matches, match_file)
    return candidate_file, match_file


def create_pr_plot(ap: AveragePrecision, filename: str) -> None:
    """The precision-recall curve of ``ap`` into ``filename`` (e.g. a
    PDF), on matplotlib's non-interactive backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ax = ap.pr_curve.plot(linewidth=1)
    plt.savefig(filename)
    plt.close(ax.figure)


def report_metrics(
    ground_truth: str,
    candidate_file: str,
    match_file: str,
    log: logging.Logger,
    output_path: Optional[str] = None,
) -> Dict[str, float]:
    """Score both stages against GT: candidate-level micro-AP and the
    matching-track segment AP. Returns both. With ``output_path``, render
    their PR curves there under the reference driver's names
    (candidate_precision_recall.pdf, precision_recall.pdf; reference:
    vsc/baseline/sscd_baseline.py:211-231); where matplotlib is not
    installed, one warning names the files not written."""
    gt = CandidatePair.from_matches(Match.read_csv(ground_truth, is_gt=True))
    cand_ap = average_precision(gt, CandidatePair.read_csv(candidate_file))
    log.info(f"Candidate micro-AP: {cand_ap.ap:.4f}")
    matching = evaluate_matching_track(ground_truth, match_file)
    log.info(f"Matching-track segment AP: {matching.segment_ap.ap:.4f}")
    files = [("Candidates", candidate_file), ("Matches", match_file)]
    if output_path is not None:
        plots = [
            ("Candidate PR plot", cand_ap,
             os.path.join(output_path, "candidate_precision_recall.pdf")),
            ("Match PR plot", matching.segment_ap,
             os.path.join(output_path, "precision_recall.pdf")),
        ]
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            log.warning("matplotlib is not installed: PR plots not written: %s",
                        ", ".join(path for _, _, path in plots))
        else:
            for label, ap, path in plots:
                create_pr_plot(ap, path)
                files.append((label, path))
    for label, path in files:
        log.info(f"{label}: {path}")
    return {
        "candidate_uap": float(cand_ap.ap),
        "segment_ap": float(matching.segment_ap.ap),
    }
