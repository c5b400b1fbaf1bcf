#!/usr/bin/env python3
"""SSCD/DINO matching baseline driver on the PyTorch/CUDA port.

Counterpart of ``vsc2022_tpu/baseline/sscd_baseline.py``, with the same
flags plus ``--device``: retrieval → candidates.csv → TN localization →
matches.csv → optional metric report, with the reference's stage budgets
(1200 retrievals and 25 candidates per query, 5 pairs localized per
query, β=1.2 score normalization).

    python -m vsc2022_torch.baseline.sscd_baseline \\
        --query_features q.npz --ref_features r.npz \\
        --score_norm_features noise.npz --ground_truth gt.csv \\
        --output_path out/

Runs on ``cuda`` unless ``--device cpu`` is given. ``--bf16`` runs the
score normalization's noise-NN and the retrieval over bf16 corpora (f32
accumulation; localization stays f32, as in the JAX package). ``--int8``
stages both corpora as SQ8-style int8 codes with per-row scales (queries
f32; search exact over the dequantized corpus). ``--profile_dir`` writes
a ``torch.profiler`` trace.
"""

import argparse
import logging
import os
from typing import Dict, List, Tuple

import torch

from vsc2022_torch.baseline import pipeline
from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.localization import (
    TNLocalizationCandidateScore,
    TNLocalizationMaxSim,
)
from vsc2022_torch.metrics import CandidatePair, Dataset, Match
from vsc2022_torch.retrieval.score_norm import (
    l2_normalize_rows,
    score_normalize,
    transform_features,
)
from vsc2022_torch.storage import load_features, store_features
from vsc2022_torch.types import VideoFeature
from vsc2022_torch.utils.profiling import maybe_profile

logger = logging.getLogger("vsc2022_torch.sscd_baseline")

parser = argparse.ArgumentParser()
parser.add_argument(
    "--query_features", type=str, required=True,
    help="query descriptor npz",
)
parser.add_argument(
    "--ref_features", type=str, required=True,
    help="reference descriptor npz",
)
parser.add_argument(
    "--score_norm_features", type=str,
    help="noise-corpus descriptor npz; enables score normalization",
)
parser.add_argument(
    "--output_path", type=str, required=True,
    help="directory receiving candidates.csv / matches.csv",
)
parser.add_argument(
    "--ground_truth", type=str,
    help="ground-truth matches csv; enables the metric report",
)
parser.add_argument(
    "--overwrite", action="store_true",
    help="replace the output directory if it already exists",
)
parser.add_argument(
    "--profile_dir", type=str, default=None,
    help="Write a torch.profiler (chrome trace) of the matching run.",
)
_dtype_group = parser.add_mutually_exclusive_group()
_dtype_group.add_argument(
    "--bf16", action="store_true",
    help="Retrieval in bfloat16 (half the device memory and bytes moved; "
    "scores at bf16 resolution, f32 accumulation).",
)
_dtype_group.add_argument(
    "--int8", action="store_true",
    help="SQ8-style per-row int8 retrieval corpora (a quarter of f32's "
    "device memory; queries f32, search exact over the dequantized corpus).",
)
parser.add_argument(
    "--score_normalized_inputs", action="store_true",
    help="The query/ref npz are ALREADY score-normalized (e.g. the "
    "sn_queries/sn_refs a previous run wrote): use the "
    "score-normalization alignment mode without re-normalizing. "
    "Mutually exclusive with --score_norm_features.",
)
parser.add_argument(
    "--reuse_candidates", type=str, default=None,
    help="Skip retrieval and localize the candidate pairs from this "
    "CSV (a previous run's candidates.csv over the SAME features).",
)
parser.add_argument(
    "--vcsl_faithful_tn", action="store_true",
    help="Align with the published VCSL TN configuration (absolute "
    "min_sim gate, top-K=5, path-cell masking, max_iou dedup) instead "
    "of the tuned adaptive gate.",
)
parser.add_argument(
    "--device", type=str, default="cuda", choices=("cuda", "cpu"),
    help="Device to run on (default cuda; raises when no GPU is present).",
)


# The reference's module-level API (search / localize_and_verify / match
# are imported by downstream code).

def search(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    retrieve_per_query: float = pipeline.RETRIEVE_PER_QUERY,
    candidates_per_query: float = pipeline.CANDIDATES_PER_QUERY,
    dtype: str = "float32",
    device: DeviceLike = "cuda",
) -> List[CandidatePair]:
    """Global-k frame search and per-pair max aggregation, cut to the
    candidate budget (``pipeline.retrieve_candidates``)."""
    return pipeline.retrieve_candidates(
        queries, refs, retrieve_per_query, candidates_per_query,
        dtype=dtype, device=device,
    )


def build_alignment(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    score_normalization: bool,
    vcsl_faithful: bool = False,
    device: DeviceLike = "cuda",
):
    """Alignment strategy selection (reference: sscd_baseline.py:117-135):
    score-normalized features use MaxSim scoring over positively biased
    similarity; raw features are L2-normalized and inherit the
    candidate's retrieval score."""
    if score_normalization:
        return TNLocalizationMaxSim(
            queries, refs, model_type="TN",
            tn_max_step=5, min_length=4, similarity_bias=0.5,
            vcsl_faithful=vcsl_faithful, device=device,
        )
    return TNLocalizationCandidateScore(
        transform_features(queries, l2_normalize_rows),
        transform_features(refs, l2_normalize_rows),
        model_type="TN", tn_max_step=5, min_length=4,
        vcsl_faithful=vcsl_faithful, device=device,
    )


def localize_and_verify(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    candidates: List[CandidatePair],
    localize_per_query: float = pipeline.LOCALIZE_PER_QUERY,
    score_normalization: bool = False,
    vcsl_faithful: bool = False,
    device: DeviceLike = "cuda",
) -> List[Match]:
    to_localize = candidates[: int(len(queries) * localize_per_query)]
    alignment = build_alignment(
        queries, refs, score_normalization, vcsl_faithful, device
    )
    return pipeline.align_candidates(alignment, to_localize)


def match(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    output_path: str,
    score_normalization: bool = False,
    vcsl_faithful: bool = False,
    reuse_candidates: str = None,
    dtype: str = "float32",
    device: DeviceLike = "cuda",
    stages: Dict[str, float] = None,
) -> Tuple[str, str]:
    stages = {} if stages is None else stages
    device = resolve_device(device)
    with pipeline.timed(stages, "retrieve", device):
        if reuse_candidates:
            logger.info("Reusing candidate pairs from %s", reuse_candidates)
            candidates = CandidatePair.read_csv(reuse_candidates)
        else:
            candidates = pipeline.retrieve_candidates(
                queries, refs, dtype=dtype, device=device
            )
        candidate_file, _ = pipeline.write_stage_artifacts(
            output_path, candidates
        )
    with pipeline.timed(stages, "localize", device):
        matches = localize_and_verify(
            queries, refs, candidates,
            score_normalization=score_normalization,
            vcsl_faithful=vcsl_faithful, device=device,
        )
        _, match_file = pipeline.write_stage_artifacts(
            output_path, candidates, matches
        )
    return candidate_file, match_file


def main(args) -> Dict[str, object]:
    """Run the matching pipeline; returns the per-stage seconds and, with
    ``--ground_truth``, both APs."""
    if os.path.exists(args.output_path) and not args.overwrite:
        raise Exception(
            f"Refusing to clobber {args.output_path} (pass --overwrite)."
        )
    if args.score_norm_features and args.score_normalized_inputs:
        raise Exception(
            "--score_normalized_inputs means the inputs already carry "
            "the CSLS bias dimension; --score_norm_features would "
            "normalize them twice."
        )
    device = resolve_device(args.device)
    stages: Dict[str, float] = {}
    with pipeline.timed(stages, "load", device):
        queries = load_features(args.query_features, Dataset.QUERIES)
        refs = load_features(args.ref_features, Dataset.REFS)
    score_normalization = bool(
        args.score_norm_features or args.score_normalized_inputs
    )
    dtype = "bfloat16" if args.bf16 else "int8" if args.int8 else "float32"
    if args.score_norm_features:
        with pipeline.timed(stages, "score_norm", device):
            noise = load_features(args.score_norm_features, Dataset.REFS)
            queries, refs = score_normalize(
                queries, refs, noise, beta=1.2, dtype=dtype, device=device
            )
        with pipeline.timed(stages, "store_sn", device):
            os.makedirs(args.output_path, exist_ok=True)
            store_features(
                os.path.join(args.output_path, "sn_queries.npz"), queries
            )
            store_features(os.path.join(args.output_path, "sn_refs.npz"), refs)

    with maybe_profile(args.profile_dir, device):
        candidate_file, match_file = match(
            queries, refs, args.output_path,
            score_normalization=score_normalization,
            vcsl_faithful=args.vcsl_faithful_tn,
            reuse_candidates=args.reuse_candidates,
            dtype=dtype, device=device, stages=stages,
        )

    result: Dict[str, object] = {"stages": stages}
    if args.ground_truth:
        with pipeline.timed(stages, "metrics", device):
            result.update(
                pipeline.report_metrics(
                    args.ground_truth, candidate_file, match_file, logger,
                    output_path=args.output_path,
                )
            )
    return result


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    main(parser.parse_args())
