#!/usr/bin/env python3
"""Matching-track evaluation CLI on the PyTorch/CUDA port (the flags and
the printed line of the root ``matching_eval.py``).

    python -m vsc2022_torch.matching_eval --predictions matches.csv \\
        --ground_truth gt.csv

Scores a predicted-matches CSV against a ground-truth CSV with the
matching-track metric (segment AP; ``vsc2022_torch.metrics``) and prints
exactly one result line on stdout::

    Matching track segment AP: <ap>

with the AP to 4 places. It runs on the host alone: the metric has no
device work.
"""

import argparse
import logging

from vsc2022_torch.metrics import evaluate_matching_track

logger = logging.getLogger("vsc2022_torch.matching_eval")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Matching-track evaluation")
    p.add_argument(
        "--predictions", type=str, required=True,
        help="predicted matches CSV (PairMatches row schema)",
    )
    p.add_argument(
        "--ground_truth", type=str, required=True, help="ground-truth matches CSV",
    )
    return p


def main(args: argparse.Namespace) -> str:
    """Print the result line and return it."""
    track = evaluate_matching_track(args.ground_truth, args.predictions)
    line = f"Matching track segment AP: {track.segment_ap.ap:.4f}"
    logger.info(line)
    print(line)
    return line


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    main(build_parser().parse_args())
