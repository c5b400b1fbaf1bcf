#!/usr/bin/env python3
"""Descriptor-track evaluation CLI on the PyTorch/CUDA port (the flags of
the root ``descriptor_eval.py``, plus ``--device``).

    python -m vsc2022_torch.descriptor_eval --query_features q.npz \\
        --ref_features r.npz --ground_truth gt.csv [--candidates_output c.csv]

``--bf16`` stages the reference corpus and the queries in bfloat16 (f32
accumulation); ``--int8`` stages the reference corpus as SQ8-style int8
codes with per-row scales (queries f32). ``--sharded`` shards the
reference corpus over every device of the ``--device`` kind
(``vsc2022_torch.parallel.corpus_mesh``: each card, or the one CPU).
"""

import argparse
import logging
from typing import Optional

from vsc2022_torch.descriptor_eval_lib import (
    DescriptorEvalProtocol,
    evaluate_descriptor_track,
)
from vsc2022_torch.metrics import CandidatePair

logger = logging.getLogger("vsc2022_torch.descriptor_eval")

parser = argparse.ArgumentParser()
parser.add_argument(
    "--query_features", help="Path to query descriptors", type=str, required=True
)
parser.add_argument(
    "--ref_features", help="Path to reference descriptors", type=str, required=True
)
parser.add_argument(
    "--ground_truth", help="Path to the ground truth (labels) CSV file.", type=str
)
parser.add_argument(
    "--candidates_output", help="Path to write the candidates CSV file.", type=str
)
parser.add_argument(
    "--sharded", action="store_true",
    help="Shard the reference corpus across every device of the --device kind.",
)
_dtype_group = parser.add_mutually_exclusive_group()
_dtype_group.add_argument(
    "--bf16", action="store_true",
    help="Stage the reference corpus and the queries in bfloat16 (half the "
    "device memory; scores at bf16 resolution, f32 accumulation).",
)
_dtype_group.add_argument(
    "--int8", action="store_true",
    help="Stage the reference corpus as SQ8-style per-row int8 (a quarter "
    "of f32's device memory; queries f32, search exact over the dequantized "
    "corpus).",
)
parser.add_argument(
    "--device", type=str, default="cuda", choices=("cuda", "cpu"),
    help="Device to run on (default cuda; raises when no GPU is present).",
)


def main(args) -> Optional[float]:
    """Run the evaluation; returns the micro-AP when GT is given."""
    mesh = None
    if args.sharded:
        from vsc2022_torch.parallel import corpus_mesh

        mesh = corpus_mesh(device=args.device)
    ap, candidates = evaluate_descriptor_track(
        args.query_features, args.ref_features, args.ground_truth,
        protocol=DescriptorEvalProtocol(
            dtype="bfloat16" if args.bf16 else "int8" if args.int8 else "float32",
            device=args.device, mesh=mesh,
        ),
    )
    if ap is not None:
        logger.info(f"Descriptor track micro-AP (uAP): {ap.ap:.4f}")
    if args.candidates_output:
        CandidatePair.write_csv(candidates, args.candidates_output)
        logger.info(f"Wrote candidates to {args.candidates_output}")
    return None if ap is None else float(ap.ap)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    main(parser.parse_args())
