#!/usr/bin/env python3
"""DnS video indexing on the PyTorch/CUDA port: re-encode raw L3-iMAC
frame features through a DnS student.

Counterpart of ``vsc2022_tpu/baseline/dns_index.py`` (reference:
vsc/baseline/dns_index.py), with the same flags: ``--accelerator cpu``
runs on the CPU, ``--accelerator tpu`` (or ``cuda``) on the card, and
``--device {cuda,cpu}`` says the same. Per video,
``student.index_video`` runs the student on the device; fine binarization
students are stored as booleans (``> 0``), fine attention students as
fp16, coarse students as f32, optionally score-normalized with β = 1.2
and no dimension replacement. Output files are
``{queries,refs}_{network_name}[_sn].npz``.

    python -m vsc2022_torch.baseline.dns_index --student cg \\
        --query_features q_raw.npz --ref_features r_raw.npz \\
        --score_norm_features noise_raw.npz --checkpoint_path cg.npz \\
        --output_path idx/

Weights come from an npz variable tree of the JAX package's layout
(``--checkpoint_path``), from a student TorchScript whose state dict
carries the published names (``--torchscript_path``; its
``student_type`` / ``fg_type`` attributes override the flags), or from a
seeded random init. Runs on ``cuda`` unless ``--device cpu`` or
``--accelerator cpu`` is given.
"""

import argparse
import dataclasses
import logging
import os
from typing import Dict, List

import numpy as np
import torch

from vsc2022_torch.baseline import pipeline
from vsc2022_torch.convert import dns_student_from_jax
from vsc2022_torch.device import add_device_flags, resolve_device
from vsc2022_torch.metrics import Dataset
from vsc2022_torch.models.dns import DnSStudent
from vsc2022_torch.retrieval.score_norm import score_normalize
from vsc2022_torch.storage import load_features, store_features
from vsc2022_torch.types import VideoFeature
from vsc2022_torch.utils.checkpoint import load_variables

logger = logging.getLogger("vsc2022_torch.dns_index")

# Progress goes to the log every this many videos.
_PROGRESS_EVERY = 200

parser = argparse.ArgumentParser()
parser.add_argument(
    "--query_features", help="Path to query descriptors", type=str, required=True
)
parser.add_argument(
    "--ref_features", help="Path to reference descriptors", type=str, required=True
)
parser.add_argument(
    "--score_norm_features", help="Path to score normalization descriptors", type=str
)
parser.add_argument(
    "--output_path", help="The path to write indexed features.", type=str,
    required=True,
)
parser.add_argument(
    "--student", choices=["cg", "fg"], default=None,
    help="Student type used for indexing (read from --torchscript_path "
    "when omitted).",
)
parser.add_argument(
    "--fg_type", choices=["att", "bin"], default="att",
    help="Fine-grained student variant.",
)
parser.add_argument(
    "--checkpoint_path", type=str, default=None,
    help="npz variable tree for the student (random init if omitted).",
)
parser.add_argument(
    "--torchscript_path", type=str, default=None,
    help="Student TorchScript (the reference's invocation style); its "
    "state dict loads into the port's student by name.",
)
add_device_flags(parser)


def index_videos(
    model: DnSStudent, features: List[VideoFeature]
) -> List[VideoFeature]:
    """(reference: vsc/baseline/dns_index.py:100-116)"""
    indexed = []
    for i, video in enumerate(features):
        feature = model.index_video(video.feature)
        if model.student_type == "fg":
            feature = (
                feature > 0 if model.fg_type == "bin"
                else feature.astype(np.float16)
            )
        indexed.append(dataclasses.replace(video, feature=feature))
        if (i + 1) % _PROGRESS_EVERY == 0:
            logger.info("  %d/%d videos indexed", i + 1, len(features))
    return indexed


def _build_student(args, device) -> DnSStudent:
    student, fg_type = args.student, args.fg_type
    state = None
    if args.torchscript_path:
        module = torch.jit.load(args.torchscript_path, map_location="cpu")
        # The published artifacts carry their own type metadata (the
        # reference reads it: vsc/baseline/dns_index.py:121-127).
        student = getattr(module, "student_type", student)
        fg_type = getattr(module, "fg_type", fg_type)
        if student is None:
            raise Exception(
                "--student is required when the TorchScript module "
                "carries no student_type attribute"
            )
        state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    elif student is None:
        raise Exception("Provide --student (or --torchscript_path)")
    elif args.checkpoint_path:
        state = dns_student_from_jax(
            load_variables(args.checkpoint_path), student, fg_type
        )
    return DnSStudent(
        student, fg_type if student == "fg" else None, state_dict=state,
        device=device,
    )


def _load_and_reencode(
    model: DnSStudent, path: str, dataset: Dataset, role: str
) -> List[VideoFeature]:
    logger.info(f"Re-encoding {role} ({path}) through {model.get_network_name()}")
    videos = load_features(path, dataset)
    logger.info(f"  {len(videos)} {role} videos")
    return index_videos(model, videos)


def main(args) -> Dict[str, object]:
    """Index the query and ref videos; returns the per-stage seconds and
    the files written."""
    device = resolve_device(args.device)
    model = _build_student(args, device)
    if model.student_type == "fg" and args.score_norm_features:
        raise Exception(
            "Fine-grained student output feeds the localizer directly; "
            "score normalization only applies to the coarse (cg) student."
        )

    stages: Dict[str, float] = {}
    with pipeline.timed(stages, "index", device):
        out_queries = _load_and_reencode(
            model, args.query_features, Dataset.QUERIES, "queries"
        )
        out_refs = _load_and_reencode(
            model, args.ref_features, Dataset.REFS, "refs"
        )

    suffix = model.get_network_name()
    if args.score_norm_features:
        with pipeline.timed(stages, "score_norm", device):
            noise = _load_and_reencode(
                model, args.score_norm_features, Dataset.REFS, "score-norm refs"
            )
            out_queries, out_refs = score_normalize(
                out_queries, out_refs, noise, replace_dim=False, beta=1.2,
                device=device,
            )
        suffix += "_sn"

    files = []
    with pipeline.timed(stages, "store", device):
        os.makedirs(args.output_path, exist_ok=True)
        for name, videos in (("queries", out_queries), ("refs", out_refs)):
            target = os.path.join(args.output_path, f"{name}_{suffix}.npz")
            store_features(target, videos)
            logger.info(f"Wrote {target}")
            files.append(target)
    return {"stages": stages, "files": files}


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    main(parser.parse_args())
