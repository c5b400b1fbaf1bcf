"""One-command real-data parity dress rehearsal on the PyTorch/CUDA port
(counterpart of ``vsc2022_tpu/parity.py``: the same stages, flags,
targets, resume rule and ``parity_summary.json``, plus ``--device``).

``python -m vsc2022_torch parity`` packages the quality-parity protocol
against the reference's published numbers (reference runbook:
docs/baseline.md:62-135) into a single resumable run:

  1. (real-artifact day) TorchScript probe + verified conversion
     (``adapt_model --probe`` then ``--verify``),
  2. descriptor inference over the query / reference / noise video
     datasets (reference: vsc/baseline/inference.py),
  3. the score-normalized matching pipeline under BOTH temporal-network
     configurations (``--vcsl_faithful_tn``, the published VCSL parity
     configuration, to compare against 0.6499 µAP / 0.4692 segment AP
     first, and the tuned adaptive gate) plus the raw no-score-norm run
     (reference targets 0.4754 / 0.3650),
  4. the eval CLIs over the produced artifacts: ``python -m
     vsc2022_torch.descriptor_eval`` (candidate budgets enforced) and
     ``python -m vsc2022_torch.matching_eval`` per matching run,
  5. a ``parity_summary.json`` collating every metric next to the
     reference's published target (BASELINE.json) with deltas.

Every stage is a subprocess of the port's CLI it rehearses, runs in the
batch pipelines' float32 default, and is skipped when its artifacts
already exist, so a crashed or partial run resumes by re-invoking the
same command (the eval CLIs run every time). Precomputed descriptor npz
files can replace the dataset directories (``--query_features`` etc.) to
start from stage 3. ``--device`` (cuda unless ``--device cpu``) goes to
every stage with device work; the matching eval runs on the host.
``--accelerator`` reaches the inference CLI as in the JAX package; left
out, it names ``--device``'s (tpu, the card, or cpu).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import subprocess
import sys
import time

logger = logging.getLogger("parity")

parser = argparse.ArgumentParser(
    description="One-command real-data parity run (see module docstring)."
)
parser.add_argument(
    "--output_path", required=True,
    help="Directory receiving every stage artifact + parity_summary.json",
)
model_group = parser.add_mutually_exclusive_group()
model_group.add_argument(
    "--torchscript_path",
    help="The published TorchScript artifact (sscd_disc_mixup...); "
    "probed then converted with numeric verification.",
)
model_group.add_argument(
    "--checkpoint_path",
    help="An already-converted Flax npz checkpoint (skips conversion).",
)
parser.add_argument(
    "--model", default="sscd",
    choices=["sscd", "dino"],
    help="Model family for conversion + inference transforms.",
)
for role in ("queries", "refs", "noise"):
    parser.add_argument(
        f"--{role}_dataset",
        help=f"Directory of {role} videos (mp4) for inference; the "
        "noise dataset is the validation refs when evaluating on the "
        "training set (reference: docs/baseline.md:66-72).",
    )
parser.add_argument("--query_features", help="Precomputed query npz")
parser.add_argument("--ref_features", help="Precomputed reference npz")
parser.add_argument("--noise_features", help="Precomputed noise npz")
parser.add_argument(
    "--ground_truth",
    help="Matching-track ground-truth csv (training_dataset/"
    "ground_truth.csv); enables every metric stage.",
)
parser.add_argument("--batch_size", type=int, default=32)
parser.add_argument("--processes", type=int, default=1)
parser.add_argument("--fps", type=float, default=1)
parser.add_argument("--ffmpeg_path", default="ffmpeg")
parser.add_argument(
    "--accelerator", default=None, choices=["tpu", "cpu"],
    help="The inference CLI's --accelerator (default: --device's; tpu "
    "names the card).",
)
parser.add_argument(
    "--device", default="cuda", choices=["cuda", "cpu"],
    help="Device of every stage (default cuda; raises when no GPU is present).",
)
parser.add_argument(
    "--transforms", default=None,
    help="Override the model family's default inference transform "
    "(sscd: RESIZE_320_CENTER; dino: RESIZE_224_SQUARE).",
)
parser.add_argument(
    "--skip_probe", action="store_true",
    help="Skip the informational adapt_model --probe print.",
)
parser.add_argument(
    "--overwrite", action="store_true",
    help="Re-run every stage even when its artifacts exist.",
)

# Published reference targets (BASELINE.md; reference README.md:54-55).
TARGETS = {
    "sscd": {
        "candidate_uap_sn": 0.6499,
        "segment_ap_sn": 0.4692,
        "candidate_uap_raw": 0.4754,
        "segment_ap_raw": 0.3650,
    },
    "dino": {
        "candidate_uap_sn": 0.4402,
        "segment_ap_sn": 0.3393,
    },
}
DEFAULT_TRANSFORMS = {"sscd": "RESIZE_320_CENTER", "dino": "RESIZE_224_SQUARE"}


def accelerator(args) -> str:
    """The inference CLI's --accelerator: the one given, which must name
    --device's device, or --device's own."""
    implied = "cpu" if args.device == "cpu" else "tpu"
    if args.accelerator is not None and args.accelerator != implied:
        raise SystemExit(f"--accelerator {args.accelerator} names another device "
                         f"than --device {args.device}")
    return args.accelerator or implied


def run_cli(cmd, capture=False) -> str:
    """Run one stage CLI, streaming (or capturing) its output, and log its
    seconds; any failure aborts the parity run with the failing command
    named."""
    logger.info("$ %s", " ".join(cmd))
    t0 = time.perf_counter()
    if capture:
        proc = subprocess.run(
            cmd, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        sys.stdout.write(proc.stdout)
    else:
        proc = subprocess.run(cmd)
    if proc.returncode != 0:
        raise SystemExit(
            f"Parity stage failed (exit {proc.returncode}): {' '.join(cmd)}"
        )
    where = cmd[cmd.index("--output_path") + 1] if "--output_path" in cmd else ""
    logger.info("stage %s%s: %.2f s", cmd[2], f" ({os.path.basename(where)})" if where else "",
                time.perf_counter() - t0)
    return proc.stdout if capture else ""


def fresh(path, args) -> bool:
    """True when the stage owning ``path`` must run."""
    if args.overwrite or not os.path.exists(path):
        return True
    logger.info("Reusing existing artifact: %s", path)
    return False


def stage_convert(args, out) -> str | None:
    """TorchScript → verified npz checkpoint (the real-artifact seam;
    reference model load: vsc/baseline/inference_impl.py:173)."""
    if args.checkpoint_path:
        return args.checkpoint_path
    if not args.torchscript_path:
        return None
    ckpt = os.path.join(out, f"{args.model}_flax.npz")
    if not args.skip_probe:
        run_cli([
            sys.executable, "-m", "vsc2022_torch.baseline.adapt_model",
            "--probe", "--input_torchscript", args.torchscript_path,
            "--model", args.model, "--device", args.device,
        ])
    if fresh(ckpt, args):
        run_cli([
            sys.executable, "-m", "vsc2022_torch.baseline.adapt_model",
            "--input_torchscript", args.torchscript_path,
            "--model", args.model, "--verify",
            "--output_checkpoint", ckpt, "--device", args.device,
        ])
    return ckpt


def stage_inference(args, out, ckpt) -> dict:
    """Descriptor extraction per dataset role; precomputed npz inputs
    short-circuit their role."""
    npz = {}
    for role, feat_arg in (
        ("queries", args.query_features),
        ("refs", args.ref_features),
        ("noise", args.noise_features),
    ):
        if feat_arg:
            npz[role] = feat_arg
            continue
        feat_flag = {
            "queries": "--query_features",
            "refs": "--ref_features",
            "noise": "--noise_features",
        }[role]
        dataset = getattr(args, f"{role}_dataset")
        if not dataset:
            raise SystemExit(
                f"Need --{role}_dataset (videos) or a precomputed "
                f"{feat_flag} npz"
            )
        path = os.path.join(out, f"{role}.npz")
        npz[role] = path
        if not fresh(path, args):
            continue
        if not ckpt:
            raise SystemExit(
                "Inference needs --torchscript_path or --checkpoint_path"
            )
        run_cli([
            sys.executable, "-m", "vsc2022_torch.inference.cli",
            "--baseline", args.model,
            "--checkpoint_path", ckpt,
            "--transforms",
            args.transforms or DEFAULT_TRANSFORMS[args.model],
            "--accelerator", accelerator(args),
            "--batch_size", str(args.batch_size),
            "--processes", str(args.processes),
            "--fps", str(args.fps),
            "--ffmpeg_path", args.ffmpeg_path,
            "--dataset_path", dataset,
            "--output_file", path,
            "--device", args.device,
        ])
    return npz


def stage_matching(args, out, npz) -> dict:
    """The three matching runs: score-normalized × {faithful TN, tuned
    TN} + raw (no score norm). The two SN runs share the same
    normalization AND the same candidate search (only the TN config
    differs), so the tuned run reuses the faithful run's sn_queries /
    sn_refs npz and candidates.csv: at real-data scale the candidate
    search is the dominant stage cost and must not be paid twice for
    bit-identical intermediates. Returns run name → directory."""
    faithful_dir = os.path.join(out, "sn_faithful")
    runs = {}
    for name, feats, extra in (
        (
            "sn_faithful", (npz["queries"], npz["refs"]),
            ["--score_norm_features", npz["noise"], "--vcsl_faithful_tn"],
        ),
        (
            "sn_tuned",
            (
                os.path.join(faithful_dir, "sn_queries.npz"),
                os.path.join(faithful_dir, "sn_refs.npz"),
            ),
            [
                "--score_normalized_inputs",
                "--reuse_candidates",
                os.path.join(faithful_dir, "candidates.csv"),
            ],
        ),
        ("raw", (npz["queries"], npz["refs"]), []),
    ):
        run_dir = os.path.join(out, name)
        runs[name] = run_dir
        if not fresh(os.path.join(run_dir, "matches.csv"), args):
            continue
        cmd = [
            sys.executable, "-m", "vsc2022_torch.baseline.sscd_baseline",
            "--query_features", feats[0],
            "--ref_features", feats[1],
            "--output_path", run_dir, "--overwrite",
        ] + extra
        if args.ground_truth:
            cmd += ["--ground_truth", args.ground_truth]
        run_cli(cmd + ["--device", args.device])
    return runs


def stage_eval(args, out, npz, runs) -> dict:
    """The eval CLIs over the produced artifacts: the challenge-official
    numbers (reference: descriptor_eval.py, matching_eval.py)."""
    metrics = {}
    if not args.ground_truth:
        logger.info("No --ground_truth: skipping the eval CLIs")
        return metrics
    # Descriptor track on the score-normalized descriptors (the
    # conforming submission artifact; budget enforcement is the CLI's).
    sn_dir = runs["sn_faithful"]
    desc_out = run_cli([
        sys.executable, "-m", "vsc2022_torch.descriptor_eval",
        "--query_features", os.path.join(sn_dir, "sn_queries.npz"),
        "--ref_features", os.path.join(sn_dir, "sn_refs.npz"),
        "--ground_truth", args.ground_truth,
        "--candidates_output", os.path.join(out, "descriptor_candidates.csv"),
        "--device", args.device,
    ], capture=True)
    m = re.search(r"Descriptor track micro-AP \(uAP\):\s+([0-9.]+)", desc_out)
    if m:
        metrics["descriptor_uap"] = float(m.group(1))
    for name, run_dir in runs.items():
        match_out = run_cli([
            sys.executable, "-m", "vsc2022_torch.matching_eval",
            "--predictions", os.path.join(run_dir, "matches.csv"),
            "--ground_truth", args.ground_truth,
        ], capture=True)
        m = re.search(
            r"Matching track segment AP:\s+([0-9.]+)", match_out
        )
        if m:
            metrics[f"segment_ap_{name}"] = float(m.group(1))
    return metrics


def main(args):
    out = args.output_path
    os.makedirs(out, exist_ok=True)
    ckpt = stage_convert(args, out)
    npz = stage_inference(args, out, ckpt)
    runs = stage_matching(args, out, npz)
    metrics = stage_eval(args, out, npz, runs)

    targets = TARGETS[args.model]
    summary = {
        "model": args.model,
        "artifacts": {
            "features": npz,
            "runs": runs,
        },
        "metrics": metrics,
        "targets": targets,
    }
    deltas = {}
    pairs = [
        ("segment_ap_sn_faithful", "segment_ap_sn"),
        ("segment_ap_sn_tuned", "segment_ap_sn"),
        ("segment_ap_raw", "segment_ap_raw"),
        ("descriptor_uap", "candidate_uap_sn"),
    ]
    for got_key, target_key in pairs:
        if got_key in metrics and target_key in targets:
            deltas[got_key] = round(
                metrics[got_key] - targets[target_key], 4
            )
    summary["delta_vs_reference"] = deltas
    summary_path = os.path.join(out, "parity_summary.json")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2)
    logger.info("Parity summary: %s", summary_path)
    print(json.dumps(summary))


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    main(parser.parse_args())
