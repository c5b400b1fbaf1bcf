"""The port's one-command parity rehearsal (``python -m vsc2022_torch
parity``) against the JAX package's ``parity``: the same targets, the same
stage commands (mapped onto the port's modules, with ``--device``) in every
input mode, the same summary for the same eval outputs, and one real run
on tiny synthetic npz files on the CPU, with its resume."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from vsc2022_torch import parity as torch_parity
from vsc2022_tpu import parity as jax_parity
from vsc2022_tpu.metrics import Dataset, Match
from vsc2022_tpu.storage import store_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The stub eval CLIs' outputs: the lines the parity stage parses.
DESCRIPTOR_LINE = "2026-01-01 00:00:00 INFO     Descriptor track micro-AP (uAP): 0.7123\n"
MATCHING_LINE = "Matching track segment AP: 0.4567\n"


def test_targets_and_transforms_are_jax():
    assert torch_parity.TARGETS == jax_parity.TARGETS
    assert torch_parity.DEFAULT_TRANSFORMS == jax_parity.DEFAULT_TRANSFORMS


def _record(monkeypatch, module):
    """Stub ``module.run_cli``: record each command, answer the eval CLIs
    with fixed result lines."""
    cmds = []

    def run_cli(cmd, capture=False):
        cmds.append(list(cmd))
        text = " ".join(cmd)
        if "descriptor_eval" in text:
            return DESCRIPTOR_LINE
        if "matching_eval" in text:
            return MATCHING_LINE
        return ""

    monkeypatch.setattr(module, "run_cli", run_cli)
    return cmds


def _as_port(cmd, device):
    """A JAX stage command as the port issues it: the port's modules, the
    root eval scripts as the port's ``-m`` modules, and ``--device`` on
    every stage with device work (the matching eval has none)."""
    cmd = list(cmd)
    if cmd[1].endswith(".py"):  # the root descriptor_eval.py / matching_eval.py
        cmd[1:2] = ["-m", "vsc2022_torch." + os.path.basename(cmd[1])[:-3]]
    else:
        cmd[2] = cmd[2].replace("vsc2022_tpu", "vsc2022_torch")
    if cmd[2] != "vsc2022_torch.matching_eval":
        cmd += ["--device", device]
    return cmd


MODES = {
    "torchscript, videos, GT": ["--torchscript_path", "m.pt", "--queries_dataset", "qv",
                                "--refs_dataset", "rv", "--noise_dataset", "nv",
                                "--ground_truth", "gt.csv"],
    "torchscript, skip probe, dino": ["--torchscript_path", "m.pt", "--skip_probe",
                                      "--model", "dino", "--queries_dataset", "qv",
                                      "--ref_features", "r.npz", "--noise_features",
                                      "n.npz"],
    "checkpoint, videos, no GT": ["--checkpoint_path", "c.npz", "--queries_dataset", "qv",
                                  "--refs_dataset", "rv", "--noise_dataset", "nv",
                                  "--batch_size", "8", "--fps", "2",
                                  "--transforms", "RESIZE_288_SQUARE"],
    "precomputed npz, GT": ["--query_features", "q.npz", "--ref_features", "r.npz",
                            "--noise_features", "n.npz", "--ground_truth", "gt.csv"],
    "precomputed npz, no GT": ["--query_features", "q.npz", "--ref_features", "r.npz",
                               "--noise_features", "n.npz"],
}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("mode", list(MODES))
def test_stage_commands_are_jax_mapped_to_the_port(monkeypatch, tmp_path, mode, device):
    argv = MODES[mode]
    jax_cmds, torch_cmds = _record(monkeypatch, jax_parity), _record(monkeypatch, torch_parity)
    accelerator = ["--accelerator", "cpu"] if device == "cpu" else []
    jax_parity.main(jax_parity.parser.parse_args(
        argv + accelerator + ["--output_path", str(tmp_path / "run")]))
    torch_parity.main(torch_parity.parser.parse_args(
        argv + ["--device", device, "--output_path", str(tmp_path / "run")]))
    assert torch_cmds == [_as_port(c, device) for c in jax_cmds]
    assert len(torch_cmds) >= 3


def test_accelerator_must_name_the_device(monkeypatch, tmp_path):
    _record(monkeypatch, torch_parity)
    args = torch_parity.parser.parse_args(MODES["checkpoint, videos, no GT"] + [
        "--device", "cpu", "--accelerator", "tpu", "--output_path", str(tmp_path)])
    with pytest.raises(SystemExit, match="another device"):
        torch_parity.main(args)


def test_summary_is_jax_for_the_same_eval_outputs(monkeypatch, tmp_path, capsys):
    argv = MODES["precomputed npz, GT"]
    summaries = {}
    for side, module in (("jax", jax_parity), ("torch", torch_parity)):
        _record(monkeypatch, module)
        out = tmp_path / side
        module.main(module.parser.parse_args(argv + ["--output_path", str(out)]))
        with open(out / "parity_summary.json") as f:
            summaries[side] = json.load(f)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == summaries[side]
    jax_runs = summaries["jax"]["artifacts"].pop("runs")
    torch_runs = summaries["torch"]["artifacts"].pop("runs")
    assert summaries["torch"] == summaries["jax"]
    assert {k: os.path.basename(v) for k, v in torch_runs.items()} == {
        k: os.path.basename(v) for k, v in jax_runs.items()}
    assert summaries["torch"]["metrics"]["descriptor_uap"] == 0.7123
    assert set(summaries["torch"]["delta_vs_reference"]) == {
        "segment_ap_sn_faithful", "segment_ap_sn_tuned", "segment_ap_raw",
        "descriptor_uap"}


def test_failed_stage_names_its_command():
    with pytest.raises(SystemExit, match="Parity stage failed .exit 3.: .*-c"):
        torch_parity.run_cli([sys.executable, "-c", "raise SystemExit(3)"])


# ---- one real run on the CPU ----------------------------------------------------------


def _synthetic(tmp):
    spec = importlib.util.spec_from_file_location(
        "synthetic_eval", os.path.join(REPO, "tools", "synthetic_eval.py"))
    se = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(se)
    queries, refs, noise, gt = se.build_benchmark(se.parser.parse_args(
        ["--queries", "4", "--refs", "8", "--noise_videos", "4", "--dim", "32",
         "--calibrated"]))
    paths = {k: str(tmp / f"{k}.npz") for k in ("q", "r", "n")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    paths["gt"] = str(tmp / "gt.csv")
    Match.write_csv(gt, paths["gt"])
    return paths


def test_real_cpu_run_and_its_resume(tmp_path):
    from vsc2022_torch.baseline import sscd_baseline
    from vsc2022_torch.metrics import CandidatePair

    paths = _synthetic(tmp_path)
    out = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "vsc2022_torch", "parity", "--device", "cpu",
           "--output_path", out, "--query_features", paths["q"], "--ref_features",
           paths["r"], "--noise_features", paths["n"], "--ground_truth", paths["gt"]]

    def run():
        proc = subprocess.run(cmd, cwd=REPO, text=True, timeout=300,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stdout[-3000:]
        return proc.stdout, json.loads(proc.stdout.strip().splitlines()[-1])

    log, summary = run()
    for arm in ("sn_faithful", "sn_tuned", "raw"):
        for name in ("candidates.csv", "matches.csv"):
            assert os.path.exists(os.path.join(out, arm, name)), (arm, name)
    # The tuned arm reuses the faithful arm's candidates (read, then written
    # again: the same pairs and values).
    faithful, tuned = (
        [(c.query_id, c.ref_id, c.score) for c in
         CandidatePair.read_csv(os.path.join(out, arm, "candidates.csv"))]
        for arm in ("sn_faithful", "sn_tuned"))
    assert tuned == faithful and len(faithful) > 0
    metrics = summary["metrics"]
    assert set(metrics) == {"descriptor_uap", "segment_ap_sn_faithful",
                            "segment_ap_sn_tuned", "segment_ap_raw"}
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    assert metrics["segment_ap_sn_tuned"] > 0.5 and metrics["descriptor_uap"] > 0.5
    assert "stage vsc2022_torch.baseline.sscd_baseline (sn_faithful):" in log
    with open(os.path.join(out, "parity_summary.json")) as f:
        assert json.load(f) == summary

    # The faithful arm is sscd_baseline --vcsl_faithful_tn on the same files.
    direct = str(tmp_path / "direct")
    sscd_baseline.main(sscd_baseline.parser.parse_args([
        "--query_features", paths["q"], "--ref_features", paths["r"],
        "--score_norm_features", paths["n"], "--vcsl_faithful_tn",
        "--output_path", direct, "--device", "cpu"]))
    for name in ("candidates.csv", "matches.csv"):
        with open(os.path.join(direct, name), "rb") as a, \
                open(os.path.join(out, "sn_faithful", name), "rb") as b:
            assert a.read() == b.read(), name

    # Resume: no matching stage reruns, the same summary.
    mtime = os.path.getmtime(os.path.join(out, "raw", "matches.csv"))
    log2, summary2 = run()
    assert log2.count("Reusing existing artifact") == 3
    assert "sscd_baseline" not in log2
    assert summary2 == summary
    assert os.path.getmtime(os.path.join(out, "raw", "matches.csv")) == mtime


def test_parser_takes_the_jax_flags():
    jax_flags = {a.dest for a in jax_parity.parser._actions}
    torch_flags = {a.dest for a in torch_parity.parser._actions}
    assert torch_flags == jax_flags | {"device"}
    acc = next(a for a in torch_parity.parser._actions if a.dest == "accelerator")
    jacc = next(a for a in jax_parity.parser._actions if a.dest == "accelerator")
    assert acc.choices == jacc.choices
    assert isinstance(torch_parity.parser.parse_args(["--output_path", "x"]),
                      argparse.Namespace)
