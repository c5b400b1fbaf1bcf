"""The whole matching driver, port against JAX, on the synthetic corpus of
tests/test_pipeline_e2e.py (``build_corpus``), with and without score
normalization, plus an integer-valued corpus.

Float corpora: candidates.csv and matches.csv hold the same rows and
scores within 1e-5 (XLA and torch sum f32 products in other orders).
The integer-valued corpus without score normalization scores exactly on
both sides, so the files are byte-identical. µAP and segment AP agree.
"""

import csv
import os

import numpy as np
import pytest

from test_pipeline_e2e import build_corpus
from vsc2022_torch import descriptor_eval as torch_descriptor_eval
from vsc2022_torch.baseline import sscd_baseline as torch_driver
from vsc2022_tpu import metrics as jm
from vsc2022_tpu.baseline import sscd_baseline as jax_driver
from vsc2022_tpu.descriptor_eval_lib import evaluate_descriptor_track
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature


def _integer_corpus(rng, d=32, n_refs=12, n_queries=5):
    def video(i, n):
        return VideoFeature(
            video_id=i, timestamps=np.arange(n, dtype=np.float64),
            feature=rng.randint(-3, 4, size=(n, d)).astype(np.float32),
        )

    refs = [video(i, int(rng.randint(30, 60))) for i in range(n_refs)]
    queries = [video(i, 40) for i in range(n_queries)]
    gt = []
    for i in range(3):
        queries[i].feature[10:22] = refs[i].feature[5:17]
        gt.append(jm.Match(f"Q{i:06d}", f"R{i:06d}", 1.0, 10.0, 22.0, 5.0, 17.0))
    return queries, refs, gt


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    out = {}
    int_q, int_r, int_gt = _integer_corpus(np.random.RandomState(5))
    for name, (queries, refs, noise, gt) in (
        ("float", build_corpus(np.random.RandomState(11))),
        ("int", (int_q, int_r, None, int_gt)),
    ):
        root = tmp_path_factory.mktemp(name)
        paths = {"q": str(root / "q.npz"), "r": str(root / "r.npz"),
                 "gt": str(root / "gt.csv"), "root": root}
        store_features(paths["q"], queries, Dataset.QUERIES)
        store_features(paths["r"], refs, Dataset.REFS)
        if noise is not None:
            paths["n"] = str(root / "n.npz")
            store_features(paths["n"], noise, Dataset.REFS)
        jm.Match.write_csv(gt, paths["gt"])
        out[name] = paths
    return out


def _run_both(paths, score_norm, vcsl=False):
    tag = ("sn" if score_norm else "raw") + ("_vcsl" if vcsl else "")
    common = ["--query_features", paths["q"], "--ref_features", paths["r"]]
    if score_norm:
        common += ["--score_norm_features", paths["n"]]
    if vcsl:
        common += ["--vcsl_faithful_tn"]
    jax_out = str(paths["root"] / f"jax_{tag}")
    torch_out = str(paths["root"] / f"torch_{tag}")
    jax_driver.main(jax_driver.parser.parse_args(common + ["--output_path", jax_out]))
    result = torch_driver.main(torch_driver.parser.parse_args(
        common + ["--output_path", torch_out, "--device", "cpu",
                  "--ground_truth", paths["gt"]]
    ))
    return jax_out, torch_out, result


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_close_csv(a, b, float_cols):
    ra, rb = _rows(a), _rows(b)
    assert ra[0] == rb[0] and len(ra) == len(rb) and len(ra) > 1
    for x, y in zip(ra[1:], rb[1:]):
        for i, (u, v) in enumerate(zip(x, y)):
            if ra[0][i] in float_cols:
                assert abs(float(u) - float(v)) <= 1e-5, (ra[0][i], u, v)
            else:
                assert u == v


def _jax_metrics(jax_out, gt_path):
    gt = jm.CandidatePair.from_matches(jm.Match.read_csv(gt_path, is_gt=True))
    uap = jm.average_precision(
        gt, jm.CandidatePair.read_csv(os.path.join(jax_out, "candidates.csv"))
    ).ap
    seg = jm.evaluate_matching_track(
        gt_path, os.path.join(jax_out, "matches.csv")
    ).segment_ap.ap
    return uap, seg


@pytest.mark.parametrize("score_norm", [False, True])
def test_float_corpus_matches_jax(corpora, score_norm):
    paths = corpora["float"]
    jax_out, torch_out, result = _run_both(paths, score_norm)
    _assert_close_csv(os.path.join(jax_out, "candidates.csv"),
                      os.path.join(torch_out, "candidates.csv"), {"score"})
    _assert_close_csv(os.path.join(jax_out, "matches.csv"),
                      os.path.join(torch_out, "matches.csv"), {"score"})
    uap, seg = _jax_metrics(jax_out, paths["gt"])
    assert result["candidate_uap"] == pytest.approx(uap, abs=1e-9)
    assert result["segment_ap"] == pytest.approx(seg, abs=1e-9)
    assert uap > 0.9 and seg > 0.5
    if score_norm:
        for name in ("sn_queries.npz", "sn_refs.npz"):
            with np.load(os.path.join(jax_out, name)) as a, \
                    np.load(os.path.join(torch_out, name)) as b:
                np.testing.assert_array_equal(b["video_ids"], a["video_ids"])
                np.testing.assert_allclose(
                    b["features"], a["features"], rtol=0, atol=1e-6
                )


@pytest.mark.parametrize("vcsl", [False, True])
def test_integer_corpus_byte_identical(corpora, vcsl):
    paths = corpora["int"]
    jax_out, torch_out, result = _run_both(paths, score_norm=False, vcsl=vcsl)
    for name in ("candidates.csv", "matches.csv"):
        with open(os.path.join(jax_out, name), "rb") as a, \
                open(os.path.join(torch_out, name), "rb") as b:
            assert b.read() == a.read(), name
    uap, seg = _jax_metrics(jax_out, paths["gt"])
    assert (result["candidate_uap"], result["segment_ap"]) == (uap, seg)


def test_descriptor_eval_matches_jax(corpora, tmp_path):
    paths = corpora["float"]
    want_ap, want = evaluate_descriptor_track(paths["q"], paths["r"], paths["gt"])
    out = str(tmp_path / "c.csv")
    got_ap = torch_descriptor_eval.main(torch_descriptor_eval.parser.parse_args([
        "--query_features", paths["q"], "--ref_features", paths["r"],
        "--ground_truth", paths["gt"], "--candidates_output", out,
        "--device", "cpu",
    ]))
    assert got_ap == pytest.approx(want_ap.ap, abs=1e-9)
    got = _rows(out)[1:]
    assert [r[:2] for r in got] == [[c.query_id, c.ref_id] for c in want]
    np.testing.assert_allclose([float(r[2]) for r in got],
                               [c.score for c in want], rtol=0, atol=1e-5)


def test_profile_dir_writes_trace(corpora, tmp_path):
    paths = corpora["int"]
    prof = tmp_path / "prof"
    torch_driver.main(torch_driver.parser.parse_args([
        "--query_features", paths["q"], "--ref_features", paths["r"],
        "--output_path", str(tmp_path / "out"), "--device", "cpu",
        "--profile_dir", str(prof),
    ]))
    assert (prof / "trace.json").stat().st_size > 0
    assert "Self CPU" in (prof / "summary.txt").read_text()


def test_report_metrics_writes_the_pr_plots(corpora, tmp_path):
    # With --ground_truth the driver renders both PR curves, as JAX's does.
    paths = corpora["int"]
    out = tmp_path / "out"
    torch_driver.main(torch_driver.parser.parse_args([
        "--query_features", paths["q"], "--ref_features", paths["r"],
        "--output_path", str(out), "--device", "cpu", "--ground_truth", paths["gt"],
    ]))
    for name in ("candidate_precision_recall.pdf", "precision_recall.pdf"):
        assert (out / name).read_bytes()[:5] == b"%PDF-"


def test_report_metrics_without_matplotlib(corpora, tmp_path, monkeypatch, caplog):
    # No matplotlib (the GPU machine has none): one warning naming both
    # files, no plot written, the metrics still returned.
    import logging
    import sys

    from vsc2022_torch.baseline import pipeline

    paths = corpora["int"]
    out = tmp_path / "out"
    torch_driver.main(torch_driver.parser.parse_args([
        "--query_features", paths["q"], "--ref_features", paths["r"],
        "--output_path", str(out), "--device", "cpu",
    ]))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    log = logging.getLogger("test_report")
    with caplog.at_level(logging.INFO, logger="test_report"):
        got = pipeline.report_metrics(paths["gt"], str(out / "candidates.csv"),
                                      str(out / "matches.csv"), log,
                                      output_path=str(out))
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1
    for name in ("candidate_precision_recall.pdf", "precision_recall.pdf"):
        assert name in warnings[0].getMessage()
        assert not (out / name).exists()
    uap, seg = _jax_metrics(str(out), paths["gt"])
    assert got == {"candidate_uap": uap, "segment_ap": seg}


def test_create_pr_plot_like_jax(tmp_path):
    from vsc2022_torch import metrics as tm
    from vsc2022_torch.baseline import pipeline
    from vsc2022_tpu.baseline import pipeline as jax_pipeline

    rng = np.random.RandomState(3)
    arrays = (np.sort(rng.rand(30)), np.sort(rng.rand(30)), rng.rand(30))
    jax_pipeline.create_pr_plot(jm.AveragePrecision(0.5, jm.PrecisionRecallCurve(*arrays)),
                                str(tmp_path / "jax.pdf"))
    pipeline.create_pr_plot(tm.AveragePrecision(0.5, tm.PrecisionRecallCurve(*arrays)),
                            str(tmp_path / "torch.pdf"))
    for name in ("jax.pdf", "torch.pdf"):
        assert (tmp_path / name).read_bytes()[:5] == b"%PDF-"


def test_sscd_search_matches_jax(corpora):
    # The module-level search of the reference's API: the same candidate
    # pairs and scores on the integer corpus (exact scores).
    from vsc2022_torch.metrics import Dataset as TDataset
    from vsc2022_torch.storage import load_features as torch_load
    from vsc2022_tpu.storage import load_features as jax_load

    paths = corpora["int"]
    want = jax_driver.search(jax_load(paths["q"], Dataset.QUERIES),
                             jax_load(paths["r"], Dataset.REFS))
    got = torch_driver.search(torch_load(paths["q"], TDataset.QUERIES),
                              torch_load(paths["r"], TDataset.REFS), device="cpu")
    assert [(c.query_id, c.ref_id, c.score) for c in got] == \
        [(c.query_id, c.ref_id, c.score) for c in want]
    assert len(got) == 5 * 12  # every (query, ref) pair: under the budget of 25


def test_matching_eval_prints_the_root_scripts_line(corpora, tmp_path):
    # python -m vsc2022_torch.matching_eval prints exactly the line of the
    # root matching_eval.py on the same files.
    import subprocess
    import sys

    paths = corpora["int"]
    out = tmp_path / "out"
    torch_driver.main(torch_driver.parser.parse_args([
        "--query_features", paths["q"], "--ref_features", paths["r"],
        "--output_path", str(out), "--device", "cpu",
    ]))
    args = ["--predictions", str(out / "matches.csv"), "--ground_truth", paths["gt"]]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = []
    for cmd in (["matching_eval.py"], ["-m", "vsc2022_torch.matching_eval"]):
        run = subprocess.run([sys.executable, *cmd, *args], cwd=root, text=True,
                             capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert run.returncode == 0, run.stderr
        lines.append(run.stdout.splitlines())
    want, got = lines
    assert got == want and len(got) == 1
    assert got[0].startswith("Matching track segment AP: ")
