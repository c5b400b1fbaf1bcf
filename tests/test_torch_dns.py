"""The port's DnS track against the JAX package on the same inputs:
the fused fine+coarse similarity, the students (weights carried across by
``dns_student_from_jax``), the npz checkpoints and TorchScript students
both entry points take, the DnS localizer, and dns_index → dns_baseline end to
end through both packages' ``main()``s. The port's parsers take the JAX
package's command lines, ``--accelerator`` included.

Tolerances: f32 within 1e-5 (XLA and torch sum the f32 products in other
orders); fp16 features within one fp16 ULP (the two f32 results can
straddle a rounding boundary); bin codes identical wherever the f32 value
before the sign is further than 1e-5 from 0.
"""

import argparse
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc2022_torch.baseline import dns_baseline as torch_baseline
from vsc2022_torch.baseline import dns_index as torch_index
from vsc2022_torch.convert import dns_student_from_jax
from vsc2022_torch.device import resolve_device
from vsc2022_torch.metrics import CandidatePair as TorchPair
from vsc2022_torch.models.dns import DnSStudent as TorchStudent
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_torch.utils import checkpoint as torch_ckpt
from vsc2022_tpu import metrics as jm
from vsc2022_tpu.baseline import dns_baseline as jax_baseline
from vsc2022_tpu.baseline import dns_index as jax_index
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.models.dns import NUM_REGIONS, REDUCED_DIM
from vsc2022_tpu.models.dns import DnSStudent as JaxStudent
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature as JVF
from vsc2022_tpu.utils import checkpoint as jax_ckpt

RAW_DIM = NUM_REGIONS * 3840
STUDENTS = [("cg", None), ("fg", "att"), ("fg", "bin")]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _students(student_type, fg_type, seed):
    jax_student = JaxStudent(student_type, fg_type, rng_seed=seed)
    state = dns_student_from_jax(
        _np_tree(jax_student.params), student_type, fg_type or "att"
    )
    return jax_student, TorchStudent(
        student_type, fg_type, state_dict=state, device="cpu"
    )


def _assert_fp16_within_ulp(got, want):
    got, want = np.asarray(got, np.float16), np.asarray(want, np.float16)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (diff <= ulp.astype(np.float32)).all(), float(diff.max())


def _assert_bits_agree(got_bits, want_bits, want_f32):
    clear = np.abs(want_f32) > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got_bits[clear], want_bits[clear])


# ---- fused similarity -------------------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
def test_chamfer_fuse_matches_jax(symmetric):
    rng = np.random.RandomState(3)
    b, nq, nr, r, d, dc = 2, 4, 5, NUM_REGIONS, 8, 6
    qf = rng.randn(b, nq, r, d).astype(np.float32)
    rf = rng.randn(b, nr, r, d).astype(np.float32)
    qc = rng.randn(b, nq, dc).astype(np.float32)
    rc = rng.randn(b, nr, dc).astype(np.float32)
    qf[1, 3:] = 0.0  # zero-pad frames, as gathered past a video's end
    rf[0, 4:] = 0.0
    want = np.asarray(jax_baseline._fused_fine_coarse_sims(
        jnp.asarray(qf), jnp.asarray(rf), jnp.asarray(qc), jnp.asarray(rc),
        jnp.float32(0.5), symmetric=symmetric,
    ))
    got = torch_baseline._chamfer_fuse(
        *(torch.from_numpy(x) for x in (qf, rf, qc, rc)), 0.5, symmetric
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- students -----------------------------------------------------------------


@pytest.mark.parametrize("student_type,fg_type", STUDENTS)
def test_students_match_jax(student_type, fg_type):
    jax_student, torch_student = _students(student_type, fg_type, seed=3)
    assert torch_student.get_network_name() == jax_student.get_network_name()
    rng = np.random.RandomState(4)
    videos = [
        (f"Q{i:06d}", (0.05 * rng.randn(n, RAW_DIM)).astype(np.float32))
        for i, n in enumerate((5, 9))
    ]
    want = jax_index.index_videos(
        jax_student, [JVF(v, np.arange(len(f), dtype=np.float64), f) for v, f in videos]
    )
    got = torch_index.index_videos(
        torch_student, [TVF(v, np.arange(len(f), dtype=np.float64), f) for v, f in videos]
    )
    for (_, raw), w, g in zip(videos, want, got):
        assert g.video_id == w.video_id and g.feature.dtype == w.feature.dtype
        assert g.feature.shape == w.feature.shape
        if student_type == "cg":
            np.testing.assert_allclose(g.feature, w.feature, rtol=0, atol=1e-5)
        elif fg_type == "att":
            _assert_fp16_within_ulp(g.feature, w.feature)
        else:
            want_f32 = jax_student.index_video(raw)
            np.testing.assert_allclose(
                torch_student.index_video(raw), want_f32, rtol=0, atol=1e-5
            )
            _assert_bits_agree(g.feature, w.feature, want_f32)


def test_fg_student_similarity_matches_jax():
    jax_student, torch_student = _students("fg", "att", seed=5)
    rng = np.random.RandomState(6)
    q = jax_student.index_video(0.05 * rng.randn(7, RAW_DIM))
    r = jax_student.index_video(0.05 * rng.randn(11, RAW_DIM))
    np.testing.assert_allclose(
        torch_student(q, r), jax_student(q, r), rtol=0, atol=1e-5
    )
    with pytest.raises(ValueError):
        _students("cg", None, seed=5)[1](q, r)


def test_checkpoint_npz_round_trip_between_packages(tmp_path):
    jax_student = JaxStudent("fg", "bin", rng_seed=7)
    tree = _np_tree(jax_student.params)
    jax_ckpt.save_variables(str(tmp_path / "jax.npz"), jax_student.params)
    from_jax = torch_ckpt.load_variables(str(tmp_path / "jax.npz"))
    torch_ckpt.save_variables(str(tmp_path / "torch.npz"), from_jax)
    back = jax_ckpt.load_variables(str(tmp_path / "torch.npz"))
    flat = torch_ckpt._flatten(tree)
    assert torch_ckpt._flatten(from_jax).keys() == flat.keys()
    for key, value in flat.items():
        np.testing.assert_array_equal(torch_ckpt._flatten(from_jax)[key], value)
        np.testing.assert_array_equal(jax_ckpt._flatten(back)[key], value)
    # The port's student from the npz computes what it computes from the
    # in-memory tree.
    raw = 0.05 * np.random.RandomState(8).randn(4, RAW_DIM)
    a = TorchStudent("fg", "bin", state_dict=dns_student_from_jax(
        from_jax, "fg", "bin"), device="cpu").index_video(raw)
    b = TorchStudent("fg", "bin", state_dict=dns_student_from_jax(
        tree, "fg", "bin"), device="cpu").index_video(raw)
    np.testing.assert_array_equal(a, b)


def test_random_init_follows_flax_distributions():
    student = TorchStudent("fg", "bin", seed=0, device="cpu").module
    w = student.reduction.weight.detach().numpy()
    std = np.sqrt(1.0 / 3840)
    assert abs(w.std() - std) < 0.02 * std and np.abs(w).max() <= 2 * std / 0.8796
    assert (student.reduction.bias == 0).all()
    rot = student.binarization.W.detach().numpy()
    np.testing.assert_allclose(rot @ rot.T, np.eye(REDUCED_DIM), atol=1e-4)
    again = TorchStudent("fg", "bin", seed=0, device="cpu").module
    assert torch.equal(again.binarization.W, student.binarization.W)


def _script_student(path, student_type, fg_type, seed):
    module = _students(student_type, fg_type, seed)[1].module
    torch.jit.save(torch.jit.script(module), str(path))
    return module


def test_torchscript_student_in_both_packages_entry_points(tmp_path):
    path = tmp_path / "fg_bin.pt"
    _script_student(path, "fg", "bin", seed=9)
    # --fg_type att on the command line; the module's metadata wins.
    ns = argparse.Namespace(
        torchscript_path=str(path), student=None, fg_type="att",
        checkpoint_path=None,
    )
    jax_student = jax_index._build_student(ns)
    torch_student = torch_index._build_student(
        torch_index.parser.parse_args([
            "--query_features", "q.npz", "--ref_features", "r.npz",
            "--output_path", "out", "--torchscript_path", str(path),
            "--fg_type", "att",
        ]), "cpu",
    )
    for s in (jax_student, torch_student):
        assert (s.student_type, s.fg_type) == ("fg", "bin")
    raw = 0.05 * np.random.RandomState(10).randn(6, RAW_DIM)
    np.testing.assert_allclose(
        torch_student.index_video(raw), jax_student.index_video(raw),
        rtol=0, atol=1e-5,
    )
    # dns_baseline takes only fine-grained students, in both packages.
    cg_path = tmp_path / "cg.pt"
    _script_student(cg_path, "cg", None, seed=11)
    files = ["--query_coarse_features", "qc.npz", "--ref_coarse_features",
             "rc.npz", "--query_fine_features", "qf.npz",
             "--ref_fine_features", "rf.npz", "--torchscript_path", str(cg_path)]
    with pytest.raises(Exception, match="fine-grained"):
        jax_baseline.main(jax_baseline.parser.parse_args(
            files + ["--output_path", str(tmp_path / "jo")]))
    with pytest.raises(Exception, match="fine-grained"):
        torch_baseline.main(torch_baseline.parser.parse_args(
            files + ["--output_path", str(tmp_path / "to"), "--device", "cpu"]))


# ---- localization -------------------------------------------------------------


def _unit_regions(rng, n):
    x = rng.normal(size=(n, NUM_REGIONS, REDUCED_DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _coarse_from(fine):
    pooled = fine.mean(axis=1)
    return pooled / np.linalg.norm(pooled, axis=-1, keepdims=True)


def _localization_case(name):
    rng = np.random.RandomState(7 if name == "planted" else 19)
    if name == "planted":  # tests/test_dns.py::TestDnSLocalization
        q_fine = [_unit_regions(rng, 40)]
        r_fine = [None, None, _unit_regions(rng, 50)]
        q_fine[0][10:22] = r_fine[2][5:17]
        pairs = [(0, 2)]
    else:  # queries and refs across the 32, 64 and 128 buckets
        q_fine = [_unit_regions(rng, n) for n in (30, 64, 100)]
        r_fine = [_unit_regions(rng, n) for n in (24, 40, 70, 33, 128)]
        q_fine[0][8:20] = r_fine[1][5:17]
        q_fine[1][30:60] = r_fine[2][20:50]
        q_fine[2][50:90] = r_fine[4][80:120]
        pairs = [(i, j) for i in range(3) for j in range(5)]

    def side(prefix, fines, vf):
        fine = {f"{prefix}{i:06d}": vf(f"{prefix}{i:06d}", np.arange(len(f), dtype=np.float64),
                                       f.reshape(len(f), -1))
                for i, f in enumerate(fines) if f is not None}
        coarse = [vf(f"{prefix}{i:06d}", np.arange(len(f), dtype=np.float64), _coarse_from(f))
                  for i, f in enumerate(fines) if f is not None]
        return fine, coarse

    def build(vf):
        return (*side("Q", q_fine, vf), *side("R", r_fine, vf))

    ids = [(f"Q{i:06d}", f"R{j:06d}") for i, j in pairs]
    return build, ids


def _key(m):
    return (m.query_id, m.ref_id, m.query_start, m.query_end, m.ref_start, m.ref_end)


@pytest.mark.parametrize("case", ["planted", "multi_bucket"])
def test_dns_localization_matches_jax(case):
    build, ids = _localization_case(case)
    kw = dict(model_type="TN", tn_max_step=5, min_length=4, similarity_bias=0.5)
    qf, qc, rf, rc = build(JVF)
    want = jax_baseline.DnSLocalization(qf, rf, qc, rc, **kw).localize_all(
        [jm.CandidatePair(q, r, 1.0) for q, r in ids]
    )
    qf, qc, rf, rc = build(TVF)
    got = torch_baseline.DnSLocalization(
        qf, rf, qc, rc, device="cpu", **kw
    ).localize_all([TorchPair(q, r, 1.0) for q, r in ids])
    assert len(want) >= (1 if case == "planted" else 3)
    assert [_key(m) for m in got] == [_key(m) for m in want]
    np.testing.assert_allclose(
        [m.score for m in got], [m.score for m in want], rtol=0, atol=1e-5
    )


# ---- dns_index → dns_baseline, both packages ----------------------------------


@pytest.fixture(scope="module")
def raw_corpus(tmp_path_factory):
    """Raw L3-iMAC rows of 3 query, 5 reference and 2 noise videos (8, 24
    and 40 frames), two queries copying a reference segment."""
    root = tmp_path_factory.mktemp("dns")
    rng = np.random.RandomState(0)

    def video(prefix, i, n):
        return JVF(f"{prefix}{i:06d}", np.arange(n, dtype=np.float64),
                   (0.05 * rng.randn(n, RAW_DIM)).astype(np.float32))

    refs = [video("R", i, n) for i, n in enumerate((24, 40, 8, 40, 24))]
    queries = [video("Q", i, n) for i, n in enumerate((40, 24, 8))]
    noise = [video("R", 900 + i, 24) for i in range(2)]
    queries[0].feature[5:20] = refs[1].feature[10:25]
    queries[1].feature[2:14] = refs[3].feature[20:32]
    gt = [jm.Match("Q000000", "R000001", 1.0, 5.0, 20.0, 10.0, 25.0),
          jm.Match("Q000001", "R000003", 1.0, 2.0, 14.0, 20.0, 32.0)]
    paths = {k: str(root / f"{k}.npz") for k in ("q", "r", "n", "cg", "fg")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    jax_ckpt.save_variables(paths["cg"], JaxStudent("cg", rng_seed=0).params)
    jax_ckpt.save_variables(paths["fg"], JaxStudent("fg", "att", rng_seed=1).params)
    paths["gt"] = str(root / "gt.csv")
    jm.Match.write_csv(gt, paths["gt"])
    paths["ts"] = str(root / "fg_att.pt")
    module = TorchStudent("fg", "att", state_dict=dns_student_from_jax(
        torch_ckpt.load_variables(paths["fg"]), "fg", "att"), device="cpu").module
    torch.jit.save(torch.jit.script(module), paths["ts"])
    paths["root"] = root
    return paths


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_close_csv(a, b):
    ra, rb = _rows(a), _rows(b)
    assert ra[0] == rb[0] and len(ra) == len(rb) and len(ra) > 1
    for x, y in zip(ra[1:], rb[1:]):
        for name, u, v in zip(ra[0], x, y):
            if name == "score":
                assert abs(float(u) - float(v)) <= 1e-5, (u, v)
            else:
                assert u == v


def test_two_stage_flow_matches_jax(raw_corpus):
    p = raw_corpus
    root = p["root"]
    stages = [("cg", p["cg"], p["n"]), ("fg", p["fg"], None)]
    for student, ckpt, noise in stages:
        jax_index.main(argparse.Namespace(
            query_features=p["q"], ref_features=p["r"], score_norm_features=noise,
            output_path=str(root / "jax_idx"), student=student, fg_type="att",
            checkpoint_path=ckpt,
        ))
        argv = ["--query_features", p["q"], "--ref_features", p["r"],
                "--output_path", str(root / "torch_idx"), "--student", student,
                "--checkpoint_path", ckpt, "--device", "cpu"]
        if noise:
            argv += ["--score_norm_features", noise]
        torch_index.main(torch_index.parser.parse_args(argv))

    for name in ("queries_cg_student_sn", "refs_cg_student_sn",
                 "queries_fg_att_student", "refs_fg_att_student"):
        with np.load(root / "jax_idx" / f"{name}.npz") as a, \
                np.load(root / "torch_idx" / f"{name}.npz") as b:
            np.testing.assert_array_equal(b["video_ids"], a["video_ids"])
            np.testing.assert_array_equal(b["timestamps"], a["timestamps"])
            assert b["features"].dtype == a["features"].dtype
            if a["features"].dtype == np.float16:
                _assert_fp16_within_ulp(b["features"], a["features"])
            else:
                assert a["features"].shape[1] == 1025  # the CSLS bias column
                np.testing.assert_allclose(
                    b["features"], a["features"], rtol=0, atol=1e-5
                )

    def files(idx):
        return ["--query_coarse_features", str(idx / "queries_cg_student_sn.npz"),
                "--ref_coarse_features", str(idx / "refs_cg_student_sn.npz"),
                "--query_fine_features", str(idx / "queries_fg_att_student.npz"),
                "--ref_fine_features", str(idx / "refs_fg_att_student.npz"),
                "--torchscript_path", p["ts"]]

    jax_out, torch_out = root / "jax_out", root / "torch_out"
    jax_baseline.main(jax_baseline.parser.parse_args(
        files(root / "jax_idx") + ["--output_path", str(jax_out)]))
    result = torch_baseline.main(torch_baseline.parser.parse_args(
        files(root / "torch_idx") + ["--output_path", str(torch_out),
                                     "--ground_truth", p["gt"], "--device", "cpu"]))
    for name in ("candidates.csv", "matches.csv"):
        _assert_close_csv(jax_out / name, torch_out / name)

    gt = jm.CandidatePair.from_matches(jm.Match.read_csv(p["gt"], is_gt=True))
    uap = jm.average_precision(
        gt, jm.CandidatePair.read_csv(str(jax_out / "candidates.csv"))).ap
    seg = jm.evaluate_matching_track(
        p["gt"], str(jax_out / "matches.csv")).segment_ap.ap
    assert (result["candidate_uap"], result["segment_ap"]) == (uap, seg)
    assert uap == 1.0 and seg > 0.5
    assert set(result["stages"]) == {"load", "retrieve", "localize", "metrics"}
    assert os.path.getsize(torch_out / "matches.csv") > 0


def test_tables_stage_only_the_candidates_videos_and_grow():
    build, ids = _localization_case("multi_bucket")
    kw = dict(model_type="TN", tn_max_step=5, min_length=4, similarity_bias=0.5,
              device="cpu")
    qf, qc, rf, rc = build(TVF)
    first = [TorchPair(q, r, 1.0) for q, r in ids if r in ("R000001", "R000002")]
    later = [TorchPair(q, r, 1.0) for q, r in ids if r == "R000004"]
    loc = torch_baseline.DnSLocalization(qf, rf, qc, rc, **kw)
    loc.localize_all(first)
    ref_rows = {n: loc._tables[n][0].shape[0] for n in ("ref", "ref_fine")}
    assert ref_rows == {"ref": 1 + 40 + 70, "ref_fine": 1 + 40 + 70}
    got = loc.localize_all(later)  # appends R000004's rows to both tables
    assert {n: loc._tables[n][0].shape[0] for n in ref_rows} == {
        "ref": 1 + 40 + 70 + 128, "ref_fine": 1 + 40 + 70 + 128}
    want = torch_baseline.DnSLocalization(qf, rf, qc, rc, **kw).localize_all(later)
    assert got and [_key(m) + (m.score,) for m in got] == [
        _key(m) + (m.score,) for m in want]


# ---- the JAX entry points' --accelerator flag ----------------------------------

# The JAX package's own command lines (vsc2022_tpu/baseline/dns_index.py,
# dns_baseline.py), without their --accelerator.
JAX_COMMAND_LINES = {
    "dns_index": (jax_index.parser, torch_index.parser, [
        "--query_features", "q.npz", "--ref_features", "r.npz",
        "--score_norm_features", "n.npz", "--output_path", "idx",
        "--student", "cg", "--checkpoint_path", "cg.npz"]),
    "dns_baseline": (jax_baseline.parser, torch_baseline.parser, [
        "--query_coarse_features", "qc.npz", "--ref_coarse_features", "rc.npz",
        "--query_fine_features", "qf.npz", "--ref_fine_features", "rf.npz",
        "--output_path", "out", "--ground_truth", "gt.csv"]),
}


@pytest.mark.parametrize("accelerator,device", [
    (None, "cuda"), ("cpu", "cpu"), ("tpu", "cuda")])
@pytest.mark.parametrize("entry", sorted(JAX_COMMAND_LINES))
def test_port_parsers_take_the_jax_command_lines(entry, accelerator, device):
    # Every JAX command line parses in the port: --accelerator cpu selects
    # the CPU, tpu (the JAX default) the card, as no flag does.
    jax_parser, torch_parser, argv = JAX_COMMAND_LINES[entry]
    if accelerator is not None:
        argv = argv + ["--accelerator", accelerator]
    jax_args, args = jax_parser.parse_args(argv), torch_parser.parse_args(argv)
    assert jax_args.accelerator == (accelerator or "tpu")
    assert args.device == device
    assert args.output_path == jax_args.output_path
    if device == "cpu":
        assert resolve_device(args.device) == torch.device("cpu")


@pytest.mark.parametrize("flags,device", [
    (["--accelerator", "cuda"], "cuda"), (["--device", "cpu"], "cpu"),
    (["--device", "cpu", "--accelerator", "cpu"], "cpu"),
    (["--accelerator", "tpu", "--device", "cuda"], "cuda")])
@pytest.mark.parametrize("entry", sorted(JAX_COMMAND_LINES))
def test_port_device_flags_that_agree(entry, flags, device):
    _, torch_parser, argv = JAX_COMMAND_LINES[entry]
    assert torch_parser.parse_args(argv + flags).device == device


@pytest.mark.parametrize("flags", [
    ["--device", "cpu", "--accelerator", "tpu"],
    ["--accelerator", "cuda", "--device", "cpu"],
    ["--accelerator", "cpu", "--accelerator", "tpu"]])
@pytest.mark.parametrize("entry", sorted(JAX_COMMAND_LINES))
def test_port_device_flags_that_disagree_are_an_error(entry, flags, capsys):
    _, torch_parser, argv = JAX_COMMAND_LINES[entry]
    with pytest.raises(SystemExit) as exc:
        torch_parser.parse_args(argv + flags)
    assert exc.value.code == 2
    assert "earlier flag selected" in capsys.readouterr().err


def test_two_stage_flow_with_accelerator_cpu(raw_corpus, tmp_path):
    # The JAX package's command lines with --accelerator cpu run the port's
    # dns_index -> dns_baseline on the CPU, end to end.
    p = raw_corpus
    idx, out = tmp_path / "idx", tmp_path / "out"
    for student, ckpt, noise in (("cg", p["cg"], p["n"]), ("fg", p["fg"], None)):
        argv = ["--query_features", p["q"], "--ref_features", p["r"],
                "--output_path", str(idx), "--student", student,
                "--checkpoint_path", ckpt, "--accelerator", "cpu"]
        if noise:
            argv += ["--score_norm_features", noise]
        jax_index.parser.parse_args(argv)
        torch_index.main(torch_index.parser.parse_args(argv))
    argv = ["--query_coarse_features", str(idx / "queries_cg_student_sn.npz"),
            "--ref_coarse_features", str(idx / "refs_cg_student_sn.npz"),
            "--query_fine_features", str(idx / "queries_fg_att_student.npz"),
            "--ref_fine_features", str(idx / "refs_fg_att_student.npz"),
            "--torchscript_path", p["ts"], "--output_path", str(out),
            "--ground_truth", p["gt"], "--accelerator", "cpu"]
    jax_baseline.parser.parse_args(argv)
    result = torch_baseline.main(torch_baseline.parser.parse_args(argv))
    assert result["candidate_uap"] == 1.0 and result["segment_ap"] > 0.5
    assert os.path.getsize(out / "matches.csv") > 0
