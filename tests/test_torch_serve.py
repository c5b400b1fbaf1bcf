"""The port's serving stack against the JAX package: the score-normalized
searcher and index, the index and localizer lifecycle (add, remove,
set_queries), ``serve_request`` on the same request lines, the failure
contracts of add/remove/save, and one server subprocess of the port over
stdin and over TCP.

The corpora are dyadic: every descriptor row has dimension 0 at zero
(the noise corpus makes it the min-variance dimension that the score
normalization drops) and ±1 on four other dimensions, so L2 rows are
±0.5, every inner product is a multiple of 1/4, and β = 1.25 keeps the
noise-NN bias a multiple of 1/16. Every score is exact on both sides, so
CSVs must be byte-identical (the DnS matches, which run through the
fine chamfer's division by 9 and a square root, within 1e-5).
"""

import argparse
import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vsc2022_torch.baseline import dns_baseline as torch_dns
from vsc2022_torch.localization import TNLocalizationMaxSim as TorchMaxSim
from vsc2022_torch.metrics import CandidatePair as TorchPair
from vsc2022_torch.retrieval import serve as torch_serve
from vsc2022_torch.retrieval.candidates import MaxScoreAggregation as TorchAgg
from vsc2022_torch.retrieval.candidates import rank_candidates as torch_rank
from vsc2022_torch.retrieval.client import ServeClient, ServeError
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex as TorchSNIndex
from vsc2022_torch.retrieval.index import VideoIndex as TorchIndex
from vsc2022_torch.retrieval.sn_search import ScoreNormalizedSearcher as TorchSN
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu import metrics as jm
from vsc2022_tpu.baseline import dns_baseline as jax_dns
from vsc2022_tpu.localization import TNLocalizationMaxSim as JaxMaxSim
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.retrieval import serve as jax_serve
from vsc2022_tpu.retrieval.candidates import MaxScoreAggregation as JaxAgg
from vsc2022_tpu.retrieval.candidates import rank_candidates as jax_rank
from vsc2022_tpu.retrieval.index import ScoreNormalizedVideoIndex as JaxSNIndex
from vsc2022_tpu.retrieval.index import VideoIndex as JaxIndex
from vsc2022_tpu.retrieval.sn_search import ScoreNormalizedSearcher as JaxSN
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature as JVF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 12
BETA = 1.25
FINE_D = 8  # per-region width of the DnS fine features (9 regions)


def _dyadic(rng, n, d=D):
    """[n, d]: dimension 0 at zero, ±1 on four of the others."""
    x = np.zeros((n, d), np.float32)
    cols = 1 + np.argsort(rng.rand(n, d - 1), axis=1)[:, :4]
    np.put_along_axis(x, cols, rng.choice([-1.0, 1.0], size=(n, 4)), axis=1)
    return x


def _videos(vf, rng, prefix, lengths, offset=0):
    return [vf(f"{prefix}{offset + i:06d}", np.arange(n, dtype=np.float64),
               _dyadic(rng, n)) for i, n in enumerate(lengths)]


def _corpus(vf, seed=0):
    """(queries, refs, noise, extra refs): queries 0 and 1 copy reference
    segments, query 2 copies a segment of the first extra ref."""
    rng = np.random.RandomState(seed)
    refs = _videos(vf, rng, "R", rng.randint(16, 40, size=10))
    noise = _videos(vf, rng, "R", [20] * 5, offset=500)
    queries = _videos(vf, rng, "Q", [24, 30, 20, 26])
    extra = _videos(vf, rng, "R", [28, 18], offset=100)
    queries[0].feature[4:14] = refs[1].feature[2:12]
    queries[1].feature[10:22] = refs[4].feature[0:12]
    queries[2].feature[3:15] = extra[0].feature[8:20]
    return queries, refs, noise, extra


def _both(fn):
    return fn(JVF), fn(TVF)


def _pairs(cands):
    return [(c.query_id, c.ref_id, c.score) for c in cands]


def _hits(index, queries, k, rank, agg):
    return _pairs(rank(index.search(queries, global_k=k), agg))


# ---- score-normalized searcher and index ------------------------------------


def test_sn_searcher_identical_to_jax_on_integers():
    rng = np.random.RandomState(4)
    refs = rng.randint(-3, 4, size=(700, 16)).astype(np.float32)
    noise = rng.randint(-3, 4, size=(300, 16)).astype(np.float32)
    q = rng.randint(-3, 4, size=(37, 16)).astype(np.float32)
    refs[50:60] = q[3]
    js = JaxSN(refs, noise, beta=BETA)
    ts = TorchSN(refs, noise, beta=BETA, device="cpu")
    for k in (300, 5000):
        for e, g in zip(js.global_topk(q, k), ts.global_topk(q, k)):
            np.testing.assert_array_equal(g, e)
    np.testing.assert_array_equal(ts.last_q_sn.numpy(), np.asarray(js.last_q_sn)[:37])
    np.testing.assert_array_equal(ts.normalize_queries(q).numpy(),
                                  np.asarray(js.normalize_queries(q)))
    # Growth and compaction of the bias-augmented corpus.
    new = rng.randint(-3, 4, size=(90, 16)).astype(np.float32)
    js.append_refs(new)
    ts.append_refs(new)
    keep = np.flatnonzero(rng.rand(790) < 0.6)
    js.keep_refs(keep)
    ts.keep_refs(keep)
    for e, g in zip(js.global_topk(q, 900), ts.global_topk(q, 900)):
        np.testing.assert_array_equal(g, e)


def test_sn_index_lifecycle_identical_to_jax():
    (jq, jr, jn, jx), (tq, tr, tn, tx) = _both(_corpus)
    j = JaxSNIndex(D, jn, beta=BETA)
    t = TorchSNIndex(D, tn, beta=BETA, device="cpu")
    j.add(jr)
    t.add(tr)
    k = 1200 * len(jq)
    want = _hits(j, jq, k, jax_rank, JaxAgg())
    assert _hits(t, tq, k, torch_rank, TorchAgg()) == want
    staged = t._searcher
    j.add(jx)
    t.add(tx)
    assert t._searcher is staged  # grown on the device, not restaged
    want = _hits(j, jq, k, jax_rank, JaxAgg())
    assert _hits(t, tq, k, torch_rank, TorchAgg()) == want
    assert any(q == "Q000002" and r == "R000100" for q, r, _ in want)
    assert j.remove(["R000001", "R000100"]) == t.remove(["R000001", "R000100"])
    assert t._searcher is staged
    want = _hits(j, jq, k, jax_rank, JaxAgg())
    got = _hits(t, tq, k, torch_rank, TorchAgg())
    assert got == want
    assert not any(r in ("R000001", "R000100") for _, r, _ in got)
    for a, b in zip(j.features(), t.features()):
        assert a.video_id == b.video_id
        np.testing.assert_array_equal(b.feature, a.feature)
        np.testing.assert_array_equal(b.timestamps, a.timestamps)
    # After the remove, results equal a fresh index over the survivors.
    fresh = TorchSNIndex(D, tn, beta=BETA, device="cpu")
    fresh.add(t.features())
    assert _hits(fresh, tq, k, torch_rank, TorchAgg()) == got
    assert torch.equal(fresh._get_searcher().searcher._refs, t._searcher.searcher._refs)
    # The localizer's feature spaces equal the JAX index's.
    for a, b in zip(j.localizer_queries(jq), t.localizer_queries(tq)):
        np.testing.assert_array_equal(b.feature, np.asarray(a.feature))
    for a, b in zip(j.localizer_ref_features(jr[:3]), t.localizer_ref_features(tr[:3])):
        np.testing.assert_array_equal(b.feature, a.feature)


def test_video_index_add_remove_and_validation():
    (jq, jr, _, jx), (tq, tr, _, tx) = _both(_corpus)
    j, t = JaxIndex(D), TorchIndex(D, device="cpu")
    for idx, refs, extra in ((j, jr, jx), (t, tr, tx)):
        idx.add(refs[:6])
    k = 500
    assert _hits(t, tq, k, torch_rank, TorchAgg()) == _hits(j, jq, k, jax_rank, JaxAgg())
    j.add(jr[6:] + jx)
    t.add(tr[6:] + tx)
    j.remove(["R000004"])
    t.remove(["R000004"])
    assert _hits(t, tq, k, torch_rank, TorchAgg()) == _hits(j, jq, k, jax_rank, JaxAgg())
    with pytest.raises(KeyError):
        t.remove(["R000004"])
    n_rows = len(t.video_clip_to_video_ids)
    bad = TVF("R000777", np.arange(3, dtype=np.float64), np.zeros((3, D + 1), np.float32))
    with pytest.raises(ValueError):
        t.add([tr[0], bad])
    assert len(t.video_clip_to_video_ids) == n_rows  # nothing half-added
    assert [v.video_id for v in t.features()] == [v.video_id for v in j.features()]


# ---- localizer lifecycle ----------------------------------------------------------


def _sn_localizer_case(vf):
    queries, refs, noise, extra = _corpus(vf)
    index = (JaxSNIndex if vf is JVF else TorchSNIndex)(
        D, noise, beta=BETA, **({} if vf is JVF else {"device": "cpu"})
    )
    index.add(refs)
    return index, queries, refs, extra


def _match_rows(matches):
    return [(m.query_id, m.ref_id, m.query_start, m.query_end, m.ref_start,
             m.ref_end, m.score) for m in matches]


def test_tn_localizer_lifecycle_identical_to_jax():
    pairs = [("Q000000", "R000001"), ("Q000001", "R000004"), ("Q000002", "R000100"),
             ("Q000003", "R000002")]
    out = {}
    for vf, maxsim, pair in ((JVF, JaxMaxSim, jm.CandidatePair),
                             (TVF, TorchMaxSim, TorchPair)):
        index, queries, refs, extra = _sn_localizer_case(vf)
        kw = {} if vf is JVF else {"device": "cpu"}
        loc = maxsim([], index.localizer_ref_features(refs), model_type="TN",
                     similarity_bias=0.5, **kw)
        index.search(queries, global_k=500)
        loc.set_queries(index.localizer_queries(queries))
        first = loc.localize_all([pair(q, r, 1.0) for q, r in pairs[:2]])
        loc.add_refs(index.localizer_ref_features(extra))
        # R000004 is staged (the table compacts around it), R000002 not.
        loc.remove_refs(["R000002", "R000004"])
        with pytest.raises(KeyError):
            loc.remove_refs(["R000002"])
        second = loc.localize_all(
            [pair(q, r, 1.0) for q, r in pairs[:3:2] + [("Q000001", "R000005")]]
        )
        out[vf] = (_match_rows(first), _match_rows(second), sorted(loc.refs))
    assert out[TVF] == out[JVF]
    assert any(r == ("Q000002", "R000100") for r in [m[:2] for m in out[TVF][1]])


def _dns_side(vf, rng, videos):
    """Fine features (9 dyadic regions of FINE_D per frame) keyed by id."""
    return {v.video_id: vf(v.video_id, v.timestamps,
                           _dyadic(rng, len(v) * 9, FINE_D).reshape(len(v), -1) * 0.5)
            for v in videos}


def _dns_case(vf):
    queries, refs, _, extra = _corpus(vf, seed=3)
    rng = np.random.RandomState(8)
    fines = [_dns_side(vf, rng, vids) for vids in (queries, refs, extra)]
    # Plant the fine copies where the coarse copies are.
    qf, rf, xf = fines
    qf["Q000000"].feature[4:14] = rf["R000001"].feature[2:12]
    qf["Q000002"].feature[3:15] = xf["R000100"].feature[8:20]
    return queries, refs, extra, qf, rf, xf


def test_dns_localizer_lifecycle_matches_jax():
    pairs = [("Q000000", "R000001"), ("Q000002", "R000100"), ("Q000001", "R000003")]
    out = {}
    for vf, cls, pair in ((JVF, jax_dns.DnSLocalization, jm.CandidatePair),
                          (TVF, torch_dns.DnSLocalization, TorchPair)):
        queries, refs, extra, qf, rf, xf = _dns_case(vf)
        kw = {} if vf is JVF else {"device": "cpu"}
        loc = cls({}, dict(rf), [], refs, model_type="TN", similarity_bias=0.5, **kw)
        loc.set_queries(queries[:2], queries_fine={k: qf[k] for k in ("Q000000", "Q000001")})
        first = loc.localize_all([pair(*pairs[0], 1.0)])
        with pytest.raises(ValueError):
            loc.add_refs(extra)
        loc.add_refs(extra, refs_fine=xf)
        loc.remove_refs(["R000003"])
        assert "R000003" not in loc.refs_fine
        loc.set_queries(queries, queries_fine=qf)
        second = loc.localize_all([pair(q, r, 1.0) for q, r in pairs[:2]])
        out[vf] = (_match_rows(first), _match_rows(second))
    for got, want in zip(out[TVF], out[JVF]):
        assert [m[:6] for m in got] == [m[:6] for m in want] and got
        np.testing.assert_allclose([m[6] for m in got], [m[6] for m in want],
                                   rtol=0, atol=1e-5)


# ---- serve_request, both packages ---------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    queries, refs, noise, extra = _corpus(JVF)
    paths = {k: str(root / f"{k}.npz") for k in ("q", "q1", "r", "n", "x")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["q1"], queries[2:3], Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    store_features(paths["x"], extra, Dataset.REFS)
    dq, dr, dx, qf, rf, xf = _dns_case(JVF)
    for name, vids, ds in (("dq", dq, Dataset.QUERIES), ("dr", dr, Dataset.REFS),
                           ("dx", dx, Dataset.REFS), ("dqf", list(qf.values()), Dataset.QUERIES),
                           ("drf", list(rf.values()), Dataset.REFS),
                           ("dxf", list(xf.values()), Dataset.REFS)):
        paths[name] = str(root / f"{name}.npz")
        store_features(paths[name], vids, ds)
    paths["root"] = root
    return paths


def _servers(argv):
    jargs = jax_serve.parser.parse_args(argv)
    targs = torch_serve.parser.parse_args(argv + ["--device", "cpu"])
    for args in (jargs, targs):  # main's rule: the DnS mode implies --matches
        args.matches = args.matches or bool(args.ref_fine_features)
    j_index, j_refs, _ = jax_serve.build_index(jargs)
    j_loc = jax_serve.build_localizer(j_index, j_refs, jargs) if jargs.matches else None
    device = torch.device("cpu")
    t_index, t_refs, _ = torch_serve.build_index(targs, device)
    t_loc = torch_serve.build_localizer(t_index, t_refs, targs, device)
    return (jargs, j_index, j_loc), (targs, t_index, t_loc)


def _strip(reply, root):
    """A reply without its seconds and with the side's paths folded."""
    fields = reply.split("\t")[:-1] if reply.split("\t")[1] != "stats" else reply.split("\t")
    return "\t".join(f.replace(str(root / "jax"), "@").replace(str(root / "torch"), "@")
                     for f in fields)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_matches_close(a, b):
    ra, rb = _read_csv(a) if isinstance(a, str) else a, _read_csv(b) if isinstance(b, str) else b
    assert ra[0] == rb[0] and len(ra) == len(rb) and len(ra) > 1
    score = ra[0].index("score")
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:score] + x[score + 1:] == y[:score] + y[score + 1:]
        assert abs(float(x[score]) - float(y[score])) <= 1e-5


def test_serve_requests_identical_to_jax_sn(served):
    root = served["root"]
    (jargs, ji, jl), (targs, ti, tl) = _servers([
        "--ref_features", served["r"], "--score_norm_features", served["n"],
        "--f32", "--matches", "--beta", str(BETA),
    ])
    for side in ("jax", "torch"):
        os.makedirs(root / side, exist_ok=True)

    def both(line_of, payloads=None):
        replies = []
        for side, args, index, loc, mod in (("jax", jargs, ji, jl, jax_serve),
                                            ("torch", targs, ti, tl, torch_serve)):
            agg = JaxAgg() if side == "jax" else TorchAgg()
            replies.append(mod.serve_request(index, agg, loc, line_of(str(root / side)),
                                             args, payloads=payloads))
        return replies

    def search(tag):
        j, t = both(lambda d: f"{served['q']}\t{d}/{tag}_c.csv\t{d}/{tag}_m.csv")
        assert _strip(t, root) == _strip(j, root)
        for suffix in ("c", "m"):
            a = (root / "jax" / f"{tag}_{suffix}.csv").read_bytes()
            b = (root / "torch" / f"{tag}_{suffix}.csv").read_bytes()
            assert b == a and b.count(b"\n") > 1, (tag, suffix)

    search("a")
    (j, jb), (t, tb) = both(lambda d: "searchb\t1", payloads=[open(served["q"], "rb").read()])
    assert tb == jb and _strip(t, root) == _strip(j, root)
    assert tb[0] == (root / "torch" / "a_c.csv").read_bytes()  # in-band ≡ path
    j, t = both(lambda d: f"add\t{served['x']}")
    assert _strip(t, root) == _strip(j, root)
    j, t = both(lambda d: "remove\tR000001\tR000003")
    assert _strip(t, root) == _strip(j, root)
    j, t = both(lambda d: f"save\t{d}/snap.npz")
    assert _strip(t, root) == _strip(j, root)
    for key in ("video_ids", "features", "timestamps"):
        with np.load(root / "jax" / "snap.npz") as a, np.load(root / "torch" / "snap.npz") as b:
            np.testing.assert_array_equal(b[key], a[key])
    search("g")
    j, t = both(lambda d: "stats")
    assert t == j
    for bad in ("remove\tR999999", "add\t" + served["r"], "probe\tx"):
        with pytest.raises(Exception):
            torch_serve.serve_request(ti, TorchAgg(), tl, bad, targs)


def test_serve_requests_match_jax_dns(served):
    root = served["root"]
    (jargs, ji, jl), (targs, ti, tl) = _servers([
        "--ref_features", served["dr"], "--ref_fine_features", served["drf"], "--f32",
    ])
    out = {}
    for side, args, index, loc, mod, agg in (
        ("jax", jargs, ji, jl, jax_serve, JaxAgg()),
        ("torch", targs, ti, tl, torch_serve, TorchAgg()),
    ):
        d = root / f"dns_{side}"
        os.makedirs(d, exist_ok=True)
        replies = [mod.serve_request(index, agg, loc, line, args) for line in (
            f"{served['dq']}\t{served['dqf']}\t{d}/c1.csv\t{d}/m1.csv",
            f"add\t{served['dx']}\t{served['dxf']}",
            "remove\tR000003",
            f"save\t{d}/snap.npz\t{d}/snap_fine.npz",
            f"{served['dq']}\t{served['dqf']}\t{d}/c2.csv\t{d}/m2.csv",
        )]
        out[side] = ([r.split("\t")[0] for r in replies], d)
    assert out["torch"][0] == out["jax"][0] == ["ok"] * 5
    jd, td = out["jax"][1], out["torch"][1]
    for tag in ("1", "2"):
        assert (td / f"c{tag}.csv").read_bytes() == (jd / f"c{tag}.csv").read_bytes()
        _assert_matches_close(str(jd / f"m{tag}.csv"), str(td / f"m{tag}.csv"))
    for name in ("snap.npz", "snap_fine.npz"):
        with np.load(jd / name) as a, np.load(td / name) as b:
            for key in ("video_ids", "features", "timestamps"):
                np.testing.assert_array_equal(b[key], a[key])


def test_unported_modes_raise(served):
    # The JAX default (bf16, no dtype flag) is ported: tests below start it.
    base = ["--ref_features", served["r"], "--device", "cpu"]
    # --ivf is ported: with --sharded it raises the JAX server's ValueError;
    # alone it stages the IVF tier with JAX's nlist and searches as JAX's
    # (tests/test_torch_ivf.py serves with it).
    with pytest.raises(ValueError, match="single-chip"):
        torch_serve.main(torch_serve.parser.parse_args(base + ["--sharded", "--ivf", "4"]))
    for flags in (["--bf16", "--ivf", "4"], ["--bf16", "--ivf", "0"]):
        targs = torch_serve.parser.parse_args(base + flags)
        jargs = jax_serve.parser.parse_args(base[:2] + flags)
        t_index = torch_serve.build_index(targs, torch.device("cpu"))[0]
        j_index = jax_serve.build_index(jargs)[0]
        assert t_index._ivf_nlist == j_index._ivf_nlist
        assert (_hits(t_index, _corpus(TVF)[0], 60, torch_rank, TorchAgg())
                == _hits(j_index, _corpus(JVF)[0], 60, jax_rank, JaxAgg()))
    # Multi-host serving is ported: its flags are checked as JAX checks them
    # (tests/test_torch_multihost.py runs the pods).
    with pytest.raises(ValueError, match="requires --coordinator"):
        torch_serve.main(torch_serve.parser.parse_args(base + ["--f32", "--num_processes", "2"]))
    # --baseline is ported: without weights it raises the JAX server's
    # ValueError, as do weights without --baseline.
    for extra, message in ((["--baseline", "sscd"], "needs weights"),
                           (["--checkpoint_path", "w.npz"], "need --baseline")):
        with pytest.raises(ValueError, match=message):
            torch_serve.main(torch_serve.parser.parse_args(base + extra))
        with pytest.raises(ValueError, match=message):
            jax_serve.build_extractor(jax_serve.parser.parse_args(base[:2] + extra))
    # --int8 is ported: it stages SQ8 codes with bf16 localizer tables, as
    # the JAX server picks them (tests/test_torch_int8.py runs it).
    args = torch_serve.parser.parse_args(base + ["--int8"])
    assert torch_serve.staging_dtype(args) == "int8"
    assert torch_serve.table_dtype(args) == "bfloat16"


# ---- failure consistency (tests/test_serve.py Test*FailureConsistency) --------------


def _sn_holders():
    index, queries, refs, extra = _sn_localizer_case(TVF)
    loc = TorchMaxSim([], index.localizer_ref_features(refs), model_type="TN",
                      similarity_bias=0.5, device="cpu")
    index.search(queries, global_k=300)  # stage
    loc.set_queries(index.localizer_queries(queries))
    loc.localize_all([TorchPair("Q000000", "R000001", 1.0)])  # stage the ref table
    args = argparse.Namespace(ref_fine_features=None, score_norm_features="noise.npz")
    return index, loc, queries, extra, args


def _boom(*a, **k):
    raise RuntimeError("simulated device failure")


def test_remove_failure_keeps_holders_consistent(monkeypatch):
    index, loc, queries, _, _ = _sn_holders()
    monkeypatch.setattr(index._searcher, "keep_refs", _boom)
    with pytest.raises(RuntimeError, match="simulated"):
        torch_serve._remove_refs(index, loc, ["remove", "R000001"])
    assert "R000001" not in index.video_metadata and "R000001" not in loc.refs
    assert index._searcher is None
    assert not any(pm.ref_id == "R000001" for pm in index.search(queries, global_k=300))
    with pytest.raises(ValueError, match="not indexed"):
        torch_serve._remove_refs(index, loc, ["remove", "R000001"])


@pytest.mark.parametrize("where", ["index", "localizer"])
def test_add_failure_keeps_holders_consistent(monkeypatch, tmp_path, where):
    index, loc, queries, extra, args = _sn_holders()
    path = str(tmp_path / "extra.npz")
    store_features(path, [JVF(v.video_id, v.timestamps, v.feature) for v in extra],
                   Dataset.REFS)
    if where == "index":
        monkeypatch.setattr(index._searcher, "append_refs", _boom)
    else:
        monkeypatch.setattr(loc, "_grow_table", _boom)
    with pytest.raises(RuntimeError, match="simulated"):
        torch_serve._add_refs(index, loc, ["add", path], args)
    if where == "index":
        assert index._searcher is None
    else:
        assert "ref" not in loc._tables  # staged table dropped
    monkeypatch.undo()
    for vid in ("R000100", "R000101"):
        assert vid in index.video_metadata and vid in loc.refs
    got = index.search(queries, global_k=300)
    assert any(pm.ref_id == "R000100" for pm in got)
    loc.set_queries(index.localizer_queries(queries))
    found = loc.localize_all([TorchPair("Q000002", "R000100", 1.0)])
    assert any(m.ref_id == "R000100" for m in found)
    torch_serve._remove_refs(index, loc, ["remove", "R000100"])
    assert "R000100" not in index.video_metadata and "R000100" not in loc.refs


@pytest.mark.parametrize("side", ["fine", "coarse"])
def test_dns_add_failure_drops_the_right_tables(monkeypatch, side):
    queries, refs, extra, qf, rf, xf = _dns_case(TVF)
    loc = torch_dns.DnSLocalization({}, dict(rf), [], refs, model_type="TN",
                                    similarity_bias=0.5, device="cpu")
    loc.set_queries(queries, queries_fine=qf)
    loc.localize_all([TorchPair("Q000000", "R000001", 1.0)])
    assert "ref" in loc._tables and "ref_fine" in loc._tables
    real = loc._grow_table

    def grow(name, *a, **k):
        if (name == "ref_fine") == (side == "fine"):
            _boom()
        return real(name, *a, **k)

    monkeypatch.setattr(loc, "_grow_table", grow)
    with pytest.raises(RuntimeError, match="simulated"):
        loc.add_refs(extra, refs_fine=xf)
    assert "ref_fine" not in loc._tables
    assert ("ref" in loc._tables) == (side == "fine")
    assert "R000100" in loc.refs and "R000100" in loc.refs_fine
    monkeypatch.undo()
    found = loc.localize_all([TorchPair("Q000002", "R000100", 1.0)])
    assert any(m.ref_id == "R000100" for m in found)


def test_save_failure_leaves_state_unmutated(monkeypatch, tmp_path):
    index, _, _, _, _ = _sn_holders()

    class FineLoc:
        refs_fine = {vf.video_id: vf for vf in index.features()}

    args = argparse.Namespace(ref_fine_features="fine.npz", score_norm_features=None)
    coarse, fine = str(tmp_path / "c.npz"), str(tmp_path / "f.npz")
    before = [v.video_id for v in index.features()]
    real = torch_serve.store_features

    def fail_fine(path, feats, *a, **k):
        if path == fine:
            raise OSError("simulated disk failure")
        return real(path, feats, *a, **k)

    monkeypatch.setattr(torch_serve, "store_features", fail_fine)
    with pytest.raises(OSError, match="simulated"):
        torch_serve._save_refs(index, FineLoc(), ["save", coarse, fine], args)
    assert [v.video_id for v in index.features()] == before
    assert os.path.exists(coarse)
    monkeypatch.undo()
    reply = torch_serve._save_refs(index, FineLoc(), ["save", coarse, fine], args)
    assert reply.startswith("ok\tsaved") and os.path.exists(fine)


# ---- the port's server as a subprocess ----------------------------------------------


def test_server_subprocess_stdin_and_tcp(served, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    common = dict(score_norm_features=served["n"], matches=True, f32=True,
                  device="cpu", extra_args=["--beta", str(BETA)], env=env,
                  cwd=str(tmp_path), stderr=subprocess.DEVNULL)
    query_bytes = open(served["q"], "rb").read()
    with ServeClient.spawn(served["r"], **common) as client:
        assert client.n_ref_videos == 10
        res = client.search(served["q"], candidates_csv=str(tmp_path / "c.csv"),
                            matches_csv=str(tmp_path / "m.csv"))
        inband = client.search_bytes(query_bytes)
        assert inband.candidates_csv == open(res.candidates_csv, "rb").read()
        assert inband.matches_csv == open(res.matches_csv, "rb").read()
        assert res.n_candidates == inband.n_candidates > 0
        with pytest.raises(ServeError, match="not indexed"):
            client.remove(["R999999"])
        assert client.stats().n_videos == 10  # still serving
        # On the CPU the wrappers run the plain versions: no launches.
        assert set(client.launches().values()) == {0}
    proc = subprocess.Popen(
        [sys.executable, "-m", "vsc2022_torch.retrieval.serve", "--ref_features",
         served["r"], "--score_norm_features", served["n"], "--f32", "--matches",
         "--beta", str(BETA), "--device", "cpu", "--listen", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, cwd=str(tmp_path),
    )
    try:
        assert proc.stdout.readline().decode().startswith("ready\t10\t")
        host, port = proc.stdout.readline().decode().strip().split("\t")[1].rsplit(":", 1)
        with ServeClient.connect(host, int(port), timeout=60) as client:
            tcp = client.search_bytes(query_bytes)
            assert tcp.candidates_csv == inband.candidates_csv
            assert tcp.matches_csv == inband.matches_csv
            client.close(shutdown=True)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---- the typed in-band client API (tests/test_serve.py, the in-band cases) ----------
# The port's server on the JAX package's default flags (bf16), driven by the
# port's client and, over TCP, by the JAX package's client too.


def _ckey(c):
    return (c.query_id, c.ref_id, c.score)


def _mkey(m):
    return (m.query_id, m.ref_id, m.query_start, m.query_end, m.ref_start,
            m.ref_end, m.score)


def _listen(argv, cwd):
    """A port server on a free TCP port: (process, host, port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "vsc2022_torch.retrieval.serve", *argv,
         "--device", "cpu", "--listen", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=cwd,
    )
    assert proc.stdout.readline().decode().startswith("ready\t")
    host, port = proc.stdout.readline().decode().strip().split("\t")[1].rsplit(":", 1)
    return proc, host, int(port)


def test_inband_equals_paths_over_stdio(served, tmp_path):
    from vsc2022_torch.storage import load_features as torch_load

    queries, refs, _, extra = _corpus(TVF)
    with ServeClient.spawn(served["r"], score_norm_features=served["n"], matches=True,
                           device="cpu", env=dict(os.environ, PYTHONPATH=REPO),
                           cwd=str(tmp_path), stderr=subprocess.DEVNULL) as client:
        assert client.stats().dtype == "bfloat16"  # no dtype flag: the bf16 default
        by_path = client.search(served["q"], candidates_csv=str(tmp_path / "c.csv"),
                                matches_csv=str(tmp_path / "m.csv"))
        inband = client.search_features(queries)
        assert list(map(_ckey, inband.candidates)) == list(map(_ckey, by_path.candidates()))
        assert list(map(_mkey, inband.matches)) == list(map(_mkey, by_path.matches()))
        assert len(inband.candidates) >= 1
        # In-band add grows the corpus like the path form; the planted copy
        # in the added ref then localizes.
        assert client.add_features(extra) == len(extra)
        post = client.search_features(queries)
        assert any(m.query_id == "Q000002" and m.ref_id == "R000100" for m in post.matches)
        # Duplicate ids travel as a typed error and the session keeps serving.
        with pytest.raises(ServeError, match="already indexed"):
            client.add_features(extra)
        client.remove([vf.video_id for vf in extra])
        # The in-band snapshot equals the on-disk save.
        snap_refs, snap_fine = client.snapshot()
        assert snap_fine is None
        client.save(str(tmp_path / "snap.npz"))
        disk = torch_load(str(tmp_path / "snap.npz"), Dataset.REFS)
        assert [vf.video_id for vf in snap_refs] == [vf.video_id for vf in disk]
        for a, b in zip(snap_refs, disk):
            np.testing.assert_array_equal(a.feature, b.feature)
            np.testing.assert_array_equal(a.timestamps, b.timestamps)
        # Malformed payload lengths answer an error; nothing was consumed.
        client._write_line("searchb\tnotanumber")
        client._wfile.flush()
        assert client._read_line().startswith("error")
        assert client.stats().n_videos == len(refs)
    with pytest.raises(ValueError, match="matches"):
        type(by_path)(by_path.candidates_csv, 1, None, None, 0.0).matches()


def test_inband_over_tcp_needs_no_shared_paths(served, tmp_path):
    from vsc2022_tpu.retrieval.client import ServeClient as JaxClient

    queries, refs, _, extra = _corpus(TVF)
    j_queries, _, _, j_extra = _corpus(JVF)
    proc, host, port = _listen(["--ref_features", served["r"], "--score_norm_features",
                                served["n"], "--matches"], str(tmp_path))
    try:
        with JaxClient.connect(host, port) as c1:  # the JAX package's client
            r1 = c1.search_features(j_queries)
            assert len(r1.candidates) >= 1 and r1.matches
            assert c1.add_features(j_extra) == len(extra)
            snap_refs, _ = c1.snapshot()
            assert len(snap_refs) == len(refs) + len(extra)
            assert c1.stats().dtype == "bfloat16"
        with ServeClient.connect(host, port) as c2:  # the port's client
            r2 = c2.search_features(queries)
            assert any(m.query_id == "Q000002" and m.ref_id == "R000100"
                       for m in r2.matches)
            c2.remove([vf.video_id for vf in extra])
            r3 = c2.search_features(queries)
            assert list(map(_ckey, r3.candidates)) == list(map(_ckey, r1.candidates))
            assert list(map(_mkey, r3.matches)) == list(map(_mkey, r1.matches))
            c2.close(shutdown=True)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_inband_dns_two_payloads(served, tmp_path):
    from vsc2022_tpu.retrieval.client import ServeClient as JaxClient

    dq, _, _, qf, _, _ = _dns_case(TVF)
    j_dq, _, _, j_qf, _, _ = _dns_case(JVF)
    proc, host, port = _listen(["--ref_features", served["dr"], "--ref_fine_features",
                                served["drf"]], str(tmp_path))
    try:
        with JaxClient.connect(host, port) as c1:
            want = c1.search_features(j_dq, queries_fine=j_qf)
        with ServeClient.connect(host, port) as c2:
            res = c2.search_features(dq, queries_fine=qf)  # a dict, as JAX takes it
            assert res.matches is not None
            assert any(m.query_id == "Q000000" and m.ref_id == "R000001"
                       for m in res.matches)
            assert list(map(_ckey, res.candidates)) == list(map(_ckey, want.candidates))
            assert list(map(_mkey, res.matches)) == list(map(_mkey, want.matches))
            # A single-payload searchb against a DnS server is an error.
            with pytest.raises(ServeError, match="searchb"):
                c2.search_features(dq)
            # The snapshot returns both sides in-band.
            snap_refs, snap_fine = c2.snapshot()
            assert snap_fine is not None
            assert [v.video_id for v in snap_refs] == [v.video_id for v in snap_fine]
            c2.close(shutdown=True)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---- resident extraction: extract / searchv ----------------------------------------


class _FixedExtractor:
    """Stands in for a resident model: the descriptors of each video of a
    directory, by file name (the same rows on both packages' sides)."""

    def __init__(self, vf, features):
        self._vf, self._features = vf, features

    def extract(self, dataset):
        for _, path in dataset.selected_videos:
            f = self._features[os.path.basename(path).split(".")[0]]
            yield self._vf(f.video_id, np.stack([f.timestamps, f.timestamps + 1], 1),
                           f.feature)


def test_extract_and_searchv_replies_match_jax(served):
    root = served["root"]
    queries = _corpus(JVF)[0]
    videos = root / "query_videos"
    videos.mkdir(exist_ok=True)
    for q in queries:
        (videos / f"{q.video_id}.mp4").write_bytes(b"x")
    by_name = {q.video_id: q for q in queries}
    (jargs, ji, jl), (targs, ti, tl) = _servers([
        "--ref_features", served["r"], "--score_norm_features", served["n"],
        "--f32", "--matches", "--beta", str(BETA),
    ])
    replies = {}
    for side, args, index, loc, mod, agg, vf in (
        ("jax", jargs, ji, jl, jax_serve, JaxAgg(), JVF),
        ("torch", targs, ti, tl, torch_serve, TorchAgg(), TVF),
    ):
        d = root / f"extract_{side}"
        os.makedirs(d, exist_ok=True)
        bundle = (_FixedExtractor(vf, by_name), None)
        replies[side] = [mod.serve_request(index, agg, loc, line, args, extractor=bundle)
                         for line in (f"extract\t{videos}\t{d}/x.npz",
                                      f"searchv\t{videos}\t{d}/v_c.csv\t{d}/v_m.csv",
                                      f"{d}/x.npz\t{d}/s_c.csv\t{d}/s_m.csv")]
        for bad, message in ((f"searchv\t{root}/missing", "Not a video directory"),
                             ("extract\tonly_one_field", "extract needs")):
            with pytest.raises(ValueError, match=message):
                mod.serve_request(index, agg, loc, bad, args, extractor=bundle)
        with pytest.raises(ValueError, match="No resident model"):
            mod.serve_request(index, agg, loc, f"searchv\t{videos}", args)
    for j, t in zip(replies["jax"], replies["torch"]):
        assert _strip(t, root).replace("extract_torch", "extract_jax") == _strip(j, root)
    assert replies["torch"][0].split("\t")[1:4] == ["extracted", "4", str(sum(
        len(q) for q in queries))]
    jd, td = root / "extract_jax", root / "extract_torch"
    with np.load(jd / "x.npz") as a, np.load(td / "x.npz") as b:
        for key in ("video_ids", "features", "timestamps"):
            np.testing.assert_array_equal(b[key], a[key])
    for name in ("v_c.csv", "v_m.csv"):
        assert (td / name).read_bytes() == (jd / name).read_bytes()
        # searchv ≡ extract, then a path search of its npz.
        assert (td / name).read_bytes() == (td / name.replace("v_", "s_")).read_bytes()
    assert (td / "v_m.csv").read_bytes().count(b"\n") > 1


def test_searchv_refuses_dns_as_jax(served):
    (jargs, ji, jl), (targs, ti, tl) = _servers([
        "--ref_features", served["dr"], "--ref_fine_features", served["drf"], "--f32",
    ])
    for mod, index, loc, args, agg in ((jax_serve, ji, jl, jargs, JaxAgg()),
                                       (torch_serve, ti, tl, targs, TorchAgg())):
        with pytest.raises(ValueError, match="does not serve the DnS track"):
            mod.serve_request(index, agg, loc, f"searchv\t{served['root']}", args,
                              extractor=(None, None))


@pytest.fixture(scope="module")
def video_rig(tmp_path_factory):
    """Stub ffmpeg, a reference and a query video directory (query
    Q000001 copies frames 1-3 of R000002), a TorchScript SSCD written by
    the port (seeded weights) and the port CLI's npz of both directories,
    each CLI run a subprocess as the server is."""
    from torch_video_stub import write_tools, write_video

    from vsc2022_torch.models.init import init_flax_like
    from vsc2022_torch.models.sscd import SSCDModel

    tmp = tmp_path_factory.mktemp("videos")
    ffmpeg = write_tools(tmp / "tools")
    refs, queries = tmp / "refs", tmp / "queries"
    refs.mkdir()
    queries.mkdir()
    for i, n in enumerate((4, 3, 5)):
        write_video(refs / f"R{i:06d}.mp4", [(20 + i, j) for j in range(n)])
    write_video(queries / "Q000000.mp4", [(40, j) for j in range(3)])
    write_video(queries / "Q000001.mp4", [(41, 0)] + [(22, j) for j in (1, 2, 3)])
    model = SSCDModel()
    init_flax_like(model, torch.Generator().manual_seed(4))
    weights = str(tmp / "sscd.pt")
    torch.jit.save(torch.jit.trace(model.eval(), torch.zeros(1, 3, 64, 64)), weights)
    rng = np.random.RandomState(5)
    noise = [JVF(f"R{900 + i:06d}", np.arange(6, dtype=np.float64),
                 rng.randn(6, 512).astype(np.float32)) for i in range(3)]
    store_features(str(tmp / "noise.npz"), noise, Dataset.REFS)
    flags = ["--baseline", "sscd", "--torchscript_path", weights, "--device", "cpu",
             "--ffmpeg_path", ffmpeg]
    env = dict(os.environ, PYTHONPATH=REPO)
    for name, directory in (("r", refs), ("q", queries)):
        r = subprocess.run(
            [sys.executable, "-m", "vsc2022_torch.inference.cli", *flags,
             "--transforms", "RESIZE_224_SQUARE", "--batch_size", "4",
             "--dataset_path", str(directory), "--output_file", str(tmp / f"{name}.npz")],
            capture_output=True, text=True, timeout=600, env=env)
        assert r.returncode == 0, r.stderr[-2000:]
    return tmp, flags, env


def test_extract_and_searchv_over_stdio(video_rig, tmp_path):
    # The port's server with a resident SSCD: extract writes the CLI's npz
    # byte for byte, searchv answers as a path search of that npz.
    tmp, flags, env = video_rig
    extra = flags[:4] + flags[6:] + ["--extract_transforms", "RESIZE_224_SQUARE",
                                     "--extract_batch_size", "4"]
    with ServeClient.spawn(str(tmp / "r.npz"), score_norm_features=str(tmp / "noise.npz"),
                           matches=True, f32=True, device="cpu", extra_args=extra,
                           env=env, cwd=str(tmp_path), stderr=subprocess.DEVNULL) as client:
        assert client.extract(str(tmp / "queries"), str(tmp_path / "x.npz")) == (2, 7)
        with np.load(tmp_path / "x.npz") as a, np.load(tmp / "q.npz") as b:
            assert list(a["video_ids"]) == ["Q000000"] * 3 + ["Q000001"] * 4
            for key in ("video_ids", "features", "timestamps"):
                np.testing.assert_array_equal(a[key], b[key])
        path = client.search(str(tmp / "q.npz"), candidates_csv=str(tmp_path / "c.csv"),
                             matches_csv=str(tmp_path / "m.csv"))
        video = client.search_videos(str(tmp / "queries"),
                                     candidates_csv=str(tmp_path / "vc.csv"),
                                     matches_csv=str(tmp_path / "vm.csv"))
        assert (video.n_candidates, video.n_matches) == (path.n_candidates, path.n_matches)
        for a, b in (("c.csv", "vc.csv"), ("m.csv", "vm.csv")):
            assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
        assert ("Q000001", "R000002") in {(c.query_id, c.ref_id) for c in video.candidates()}
        with pytest.raises(ServeError, match="Not a video directory"):
            client.search_videos(str(tmp_path / "missing"))
        default = client.search_videos(str(tmp / "queries"))
        assert default.candidates_csv == str(tmp / "queries") + ".candidates.csv"
        assert client.stats().n_videos == 3  # still serving
