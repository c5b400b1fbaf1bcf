"""Serving's ``probe`` on the port, and the localizers' per-candidate
``similarity``, against the JAX package.

``probe\\t<query_npz>`` answers ``ok\\tprobe\\t<search_s>\\t<tn_s>`` as the
JAX server does; on the CPU both figures are host-clock times around the
plain versions. Its errors are the JAX server's, typed on the client,
and the session goes on serving after each. The TN figure replays the
geometries of the most recent request's alignment batches
(``last_align_geoms``), which must be the JAX localizer's on the same
request.
"""

import io
import os
import subprocess

import numpy as np
import pytest
import torch

from test_torch_serve import BETA, REPO, _corpus, _servers
from vsc2022_torch.localization import TNLocalizationMaxSim as TorchMaxSim
from vsc2022_torch.localization.localize import LocalizationWithMetadata as TorchLWM
from vsc2022_torch.metrics import CandidatePair as TorchPair
from vsc2022_torch.ops import kernels
from vsc2022_torch.retrieval import serve as torch_serve
from vsc2022_torch.retrieval.candidates import MaxScoreAggregation as TorchAgg
from vsc2022_torch.retrieval.client import ServeClient, ServeError
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu.localization import TNLocalizationMaxSim as JaxMaxSim
from vsc2022_tpu.localization.localize import LocalizationWithMetadata as JaxLWM
from vsc2022_tpu.metrics import CandidatePair as JaxPair
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.retrieval import serve as jax_serve
from vsc2022_tpu.retrieval.candidates import MaxScoreAggregation as JaxAgg
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature as JVF


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe")
    queries, refs, noise, _ = _corpus(JVF)
    paths = {k: str(root / f"{k}.npz") for k in ("q", "r", "n")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    paths["root"] = root
    return paths


def _sn_argv(p, *flags):
    return ["--ref_features", p["r"], "--score_norm_features", p["n"], "--beta", str(BETA),
            "--matches", *flags]


def test_probe_replays_the_last_requests_geometries_as_jax(probed):
    root = probed["root"]
    (jargs, ji, jl), (targs, ti, tl) = _servers(_sn_argv(probed, "--f32"))
    for side, args, index, loc, mod, agg in (
            ("jax", jargs, ji, jl, jax_serve, JaxAgg()),
            ("torch", targs, ti, tl, torch_serve, TorchAgg())):
        os.makedirs(root / side, exist_ok=True)
        mod.serve_request(index, agg, loc, f"{probed['q']}\t{root / side}/c.csv"
                          f"\t{root / side}/m.csv", args)
    assert tl.last_align_geoms == jl.last_align_geoms
    assert len(tl.last_align_geoms) >= 1
    assert all(b >= 1 and nq >= 32 and nr >= 32 for b, nq, nr in tl.last_align_geoms)

    kernels.reset_launches()
    reply = torch_serve.serve_request(ti, TorchAgg(), tl, f"probe\t{probed['q']}", targs)
    tag, name, search_s, tn_s = reply.split("\t")
    assert (tag, name) == ("ok", "probe")
    assert float(search_s) > 0 and float(tn_s) > 0
    assert len(search_s.split(".")[1]) == len(tn_s.split(".")[1]) == 6
    # On the CPU the wrappers run their plain versions: nothing launches.
    assert set(kernels.launches.values()) == {0}
    # The probe's searches leave the request's localizer queries as they were.
    again = torch_serve.serve_request(ti, TorchAgg(), tl, f"probe\t{probed['q']}", targs)
    assert again.startswith("ok\tprobe\t")


def test_probe_times_every_wrapper_call_of_a_search(probed):
    # LaunchTimer sees each kernel wrapper call of the SN search once (the
    # bias's row_max, the collection, count_above), not their nested calls.
    targs = torch_serve.parser.parse_args(_sn_argv(probed, "--f32", "--device", "cpu"))
    ti = torch_serve.build_index(targs, torch.device("cpu"))[0]
    sn = ti._get_searcher()
    qmat = ti._prep_query_features(np.concatenate(
        [q.feature for q in _corpus(TVF)[0]]))
    with kernels.LaunchTimer() as timer:
        sn.global_topk(qmat, 1200 * 4)
    assert timer.calls >= 3
    assert timer.seconds() > 0
    with pytest.raises(RuntimeError, match="already active"):
        with kernels.LaunchTimer(), kernels.LaunchTimer():
            pass
    assert kernels.median_launch_seconds(lambda: sn.global_topk(qmat, 100)) > 0


def _session(index, loc, args, lines):
    """The server's request loop over ``lines``: its replies."""
    rfile = io.BytesIO("".join(line + "\n" for line in lines).encode())
    wfile = io.BytesIO()
    torch_serve._serve_stream(index, TorchAgg(), loc, args, rfile, wfile)
    return wfile.getvalue().decode().splitlines()


@pytest.mark.parametrize("flags,error", [
    ([], "probe needs a query npz"),
    (["--no_sn"], "probe needs a score-normalized index"),
    (["--sharded"], "compute probe supports unsharded corpora only"),
    (["--ivf", "2"], "compute probe supports unsharded corpora only"),
])
def test_probe_errors_are_jax_and_the_session_goes_on(probed, flags, error):
    if flags == ["--no_sn"]:
        argv = ["--ref_features", probed["r"], "--f32"]
    else:
        argv = _sn_argv(probed, "--f32", *flags)
    targs = torch_serve.parser.parse_args(argv + ["--device", "cpu"])
    device = torch.device("cpu")
    index, refs, _ = torch_serve.build_index(targs, device)
    loc = (torch_serve.build_localizer(index, refs, targs, device) if targs.matches
           else None)
    bad = "probe" if not flags else f"probe\t{probed['q']}"
    replies = _session(index, loc, targs, [bad, "stats", "quit"])
    assert replies[0].startswith("error\t") and error in replies[0]
    assert replies[1].startswith("ok\tstats\t10\t")
    # The JAX server answers the same request with the same message.
    if flags in ([], ["--no_sn"]):
        jargs = jax_serve.parser.parse_args(argv)
        j_index = jax_serve.build_index(jargs)[0]
        with pytest.raises(ValueError, match=error):
            jax_serve.serve_request(j_index, JaxAgg(), None, bad, jargs)


def test_client_probe_over_stdio(probed, tmp_path):
    with ServeClient.spawn(probed["r"], score_norm_features=probed["n"], matches=True,
                           f32=True, device="cpu", extra_args=["--beta", str(BETA)],
                           env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path),
                           stderr=subprocess.DEVNULL) as client:
        client.search(probed["q"], candidates_csv=str(tmp_path / "c.csv"),
                      matches_csv=str(tmp_path / "m.csv"))
        search_s, tn_s = client.probe(probed["q"])
        assert search_s > 0 and tn_s > 0
        with pytest.raises(ServeError, match="No such file|not found|Errno"):
            client.probe(str(tmp_path / "missing.npz"))
        assert client.stats().n_videos == 10  # still serving


# ---- the localizers' per-candidate similarity ---------------------------------------


def test_similarity_equals_jax():
    rng = np.random.RandomState(9)
    feats = {name: rng.randn(n, 24).astype(np.float32)
             for name, n in (("Q000000", 17), ("Q000001", 9), ("R000000", 30),
                             ("R000001", 12))}

    def videos(vf, prefix):
        return [vf(k, np.arange(len(v), dtype=np.float64), v) for k, v in feats.items()
                if k.startswith(prefix)]

    class JaxPlain(JaxLWM):
        def localize(self, candidate):
            return []

    class TorchPlain(TorchLWM):
        def localize(self, candidate):
            return []

    jq, jr = videos(JVF, "Q"), videos(JVF, "R")
    tq, tr = videos(TVF, "Q"), videos(TVF, "R")
    jax_plain, torch_plain = JaxPlain(jq, jr), TorchPlain(tq, tr)
    jax_tn = JaxMaxSim(jq, jr, model_type="TN", similarity_bias=0.5)
    torch_tn = TorchMaxSim(tq, tr, model_type="TN", similarity_bias=0.5, device="cpu")
    for q in ("Q000000", "Q000001"):
        for r in ("R000000", "R000001"):
            want = jax_plain.similarity(JaxPair(q, r, 1.0))
            got = torch_plain.similarity(TorchPair(q, r, 1.0))
            assert got.shape == (len(feats[q]), len(feats[r]))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(torch_tn.similarity(TorchPair(q, r, 1.0)),
                                       np.asarray(jax_tn.similarity(JaxPair(q, r, 1.0))),
                                       rtol=0, atol=1e-6)
