"""The rest of the port's corpus sharding on one process: row-sharded
localizer tables (``RowShardedTable``), the TN and DnS localizers on a
mesh, ``serve --sharded`` and the client's ``sharded``, ``descriptor_eval
--sharded`` and data-parallel extraction (``DescriptorExtractor(mesh=)``).

The meshes repeat the CPU (``Mesh(["cpu"] * n)``), as the JAX tests' 8
virtual devices do (``corpus_mesh(8)``, tests/conftest.py). The corpora
are dyadic (tests/test_torch_serve.py): every similarity is exact, so the
sharded localizers must give the unsharded localizer's rows bit for bit,
and JAX's sharded localizers' rows (DnS scores, through the chamfer's
division and a square root, within 1e-5, as tests/test_torch_serve.py
holds them); server replies and CSVs must be byte-identical to the
unsharded server's.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

import vsc2022_torch.parallel as torch_parallel
from vsc2022_torch import descriptor_eval as torch_descriptor_eval
from vsc2022_torch.baseline import dns_baseline as torch_dns
from vsc2022_torch.inference.pipeline import DescriptorExtractor
from vsc2022_torch.inference.transforms import InferenceTransforms
from vsc2022_torch.localization import TNLocalizationMaxSim as TorchMaxSim
from vsc2022_torch.localization.localize import RowShardedTable, gather_rows
from vsc2022_torch.metrics import CandidatePair as TorchPair
from vsc2022_torch.parallel import Mesh
from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher
from vsc2022_torch.retrieval import serve as torch_serve
from vsc2022_torch.retrieval.candidates import MaxScoreAggregation as TorchAgg
from vsc2022_torch.retrieval.client import ServeClient
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex as TorchSNIndex
from vsc2022_torch.retrieval.index import VideoIndex as TorchIndex
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu import metrics as jm
from vsc2022_tpu.baseline import dns_baseline as jax_dns
from vsc2022_tpu.inference import pipeline as jax_pipeline
from vsc2022_tpu.inference.transforms import InferenceTransforms as JaxTransforms
from vsc2022_tpu.localization import TNLocalizationMaxSim as JaxMaxSim
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.parallel import corpus_mesh as jax_corpus_mesh
from vsc2022_tpu.retrieval.index import VideoIndex as JaxIndex
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature as JVF

D = 12
FINE_D = 8


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
    """(queries, refs, noise, extra refs) with planted copies."""
    rng = np.random.RandomState(seed)
    refs = _videos(vf, rng, "R", rng.randint(16, 40, size=10))
    noise = _videos(vf, rng, "R", [20] * 5, offset=500)
    queries = _videos(vf, rng, "Q", [24, 30, 20, 26])
    extra = _videos(vf, rng, "R", [28, 18], offset=100)
    queries[0].feature[4:14] = refs[1].feature[2:12]
    queries[1].feature[10:22] = refs[4].feature[0:12]
    queries[2].feature[3:15] = extra[0].feature[8:20]
    return queries, refs, noise, extra


def _rows(matches):
    return [(m.query_id, m.ref_id, m.query_start, m.query_end, m.ref_start,
             m.ref_end, m.score) for m in matches]


# ---- RowShardedTable ----------------------------------------------------------------


@pytest.mark.parametrize("n_dev,rows", [(1, 7), (3, 10), (4, 1), (8, 37)])
def test_row_sharded_table_is_the_plain_table(n_dev, rows):
    mesh = Mesh(["cpu"] * n_dev)
    rng = np.random.RandomState(rows)
    full = torch.from_numpy(rng.randn(rows, 5).astype(np.float32))
    table = RowShardedTable.of(mesh, full, torch.bfloat16)
    assert table.shape == (rows, 5) and table.shard_rows == -(-rows // n_dev)
    assert all(t.untyped_storage().data_ptr() == table.shards[0].untyped_storage().data_ptr()
               for t in table.shards)  # one device: views into one tensor
    plain = full.to(torch.bfloat16)
    idx = rng.randint(0, rows, size=(3, 6))
    assert torch.equal(gather_rows(table, idx), gather_rows(plain, idx))
    new = torch.from_numpy(rng.randn(2 * rows + 3, 5).astype(np.float32))
    grown = table.append(new)
    fresh = RowShardedTable.of(mesh, torch.cat([full, new]), torch.bfloat16)
    assert grown.shard_rows == fresh.shard_rows
    assert all(torch.equal(a, b) for a, b in zip(grown.shards, fresh.shards))
    keep = np.sort(rng.choice(grown.rows, grown.rows // 2 + 1, replace=False))
    taken = grown.take(keep)
    kept = RowShardedTable.of(mesh, torch.cat([full, new])[keep], torch.bfloat16)
    assert taken.rows == keep.size
    assert all(torch.equal(a, b) for a, b in zip(taken.shards, kept.shards))


# ---- TN localization on a mesh ---------------------------------------------------------


def _sn_case(vf, **mesh_kw):
    queries, refs, noise, extra = _corpus(vf)
    kw = mesh_kw if vf is JVF else dict(mesh_kw, device="cpu")
    index = (jax_index_cls() if vf is JVF else TorchSNIndex)(D, noise, beta=1.25, **kw)
    index.add(refs)
    return index, queries, refs, extra


def jax_index_cls():
    from vsc2022_tpu.retrieval.index import ScoreNormalizedVideoIndex

    return ScoreNormalizedVideoIndex


def _tn_lifecycle(vf, maxsim, pair, **mesh_kw):
    pairs = [("Q000000", "R000001"), ("Q000001", "R000004"), ("Q000002", "R000100"),
             ("Q000003", "R000002")]
    index, queries, refs, extra = _sn_case(vf, mesh=mesh_kw.get("mesh"))
    kw = {} if vf is JVF else {"device": "cpu"}
    loc = maxsim([], index.localizer_ref_features(refs), model_type="TN",
                 similarity_bias=0.5, **kw, **mesh_kw)
    index.search(queries, global_k=500)
    loc.set_queries(index.localizer_queries(queries))
    first = loc.localize_all([pair(q, r, 1.0) for q, r in pairs[:2]])
    loc.add_refs(index.localizer_ref_features(extra))
    loc.remove_refs(["R000002", "R000004"])
    second = loc.localize_all(
        [pair(q, r, 1.0) for q, r in pairs[:3:2] + [("Q000001", "R000005")]])
    return _rows(first), _rows(second), sorted(loc.refs)


def test_tn_localizer_on_a_mesh_identical():
    # The sharded index and localizer (tables row-sharded over four
    # shards, pairs split over them) through add and remove, against the
    # unsharded port and JAX's localizer with shard_ref_table.
    want = _tn_lifecycle(TVF, TorchMaxSim, TorchPair)
    mesh = Mesh(["cpu"] * 4)
    for kw in ({"mesh": mesh}, {"mesh": mesh, "shard_ref_table": True}):
        assert _tn_lifecycle(TVF, TorchMaxSim, TorchPair, **kw) == want
    jax_rows = _tn_lifecycle(JVF, JaxMaxSim, jm.CandidatePair, mesh=jax_corpus_mesh(8),
                             shard_ref_table=True)
    assert jax_rows == want
    assert any(r[:2] == ("Q000002", "R000100") for r in want[1])


def test_tn_alignment_over_a_mesh_matches_jax():
    # tests/test_sharded_search.py TestMeshShardedLocalization: five pairs
    # (an odd count) split over eight entries.
    rng = np.random.RandomState(12)
    out = {}
    for vf, cls, pair, kw in ((JVF, JaxMaxSim, jm.CandidatePair,
                               {"mesh": jax_corpus_mesh(8)}),
                              (TVF, TorchMaxSim, TorchPair,
                               {"mesh": Mesh(["cpu"] * 8), "device": "cpu"})):
        rng = np.random.RandomState(12)
        refs, queries, cands = [], [], []
        for i in range(5):
            r, q = _dyadic(rng, 40), _dyadic(rng, 30)
            q[10:20] = r[5:15]
            refs.append(vf(f"R{i:06d}", np.arange(40.0), r))
            queries.append(vf(f"Q{i:06d}", np.arange(30.0), q))
            cands.append(pair(f"Q{i:06d}", f"R{i:06d}", 1.0))
        loc = cls(queries, refs, "TN", **kw)
        out[vf] = sorted(_rows(loc.localize_all(cands)))
    assert out[TVF] == out[JVF] and len(out[TVF]) >= 5
    with pytest.raises(ValueError, match="requires a mesh"):
        TorchMaxSim([], [], "TN", shard_ref_table=True, device="cpu")


# ---- DnS localization with row-sharded tables ------------------------------------------


def _dns_side(vf, rng, videos):
    return {v.video_id: vf(v.video_id, v.timestamps,
                           _dyadic(rng, len(v) * 9, FINE_D).reshape(len(v), -1) * 0.5)
            for v in videos}


def _dns_lifecycle(vf, cls, pair, **kw):
    queries, refs, _, extra = _corpus(vf, seed=3)
    rng = np.random.RandomState(8)
    qf, rf, xf = (_dns_side(vf, rng, vids) for vids in (queries, refs, extra))
    qf["Q000000"].feature[4:14] = rf["R000001"].feature[2:12]
    qf["Q000002"].feature[3:15] = xf["R000100"].feature[8:20]
    pairs = [("Q000000", "R000001"), ("Q000002", "R000100"), ("Q000001", "R000003")]
    loc = cls({}, dict(rf), [], refs, model_type="TN", similarity_bias=0.5, **kw)
    loc.set_queries(queries[:2], queries_fine={k: qf[k] for k in ("Q000000", "Q000001")})
    first = loc.localize_all([pair(*pairs[0], 1.0), pair(*pairs[2], 1.0)])
    loc.add_refs(extra, refs_fine=xf)
    loc.remove_refs(["R000003"])
    loc.set_queries(queries, queries_fine=qf)
    second = loc.localize_all([pair(q, r, 1.0) for q, r in pairs[:2]])
    return _rows(first), _rows(second)


def test_dns_row_sharded_tables():
    want = _dns_lifecycle(TVF, torch_dns.DnSLocalization, TorchPair, device="cpu")
    got = _dns_lifecycle(TVF, torch_dns.DnSLocalization, TorchPair, device="cpu",
                         mesh=Mesh(["cpu"] * 4), shard_ref_table=True)
    assert got == want and want[1]
    jax_rows = _dns_lifecycle(JVF, jax_dns.DnSLocalization, jm.CandidatePair,
                              mesh=jax_corpus_mesh(8), shard_ref_table=True)
    for g, w in zip(got, jax_rows):
        assert [m[:6] for m in g] == [m[:6] for m in w]
        np.testing.assert_allclose([m[6] for m in g], [m[6] for m in w], rtol=0, atol=1e-5)


# ---- serve --sharded, the client, descriptor_eval --sharded ----------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    queries, refs, noise, extra = _corpus(JVF)
    paths = {k: str(root / f"{k}.npz") for k in ("q", "r", "n", "x")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    store_features(paths["x"], extra, Dataset.REFS)
    paths["root"] = root
    return paths


@pytest.fixture
def four_shards(monkeypatch):
    """``corpus_mesh`` over four CPU entries (one device has one shard)."""
    monkeypatch.setattr(torch_parallel, "corpus_mesh",
                        lambda n_devices=None, device="cuda": Mesh(["cpu"] * 4))


def test_serve_sharded_replies_identical(files, four_shards):
    root = files["root"]
    sides = {}
    for name, flags in (("plain", []), ("sharded", ["--sharded"])):
        args = torch_serve.parser.parse_args([
            "--ref_features", files["r"], "--score_norm_features", files["n"],
            "--f32", "--matches", "--device", "cpu", *flags])
        device = torch.device("cpu")
        index, refs, _ = torch_serve.build_index(args, device)
        loc = torch_serve.build_localizer(index, refs, args, device)
        sides[name] = (args, index, loc)
        os.makedirs(root / name, exist_ok=True)
    index = sides["sharded"][1]
    assert index.mesh.size == 4 and sides["sharded"][2]._shard_ref_table

    def both(line_of):
        replies = [torch_serve.serve_request(index, TorchAgg(), loc, line_of(name), args)
                   for name, (args, index, loc) in sides.items()]
        return [r.split("\t")[:-1] if r.split("\t")[1] != "stats" else r.split("\t")
                for r in (x.replace(str(root / n), "@") for x, n in zip(replies, sides))]

    def search(tag):
        a, b = both(lambda n: f"{files['q']}\t{root / n}/{tag}_c.csv\t{root / n}/{tag}_m.csv")
        assert a == b
        for suffix in ("c", "m"):
            plain = (root / "plain" / f"{tag}_{suffix}.csv").read_bytes()
            assert (root / "sharded" / f"{tag}_{suffix}.csv").read_bytes() == plain
            assert plain.count(b"\n") > 1

    search("a")
    a, b = both(lambda n: f"add\t{files['x']}")
    assert a == b
    a, b = both(lambda n: "remove\tR000001\tR000003")
    assert a == b
    search("g")
    a, b = both(lambda n: "stats")
    assert a[5] == "0" and b[5] == "1" and a[:5] + a[6:] == b[:5] + b[6:]
    assert isinstance(index._searcher.searcher, ShardedSimilaritySearcher)


def test_client_spawns_sharded(monkeypatch):
    seen = []

    def popen(cmd, **kw):
        seen.append(cmd)
        raise OSError("not started")

    monkeypatch.setattr(subprocess, "Popen", popen)
    for sharded in (True, False):
        with pytest.raises(OSError):
            ServeClient.spawn("r.npz", sharded=sharded, device="cpu")
    assert "--sharded" in seen[0] and "--sharded" not in seen[1]


@pytest.mark.parametrize("shards", ["one", "four"])
def test_descriptor_eval_sharded_csv_identical(files, request, shards):
    if shards == "four":
        request.getfixturevalue("four_shards")
    root = files["root"]
    base = ["--query_features", files["q"], "--ref_features", files["r"],
            "--device", "cpu", "--candidates_output"]
    torch_descriptor_eval.main(torch_descriptor_eval.parser.parse_args(
        base + [str(root / f"de_{shards}.csv")]))
    torch_descriptor_eval.main(torch_descriptor_eval.parser.parse_args(
        base + [str(root / f"de_{shards}_sharded.csv"), "--sharded"]))
    plain = (root / f"de_{shards}.csv").read_bytes()
    assert (root / f"de_{shards}_sharded.csv").read_bytes() == plain
    assert plain.count(b"\n") > 1


def test_index_mesh_and_ivf_exclusive():
    mesh = Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="not both"):
        TorchIndex(D, codec_str="IVF4", mesh=mesh)
    # Without a mesh the IVF codec constructs, as JAX's does.
    index, jax_index = TorchIndex(D, codec_str="IVF4", device="cpu"), JaxIndex(D, codec_str="IVF4")
    assert (index._ivf_nlist, index.mesh) == (jax_index._ivf_nlist, jax_index.mesh) == (4, None)
    index = TorchIndex(D, mesh=mesh)
    assert index.mesh is mesh and index.device == torch.device("cpu")


# ---- data-parallel extraction ------------------------------------------------------------


class _MeanModel(torch.nn.Module):
    """The JAX test's model: the mean over the image, per channel."""

    def forward(self, images):
        return images.mean(dim=(2, 3))


class _Frames:
    """Eight videos of 13 frames, for both packages' extractors."""

    def __init__(self, frames):
        self.frames = frames

    def iter_decoded(self):
        ts = np.stack([np.arange(13.0), np.arange(13.0) + 1], axis=1)
        for i in range(self.frames.shape[0]):
            yield f"v{i:03d}", self.frames[i], ts

    def num_videos(self):
        return self.frames.shape[0]


class _JaxFrames(_Frames, jax_pipeline.VideoDataset):
    pass


def test_extractor_on_a_mesh():
    # tests/test_sharded_search.py TestMeshShardedInference: the batch of 8
    # splits over the mesh; descriptors within 1e-5 of the unsharded
    # forward (the same function on fewer rows a call), and within 1e-4
    # of JAX's, the tolerance of the port's preprocessing against
    # jax.image.resize (tests/test_torch_inference.py).
    rng = np.random.RandomState(11)
    frames = (rng.rand(8, 13, 32, 48, 3) * 255).astype(np.uint8)
    transform = InferenceTransforms.RESIZE_224_SQUARE
    base = DescriptorExtractor(_MeanModel(), transform, batch_size=8, device="cpu")
    ref = {vf.video_id: vf.feature for vf in base.extract(_Frames(frames))}
    for n in (2, 8):
        sharded = DescriptorExtractor(_MeanModel(), transform, batch_size=8,
                                      mesh=Mesh(["cpu"] * n))
        got = {vf.video_id: vf.feature for vf in sharded.extract(_Frames(frames))}
        assert sorted(got) == sorted(ref)
        for vid in ref:
            np.testing.assert_allclose(got[vid], ref[vid], rtol=0, atol=1e-5)
    jax_ex = jax_pipeline.DescriptorExtractor(
        lambda variables, images: images.mean(axis=(1, 2)), {},
        JaxTransforms.RESIZE_224_SQUARE, batch_size=8, mesh=jax_corpus_mesh(8))
    for vf in jax_ex.extract(_JaxFrames(frames)):
        np.testing.assert_allclose(got[vf.video_id], vf.feature, rtol=0, atol=1e-4)
