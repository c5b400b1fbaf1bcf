"""The port's corpus-sharded search (vsc2022_torch.parallel) against the
JAX package's, and against the port's own single-device searcher.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py
(``corpus_mesh(8)``), the port on ``Mesh(["cpu"] * 8)``: eight shards on
the CPU, where every wrapper runs its kernel's plain version on the
shard it is given. The inputs are integers (|x| ≤ 3), so every score is
exact on both sides and both searchers must return IDENTICAL (q, r,
score) arrays, tie order included; the geometry (``shard_rows``,
``col_block``) and the routing (``_collection_mode``) must be JAX's.
The classes mirror tests/test_sharded_search.py.
"""

import types

import numpy as np
import pytest
import torch

import jax

from vsc2022_torch.ops import kernels
from vsc2022_torch.ops.similarity import COLLECTION_ENV
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_torch.parallel import (
    Mesh,
    corpus_mesh as torch_corpus_mesh,
    first_axis_sharding,
    first_axis_size,
    initialize_distributed,
    local_device_count,
)
from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher as TorchSharded
from vsc2022_torch.retrieval.sn_search import ScoreNormalizedSearcher as TorchSN
from vsc2022_tpu.parallel import ShardedSimilaritySearcher as JaxSharded
from vsc2022_tpu.parallel import corpus_mesh as jax_corpus_mesh
from vsc2022_tpu.retrieval.sn_search import ScoreNormalizedSearcher as JaxSN

JAX_ENV = "VSC2022_TPU_COLLECTION"


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_corpus_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * 8)


def _ints(rng, n, d, lo=-3, hi=4):
    return rng.randint(lo, hi, size=(n, d)).astype(np.float32)


def _identical(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _force(monkeypatch, mode):
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setenv(JAX_ENV, mode)


def _jax_mode(mode):
    return "stream" if mode is True else mode


# ---- the mesh -----------------------------------------------------------------


def test_mesh_helpers():
    mesh = Mesh(["cpu"] * 3)
    assert mesh.size == first_axis_size(mesh) == 3 and mesh.axis_names == ("corpus",)
    assert mesh.lead == torch.device("cpu") and mesh.distinct() == [torch.device("cpu")]
    one = torch_corpus_mesh(device="cpu")
    assert one.devices == (torch.device("cpu"),) and local_device_count("cpu") == 1
    with pytest.raises(ValueError, match="Requested 2 devices, have 1"):
        torch_corpus_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    parts = first_axis_sharding(mesh)(torch.arange(12).view(6, 2))
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                           [[8, 9], [10, 11]]]
    with pytest.raises(ValueError, match="divide"):
        first_axis_sharding(mesh)(torch.zeros(4))
    initialize_distributed()  # one process: nothing to do
    initialize_distributed(num_processes=1)
    # A pod needs its rendezvous address and a rank in range; the backend
    # rule refuses NCCL without a card (tests/test_torch_multihost.py runs
    # two-rank groups).
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(None, num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        initialize_distributed("localhost:1234", num_processes=2, process_id=2, device="cpu")
    with pytest.raises(ValueError, match="needs a card"):
        initialize_distributed("localhost:1234", 2, 0, backend="nccl", device="cpu")


# ---- geometry and routing -------------------------------------------------------


@pytest.mark.parametrize("n,col_block", [(5, 8192), (533, 8192), (16384, 8192),
                                         (4096, 256), (70_001, 8192)])
def test_geometry_and_routing_equal_jax(jmesh, tmesh, monkeypatch, n, col_block):
    r = np.zeros((n, 4), np.float32)
    js = JaxSharded(r, jmesh, col_block=col_block)
    ts = TorchSharded(r, tmesh, col_block=col_block)
    assert (ts.shard_rows, ts.col_block) == (js.shard_rows, js.col_block)
    for mode in ("", "pooled", "stream"):
        _force(monkeypatch, mode)
        for m, kappa in ((8, 32), (24, 64), (9000, 32), (4096, 4096)):
            assert ts._collection_mode(m, kappa) == _jax_mode(
                js._collection_mode(m, kappa, True)), (mode, m, kappa)
    # append_rows / keep_rows land on JAX's fresh-stage geometry.
    for grow in (1, 3 * n + 200):
        js.append_rows(np.ones((grow, 4), np.float32))
        ts.append_rows(np.ones((grow, 4), np.float32))
        assert (ts.shard_rows, ts.col_block) == (js.shard_rows, js.col_block)
    keep = np.arange(0, ts.n_refs, 7)
    js.keep_rows(keep)
    ts.keep_rows(keep)
    assert (ts.shard_rows, ts.col_block, ts.n_refs) == (js.shard_rows, js.col_block,
                                                        js.n_refs)


def test_sscd_scale_routing():
    # The card's two shard counts at phase 4's corpus (1,000,020 rows):
    # 2 shards pool, 4 shards stream, with no mode forced.
    for n_dev, want, shard_rows in ((2, "pooled", 507_904), (4, "stream", 253_952)):
        ts = TorchSharded.__new__(TorchSharded)
        ts.n_dev, ts._col_block_req = n_dev, 8192
        ts.shard_rows, ts.col_block = ts._geometry(1_000_020)
        assert ts.shard_rows == shard_rows
        assert ts._collection_mode(9000, 32) == want


# ---- TestShardedSearch -----------------------------------------------------------


@pytest.mark.parametrize("metric", ["IP", "L2"])
def test_matches_jax_sharded(jmesh, tmesh, metric):
    rng = np.random.RandomState(0)
    q, r = _ints(rng, 23, 16), _ints(rng, 533, 16)
    js = JaxSharded(r, jmesh, metric=metric)
    ts = TorchSharded(r, tmesh, metric=metric)
    single = TorchSearcher(r, metric=metric, device="cpu")
    for k in (50, 700):
        got = ts.global_topk(q, k)
        _identical(got, js.global_topk(q, k))
        _identical(got, single.global_topk(q, k))


def test_row_topk_and_row_nn_match(jmesh, tmesh):
    rng = np.random.RandomState(1)
    q, r = _ints(rng, 11, 8), _ints(rng, 301, 8)
    ts = TorchSharded(r, tmesh)
    want_s, want_i = JaxSharded(r, jmesh).row_topk(q, 7)
    got_s, got_i = ts.row_topk(q, 7)
    np.testing.assert_array_equal(got_s, want_s)
    single = TorchSearcher(r, device="cpu")
    _identical((got_s, got_i), single.row_topk(q, 7))
    np.testing.assert_array_equal(ts.row_nn(q), single.row_nn(q))


def test_saturation_fallback_sharded(jmesh, tmesh):
    rng = np.random.RandomState(2)
    q, r = _ints(rng, 8, 16, -2, 3), _ints(rng, 1024, 16, -2, 3)
    hot = rng.randint(-2, 3, size=16).astype(np.float32)
    q[3] = hot * 10
    r[:512] += hot
    _identical(TorchSharded(r, tmesh).global_topk(q, 600, kappa=64),
               JaxSharded(r, jmesh).global_topk(q, 600, kappa=64))


def test_corpus_smaller_than_mesh(jmesh, tmesh, monkeypatch):
    # Five rows over eight shards of 128 rows: shard 0 holds them all, the
    # other seven no valid row, and they run no kernel.
    rng = np.random.RandomState(3)
    q, r = _ints(rng, 4, 8), _ints(rng, 5, 8)
    ts = TorchSharded(r, tmesh)
    assert [n for _, _, _, n in ts._shards()] == [5]
    kernels.reset_launches()
    got = ts.global_topk(q, 10)
    assert kernels.launches["fused_topk"] == kernels.launches["count_above"] == 0  # CPU
    _identical(got, JaxSharded(r, jmesh).global_topk(q, 10))
    launched = []
    monkeypatch.setattr(kernels, "fused_topk", lambda q, refs, n, *a, **kw: (
        launched.append(n), kernels.fused_topk_plain(q, refs, n, *a, **kw))[1])
    _identical(ts.global_topk(q, 10), got)
    assert launched == [5]


# ---- score normalization -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sn_fused_matches_jax(jmesh, tmesh, dtype):
    rng = np.random.RandomState(6)
    q, r, noise = _ints(rng, 13, 12), _ints(rng, 200, 12), _ints(rng, 90, 12)
    js = JaxSN(r, noise, mesh=jmesh, dtype=dtype)
    ts = TorchSN(r, noise, mesh=tmesh, dtype=dtype)
    assert isinstance(ts.searcher, TorchSharded) and isinstance(ts.noise_searcher,
                                                                TorchSharded)
    got = ts.global_topk(q, 40)
    _identical(got, js.global_topk(q, 40))
    np.testing.assert_array_equal(ts.last_q_sn.numpy(), np.asarray(js.last_q_sn)[:13])
    _identical(got, TorchSN(r, noise, dtype=dtype, device="cpu").global_topk(q, 40))


def test_sn_pooled_matches_jax(jmesh, tmesh, monkeypatch):
    rng = np.random.RandomState(43)
    q, r, noise = _ints(rng, 17, 16), _ints(rng, 16384, 16), _ints(rng, 512, 16)
    _force(monkeypatch, "pooled")
    ts = TorchSN(r, noise, mesh=tmesh)
    kappa, _ = ts.searcher._plan(17, 700)
    assert ts.searcher._collection_mode(24, kappa) == "pooled"
    got = ts.global_topk(q, 700)
    assert ts.searcher.last_stats["mode"] == "pooled"
    _identical(got, JaxSN(r, noise, mesh=jmesh).global_topk(q, 700))


# ---- TestShardedPooledCollection ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pooled_matches_jax_and_single(jmesh, tmesh, monkeypatch, dtype):
    rng = np.random.RandomState(17)
    q, r = _ints(rng, 23, 16), _ints(rng, 16384, 16)
    single = TorchSearcher(r, dtype=dtype, device="cpu")
    _force(monkeypatch, "pooled")
    js, ts = JaxSharded(r, jmesh, dtype=dtype), TorchSharded(r, tmesh, dtype=dtype)
    assert ts._collection_mode(24, 32) == "pooled"
    # k = 700 plans κ = 64, the most the shards' pools take (4κ ≤ 8 · 32);
    # k = 5000 plans κ = 512 and falls back to the stream, as in JAX.
    cases = ((50, "pooled"), (700, "pooled")) + (((5000, "stream"),)
                                                 if dtype == "float32" else ())
    for k, mode in cases:
        got = ts.global_topk(q, k)
        assert ts.last_stats["mode"] == mode
        _identical(got, js.global_topk(q, k))
        _identical(got, single.global_topk(q, k))


def test_clustered_hits_cross_shard(jmesh, tmesh, monkeypatch):
    # More than two entries >= tau inside single 128-column segments, on
    # two shards (shard_rows = 2048): the ambiguous rows resolve through
    # the summed counts and the sharded corpus re-search.
    rng = np.random.RandomState(19)
    q, r = _ints(rng, 9, 16, -2, 3), _ints(rng, 16384, 16, -2, 3)
    hot = rng.randint(-2, 3, size=16).astype(np.float32)
    q[4] = hot * 8
    r[300:360] += hot
    r[4096 + 128 : 4096 + 180] += hot
    _force(monkeypatch, "pooled")
    js, ts = JaxSharded(r, jmesh), TorchSharded(r, tmesh)
    for k in (40, 300):
        got = ts.global_topk(q, k, kappa=32)
        assert ts.last_stats["amb_rows"] > 0 and ts.last_stats["corpus_rows"] > 0
        _identical(got, js.global_topk(q, k, kappa=32))


def test_pooled_l2_matches(jmesh, tmesh, monkeypatch):
    rng = np.random.RandomState(23)
    q, r = _ints(rng, 11, 12), _ints(rng, 16384, 12)
    _force(monkeypatch, "pooled")
    ts = TorchSharded(r, tmesh, metric="L2")
    got = ts.global_topk(q, 400)
    assert ts.last_stats["mode"] == "pooled"
    _identical(got, JaxSharded(r, jmesh, metric="L2").global_topk(q, 400))


def test_cross_shard_duplicate_ties(jmesh, tmesh, monkeypatch):
    # The same 16 rows at the head of every shard: equal scores whose
    # order is the global id, built from the shards' bases.
    rng = np.random.RandomState(31)
    q, r = _ints(rng, 8, 16, -2, 3), _ints(rng, 16384, 16, -2, 3)
    dup = _ints(rng, 16, 16, -2, 3)
    for s in range(8):
        r[s * 2048 : s * 2048 + 16] = dup
    single = TorchSearcher(r, device="cpu")
    for mode in ("pooled", "stream"):
        _force(monkeypatch, mode)
        js, ts = JaxSharded(r, jmesh), TorchSharded(r, tmesh)
        for k in (10, 120):
            got = ts.global_topk(q, k)
            assert ts.last_stats["mode"] == mode
            _identical(got, js.global_topk(q, k))
            _identical(got, single.global_topk(q, k))


def test_infeasible_pool_falls_back_to_stream(jmesh, tmesh, monkeypatch):
    _force(monkeypatch, "pooled")
    rng = np.random.RandomState(29)
    q, r = _ints(rng, 8, 8), _ints(rng, 600, 8)
    js, ts = JaxSharded(r, jmesh), TorchSharded(r, tmesh)
    assert js._collection_mode(8, 32, True) is True
    assert ts._collection_mode(8, 32) == "stream"
    got = ts.global_topk(q, 200)
    assert ts.last_stats["mode"] == "stream"
    _identical(got, js.global_topk(q, 200))


def test_row_blocked_fused_matches_jax(jmesh, tmesh):
    # JAX scans 16-row blocks inside its mesh dispatch; the port's kernels
    # take every row at once. The selections must agree.
    rng = np.random.RandomState(31)
    q, r = _ints(rng, 50, 16), _ints(rng, 300, 16)
    js, ts = JaxSharded(r, jmesh, row_block=16), TorchSharded(r, tmesh)
    for k in (9, 400):
        _identical(ts.global_topk(q, k), js.global_topk(q, k))


# ---- storage dtypes ----------------------------------------------------------------


def test_int8_mutations_match_jax(jmesh, tmesh):
    rng = np.random.RandomState(10)
    q, r, r2 = _ints(rng, 23, 16), _ints(rng, 517, 16), _ints(rng, 130, 16)
    js = JaxSharded(r, jmesh, dtype="int8")
    ts = TorchSharded(r, tmesh, dtype="int8")
    _identical(ts.global_topk(q, 300), js.global_topk(q, 300))
    js.append_rows(r2)
    ts.append_rows(r2)
    _identical(ts.global_topk(q, 400), js.global_topk(q, 400))
    keep = np.sort(rng.choice(647, 300, replace=False))
    js.keep_rows(keep)
    ts.keep_rows(keep)
    _identical(ts.global_topk(q, 400), js.global_topk(q, 400))


def test_int8_pooled_collection_matches(jmesh, tmesh, monkeypatch):
    _force(monkeypatch, "pooled")
    rng = np.random.RandomState(12)
    q, r = _ints(rng, 16, 12), _ints(rng, 4096, 12)
    # As in JAX: shards of 512 rows pool 8 entries a row, too few for the
    # planned κ, so the forced pool falls back to the stream.
    ts = TorchSharded(r, tmesh, dtype="int8", col_block=256)
    got = ts.global_topk(q, 900)
    assert ts.last_stats["mode"] == "stream"
    _identical(got, JaxSharded(r, jmesh, dtype="int8", col_block=256).global_topk(q, 900))


def test_bf16_matches_jax(jmesh, tmesh, monkeypatch):
    rng = np.random.RandomState(13)
    q, r = _ints(rng, 16, 12), _ints(rng, 4096, 12)
    _force(monkeypatch, "pooled")
    ts = TorchSharded(r, tmesh, dtype="bfloat16", col_block=256)
    _identical(ts.global_topk(q, 900),
               JaxSharded(r, jmesh, dtype="bfloat16", col_block=256).global_topk(q, 900))


# ---- sharded == the single-device port, with no JAX involved ---------------------------


@pytest.mark.parametrize("dtype,metric", [("float32", "IP"), ("float32", "L2"),
                                          ("bfloat16", "IP"), ("bfloat16", "L2"),
                                          ("int8", "IP")])
@pytest.mark.parametrize("mode", ["pooled", "stream"])
def test_sharded_equals_single_device(monkeypatch, dtype, metric, mode):
    rng = np.random.RandomState(41)
    q, r = _ints(rng, 19, 13), _ints(rng, 3000, 13)
    extra = _ints(rng, 1500, 13)
    _force(monkeypatch, mode)
    mesh = Mesh(["cpu"] * 3)
    single = TorchSearcher(r, metric=metric, dtype=dtype, device="cpu")
    ts = TorchSharded(r, mesh, metric=metric, dtype=dtype, col_block=256)
    single_shape = single._refs.shape[0]

    def check(k):
        # κ = 4 fits every layout's pools (4κ ≤ the mesh's pool width) and
        # saturates rows, so the repairs and the re-search run.
        got = ts.global_topk(q, k, kappa=4)
        _identical(got, single.global_topk(q, k, kappa=4))
        assert ts.last_stats["mode"] == mode

    check(700)
    # Grown past its shards (the resident rows move to the new layout),
    # then compacted: each time the layout of a fresh stage.
    ts.append_rows(extra)
    single.append_rows(extra)
    fresh = TorchSharded(np.concatenate([r, extra]), mesh, metric=metric, dtype=dtype,
                         col_block=256)
    for name in ("refs", "scale", "ref_sq"):
        for a, b in zip(ts._shard[name] or [], fresh._shard[name] or []):
            assert torch.equal(a, b)
    check(2000)
    keep = np.flatnonzero(rng.rand(4500) < 0.3)
    ts.keep_rows(keep)
    single.keep_rows(keep)
    check(500)
    assert single._refs.shape[0] <= single_shape * 2


def test_shards_are_views_on_one_device(tmesh, monkeypatch):
    r = np.arange(40 * 4, dtype=np.float32).reshape(40, 4)
    ts = TorchSharded(r, Mesh(["cpu"] * 4))
    refs = ts._shard["refs"]
    assert ts.shard_rows == 128
    base = refs[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in refs)
    assert [t.data_ptr() - base for t in refs] == [i * 128 * 4 * 4 for i in range(4)]
    assert ts.staged_bytes() == 4 * 128 * 4 * 4
    # One allocation a run of consecutive entries on one device.
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    fake = types.SimpleNamespace(mesh=types.SimpleNamespace(devices=[a, a, b, a, a],
                                                            local=range(5)))
    assert TorchSharded._allocations(fake) == [[0, 1], [2], [3, 4]]
    # In a pod, a process allocates its own entries only.
    fake.mesh.local = (1, 2, 3, 4)
    assert TorchSharded._allocations(fake) == [[1], [2], [3, 4]]
    # One run of rows for the dense f32 products (the single-device call).
    (dev, base, n, run), = ts._runs()
    assert (base, n) == (0, 40) and torch.equal(run["refs"], torch.from_numpy(r))
    q = np.eye(4, dtype=np.float32)
    want = ts.global_topk(q, 12)
    assert ts.row_topk(q, 40)[1].tolist() == [list(np.argsort(-r[:, j], kind="stable"))
                                              for j in range(4)]
    corpus = np.arange(600 * 4, dtype=np.float32).reshape(600, 4) % 7
    big = TorchSharded(corpus, Mesh(["cpu"] * 4), metric="L2")
    assert [(b, n) for _, b, n, _ in big._runs()] == [(0, 600)]
    # One allocation a shard, as on separate cards: a run a shard that
    # holds valid rows, and the same search.
    monkeypatch.setattr(TorchSharded, "_allocations",
                        lambda self: [[s] for s in range(self.n_dev)])
    apart = TorchSharded(r, Mesh(["cpu"] * 4))
    assert len({t.untyped_storage().data_ptr() for t in apart._shard["refs"]}) == 4
    assert apart.staged_bytes() == ts.staged_bytes()
    assert len(apart._runs()) == 1  # 40 rows: shard 0 alone holds valid rows
    _identical(apart.global_topk(q, 12), want)
    big_apart = TorchSharded(corpus, Mesh(["cpu"] * 4), metric="L2")
    assert [(b, n) for _, b, n, _ in big_apart._runs()] == [(0, 256), (256, 256), (512, 88)]
    _identical(big_apart.row_topk(q, 50), big.row_topk(q, 50))
    _identical(big_apart.global_topk(q, 60), big.global_topk(q, 60))


@pytest.mark.parametrize("d", [16, 13])
def test_staged_bytes_count_a_shared_copy_once(d):
    # A bf16 corpus at a D of a multiple of 8 is its own tensor-core copy:
    # counted once. At D = 13 the kernels read a padded copy, counted too.
    r = np.ones((300, d), np.float32)
    single = TorchSearcher(r, dtype="bfloat16", device="cpu")
    sharded = TorchSharded(r, Mesh(["cpu"] * 2), dtype="bfloat16")
    q = np.ones((3, d), np.float32)
    single.global_topk(q, 5)
    sharded.global_topk(q, 5)
    rows = 2 * d * single._refs.shape[0]
    copy = 2 * 16 * single._refs.shape[0] if d % 8 else 0
    assert single.staged_bytes() == rows + copy
    assert sharded.staged_bytes() == 2 * (d + (16 if d % 8 else 0)) * 2 * sharded.shard_rows
