"""The IVF pruned tier: the port (vsc2022_torch/ops/ivf.py) against the JAX
package's (vsc2022_tpu/ops/ivf.py), on the CPU.

On ``tests/test_ivf.py``'s ``clustered_ints`` data (integer rows, so every
score is exact on both sides):

- ``kmeans_assign`` gives JAX's assignments and centroids, ``order_clusters``
  JAX's chain, and the searcher JAX's permutation. The k-means seed is one
  whose initial rows fall in distinct clusters, so Lloyd's first assignment
  is the clustering itself and no row lies near a cell boundary, where the
  two BLAS products could round a score apart.
- The plain block-subset kernels (``fused_topk`` / ``count_above`` with
  ``blocks=``) equal JAX's ``streaming_topk`` / ``streaming_count_above``
  with ``block_ids`` and the full-corpus plain versions over the listed
  blocks' rows; an empty list, bad ids and L2 behave as documented.
- ``IVFSimilaritySearcher.global_topk`` equals JAX's IVF searcher and the
  port's plain searcher exactly (ids, scores, tie order) in f32, bf16 and
  int8, with JAX's probe mask and ``last_search_stats`` (``certified_extra``
  where JAX's candidates are segment winners too: ops/ivf.py's docstring),
  at low nprobe, on isotropic data, under saturation, on the small-corpus
  and fallback paths, after append and keep; ``row_topk`` maps its ids.
- ``VideoIndex`` parses the IVF codecs as JAX does; the score-normalized
  index with an IVF codec equals the flat index and JAX's, and keeps JAX's
  unrounded bias in ``last_q_sn``; ``serve --ivf`` answers as the JAX
  server's ``--ivf`` on the same files.
"""

import csv

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_serve import _strip
from vsc2022_torch.ops import kernels
from vsc2022_torch.ops import ivf as torch_ivf
from vsc2022_torch.ops.ivf import IVFSimilaritySearcher as TorchIVF
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_torch.parallel import Mesh
from vsc2022_torch.retrieval import serve as torch_serve
from vsc2022_torch.retrieval.candidates import MaxScoreAggregation as TorchAgg
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex as TorchSNIndex
from vsc2022_torch.retrieval.index import VideoIndex as TorchIndex
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.ops import ivf as jax_ivf
from vsc2022_tpu.ops.ivf import IVFSimilaritySearcher as JaxIVF
from vsc2022_tpu.ops.similarity import quantize_rows_int8, streaming_count_above, streaming_topk
from vsc2022_tpu.retrieval import serve as jax_serve
from vsc2022_tpu.retrieval.candidates import MaxScoreAggregation as JaxAgg
from vsc2022_tpu.retrieval.index import ScoreNormalizedVideoIndex as JaxSNIndex
from vsc2022_tpu.retrieval.index import VideoIndex as JaxIndex
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature as JVF

CPU = torch.device("cpu")
DTYPES = ("float32", "bfloat16", "int8")
SEG = kernels.SEG_LANES
# Score-normalized floats (a float bias column; tests/test_torch_serve.py).
FLOAT_ATOL = 1e-5
# The bias column of a score-normalized query as the localizer reads it:
# rounded to bf16 beside a plain bf16 searcher (the fused path's rule),
# unrounded beside an IVF one (JAX's). |bias| <= beta |sim| <= 1.2 here, so
# a similarity moves by at most 2^-9 * 1.2 < 2^-8: the matches of serve --ivf
# against the plain server's (chip_smoke.py phase 11c states the same).
IVF_BIAS_ATOL = 2.0 ** -8


def clustered_ints(rng, n, d, n_clusters, spread=12, noise=2):
    """tests/test_ivf.py's data: integer rows in well-separated clusters,
    membership round-robin over the row ids."""
    centers = rng.randint(-spread, spread + 1, size=(n_clusters, d)) * 8
    assign = np.arange(n) % n_clusters
    rows = centers[assign] + rng.randint(-noise, noise + 1, size=(n, d))
    return rows.astype(np.float32), assign


def clean_seed(truth, nlist):
    """The first k-means seed whose initial rows (``kmeans_assign``'s
    RandomState(seed).choice) lie in nlist distinct clusters of ``truth``."""
    for seed in range(100_000):
        init = np.random.RandomState(seed).choice(truth.size, size=nlist, replace=False)
        if np.unique(truth[init]).size == nlist:
            return seed
    raise AssertionError("no clean seed")


def clean_layout(r, truth, nlist, seed=0):
    """(rows, clusters) reordered so that ``seed`` is a clean k-means seed
    (``clean_seed``): for each c < nlist, seed's c-th initial row is swapped
    with a row of cluster c."""
    r, truth = r.copy(), truth.copy()
    init = np.random.RandomState(seed).choice(truth.size, size=nlist, replace=False)
    for c, at in enumerate(init):
        other = np.nonzero((truth == c) & ~np.isin(np.arange(truth.size), init))[0][0]
        r[[at, other]], truth[[at, other]] = r[[other, at]], truth[[other, at]]
    assert clean_seed(truth, nlist) == seed
    return r, truth


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _segment_candidates(probed, col_block, kappa):
    """Whether JAX's XLA subset collection takes segment winners (its
    seg_pool over the power-of-two padded block list reaches κ) rather than
    an exact per-block top-κ."""
    n = max(int(probed), 1)
    return kappa > 1 and 2 * (1 << (n - 1).bit_length()) * (col_block // SEG) >= kappa


def _assert_stats(port, jax, kappa, col_block):
    got, want = port.last_search_stats, jax.last_search_stats
    if want is None or got is None:
        assert got == want
        return
    assert {k: got[k] for k in ("n_blocks", "probed")} == {
        k: want[k] for k in ("n_blocks", "probed")}
    if _segment_candidates(want["probed"], col_block, kappa):
        assert got == want


def _pair(r, dtype="float32", nlist=8, truth=None, **kw):
    """(JAX IVF searcher, port IVF searcher, port plain searcher) over rows
    r, with a clean k-means seed when the clustering is known."""
    if truth is not None:
        kw.setdefault("seed", clean_seed(truth, nlist))
    j = JaxIVF(r, nlist=nlist, dtype=dtype, **kw)
    t = TorchIVF(r, nlist=nlist, dtype=dtype, device="cpu", **kw)
    np.testing.assert_array_equal(t._perm, j._perm)
    return j, t, TorchSearcher(r, dtype=dtype, device="cpu")


def _search_all(j, t, p, q, k, kappa=None, col_block=128):
    want = j.global_topk(q, k, kappa)
    got = t.global_topk(q, k, kappa)
    _same(got, want)
    _same(p.global_topk(q, k, kappa), want)
    kappa_eff, _ = t._plan(q.shape[0], k, kappa)
    _assert_stats(t, j, kappa_eff, col_block)
    return got


# ---- k-means and the chain ------------------------------------------------------


@pytest.mark.parametrize("n,d,clusters,iters", [(640, 8, 5, 6), (2048, 16, 8, 8)])
def test_kmeans_assign_and_order_equal_jax(n, d, clusters, iters):
    r, truth = clustered_ints(np.random.RandomState(9), n, d, n_clusters=clusters)
    seed = clean_seed(truth, clusters)
    ja, jc = jax_ivf.kmeans_assign(r, nlist=clusters, iters=iters, seed=seed)
    ta, tc = torch_ivf.kmeans_assign(r, nlist=clusters, iters=iters, seed=seed,
                                     device="cpu")
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tc, jc)
    assert ta.dtype == np.int32 and tc.dtype == np.float32
    for c in range(clusters):  # every true cluster lands in one cell
        assert len(set(ta[truth == c])) == 1
    np.testing.assert_array_equal(torch_ivf.order_clusters(tc), jax_ivf.order_clusters(jc))


def test_order_clusters_equals_jax():
    line = np.array([0.0, 10.0, 20.0, 30.0, 40.0])[:, None][[2, 0, 4, 1, 3]]
    rng = np.random.RandomState(3)
    for cent in (line, rng.randn(17, 6), np.zeros((1, 3)), rng.randn(2, 4)):
        np.testing.assert_array_equal(torch_ivf.order_clusters(cent),
                                      jax_ivf.order_clusters(cent))


def test_kmeans_keeps_an_empty_cell():
    # Two identical initial rows: every row ties between their cells and
    # takes the lower; the other cell stays empty and keeps its centroid.
    r = np.repeat(np.eye(3, dtype=np.float32) * 8, 20, axis=0)
    for seed in range(200):
        init = np.random.RandomState(seed).choice(60, size=4, replace=False)
        if len(set(init // 20)) < 4 and len(set(init // 20)) == 3:
            break
    ja, jc = jax_ivf.kmeans_assign(r, nlist=4, iters=3, seed=seed)
    ta, tc = torch_ivf.kmeans_assign(r, nlist=4, iters=3, seed=seed, device="cpu")
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tc, jc)
    assert len(set(ta)) == 3


# ---- the plain block-subset kernels ------------------------------------------


def _operands(dtype, r, q):
    """(port q, port refs, port scale, JAX q, JAX refs, JAX ref_sq, metric)."""
    if dtype == "int8":
        codes, scale = quantize_rows_int8(r)
        return (torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(scale),
                jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale), "IP8")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(r).to(tdt), None,
            jnp.asarray(q, jdt), jnp.asarray(r, jdt), jnp.zeros(r.shape[0], jnp.float32),
            "IP")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocks", [[0, 2, 5], [7], [1, 3, 4, 6, 7], []])
def test_count_above_blocks_equal_jax(dtype, blocks):
    rng = np.random.RandomState(5)
    n_valid, col_block = 1000, 128  # the last block (7) holds 104 valid rows
    r = np.zeros((1024, 16), np.float32)
    r[:n_valid] = rng.randint(-4, 5, size=(n_valid, 16))
    q = rng.randint(-4, 5, size=(19, 16)).astype(np.float32)
    tq, tr, sc, jq, jr, jsq, metric = _operands(dtype, r, q)
    ids = np.asarray(blocks, np.int32)
    for tau in (8.0, -3.0, float("-inf")):
        want = np.asarray(streaming_count_above(
            jq, jr, jnp.int32(n_valid), jsq, jnp.float32(tau), col_block=col_block,
            metric=metric, precision="highest", block_ids=jnp.asarray(ids)))
        got = kernels.count_above(tq, tr, tau, n_valid, scale=sc,
                                  blocks=torch.from_numpy(ids), col_block=col_block)
        np.testing.assert_array_equal(got.numpy(), want)
        rows = kernels.block_rows(torch.from_numpy(ids), col_block, n_valid)
        full = kernels.count_above(tq, tr[rows], tau, rows.numel(),
                                   scale=None if sc is None else sc[rows])
        np.testing.assert_array_equal(got.numpy(), full.numpy())
    if not blocks:
        assert (got.numpy() == 0).all()


# JAX's subset collection takes segment winners at these lists and κ (its
# padded list holds at least κ of them; ops/ivf.py's docstring).
@pytest.mark.parametrize("blocks,col_block", [([0, 2, 5], 128), ([1], 512),
                                              ([1, 3, 4, 6, 7], 128)])
def test_fused_topk_blocks_equal_jax_on_distinct_scores(blocks, col_block):
    # One-hot queries against permuted-integer columns: every score of a row
    # is distinct, so the candidates, their order and ids are determined.
    rng = np.random.RandomState(len(blocks))
    m, n, d, n_valid, kappa = 11, 1024, 8, 1000, 6
    q = np.zeros((m, d), np.float32)
    q[np.arange(m), np.arange(m) % d] = 1.0
    r = np.stack([rng.permutation(n) for _ in range(d)], axis=1).astype(np.float32)
    ids = np.asarray(blocks, np.int32)
    es, ei = streaming_topk(jnp.asarray(q), jnp.asarray(r), jnp.int32(n_valid),
                            jnp.zeros(n, jnp.float32), kappa=kappa, col_block=col_block,
                            metric="IP", precision="highest", approx=True,
                            block_ids=jnp.asarray(ids))
    gs, gi = kernels.fused_topk(torch.from_numpy(q), torch.from_numpy(r), n_valid, kappa,
                                blocks=torch.from_numpy(ids), col_block=col_block)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(es))
    finite = np.isfinite(np.asarray(es))
    np.testing.assert_array_equal(gi.numpy()[finite], np.asarray(ei)[finite])
    assert (gi.numpy()[~finite] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_topk_blocks_equal_full_kernel_on_listed_rows(dtype):
    rng = np.random.RandomState(7)
    n_valid, col_block, kappa = 1000, 256, 4
    r = np.zeros((1024, 16), np.float32)
    r[:n_valid] = rng.randint(-4, 5, size=(n_valid, 16))
    q = rng.randint(-4, 5, size=(13, 16)).astype(np.float32)
    tq, tr, sc, jq, jr, jsq, metric = _operands(dtype, r, q)
    for blocks in ([0, 3], [3], [1, 2], []):
        ids = torch.tensor(blocks, dtype=torch.int32)
        gs, gi = kernels.fused_topk(tq, tr, n_valid, kappa, scale=sc, blocks=ids,
                                    col_block=col_block)
        rows = kernels.block_rows(ids, col_block, n_valid)
        fs, fi = kernels.fused_topk(tq, tr[rows], rows.numel(), kappa,
                                    scale=None if sc is None else sc[rows])
        np.testing.assert_array_equal(gs.numpy(), fs.numpy())
        mapped = torch.where(torch.isfinite(fs), rows[fi.long()] if rows.numel() else 0, 0)
        np.testing.assert_array_equal(gi.numpy(), mapped.numpy())
        # JAX's segment-winner collection over the same blocks: the same values.
        es, _ = streaming_topk(jq, jr, jnp.int32(n_valid), jsq, kappa=kappa,
                               col_block=col_block, metric=metric, precision="highest",
                               approx=True, block_ids=jnp.asarray(np.asarray(blocks, np.int32)))
        if blocks:
            np.testing.assert_array_equal(gs.numpy(), np.asarray(es))
        else:
            assert np.isneginf(gs.numpy()).all() and (gi.numpy() == 0).all()


def test_block_lists_are_checked():
    q = torch.ones((3, 4))
    r = torch.ones((512, 4))
    ok = dict(col_block=128)
    for bad in ([1, 1], [2, 1], [-1], [4]):
        with pytest.raises(ValueError, match="ascending"):
            kernels.count_above(q, r, 0.0, 500, blocks=torch.tensor(bad, dtype=torch.int32), **ok)
        with pytest.raises(ValueError, match="ascending"):
            kernels.fused_topk(q, r, 500, 4, blocks=torch.tensor(bad, dtype=torch.int32), **ok)
    with pytest.raises(ValueError, match="int32"):
        kernels.count_above(q, r, 0.0, 500, blocks=torch.tensor([0]), **ok)
    with pytest.raises(ValueError, match="multiple of 128"):
        kernels.count_above(q, r, 0.0, 500, blocks=torch.tensor([0], dtype=torch.int32),
                            col_block=100)
    with pytest.raises(TypeError, match="col_block"):
        kernels.fused_topk(q, r, 500, 4, blocks=torch.tensor([0], dtype=torch.int32))
    l2 = dict(ref_sq=torch.ones(512), q_sq=torch.ones(3))
    with pytest.raises(ValueError, match="metric IP"):
        kernels.count_above(q, r, 0.0, 500, blocks=torch.tensor([0], dtype=torch.int32),
                            **ok, **l2)
    with pytest.raises(ValueError, match="metric IP"):
        kernels.fused_topk(q, r, 500, 4, blocks=torch.tensor([0], dtype=torch.int32),
                           **ok, **l2)


# ---- the searcher --------------------------------------------------------------


def _focused(rng, r, n_q=40):
    idx = rng.choice(r.shape[0], size=n_q, replace=False)
    return r[idx] + rng.randint(-1, 2, size=(n_q, r.shape[1])).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pruned_search_equals_jax_and_plain(dtype):
    # tests/test_ivf.py test_pruned_matches_oracle, with 8 cells.
    rng = np.random.RandomState(0)
    r, truth = clustered_ints(rng, 3000, 24, n_clusters=8)
    q = _focused(rng, r)
    j, t, p = _pair(r, dtype, truth=truth, col_block=128)
    for k in (1, 10, 200, 2000):
        _search_all(j, t, p, q, k)
    # Clustered queries near a few cells: the probe prunes. One query
    # video's rows near one cluster:
    _search_all(j, t, p, r[truth == 2][:30] + 1.0, 60)
    assert t.last_search_stats["pruned"] is True
    assert t.last_search_stats["probed"] < t.last_search_stats["n_blocks"]
    assert t.last_stats["mode"] == "ivf"


def test_probe_mask_equals_jax():
    rng = np.random.RandomState(1)
    r, truth = clustered_ints(rng, 2048, 16, n_clusters=8)
    j, t, _ = _pair(r, truth=truth, col_block=128, nprobe=2)
    q = _focused(rng, r, 24)
    n_blocks = t._refs.shape[0] // t.col_block
    mask, rowmax = t._probe(t._stage_queries(q), n_blocks)
    cent, rad, has = j._bounds()
    buf = np.asarray(jax_ivf._probe_packed(jnp.asarray(q), cent, rad, has,
                                           jnp.asarray(q.shape[0], jnp.int32), nprobe=2))
    np.testing.assert_array_equal(mask, buf[:n_blocks].astype(bool))
    np.testing.assert_allclose(rowmax, buf[n_blocks:].view(np.float32), rtol=1e-6)
    tc, tr, th = t._block_stats()
    np.testing.assert_allclose(tc.numpy(), np.asarray(cent), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(rad), rtol=1e-6)
    np.testing.assert_array_equal(th.numpy(), np.asarray(has))


@pytest.mark.parametrize("dtype", DTYPES)
def test_low_nprobe_certificate_repairs(dtype):
    # Queries between two clusters: nprobe=1 misses, the certificate repairs.
    rng = np.random.RandomState(1)
    r, truth = clustered_ints(rng, 2048, 16, n_clusters=8)
    mid = (r[truth == 0][:32].astype(np.float64) + r[truth == 1][:32]) / 2.0
    q = np.round(mid).astype(np.float32)
    j, t, p = _pair(r, dtype, truth=truth, nprobe=1, col_block=128)
    for k in (5, 64, 700):
        _search_all(j, t, p, q, k)


def test_isotropic_data_still_exact():
    # No cluster structure: the bounds barely prune; exactness holds. The
    # two k-means runs may part on near-ties here, so only results compare.
    rng = np.random.RandomState(2)
    r = rng.randint(-4, 5, size=(1536, 16)).astype(np.float32)
    q = rng.randint(-4, 5, size=(23, 16)).astype(np.float32)
    t = TorchIVF(r, nlist=8, col_block=128, device="cpu")
    j = JaxIVF(r, nlist=8, col_block=128)
    p = TorchSearcher(r, device="cpu")
    for k in (1, 50, 900):
        want = j.global_topk(q, k)
        _same(t.global_topk(q, k), want)
        _same(p.global_topk(q, k), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_saturation_repair_under_pruning(dtype):
    # One query hot against a cluster: its κ budget saturates, the re-search
    # runs over the permuted corpus, the ids map back.
    rng = np.random.RandomState(3)
    r, truth = clustered_ints(rng, 2048, 16, n_clusters=8)
    q = rng.randint(-2, 3, size=(8, 16)).astype(np.float32)
    q[3] = r[truth == 2][0] * 3
    j, t, p = _pair(r, dtype, truth=truth, col_block=128)
    _search_all(j, t, p, q, 600, kappa=64)
    assert t.last_stats["corpus_rows"] >= 1


def test_small_corpus_and_fallbacks():
    rng = np.random.RandomState(4)
    r = rng.randint(-3, 4, size=(300, 8)).astype(np.float32)
    q = rng.randint(-3, 4, size=(9, 8)).astype(np.float32)
    t = TorchIVF(r, nlist=4, col_block=128, device="cpu")
    j = JaxIVF(r, nlist=4, col_block=128)
    _same(t.global_topk(q, 25), j.global_topk(q, 25))
    assert t.last_search_stats is None and j.last_search_stats is None  # < 4 blocks
    assert t.global_topk(q, 0)[0].size == 0 and t.last_search_stats is None
    assert t.global_topk(q[:0], 5)[0].size == 0
    # k beyond every row's κ candidates: τ = −inf, the full-scan fallback.
    r, truth = clustered_ints(rng, 1024, 8, n_clusters=8)
    j, t, p = _pair(r, truth=truth, col_block=128)
    _search_all(j, t, p, r[:4], 900, kappa=8)
    assert t.last_search_stats["pruned"] is False
    # A wide probe (every block): the plain collection.
    j, t, p = _pair(r, truth=truth, col_block=128, nprobe=8)
    _search_all(j, t, p, r[::100], 50)
    assert t.last_search_stats == {"n_blocks": 8, "probed": 8, "certified_extra": 0,
                                   "pruned": False}


def test_row_topk_and_row_nn_remap():
    rng = np.random.RandomState(5)
    r, truth = clustered_ints(rng, 1024, 16, n_clusters=8)
    j, t, _ = _pair(r, truth=truth, col_block=128)
    q = (r[[7, 500, 1011]] * 5).astype(np.float32)
    sc, ids = t.row_topk(q, 3)
    jsc, jids = j.row_topk(q, 3)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(sc, jsc)
    dense = q @ r.T
    np.testing.assert_array_equal(np.take_along_axis(dense, ids, axis=1), sc)
    np.testing.assert_array_equal(t.row_nn(q), dense.max(axis=1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_append_and_keep_equal_jax(dtype):
    rng = np.random.RandomState(7)
    r1, truth = clustered_ints(rng, 1536, 16, n_clusters=8)
    r2 = rng.randint(-8, 9, size=(200, 16)).astype(np.float32)
    q = rng.randint(-6, 7, size=(13, 16)).astype(np.float32)
    j, t, _ = _pair(r1, dtype, truth=truth, col_block=128)
    _same(t.global_topk(q, 10), j.global_topk(q, 10))
    t.append_rows(r2)
    j.append_rows(r2)
    both = np.concatenate([r1, r2])
    plain = TorchSearcher(both, dtype=dtype, device="cpu")
    for k in (1, 64, 1200):
        _search_all(j, t, plain, q, k)
    keep = np.sort(rng.choice(both.shape[0], size=900, replace=False))
    t.keep_rows(keep)
    j.keep_rows(keep)
    np.testing.assert_array_equal(t._perm, j._perm)
    fresh = TorchSearcher(both[keep], dtype=dtype, device="cpu")
    for k in (1, 64, 700):
        _search_all(j, t, fresh, q, k)
    with pytest.raises(ValueError):
        t.keep_rows([5, 3])


def test_default_nlist_nprobe_and_layout():
    rng = np.random.RandomState(8)
    r, _ = clustered_ints(rng, 2600, 8, n_clusters=4)
    for kw in ({}, {"col_block": 256}):
        t = TorchIVF(r, device="cpu", **kw)
        j = JaxIVF(r, **kw)
        assert (t.nlist, t.col_block, t._refs.shape[0]) == (j.nlist, j.col_block,
                                                            j._refs.shape[0])
        n_blocks = t._refs.shape[0] // t.col_block
        assert t._effective_nprobe(n_blocks) == j._effective_nprobe(n_blocks)
    with pytest.raises(ValueError, match="IP"):
        TorchIVF(np.zeros((16, 4), np.float32), nlist=2, metric="L2", device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        TorchIVF(r, col_block=100, device="cpu")


# ---- the index, score normalization and the server ------------------------------


def _vf(cls, vid, f):
    return cls(video_id=vid, timestamps=np.arange(f.shape[0], dtype=np.float64), feature=f)


def _records(results):
    return sorted((pm.query_id, pm.ref_id,
                   tuple((m.query_timestamps, m.ref_timestamps, m.score) for m in pm.matches))
                  for pm in results)


def test_video_index_codecs_as_jax():
    for codec, dtype, nlist in (("IVF32,SQ8", "int8", 32), ("IVF32", "float32", 32),
                                ("IVF8,Flat", "float32", 8)):
        t, j = TorchIndex(8, codec_str=codec, device="cpu"), JaxIndex(8, codec_str=codec)
        assert (t.dtype, t._ivf_nlist) == (j.dtype, j._ivf_nlist) == (dtype, nlist)
    for bad in ("IVF32,PQ4", "HNSW32"):
        with pytest.raises(ValueError, match="Unsupported codec"):
            TorchIndex(8, codec_str=bad, device="cpu")
    with pytest.raises(ValueError, match="single-chip"):
        TorchIndex(8, codec_str="IVF16", mesh=Mesh(["cpu"] * 2))
    index = TorchIndex(4, codec_str="IVF2", metric="L2", device="cpu")
    index.add([_vf(TVF, "R0", np.ones((16, 4), np.float32))])
    with pytest.raises(ValueError, match="IP"):
        index.search([_vf(TVF, "Q0", np.ones((2, 4), np.float32))], global_k=3)


@pytest.mark.parametrize("codec", ["IVF6,Flat", "IVF6,SQ8"])
def test_video_index_ivf_equals_flat_and_jax(codec):
    rng = np.random.RandomState(10)
    feats, _ = clustered_ints(rng, 900, 16, n_clusters=6)
    q = feats[:40] + rng.randint(-1, 2, (40, 16)).astype(np.float32)
    flat_codec = "SQ8" if codec.endswith("SQ8") else "Flat"
    results = {}
    for name, cls, index in (
            ("torch", TVF, TorchIndex(16, codec_str=codec, device="cpu")),
            ("jax", JVF, JaxIndex(16, codec_str=codec)),
            ("flat", TVF, TorchIndex(16, codec_str=flat_codec, device="cpu"))):
        index.add([_vf(cls, i, feats[i * 90 : (i + 1) * 90]) for i in range(10)])
        results[name] = _records(index.search([_vf(cls, 0, q)], global_k=50))
    assert results["torch"] == results["jax"] == results["flat"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_sn_ivf_equals_flat_and_jax(dtype):
    # tests/test_ivf.py TestIVFScoreNormalized: >= 4 column blocks of 8,192
    # rows, one focused query video; the rows laid out so that the index's
    # k-means seed (0) is clean on both sides.
    rng = np.random.RandomState(12)
    n, d, fpv = 33000, 24, 825
    r, assign = clean_layout(*clustered_ints(rng, n, d, n_clusters=8), nlist=8)
    noise_rows = [rng.randint(-4, 5, size=(50, d)).astype(np.float32) for _ in range(3)]
    qf = r[assign == 0][:40]
    sides = {}
    for name, cls, mod, kw in (("jax", JVF, JaxSNIndex, {}),
                               ("torch", TVF, TorchSNIndex, {"device": "cpu"})):
        refs = [_vf(cls, i, r[i * fpv : (i + 1) * fpv]) for i in range(n // fpv)]
        noise = [_vf(cls, 1000 + i, f) for i, f in enumerate(noise_rows)]
        ivf = mod(d, noise, beta=1.2, codec_str="IVF8", dtype=dtype, **kw)
        ivf.add(refs)
        flat = None
        if name == "torch":
            flat = mod(d, noise, beta=1.2, dtype=dtype, **kw)
            flat.add(refs)
        sides[name] = (ivf, flat, [_vf(cls, 0, qf)])
    got = {name: _records(ivf.search(q, global_k=500)) for name, (ivf, _, q) in sides.items()}
    assert got["torch"] == _records(sides["torch"][1].search(sides["torch"][2], global_k=500))
    assert len(got["torch"]) == len(got["jax"]) > 0
    for (qi, ri, tm), (qj, rj, jm) in zip(got["torch"], got["jax"]):
        assert (qi, ri) == (qj, rj) and len(tm) == len(jm)
        for a, b in zip(tm, jm):
            assert a[:2] == b[:2] and abs(a[2] - b[2]) <= FLOAT_ATOL
    t_sn, j_sn = sides["torch"][0]._searcher, sides["jax"][0]._searcher
    np.testing.assert_array_equal(t_sn.searcher._perm, j_sn.searcher._perm)
    assert t_sn.searcher.last_search_stats["pruned"] is True
    assert t_sn.searcher.last_search_stats == j_sn.searcher.last_search_stats
    # The IVF searcher takes no fused path: the bias stays unrounded in f32.
    np.testing.assert_allclose(t_sn.last_q_sn.numpy(), np.asarray(j_sn.last_q_sn),
                               atol=FLOAT_ATOL, rtol=0)
    assert t_sn.last_q_sn.dtype == torch.float32
    if dtype == "bfloat16":
        bias = t_sn.last_q_sn[:, -1]
        assert not torch.equal(bias, bias.to(torch.bfloat16).float())


def test_sn_ivf_mutations_stay_exact():
    rng = np.random.RandomState(13)
    d = 16
    base = [rng.randint(-4, 5, (30, d)).astype(np.float32) for _ in range(6)]
    more = [rng.randint(-4, 5, (25, d)).astype(np.float32) for _ in range(2)]
    noise = rng.randint(-4, 5, (40, d)).astype(np.float32)
    q = base[2][:12].copy()

    def build(cls, mod, codec, vids, **kw):
        index = mod(d, [_vf(cls, 100, noise)], codec_str=codec, **kw)
        index.add([_vf(cls, v, base[v] if v < 10 else more[v - 10]) for v in vids])
        return index

    t = build(TVF, TorchSNIndex, "IVF4", range(6), device="cpu")
    j = build(JVF, JaxSNIndex, "IVF4", range(6))
    for index, cls in ((t, TVF), (j, JVF)):
        index.search([_vf(cls, 0, q)], global_k=10)
        index.add([_vf(cls, 10 + i, f) for i, f in enumerate(more)])
        index.remove([1])
    fresh = build(TVF, TorchSNIndex, "Flat", [0, 2, 3, 4, 5, 10, 11], device="cpu")
    got = _records(t.search([_vf(TVF, 0, q)], global_k=60))
    assert got == _records(fresh.search([_vf(TVF, 0, q)], global_k=60))
    want = _records(j.search([_vf(JVF, 0, q)], global_k=60))
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want]


def _assert_rows_close(a, b, tol):
    """Two matches CSVs: the same rows but for scores within tol."""
    ra, rb = (list(csv.reader(open(path, newline=""))) for path in (a, b))
    assert ra[0] == rb[0] and len(ra) == len(rb) > 1
    score = ra[0].index("score")
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:score] + x[score + 1:] == y[:score] + y[score + 1:]
        assert abs(float(x[score]) - float(y[score])) <= tol


@pytest.fixture(scope="module")
def ivf_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ivf_serve")
    rng = np.random.RandomState(15)
    d = 16
    refs = [_vf(JVF, f"R{i:06d}", rng.randint(-4, 5, (30, d)).astype(np.float32))
            for i in range(8)]
    noise = [_vf(JVF, "R000100", rng.randint(-4, 5, (40, d)).astype(np.float32))]
    q = [_vf(JVF, "Q000000", refs[3].feature[:12].copy())]
    paths = {k: str(root / f"{k}.npz") for k in ("r", "n", "q")}
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    store_features(paths["q"], q, Dataset.QUERIES)
    paths["root"] = root
    return paths


@pytest.mark.parametrize("flags", [["--ivf", "4"], ["--f32", "--ivf", "0", "--ivf_nprobe", "2"],
                                   ["--int8", "--ivf", "4"]])
def test_serve_ivf_equals_jax_server(ivf_files, flags):
    root = ivf_files["root"]
    argv = ["--ref_features", ivf_files["r"], "--score_norm_features", ivf_files["n"],
            "--matches", *flags]
    jargs = jax_serve.parser.parse_args(argv)
    targs = torch_serve.parser.parse_args(argv + ["--device", "cpu"])
    j_index, j_refs, _ = jax_serve.build_index(jargs)
    t_index, t_refs, _ = torch_serve.build_index(targs, CPU)
    j_loc = jax_serve.build_localizer(j_index, j_refs, jargs)
    t_loc = torch_serve.build_localizer(t_index, t_refs, targs, CPU)
    assert isinstance(t_index._get_searcher().searcher, TorchIVF)
    assert t_index._get_searcher().searcher.nlist == j_index._get_searcher().searcher.nlist
    replies = {}
    for side, args, index, loc, mod, agg in (("jax", jargs, j_index, j_loc, jax_serve, JaxAgg()),
                                              ("torch", targs, t_index, t_loc, torch_serve,
                                               TorchAgg())):
        out = root / side / "_".join(flags).replace("-", "")
        out.mkdir(parents=True, exist_ok=True)
        replies[side] = (mod.serve_request(
            index, agg, loc, f"{ivf_files['q']}\t{out}/c.csv\t{out}/m.csv", args), out)
    (jr, jd), (tr, td) = replies["jax"], replies["torch"]
    assert _strip(tr, root).replace(str(td), "@") == _strip(jr, root).replace(str(jd), "@")
    assert (td / "c.csv").read_bytes() == (jd / "c.csv").read_bytes()
    assert (td / "c.csv").read_bytes().count(b"\n") > 1
    _assert_rows_close(td / "m.csv", jd / "m.csv", FLOAT_ATOL)


def test_serve_ivf_with_sharded_raises_as_jax(ivf_files):
    argv = ["--ref_features", ivf_files["r"], "--sharded", "--ivf", "4"]
    with pytest.raises(ValueError, match="single-chip"):
        torch_serve.build_index(torch_serve.parser.parse_args(argv + ["--device", "cpu"]),
                                CPU)


def test_serve_ivf_equals_the_plain_server_at_bf16(ivf_files):
    # The bf16 default with and without --ivf: the candidates byte for byte
    # (the search rounds the bias in both), the matches' rows the same with
    # scores within IVF_BIAS_ATOL, through a removal.
    root = ivf_files["root"]
    base = ["--ref_features", ivf_files["r"], "--score_norm_features", ivf_files["n"],
            "--matches", "--device", "cpu"]
    outs = {}
    for name, flags in (("plain", []), ("ivf", ["--ivf", "4"])):
        args = torch_serve.parser.parse_args(base + flags)
        index, refs, _ = torch_serve.build_index(args, CPU)
        loc = torch_serve.build_localizer(index, refs, args, CPU)
        out = root / "bf16" / name
        out.mkdir(parents=True, exist_ok=True)
        for line in (f"{ivf_files['q']}\t{out}/a_c.csv\t{out}/a_m.csv", "remove\tR000002",
                     f"{ivf_files['q']}\t{out}/g_c.csv\t{out}/g_m.csv"):
            assert torch_serve.serve_request(index, TorchAgg(), loc, line, args).startswith("ok")
        outs[name] = out
    for x in "ag":
        plain, ivf = (outs[n] / f"{x}_c.csv" for n in ("plain", "ivf"))
        assert ivf.read_bytes() == plain.read_bytes() and plain.read_bytes().count(b"\n") > 1
        _assert_rows_close(outs["ivf"] / f"{x}_m.csv", outs["plain"] / f"{x}_m.csv",
                           IVF_BIAS_ATOL)
