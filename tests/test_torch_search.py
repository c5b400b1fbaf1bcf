"""The port's SimilaritySearcher against the JAX searcher.

On integer-valued inputs every score is exact on both sides, so
``global_topk`` must return IDENTICAL (q, r, score) arrays, tie order
included. On random floats XLA and torch round differently, so the
result is held as a set against the port's own dense oracle, with a
stated tolerance at the k-th score.
"""

import numpy as np
import pytest
import torch

from vsc2022_torch.convert import searcher_from_arrays
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher


def _int_case(nq, n, d, seed, plant_amb=False):
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, size=(nq, d)).astype(np.float32)
    r = rng.randint(-3, 4, size=(n, d)).astype(np.float32)
    if plant_amb:
        # Near-duplicate columns inside one 128-column segment, copied by
        # some queries: several entries ≥ τ share a segment (amb > 0) and
        # the pool can hide some of them.
        base = np.full(d, 3.0, np.float32)
        for j in range(10, 20):
            r[j] = base
            r[j, j % d] = 2.0
        q[1] = base
        q[4] = base
        q[4, 0] = 2.0
    return q, r


def _both(q, r, k, kappa=None):
    js = JaxSearcher(r)
    expect = js.global_topk(q, k, kappa=kappa)
    ts = searcher_from_arrays(
        np.asarray(js._refs), int(js._n_valid), np.asarray(js._ref_sq),
        device="cpu",
    )
    got = ts.global_topk(q, k, kappa=kappa)
    return expect, got, ts


def _assert_identical(expect, got):
    for e, g in zip(expect, got):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype


@pytest.mark.parametrize(
    "nq,n,d,k,kappa,plant",
    [
        (37, 3011, 24, 500, None, True),  # default κ, planted amb rows
        (23, 8192, 24, 700, 32, True),  # several segments per row ≥ τ
        (40, 8192, 16, 3000, 4, False),  # κ saturation: pool repairs
        (40, 1000, 16, 3000, 4, False),  # pool smaller than k: τ = −inf
        (16, 700, 8, 900, 2, True),  # tiny κ, many exact ties
        (5, 100, 8, 10000, None, False),  # k ≥ total; corpus < 128
        (9, 50, 8, 40, None, True),  # corpus < 128, k < total
    ],
)
def test_global_topk_identical_to_jax_on_integers(nq, n, d, k, kappa, plant):
    q, r = _int_case(nq, n, d, seed=nq + n, plant_amb=plant)
    expect, got, _ = _both(q, r, k, kappa)
    _assert_identical(expect, got)


def test_repair_routes_are_exercised(monkeypatch):
    # The pooled collection's routes (these corpora stream by default).
    monkeypatch.setenv("VSC2022_TORCH_COLLECTION", "pooled")
    q, r = _int_case(40, 8192, 16, seed=3, plant_amb=True)
    _, _, ts = _both(q, r, 3000, kappa=4)
    stats = ts.last_stats
    assert stats["pool_repair_rows"] > 0
    assert stats["amb_rows"] > 0
    q, r = _int_case(37, 3011, 24, seed=1, plant_amb=True)
    _, _, ts = _both(q, r, 500)
    assert ts.last_stats["corpus_rows"] > 0


def test_corpus_research_tolerates_kernel_rounding(monkeypatch):
    """The kernels may round a score above what the corpus re-search's
    ``torch.matmul`` gives for the same pair. Simulated here by adding δ
    (a quarter of the searcher's rounding margin) to the pool and the
    count: the re-searched row must still yield the exact top k (the
    pooled collection; tests/test_torch_stream.py holds the stream's)."""
    from vsc2022_torch.ops import kernels

    monkeypatch.setenv("VSC2022_TORCH_COLLECTION", "pooled")
    d, k = 24, 3
    rng = np.random.RandomState(5)
    q = rng.randn(6, d).astype(np.float32)
    r = rng.randn(3011, d).astype(np.float32)
    base = rng.randn(d).astype(np.float32)
    q[1] = 2 * base
    slack = (d * np.finfo(np.float32).eps * np.linalg.norm(q[1])
             * np.linalg.norm(r, axis=1).max())
    delta = float(slack / 4)
    # Row 1 scores columns 10-12 (segment 0) and 200 (segment 1) far
    # above the rest, at y + 2.5δ, y + 0.6δ, y + 0.3δ and y: the pool's
    # k-th value is y + δ, and column 12 hides behind segment 0's two
    # slots, so row 1 is counted and re-searched.
    sq = float(q[1] @ base)
    for j, t in ((10, 2.5), (11, 0.6), (12, 0.3), (200, 0.0)):
        r[j] = base * (1 + t * delta / sq)

    pool_writer = kernels.pool_writer

    def pool_up(q, refs, n_valid):
        vals, ids = pool_writer(q, refs, n_valid)
        return vals + delta, ids

    def count_up(q, refs, tau, n_valid):
        s = torch.matmul(q, refs[:n_valid].T) + delta
        return (s >= tau).sum(1, dtype=torch.int32)

    monkeypatch.setattr(kernels, "pool_writer", pool_up)
    monkeypatch.setattr(kernels, "count_above", count_up)
    ts = TorchSearcher(r, device="cpu")
    # κ = 8: 4κ within the 48-slot pool, so the forced pooled mode holds.
    qi, ri, s = ts.global_topk(q, k, kappa=8)
    assert ts.last_stats["mode"] == "pooled"
    assert ts.last_stats["corpus_rows"] == 1
    oq, orr, os_ = _dense_oracle(q, r, k)
    assert list(zip(qi, ri)) == list(zip(oq, orr)) == [(1, 10), (1, 11), (1, 12)]
    np.testing.assert_allclose(s, os_, rtol=0, atol=1e-5)
    # Without the margin the re-searched row loses its entries below y + δ.
    ts._ref_norm_max = 0.0
    assert len(ts.global_topk(q, k, kappa=8)[0]) < k


def _dense_oracle(q, r, k):
    s = torch.from_numpy(q) @ torch.from_numpy(r).T
    flat = s.numpy().ravel()
    order = np.lexsort(
        (np.arange(flat.size) % r.shape[0], np.arange(flat.size) // r.shape[0], -flat)
    )[:k]
    return order // r.shape[0], order % r.shape[0], flat[order]


@pytest.mark.parametrize("nq,n,d,k", [(50, 4000, 32, 2000), (64, 300, 16, 5000)])
def test_global_topk_random_floats_match_dense_oracle(nq, n, d, k):
    rng = np.random.RandomState(nq * n)
    q = rng.randn(nq, d).astype(np.float32)
    r = rng.randn(n, d).astype(np.float32)
    qi, ri, s = TorchSearcher(r, device="cpu").global_topk(q, k)
    oq, orr, os_ = _dense_oracle(q, r, k)
    assert len(qi) == k
    # Scores are sorted best-first and agree with the oracle's.
    assert (np.diff(s) <= 0).all()
    np.testing.assert_allclose(s, os_, rtol=0, atol=1e-5)
    # Same (q, r) set, except pairs within 1e-5 of the k-th score, where
    # a different f32 summation order may swap members.
    kth = os_[-1]
    got = {(a, b) for a, b, v in zip(qi, ri, s) if v > kth + 1e-5}
    want = {(a, b) for a, b, v in zip(oq, orr, os_) if v > kth + 1e-5}
    assert got == want


def test_global_topk_against_jax_random_floats():
    rng = np.random.RandomState(7)
    q = rng.randn(30, 24).astype(np.float32)
    r = rng.randn(2500, 24).astype(np.float32)
    (eq, er, es), (gq, gr, gs), _ = _both(q, r, 1500)
    np.testing.assert_allclose(gs, es, rtol=0, atol=1e-5)
    kth = es[-1]
    assert {(a, b) for a, b, v in zip(gq, gr, gs) if v > kth + 1e-5} == {
        (a, b) for a, b, v in zip(eq, er, es) if v > kth + 1e-5
    }


@pytest.mark.parametrize("kind", ["int", "float"])
def test_row_nn_matches_jax(kind):
    rng = np.random.RandomState(11)
    if kind == "int":
        q, r = _int_case(33, 777, 16, seed=11)
    else:
        q = rng.randn(33, 16).astype(np.float32)
        r = rng.randn(777, 16).astype(np.float32)
    expect = JaxSearcher(r).row_nn(q)
    got = TorchSearcher(r, device="cpu").row_nn(q)
    if kind == "int":
        np.testing.assert_array_equal(got, expect)
    else:
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5)


def test_row_topk_matches_jax():
    rng = np.random.RandomState(12)
    q = rng.randn(20, 16).astype(np.float32)
    r = rng.randn(500, 16).astype(np.float32)
    es, ei = JaxSearcher(r).row_topk(q, 7)
    gs, gi = TorchSearcher(r, device="cpu").row_topk(q, 7)
    np.testing.assert_array_equal(gi, ei)
    np.testing.assert_allclose(gs, es, rtol=0, atol=1e-5)


def test_empty_and_unported_modes():
    r = np.ones((10, 4), np.float32)
    ts = TorchSearcher(r, device="cpu")
    for arr in ts.global_topk(np.zeros((0, 4), np.float32), 5):
        assert arr.size == 0
    for arr in ts.global_topk(np.ones((2, 4), np.float32), 0):
        assert arr.size == 0
    # metric="L2" and precision="default" are ported; int8 storage stays
    # inner product only, as the JAX searcher asserts.
    for kw in ({"metric": "L2"}, {"precision": "default"}):
        assert TorchSearcher(r, device="cpu", **kw).n_refs == 10
    with pytest.raises(NotImplementedError, match="IP"):
        TorchSearcher(r, device="cpu", metric="L2", dtype="int8")
    for kw in ({"metric": "cosine"}, {"precision": "high"}):
        with pytest.raises(ValueError):
            TorchSearcher(r, device="cpu", **kw)
    # int8 (SQ8) storage is ported: it stages codes and runs the same
    # empty-query and k = 0 contracts.
    i8 = TorchSearcher(r, device="cpu", dtype="int8")
    assert i8._refs.dtype == torch.int8 and i8.n_refs == 10
    for arr in i8.global_topk(np.zeros((0, 4), np.float32), 5):
        assert arr.size == 0
    for arr in i8.global_topk(np.ones((2, 4), np.float32), 0):
        assert arr.size == 0
