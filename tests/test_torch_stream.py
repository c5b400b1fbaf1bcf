"""The port's streaming collection against the JAX package.

``fused_topk_plain`` (the CPU side of the ``fused_topk`` kernel) against
the JAX Pallas ``fused_topk`` in interpret mode; the streaming
``global_topk`` against the JAX searcher routed through that kernel
(``VSC2022_TPU_USE_PALLAS=interpret``, ``VSC2022_TPU_COLLECTION=stream``);
the collection-mode routing; and corpus growth and compaction on the
staged searcher. On integer-valued inputs every score is exact on both
sides, so selections are compared for identity, tie order included.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc2022_torch.ops import kernels
from vsc2022_torch.ops import similarity as torch_similarity
from vsc2022_torch.ops.similarity import COLLECTION_ENV
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_tpu.ops.pallas_kernels import SEG_LANES, fused_topk
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)


@pytest.mark.parametrize("m,n,d,n_valid,kappa", [
    (24, 2048, 16, 2000, 16),  # ragged valid columns
    (9, 1000, 8, 1000, 40),  # N not a multiple of the tile or the segment
    (5, 300, 8, 290, 7),  # more κ than some rows' winners need
])
def test_fused_topk_plain_identical_to_jax_on_distinct_scores(m, n, d, n_valid, kappa):
    # One-hot queries against permuted-integer columns: every score of a
    # row is a distinct integer, so the candidate set, its order and the
    # ids are fully determined on both sides.
    rng = np.random.RandomState(m + n)
    q = np.zeros((m, d), np.float32)
    q[np.arange(m), np.arange(m) % d] = 1.0
    r = np.stack([rng.permutation(n) for _ in range(d)], axis=1).astype(np.float32)
    es, ei = fused_topk(jnp.asarray(q), jnp.asarray(r), jnp.int32(n_valid), kappa,
                        interpret=True)
    gs, gi = kernels.fused_topk_plain(torch.from_numpy(q), torch.from_numpy(r),
                                      n_valid, kappa)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(es))
    finite = np.isfinite(np.asarray(es))
    np.testing.assert_array_equal(gi.numpy()[finite], np.asarray(ei)[finite])
    assert (gi.numpy()[~finite] == 0).all()


def test_fused_topk_candidate_properties():
    # TestFusedTopK.test_candidate_properties, on the port's plain version.
    rng = np.random.RandomState(2)
    m, n, d, k = 24, 8192, 32, 16
    q = rng.randn(m, d).astype(np.float32)
    r = rng.randn(n, d).astype(np.float32)
    n_valid = n - 100
    dense = q @ r[:n_valid].T
    s, i = kernels.fused_topk_plain(torch.from_numpy(q), torch.from_numpy(r),
                                    n_valid, k)
    s, i = s.numpy(), i.numpy()
    finite = s > -np.inf
    assert (i[finite] < n_valid).all()
    for row in range(m):
        np.testing.assert_allclose(dense[row, i[row][finite[row]]],
                                   s[row][finite[row]], rtol=1e-4)
    np.testing.assert_allclose(s[:, 0], dense.max(axis=1), rtol=1e-5)
    for row in range(m):
        assert (np.diff(s[row][finite[row]]) <= 0).all()
    exact = np.argsort(-dense, axis=1)[:, :k]
    recall = np.mean([len(set(i[r][finite[r]]) & set(exact[r])) / k for r in range(m)])
    assert recall > 0.9


def test_fused_topk_spikes_in_distinct_segments_are_exact():
    # TestFusedTopK.test_spikes_in_distinct_segments_are_exact.
    rng = np.random.RandomState(3)
    m, n, d, k = 8, 2048, 16, 8
    q = np.zeros((m, d), np.float32)
    r = 0.01 * rng.randn(n, d).astype(np.float32)
    expect_i = np.empty((m, k), dtype=np.int64)
    for row in range(m):
        q[row, row] = 1.0
        for spike in range(k):
            col = spike * 2 * SEG_LANES + row
            r[col] = 0.0
            r[col, row] = 1.0 + (k - spike)
            expect_i[row, spike] = col
    _, i = kernels.fused_topk_plain(torch.from_numpy(q), torch.from_numpy(r), n, k)
    np.testing.assert_array_equal(i.numpy(), expect_i)


def _plant_ties(q, r):
    """Near-duplicate columns inside one segment, copied by some queries:
    several entries ≥ τ share a segment, so the candidates miss some and
    the exact counts flag those rows."""
    base = np.full(q.shape[1], 3.0, np.float32)
    r[10:20] = base
    q[1] = base
    q[4] = base


@pytest.mark.parametrize("nq,n,d,k,kappa", [
    (29, 2711, 20, 400, None),  # default κ, planted ties
    (31, 1537, 12, 900, 4),  # κ saturation: many deficient rows
    (11, 905, 8, 60, 4),  # k > nq·κ: τ = −inf, every row searched
    (7, 101, 8, 500, None),  # corpus < 128, k ≥ total
])
def test_streaming_global_topk_identical_to_jax(monkeypatch, nq, n, d, k, kappa):
    # Shapes used nowhere else: jit bakes the routing in per shape.
    monkeypatch.setenv("VSC2022_TPU_USE_PALLAS", "interpret")
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", "stream")
    monkeypatch.setenv(COLLECTION_ENV, "stream")
    q, r = _ints((nq, d), nq), _ints((n, d), n)
    _plant_ties(q, r)
    expect = JaxSearcher(r).global_topk(q, k, kappa=kappa)
    ts = TorchSearcher(r, device="cpu")
    got = ts.global_topk(q, k, kappa=kappa)
    assert ts.last_stats["mode"] == "stream"
    for e, g in zip(expect, got):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype
    if k > nq * ts.last_stats["kappa"]:
        assert ts.last_stats["tau"] == float("-inf")
    if kappa == 4 and k < nq * kappa:
        assert ts.last_stats["corpus_rows"] > 0


def test_stream_research_tolerates_kernel_rounding(monkeypatch):
    """As test_torch_search.test_corpus_research_tolerates_kernel_rounding,
    for the streaming collection: the candidates and the counts round δ
    above the re-search's ``torch.matmul``; the re-searched row must
    still give the exact top k."""
    d, k = 24, 3
    rng = np.random.RandomState(5)
    q = rng.randn(6, d).astype(np.float32)
    r = rng.randn(3011, d).astype(np.float32)
    base = rng.randn(d).astype(np.float32)
    q[1] = 2 * base
    slack = (d * np.finfo(np.float32).eps * np.linalg.norm(q[1])
             * np.linalg.norm(r, axis=1).max())
    delta = float(slack / 4)
    sq = float(q[1] @ base)
    for j, t in ((10, 2.5), (11, 0.6), (12, 0.3), (200, 0.0)):
        r[j] = base * (1 + t * delta / sq)
    topk = kernels.fused_topk

    def topk_up(q, refs, n_valid, kappa):
        vals, ids = topk(q, refs, n_valid, kappa)
        return vals + delta, ids

    def count_up(q, refs, tau, n_valid):
        s = torch.matmul(q, refs[:n_valid].T) + delta
        return (s >= tau).sum(1, dtype=torch.int32)

    monkeypatch.setattr(kernels, "fused_topk", topk_up)
    monkeypatch.setattr(kernels, "count_above", count_up)
    ts = TorchSearcher(r, device="cpu")
    qi, ri, s = ts.global_topk(q, k, kappa=8)
    assert ts.last_stats["mode"] == "stream"
    assert ts.last_stats["corpus_rows"] == 1
    assert list(zip(qi, ri)) == [(1, 10), (1, 11), (1, 12)]
    ts._ref_norm_max = 0.0
    assert len(ts.global_topk(q, k, kappa=8)[0]) < k


def test_bf16_stream_research_margin_covers_the_tensor_cores(monkeypatch):
    """As test_stream_research_tolerates_kernel_rounding, over a bf16
    corpus. There the re-search shares the kernels' product, so its margin
    is only defensive: TENSOR_CORE_SLACK times the f32 one, what a
    re-search by an f32 sum would need against the tensor cores. Stand-in
    kernels score δ above the re-search: with δ between the f32 margin S
    and 2S, the f32 margin loses a pair the kernels counted, and the
    tensor-core margin keeps it."""
    d, k = 24, 3
    rng = np.random.RandomState(6)
    q = (0.01 * rng.randn(6, d)).astype(np.float32)
    r = (0.01 * rng.randn(3011, d)).astype(np.float32)
    q[:, 1] = 0.0
    q[1] = 0.0
    q[1, 0] = 1.0
    r[3000] = 0.0
    r[3000, 1] = 1000.0  # max ‖r‖ = 1000 widens the margin; scores 0
    # Row 1 scores columns 10-12 (segment 0) and 200 (segment 1) far above
    # the rest, at bf16 values y + 8, 4 and 1 ulps and y. The kernels
    # report δ more: τ = y + δ, segment 0 hides column 12, so row 1 is
    # counted and re-searched from y + δ − margin.
    ulp = 2.0 ** -9
    y = 0.25
    for j, t in ((10, 8), (11, 4), (12, 1), (200, 0)):
        r[j] = 0.0
        r[j, 0] = y + t * ulp
    ts = TorchSearcher(r, dtype="bfloat16", device="cpu")
    slack = d * float(np.finfo(np.float32).eps) * ts._ref_norm_max
    assert ts._ref_norm_max == 1000.0
    delta = ulp + 1.5 * slack  # y + ulp lies between the two floors
    topk = kernels.fused_topk

    def topk_up(q, refs, n_valid, kappa):
        vals, ids = topk(q, refs, n_valid, kappa)
        return vals + delta, ids

    def count_up(q, refs, tau, n_valid):
        s = torch.matmul(q.float(), refs[:n_valid].float().T) + delta
        return (s >= tau).sum(1, dtype=torch.int32)

    monkeypatch.setattr(kernels, "fused_topk", topk_up)
    monkeypatch.setattr(kernels, "count_above", count_up)
    monkeypatch.setenv(COLLECTION_ENV, "stream")
    qi, ri, s = ts.global_topk(q, k, kappa=8)
    assert ts.last_stats["corpus_rows"] == 1
    assert list(zip(qi, ri)) == [(1, 10), (1, 11), (1, 12)]
    np.testing.assert_array_equal(s, np.float32([y + 8 * ulp, y + 4 * ulp, y + ulp]))
    # The f32 margin alone loses column 12.
    monkeypatch.setattr(torch_similarity, "TENSOR_CORE_SLACK", 1.0)
    qi, ri, _ = ts.global_topk(q, k, kappa=8)
    assert (1, 12) not in set(zip(qi, ri))


def test_int8_stream_research_margin_covers_the_tensor_cores(monkeypatch):
    """As test_bf16_stream_research_margin_covers_the_tensor_cores, over an
    int8 corpus, whose kernels add 3·D exact products (the query split into
    three bf16 terms). Stand-in kernels score δ above the re-search, δ the
    derived worst case of the tensor cores against an f32 sum,
    (9·(1 + 2⁻⁷) + 2)·D·u·‖q‖·‖r‖ (_corpus_above): the int8 margin,
    INT8_TENSOR_CORE_SLACK times the f32 one, loses no entry the kernels
    counted, and the bf16 margin does."""
    d, k = 24, 3
    rng = np.random.RandomState(8)
    q = (0.01 * rng.randn(6, d)).astype(np.float32)
    r = (0.01 * rng.randn(3011, d)).astype(np.float32)
    q[:, 1] = 0.0
    q[1] = 0.0
    q[1, 0] = 1.0
    r[3000] = 0.0
    r[3000, 1] = 1000.0  # max ‖r‖ ≈ 1000 widens the margin; scores 0
    # Row 1 scores columns 10-12 (segment 0) and 200 (segment 1) far above
    # the rest. Each of these rows is 127·s at column 0, s dyadic, so its
    # SQ8 scale is s and its score 127·s, exactly: y + 8, 4 and 1 steps and
    # y. The kernels report δ more: τ = y + δ, segment 0 hides column 12,
    # so row 1 is counted and re-searched from y + δ − margin.
    step = 127 * 2.0 ** -18
    y = 127 * 2.0 ** -9
    for j, t in ((10, 8), (11, 4), (12, 1), (200, 0)):
        r[j] = 0.0
        r[j, 0] = y + t * step
    ts = TorchSearcher(r, dtype="int8", device="cpu")
    u = float(np.finfo(np.float32).eps) / 2
    assert 999.0 < ts._ref_norm_max < 1001.0
    bound = (9 * (1 + 2.0 ** -7) + 2) * d * u * ts._ref_norm_max
    delta = step + bound  # y + step lies between the two floors
    topk = kernels.fused_topk

    def topk_up(q, refs, n_valid, kappa, scale=None):
        vals, ids = topk(q, refs, n_valid, kappa, scale=scale)
        return vals + delta, ids

    def count_up(q, refs, tau, n_valid, scale=None):
        s = kernels.scores_plain(q, refs, n_valid, scale=scale) + delta
        return (s >= tau).sum(1, dtype=torch.int32)

    monkeypatch.setattr(kernels, "fused_topk", topk_up)
    monkeypatch.setattr(kernels, "count_above", count_up)
    monkeypatch.setenv(COLLECTION_ENV, "stream")
    qi, ri, s = ts.global_topk(q, k, kappa=8)
    assert ts.last_stats["corpus_rows"] == 1
    assert list(zip(qi, ri)) == [(1, 10), (1, 11), (1, 12)]
    np.testing.assert_array_equal(s, np.float32([y + 8 * step, y + 4 * step, y + step]))
    # The bf16 margin alone loses column 12.
    monkeypatch.setattr(torch_similarity, "INT8_TENSOR_CORE_SLACK",
                        torch_similarity.TENSOR_CORE_SLACK)
    qi, ri, _ = ts.global_topk(q, k, kappa=8)
    assert (1, 12) not in set(zip(qi, ri))


def test_bf16_pooled_research_margin_covers_the_tensor_cores(monkeypatch):
    """The pooled counterpart: over a bf16 corpus the pooled re-search,
    too, takes the defensive TENSOR_CORE_SLACK times the f32 margin, here
    against stand-ins for pool_writer and the count of the ambiguous rows
    that score δ above the re-search. Row 1's
    segment 0 holds columns 10-12 above the rest, so the pool keeps 10 and
    11 and hides 12; with δ between the f32 margin S and 2S, the f32
    margin loses the hidden pair the kernels counted, and the tensor-core
    margin keeps it."""
    d, k = 24, 3
    rng = np.random.RandomState(7)
    q = (0.01 * rng.randn(6, d)).astype(np.float32)
    r = (0.01 * rng.randn(3011, d)).astype(np.float32)
    q[:, 1] = 0.0
    q[1] = 0.0
    q[1, 0] = 1.0
    r[3000] = 0.0
    r[3000, 1] = 1000.0  # max ‖r‖ = 1000 widens the margin; scores 0
    # Row 1 scores columns 10-12 (segment 0) and 200 (segment 1) at bf16
    # values y + 8, 4 and 1 ulps and y. The kernels report δ more: τ, the
    # 3rd pool value, is y + δ (column 200); segment 0 holds two entries
    # ≥ τ, so row 1 is ambiguous, its count (4) exceeds its pool count (3),
    # and it is re-searched from y + δ − margin.
    ulp = 2.0 ** -9
    y = 0.25
    for j, t in ((10, 8), (11, 4), (12, 1), (200, 0)):
        r[j] = 0.0
        r[j, 0] = y + t * ulp
    ts = TorchSearcher(r, dtype="bfloat16", device="cpu")
    slack = d * float(np.finfo(np.float32).eps) * ts._ref_norm_max
    assert ts._ref_norm_max == 1000.0
    delta = ulp + 1.5 * slack  # y + ulp lies between the two floors
    pool = kernels.pool_writer

    def pool_up(q, refs, n_valid):
        vals, ids = pool(q, refs, n_valid)
        return vals + delta, ids

    def count_up(q, refs, tau, n_valid):
        s = torch.matmul(q.float(), refs[:n_valid, : q.shape[1]].float().T) + delta
        return (s >= tau).sum(1, dtype=torch.int32)

    monkeypatch.setattr(kernels, "pool_writer", pool_up)
    monkeypatch.setattr(kernels, "count_above", count_up)
    monkeypatch.setenv(COLLECTION_ENV, "pooled")
    qi, ri, s = ts.global_topk(q, k, kappa=8)
    assert ts.last_stats["mode"] == "pooled"
    assert ts.last_stats["amb_rows"] == ts.last_stats["corpus_rows"] == 1
    assert list(zip(qi, ri)) == [(1, 10), (1, 11), (1, 12)]
    np.testing.assert_array_equal(s, np.float32([y + 8 * ulp, y + 4 * ulp, y + ulp]))
    # The f32 margin alone loses column 12.
    monkeypatch.setattr(torch_similarity, "TENSOR_CORE_SLACK", 1.0)
    qi, ri, _ = ts.global_topk(q, k, kappa=8)
    assert (1, 12) not in set(zip(qi, ri))


def test_collection_mode_routes_as_jax(monkeypatch, caplog):
    monkeypatch.delenv("VSC2022_TPU_USE_PALLAS", raising=False)
    monkeypatch.delenv("VSC2022_TPU_COLLECTION", raising=False)
    monkeypatch.delenv(COLLECTION_ENV, raising=False)
    table = []
    for n in (700, 9000, 262_144, 300_000):
        r = np.zeros((n, 2), np.float32)
        js, ts = JaxSearcher(r), TorchSearcher(r, device="cpu")
        assert ts._refs.shape == js._refs.shape
        for m in (8, 9000, 120_000):
            for kappa in (32, 1024, 2048):
                want = js._collection_mode(m, kappa, True)
                want = "pooled" if want == "pooled" else "stream"
                with caplog.at_level(logging.WARNING, logger=torch_similarity.__name__):
                    got = ts._collection_mode(m, kappa)
                table.append((n, m, kappa, want))
                assert got == want, (n, m, kappa)
    modes = {row[-1] for row in table}
    assert modes == {"pooled", "stream"}
    # A pool that would win but does not fit is logged, as the JAX
    # searcher logs it.
    assert any("falls back to streaming" in rec.message for rec in caplog.records)
    # The forced override: "pooled" streams when the pool is infeasible
    # (700 rows: 12 pool slots a row, room for κ ≤ 3).
    ts = TorchSearcher(np.zeros((700, 2), np.float32), device="cpu")
    monkeypatch.setenv(COLLECTION_ENV, "pooled")
    assert ts._collection_mode(8, 3) == "pooled"
    assert ts._collection_mode(8, 4) == "stream"
    monkeypatch.setenv(COLLECTION_ENV, "stream")
    assert ts._collection_mode(8, 3) == "stream"


def test_append_and_keep_rows_land_on_the_jax_layout():
    rng = np.random.RandomState(9)
    base = _ints((150, 8), 1)
    grow = [_ints((n, 8), 2 + n) for n in (10, 200, 8000)]
    js, ts = JaxSearcher(base), TorchSearcher(base, device="cpu")
    rows = base
    for new in grow:
        js.append_rows(new)
        ts.append_rows(new)
        rows = np.concatenate([rows, new])
        np.testing.assert_array_equal(ts._refs.numpy(), np.asarray(js._refs))
        fresh = TorchSearcher(rows, device="cpu")
        assert torch.equal(ts._refs, fresh._refs) and ts.n_refs == fresh.n_refs
    keep = np.flatnonzero(rng.rand(rows.shape[0]) < 0.3)
    js.keep_rows(keep)
    ts.keep_rows(keep)
    np.testing.assert_array_equal(ts._refs.numpy(), np.asarray(js._refs))
    fresh = TorchSearcher(rows[keep], device="cpu")
    assert torch.equal(ts._refs, fresh._refs) and ts.n_refs == keep.size
    q = _ints((13, 8), 99)
    for e, g in zip(fresh.global_topk(q, 200), ts.global_topk(q, 200)):
        np.testing.assert_array_equal(g, e)
    for bad in (keep[::-1], np.array([rows.shape[0] + 5]), keep[None]):
        with pytest.raises(ValueError):
            ts.keep_rows(bad)
