"""Metric L2 on the port against the JAX package.

The JAX searcher scores L2 as the goodness (2 q·r − ‖r‖²) − ‖q‖² with XLA
and returns squared distances; the port computes the same expression on
its kernels' products (``ops/csrc/l2_goodness.cuh``; on the CPU the plain
versions) and in its f32 re-search. On integer-valued inputs every
product, norm and goodness is exact on both sides, so selections and
distances are compared for identity, tie order included (tolerance 0).
The re-search's L2 rounding margin is pinned with stand-in kernels that
score the goodness above the re-search.
"""

import numpy as np
import pytest
import torch

from vsc2022_torch.convert import searcher_from_arrays
from vsc2022_torch.ops import kernels
from vsc2022_torch.ops.similarity import COLLECTION_ENV, _row_sq
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex, VideoIndex
from vsc2022_torch.types import VideoFeature
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher
from vsc2022_tpu.retrieval.index import VideoIndex as JaxVideoIndex

JAX_COLLECTION_ENV = "VSC2022_TPU_COLLECTION"


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)


def _assert_identical(expect, got):
    for e, g in zip(expect, got):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype


def _int_case(seed, n=9000, nq=37, d=12):
    """Integer rows; planted near-duplicate columns in one segment (rows
    that hide entries in the pool and get re-searched)."""
    q, r = _ints((nq, d), seed), _ints((n, d), seed + 1)
    r[10:20] = 2.0
    r[np.arange(10, 20), np.arange(10, 20) % d] = 1.0
    q[1] = q[4] = 2.0
    return q, r


@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_global_topk_identical_to_jax(monkeypatch, dtype, mode):
    # Both collections, then the corpus grown and compacted in place
    # (append_rows, keep_rows): the same (q, r, squared distance) arrays
    # as JAX's, tolerance 0.
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setenv(JAX_COLLECTION_ENV, mode)
    q, r = _int_case(3)
    js = JaxSearcher(r, metric="L2", dtype=dtype)
    ts = TorchSearcher(r, metric="L2", dtype=dtype, device="cpu")
    _assert_identical(js.global_topk(q, 400), ts.global_topk(q, 400))
    assert ts.last_stats["mode"] == mode and ts.last_stats["corpus_rows"] > 0
    extra = _ints((300, 12), 9)
    js.append_rows(extra)
    ts.append_rows(extra)
    keep = np.arange(0, 9300, 2)
    js.keep_rows(keep)
    ts.keep_rows(keep)
    _assert_identical(js.global_topk(q, 250, kappa=8), ts.global_topk(q, 250, kappa=8))
    # The squared norms ride with their rows: a fresh stage of the survivors.
    fresh = TorchSearcher(np.concatenate([r, extra])[keep], metric="L2", dtype=dtype,
                          device="cpu")
    assert torch.equal(ts._ref_sq, fresh._ref_sq)
    assert torch.equal(ts._refs, fresh._refs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_row_topk_and_row_nn_identical_to_jax(dtype):
    # Squared distances, ascending per row, ties to the lower index.
    q, r = _ints((23, 10), 11), _ints((700, 10), 12)
    js = JaxSearcher(r, metric="L2", dtype=dtype)
    ts = TorchSearcher(r, metric="L2", dtype=dtype, device="cpu")
    _assert_identical(js.row_topk(q, 9), ts.row_topk(q, 9))
    np.testing.assert_array_equal(ts.row_nn(q), js.row_nn(q))
    assert (ts.row_nn(q) >= 0).all()


def test_l2_distances_are_squared_euclidean():
    # On floats, against numpy's squared distances (f32 rounding of
    # 2 q·r − ‖r‖² − ‖q‖² at magnitude ~100: 1e-3).
    rng = np.random.RandomState(13)
    q, r = rng.randn(15, 32).astype(np.float32), rng.randn(900, 32).astype(np.float32)
    ts = TorchSearcher(r, metric="L2", device="cpu")
    dist = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(2)
    qi, ri, s = ts.global_topk(q, 50)
    assert np.all(np.diff(s) >= 0)
    np.testing.assert_allclose(s, dist[qi, ri], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts.row_nn(q), dist.min(1), rtol=0, atol=1e-3)


def test_row_sq_depends_on_the_row_alone():
    # The staged norms: each row's, whatever rows come with it.
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(500, 37).astype(np.float32))
    whole = _row_sq(x)
    assert torch.equal(torch.cat([_row_sq(x[:7]), _row_sq(x[7:])]), whole)
    torch.testing.assert_close(whole, (x.double() ** 2).sum(1).float(), rtol=1e-6, atol=0)
    assert torch.equal(_row_sq(x.bfloat16()), _row_sq(x.bfloat16().float()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_plain_kernels_are_the_goodness(dtype):
    # Every plain L2 variant on the dense goodness (2 s − ref_sq) − q_sq of
    # the widened product, exactly on integers.
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.from_numpy(_ints((9, 8), 15)).to(tdt)
    r = torch.from_numpy(_ints((384, 8), 16)).to(tdt)
    kw = {"ref_sq": _row_sq(r), "q_sq": _row_sq(q)}
    n_valid = 300
    dense = (2 * kernels.scores_plain(q, r, n_valid) - kw["ref_sq"][:n_valid]
             - kw["q_sq"][:, None])
    dist = torch.cdist(q.float(), r[:n_valid].float()) ** 2
    assert torch.equal(dense, -dist.round())
    assert torch.equal(kernels.row_max(q, r, n_valid, **kw), dense.amax(1))
    assert torch.equal(kernels.count_above(q, r, -20.0, n_valid, **kw),
                       (dense >= -20.0).sum(1, dtype=torch.int32))
    pv, _ = kernels.pool_writer(q, r, n_valid, **kw)
    assert torch.equal(pv.view(9, -1).amax(1), dense.amax(1))
    top_v, top_i = kernels.fused_topk(q, r, n_valid, 5, **kw)
    assert torch.equal(top_v[:, 0], dense.amax(1))
    assert torch.equal(dense.gather(1, top_i.long()), top_v)
    s, rr, cc = kernels.scores_above(q, r, n_valid, torch.full((9,), -15.0), **kw)
    assert torch.equal(s, dense[rr.long(), cc.long()]) and bool((s >= -15.0).all())
    assert len(s) == int((dense >= -15.0).sum())


def test_l2_wrappers_check_their_norms():
    q, r = torch.ones((3, 8)), torch.ones((128, 8))
    with pytest.raises(TypeError, match="both"):
        kernels.row_max(q, r, 100, ref_sq=torch.ones(128))
    with pytest.raises(ValueError, match="ref_sq"):
        kernels.count_above(q, r, 0.0, 100, ref_sq=torch.ones(100), q_sq=torch.ones(3))
    with pytest.raises(ValueError, match="q_sq"):
        kernels.pool_writer(q, r, 100, ref_sq=torch.ones(128), q_sq=torch.ones(4))
    with pytest.raises(TypeError, match="int8"):
        kernels.fused_topk(q, torch.ones((128, 16), dtype=torch.int8), 100, 4,
                           scale=torch.ones(128), ref_sq=torch.ones(128), q_sq=torch.ones(3))


def test_l2_research_margin_covers_twice_the_product_error(monkeypatch):
    """Stand-in kernels score the L2 goodness δ above the re-search's (as
    a kernel whose product s rounds δ/2 above torch.matmul's would: the
    goodness takes 2 s). With δ/2 beyond a third of the f32 IP margin S,
    the IP margin cannot cover δ; the L2 margin (2 S plus the subtractions'
    rounding) keeps the pair the kernels counted, and the margin of half
    the corpus norm (S plus the rounding) loses it."""
    d, k = 64, 3
    rng = np.random.RandomState(17)
    base = rng.randn(d).astype(np.float32)
    base *= 8.0 / np.linalg.norm(base)
    q = rng.randn(6, d).astype(np.float32)
    r = rng.randn(3011, d).astype(np.float32)
    q[1] = base
    u = rng.randn(d).astype(np.float32)
    u /= np.linalg.norm(u)
    ts = TorchSearcher(r, metric="L2", device="cpu")
    slack = d * float(np.finfo(np.float32).eps) * ts._ref_norm_max * 8.0  # S of row 1
    delta = 1.7 * slack
    # Row 1 scores columns 10-12 (segment 0) and 200 (segment 1) far above
    # the rest, at goodness G + 2.5, 0.6 and 0.3 δ and G. The kernels
    # report δ more: τ = G + δ, segment 0 hides column 12, so row 1 is
    # counted and re-searched from τ less the margin.
    big = 4.0 * delta
    for j, t in ((10, 2.5), (11, 0.6), (12, 0.3), (200, 0.0)):
        r[j] = base + np.sqrt(big - t * delta) * u
    ts = TorchSearcher(r, metric="L2", device="cpu")
    topk = kernels.fused_topk

    def topk_up(q, refs, n_valid, kappa, **kw):
        vals, ids = topk(q, refs, n_valid, kappa, **kw)
        return vals + delta, ids

    def count_up(q, refs, tau, n_valid, ref_sq, q_sq):
        s = kernels.scores_plain(q, refs, n_valid)
        s = (2 * s - ref_sq[:n_valid] - q_sq[:, None]) + delta
        return (s >= tau).sum(1, dtype=torch.int32)

    monkeypatch.setattr(kernels, "fused_topk", topk_up)
    monkeypatch.setattr(kernels, "count_above", count_up)
    monkeypatch.setenv(COLLECTION_ENV, "stream")
    qi, ri, s = ts.global_topk(q, k, kappa=8)
    assert ts.last_stats["corpus_rows"] == 1
    assert list(zip(qi, ri)) == [(1, 10), (1, 11), (1, 12)]
    np.testing.assert_allclose(s, [big - 2.5 * delta, big - 0.6 * delta, big - 0.3 * delta],
                               rtol=0, atol=1e-4)
    ts._ref_norm_max /= 2
    assert list(zip(*ts.global_topk(q, k, kappa=8)[:2])) == [(1, 10), (1, 11)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_searcher_from_jax(dtype):
    # A JAX L2 searcher carried across with its squared norms, taken as
    # they are (floats: bit for bit JAX's), then searched: identical on
    # integers.
    rng = np.random.RandomState(18)
    rf = rng.randn(500, 24).astype(np.float32)
    js = JaxSearcher(rf, metric="L2", dtype=dtype)
    ts = searcher_from_arrays(np.asarray(js._refs), int(js._n_valid),
                              np.asarray(js._ref_sq), device="cpu", metric="L2")
    assert ts.metric == "L2" and ts.dtype == dtype
    np.testing.assert_array_equal(ts._ref_sq.numpy(), np.asarray(js._ref_sq))
    q, r = _int_case(19, n=3000)
    js = JaxSearcher(r, metric="L2", dtype=dtype)
    ts = searcher_from_arrays(np.asarray(js._refs), int(js._n_valid),
                              np.asarray(js._ref_sq), device="cpu", metric="L2")
    _assert_identical(js.global_topk(q, 300), ts.global_topk(q, 300))
    with pytest.raises(ValueError, match="squared norms"):
        searcher_from_arrays(np.asarray(js._refs), int(js._n_valid), device="cpu",
                             metric="L2")


def _videos(feats, prefix, lengths):
    out, at = [], 0
    for i, n in enumerate(lengths):
        out.append(VideoFeature(video_id=f"{prefix}{i:06d}",
                                timestamps=np.arange(n, dtype=np.float64),
                                feature=feats[at : at + n]))
        at += n
    return out


def _pairs(matches):
    return sorted(
        (m.query_id, m.ref_id, [(tuple(x.query_timestamps), tuple(x.ref_timestamps),
                                 x.score) for x in m.matches])
        for m in matches
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_video_index_identical_to_jax(dtype):
    q, r = _int_case(20, n=2000, nq=40)
    refs = _videos(r, "R", [500, 700, 800])
    queries = _videos(q, "Q", [15, 25])
    ji = JaxVideoIndex(12, metric="L2", dtype=dtype)
    ti = VideoIndex(12, metric="L2", dtype=dtype, device="cpu")
    ji.add(refs)
    ti.add(refs)
    assert _pairs(ti.search(queries, global_k=300)) == _pairs(ji.search(queries, global_k=300))
    assert ti._get_searcher().metric == "L2"


def test_score_normalized_index_is_ip_only():
    noise = _videos(_ints((50, 12), 21), "R", [50])
    with pytest.raises(ValueError, match="inner-product"):
        ScoreNormalizedVideoIndex(12, noise, metric="L2", device="cpu")


@pytest.mark.parametrize("metric", ["IP", "L2"])
def test_f32_research_hands_cublas_whole_chunks(monkeypatch, metric):
    # The f32 re-search pads a chunk of few rows with zero rows to
    # F32_RESEARCH_MIN_ROWS before torch.matmul (cuBLAS takes another
    # algorithm for a few rows, whose sums differ from the kernels'), and
    # keeps the chunk's own rows: the same result, tolerance 0.
    from vsc2022_torch.ops import similarity

    q, r = _int_case(23, n=3000)
    want = JaxSearcher(r, metric=metric).global_topk(q, 300, kappa=4)
    shapes = []
    real = torch.matmul

    def matmul(a, b):
        shapes.append(a.shape[0])
        return real(a, b)

    ts = TorchSearcher(r, metric=metric, device="cpu")
    monkeypatch.setattr(similarity.torch, "matmul", matmul)
    monkeypatch.setenv(COLLECTION_ENV, "stream")
    _assert_identical(want, ts.global_topk(q, 300, kappa=4))
    assert 0 < ts.last_stats["corpus_rows"] < similarity.F32_RESEARCH_MIN_ROWS
    # The plain kernels' products take all 37 query rows; the re-search's
    # few rows go to cuBLAS as one padded chunk.
    assert sorted(set(shapes)) == [37, similarity.F32_RESEARCH_MIN_ROWS]
