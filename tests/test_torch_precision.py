"""precision="default" on the port against the JAX package.

"default" is one bf16 pass per product (XLA's DEFAULT on a TPU; the
Pallas pool's bf16 branch). JAX on the CPU computes DEFAULT in f32, so
the port is held against JAX fed the inputs the port rounds: bf16-rounded
queries and corpora. The inputs lie near a grid of values with four
significant bits (s · (1 + j/8), |s| ≤ 2) but off it (moved away from 0 by
at most 0.003, under half a bf16 step there): their bf16 rounding is the grid
value, so a search that did not round would see other scores, while every
product and sum of the rounded values is exact in f32 on both sides and
selections and scores compare for identity (tolerance 0). Under L2 the
norms come from the unrounded rows and queries, in JAX and in the port,
so L2 takes integer inputs only (bf16-exact: rounding changes nothing).
"""

import numpy as np
import pytest
import torch

from vsc2022_torch.ops import kernels
from vsc2022_torch.ops.similarity import COLLECTION_ENV
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex, VideoIndex
from vsc2022_torch.types import VideoFeature
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher
from vsc2022_tpu.retrieval.index import VideoIndex as JaxVideoIndex

JAX_COLLECTION_ENV = "VSC2022_TPU_COLLECTION"


def _near_grid(shape, seed):
    """Values s · (1 + j/8) moved away from 0 by e (s in ±1, ±2; j in 0..7;
    0.0005 ≤ e ≤ 0.003, under half a bf16 step at their magnitude), f32,
    none of them bf16-exact; ``_bf16`` rounds each to its grid value."""
    rng = np.random.RandomState(seed)
    grid = rng.choice([-2, -1, 1, 2], size=shape) * (1 + rng.randint(0, 8, size=shape) / 8)
    return (grid + np.sign(grid) * rng.uniform(0.0005, 0.003, size=shape)).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)


def _assert_identical(expect, got):
    for e, g in zip(expect, got):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype


def test_near_grid_inputs_round_to_their_grid():
    x = _near_grid((200, 16), 0)
    g = _bf16(x)
    assert not np.any(g == x)
    np.testing.assert_array_equal(np.abs(g * 8), np.round(np.abs(g * 8)))
    assert np.abs(g).max() <= 3.75


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_default_f32_identical_to_jax_on_rounded_inputs(monkeypatch, mode):
    # IP: JAX at "highest" on the rounded rows and queries is the one-pass
    # product; the port at "default" rounds them itself.
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setenv(JAX_COLLECTION_ENV, mode)
    q, r = _near_grid((37, 12), 1), _near_grid((9000, 12), 2)
    r[10:20] = r[9]  # equal columns in one segment: re-searched rows
    q[1] = r[9]
    ts = TorchSearcher(r, precision="default", device="cpu")
    assert ts._refs.dtype == torch.bfloat16 and ts.query_dtype == torch.float32
    expect = JaxSearcher(_bf16(r)).global_topk(_bf16(q), 400)
    _assert_identical(expect, ts.global_topk(q, 400))
    assert ts.last_stats["mode"] == mode and ts.last_stats["corpus_rows"] > 0
    # Not rounding would score otherwise.
    unrounded = JaxSearcher(r).global_topk(q, 400)[2]
    assert not np.array_equal(unrounded, expect[2])
    _assert_identical(JaxSearcher(_bf16(r)).row_topk(_bf16(q), 7), ts.row_topk(q, 7))
    np.testing.assert_array_equal(ts.row_nn(q), JaxSearcher(_bf16(r)).row_nn(_bf16(q)))


def test_default_f32_equals_a_bf16_searcher_and_grows_alike():
    # Over an f32 corpus "default" is the bf16 searcher's product: the same
    # staged rows and results (IP), through append_rows and keep_rows too.
    q, r = _near_grid((20, 16), 3), _near_grid((2000, 16), 4)
    a = TorchSearcher(r, precision="default", device="cpu")
    b = TorchSearcher(r, dtype="bfloat16", device="cpu")
    for _ in range(2):
        assert torch.equal(a._refs, b._refs)
        _assert_identical(b.global_topk(q, 300), a.global_topk(q, 300))
        a.append_rows(r[:100])
        b.append_rows(r[:100])
        a.keep_rows(np.arange(0, a.n_refs, 3))
        b.keep_rows(np.arange(0, b.n_refs, 3))
    assert a.dtype == "float32" and a.staged_bytes() == b.staged_bytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_l2_identical_to_jax_on_integers(dtype):
    q, r = _ints((30, 10), 5), _ints((3000, 10), 6)
    ts = TorchSearcher(r, metric="L2", precision="default", dtype=dtype, device="cpu")
    js = JaxSearcher(r, metric="L2", precision="default", dtype=dtype)
    _assert_identical(js.global_topk(q, 300), ts.global_topk(q, 300))
    _assert_identical(js.row_topk(q, 5), ts.row_topk(q, 5))


def test_default_l2_norms_come_from_the_f32_rows():
    # The norms stay the unrounded rows' and queries' (JAX's _set_ref_sq
    # reads the staged f32 corpus); the products round.
    q, r = _near_grid((5, 12), 7), _near_grid((300, 12), 8)
    ts = TorchSearcher(r, metric="L2", precision="default", device="cpu")
    np.testing.assert_array_equal(ts._ref_sq[:300].numpy(),
                                  TorchSearcher(r, metric="L2", device="cpu")._ref_sq[:300])
    s = torch.from_numpy(_bf16(q)) @ torch.from_numpy(_bf16(r)).T
    qs = torch.from_numpy((q.astype(np.float64) ** 2).sum(1)).float()
    good = (2 * s - ts._ref_sq[:300]) - qs[:, None]
    torch.testing.assert_close(torch.from_numpy(ts.row_nn(q)), -good.amax(1),
                               rtol=0, atol=1e-5)


def test_default_bf16_is_highest():
    q, r = _near_grid((15, 8), 9), _near_grid((1000, 8), 10)
    a = TorchSearcher(r, dtype="bfloat16", precision="default", device="cpu")
    b = TorchSearcher(r, dtype="bfloat16", device="cpu")
    _assert_identical(b.global_topk(q, 100), a.global_topk(q, 100))
    _assert_identical(b.row_topk(q, 4), a.row_topk(q, 4))


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_default_int8_identical_to_jax_on_rounded_queries(monkeypatch, mode):
    # int8 at "default": the f32 queries rounded to bf16 before the split
    # (mid and lo zero: the three-pass product is the one-pass one); JAX's
    # int8 searcher fed the rounded queries gives the same result (codes
    # and scales from the same f32 rows).
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setenv(JAX_COLLECTION_ENV, mode)
    q, r = _near_grid((30, 12), 11), _ints((9000, 12), 12) * 42.0
    r[10:20] = r[9]
    q[1] = r[9] / 42.0
    ts = TorchSearcher(r, dtype="int8", precision="default", device="cpu")
    expect = JaxSearcher(r, dtype="int8").global_topk(_bf16(q), 300)
    _assert_identical(expect, ts.global_topk(q, 300))
    assert ts.last_stats["mode"] == mode
    assert not np.array_equal(JaxSearcher(r, dtype="int8").global_topk(q, 300)[2],
                              expect[2])


def test_default_int8_split_is_one_pass():
    q = torch.from_numpy(_near_grid((6, 16), 13))
    ts = TorchSearcher(_ints((300, 16), 14), dtype="int8", precision="default",
                       device="cpu")
    terms = kernels.split_bf16x3(ts._product_queries(q))
    assert torch.equal(terms[0].float(), q.bfloat16().float())
    assert not terms[1:].float().any()


def _videos(feats, prefix, lengths):
    out, at = [], 0
    for i, n in enumerate(lengths):
        out.append(VideoFeature(video_id=f"{prefix}{i:06d}",
                                timestamps=np.arange(n, dtype=np.float64),
                                feature=feats[at : at + n]))
        at += n
    return out


def test_video_index_takes_its_precision():
    q, r = _near_grid((40, 12), 15), _near_grid((1500, 12), 16)
    ti = VideoIndex(12, precision="default", device="cpu")
    ji = JaxVideoIndex(12)
    ti.add(_videos(r, "R", [700, 800]))
    ji.add(_videos(_bf16(r), "R", [700, 800]))
    got = ti.search(_videos(q, "Q", [15, 25]), global_k=200)
    want = ji.search(_videos(_bf16(q), "Q", [15, 25]), global_k=200)
    key = lambda m: (m.query_id, m.ref_id)  # noqa: E731
    assert [(key(m), [x.score for x in m.matches]) for m in sorted(got, key=key)] == \
        [(key(m), [x.score for x in m.matches]) for m in sorted(want, key=key)]
    assert ti._get_searcher().precision == "default"
    noise = _videos(_near_grid((80, 12), 17), "N", [80])
    sn = ScoreNormalizedVideoIndex(12, noise, precision="default", device="cpu")
    sn.add(_videos(r, "R", [700, 800]))
    searcher = sn._get_searcher()
    assert searcher.searcher.precision == searcher.noise_searcher.precision == "default"
