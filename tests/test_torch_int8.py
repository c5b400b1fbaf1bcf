"""int8 (SQ8) storage and search: the port's int8 configuration against the
JAX package's, on the CPU (the kernels' plain versions: q · codes.float()
in f32, then × scale per column).

- Quantization: the port's ``quantize_rows_int8`` gives the JAX package's
  codes and scales byte for byte (random rows, all-zero rows, rows whose
  codes land on the ±127 clip), and the searcher stages exactly those,
  zero-padded to 16 columns; ``searcher_from_arrays`` takes a JAX int8
  corpus's codes and scales as they are.
- Search: on dyadic inputs (rows whose max is 127·2⁻ᵏ, so every scale is a
  power of two, integer queries: every score exact) ``global_topk`` in
  both collection modes, ``row_nn`` and ``row_topk`` are identical to
  JAX's, tie order included. Float inputs are held against the dense
  oracle over the dequantized corpus (JAX's ``test_float_fuzz`` tolerance:
  rtol 1e-5, atol 1e-6). A grown or shrunk searcher equals a fresh stage
  of the same rows (codes, scales, padding) and searches alike. The
  re-search is one ``scores_above`` call over every re-searched row, in
  chunks only where τ = −inf would overrun its entry budget, with JAX's
  results.
- The query split of the int8 kernels (``split_bf16x3``): hi + mid + lo
  equals every f32 query row bit for bit (normal, unit-norm, integer and
  wide-exponent rows), each term bf16, mid and lo zero on integers.
- Score normalization, the SN searcher (both corpora int8, the ones column
  quantized with its row) and the index (``codec_str="SQ8"``): the same
  selections as JAX, scores within 1e-5 where the bias column is a float.
- The entry points (``sscd_baseline --int8``, ``descriptor_eval --int8``)
  write CSVs byte-identical to JAX's on an integer corpus; the server's
  ``--int8`` stages int8 codes and bf16 localizer tables, reports int8 in
  ``stats`` and answers requests as the JAX server does.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import _integer_corpus
from test_torch_serve import BETA, D, _corpus, _servers
from vsc2022_torch import descriptor_eval as torch_descriptor_eval
from vsc2022_torch.baseline import sscd_baseline as torch_driver
from vsc2022_torch.convert import searcher_from_arrays
from vsc2022_torch.ops import kernels, similarity
from vsc2022_torch.ops.similarity import COLLECTION_ENV
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_torch.ops.similarity import quantize_rows_int8 as torch_quantize
from vsc2022_torch.retrieval import serve as torch_serve
from vsc2022_torch.retrieval.candidates import MaxScoreAggregation as TorchAgg
from vsc2022_torch.retrieval.client import ServeClient
from vsc2022_torch.retrieval.index import VideoIndex as TorchIndex
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex as TorchSNIndex
from vsc2022_torch.retrieval.score_norm import score_normalize as torch_score_normalize
from vsc2022_torch.retrieval.sn_search import ScoreNormalizedSearcher as TorchSN
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu import metrics as jm
from vsc2022_tpu.baseline import sscd_baseline as jax_driver
from vsc2022_tpu.descriptor_eval_lib import DescriptorEvalProtocol, evaluate_descriptor_track
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher
from vsc2022_tpu.ops.similarity import quantize_rows_int8 as jax_quantize
from vsc2022_tpu.retrieval import serve as jax_serve
from vsc2022_tpu.retrieval.candidates import MaxScoreAggregation as JaxAgg
from vsc2022_tpu.retrieval.index import ScoreNormalizedVideoIndex as JaxSNIndex
from vsc2022_tpu.retrieval.index import VideoIndex as JaxIndex
from vsc2022_tpu.retrieval.score_norm import score_normalize as jax_score_normalize
from vsc2022_tpu.retrieval.sn_search import ScoreNormalizedSearcher as JaxSN
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature as JVF

INT8 = "int8"
# JAX's float fuzz tolerance (tests/test_search.py TestInt8Mode): float
# queries make the products inexact, so XLA and torch may sum them ~1 ulp
# apart; the scale multiply is one f32 op on both sides.
RTOL, ATOL = 1e-5, 1e-6
FLOAT_ATOL = 1e-5  # score-normalized floats (a float bias column)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dyadic_rows(n, d, seed, low=-127):
    """[n, d] rows of integer codes in [low, 127] with one ±127 per row,
    times 2⁻ᵏ (k = 0..6 by row): max |row| = 127·2⁻ᵏ, so the scale is 2⁻ᵏ
    exactly and the codes come back as they were."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(low, 128, size=(n, d)).astype(np.float32)
    codes[np.arange(n), rng.randint(0, d, size=n)] = rng.choice([-127.0, 127.0], n)
    return codes * (2.0 ** -rng.randint(0, 7, size=(n, 1))).astype(np.float32)


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)


def _check_staged_like_jax(ts, js):
    """The port's int8 corpus holds JAX's codes (plus zero columns to a
    multiple of 16) and scales, padding rows included."""
    codes, scale = np.asarray(js._refs), np.asarray(js._ref_sq)
    assert ts._refs.dtype == torch.int8 and ts._scale.dtype == torch.float32
    assert ts._refs.shape == (codes.shape[0], kernels.padded_width(codes.shape[1], 16))
    np.testing.assert_array_equal(ts._refs[:, : codes.shape[1]].numpy(), codes)
    assert not ts._refs[:, codes.shape[1]:].any()
    np.testing.assert_array_equal(ts._scale.numpy().view(np.uint32), scale.view(np.uint32))


# ---- quantization ---------------------------------------------------------------


def _quantization_rows():
    rng = np.random.RandomState(0)
    r = (rng.randn(200, 24) * 10.0 ** rng.randint(-6, 4, size=(200, 1))).astype(np.float32)
    r[0] = 0.0  # an all-zero row: scale 0, codes 0
    r[1] = np.linspace(-1.0, 1.0, 24, dtype=np.float32)  # both clip ends
    r[2] = -r[1] * np.float32(3e-7)
    r[3, :] = np.float32(5.0)  # every code at the clip
    r[4] = np.float32(127.0) * np.arange(-12, 12, dtype=np.float32) / 12.0
    return r


def test_quantize_rows_int8_byte_identical_to_jax():
    r = _quantization_rows()
    got_c, got_s = torch_quantize(r)
    want_c, want_s = jax_quantize(r)
    assert got_c.dtype == want_c.dtype == np.int8
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s.view(np.uint32), want_s.view(np.uint32))
    assert not got_c[0].any() and got_s[0] == 0.0
    assert got_c[1].min() == -127 and got_c[1].max() == 127
    assert (got_c[3] == 127).all()
    for empty in (np.zeros((0, 5), np.float32), np.zeros((3, 0), np.float32)):
        c, s = torch_quantize(empty)
        jc, js = jax_quantize(empty)
        assert c.shape == jc.shape and s.shape == js.shape


@pytest.mark.parametrize("d", [24, 13, 32])
def test_int8_staging_identical_to_jax(d):
    r = _quantization_rows()[:, :d] if d <= 24 else np.random.RandomState(1).randn(
        200, d).astype(np.float32)
    js = JaxSearcher(r, dtype=INT8)
    ts = TorchSearcher(r, dtype=INT8, device="cpu")
    _check_staged_like_jax(ts, js)
    assert ts.query_dtype == torch.float32
    q = np.random.RandomState(2).randn(7, d).astype(np.float32)
    assert ts._stage_queries(q).dtype == torch.float32
    # Dequantized row norms give the re-search margin.
    dq = ts._refs.float().numpy()[:, :d] * ts._scale.numpy()[:, None]
    np.testing.assert_allclose(ts._ref_norm_max, np.linalg.norm(dq, axis=1).max(),
                               rtol=1e-6)
    # A quarter of the f32 corpus bytes, plus one f32 scale a row.
    assert ts.staged_bytes() == ts._refs.shape[0] * (kernels.padded_width(d, 16) + 4)


def test_searcher_from_a_jax_int8_corpus():
    r = _dyadic_rows(300, 20, 3)
    js = JaxSearcher(r, dtype=INT8)
    staged = np.asarray(js._refs)
    assert staged.dtype == np.int8
    ts = searcher_from_arrays(staged, int(js._n_valid), np.asarray(js._ref_sq),
                              device="cpu")
    assert ts.dtype == INT8 and ts.n_refs == 300 and ts.dim == 20
    _check_staged_like_jax(ts, js)
    q = _ints((17, 20), 4)
    for a, b in zip(js.global_topk(q, 400), ts.global_topk(q, 400)):
        np.testing.assert_array_equal(b, a)


# ---- the query split of the int8 kernels ------------------------------------------


def _split_rows(kind):
    rng = np.random.RandomState(17)
    if kind == "normal":
        x = rng.randn(300, 40)
    elif kind == "unit":
        x = rng.randn(300, 512)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    elif kind == "integer":
        x = rng.randint(-3000, 3001, size=(300, 40))
    else:  # wide exponents: every binade from 2^-100 to 2^100, both signs
        x = rng.uniform(1.0, 2.0, size=(300, 40)) * 2.0 ** rng.randint(-100, 101,
                                                                      size=(300, 40))
        x *= rng.choice([-1.0, 1.0], size=x.shape)
        x[0, :5] = 0.0
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


@pytest.mark.parametrize("kind", ["normal", "unit", "integer", "wide"])
def test_split_bf16x3_is_exact(kind):
    q = _split_rows(kind)
    terms = kernels.split_bf16x3(q)
    assert terms.dtype == torch.bfloat16 and terms.shape == (3,) + tuple(q.shape)
    assert terms.is_contiguous()
    hi, mid, lo = terms.double()
    # Exact: three bf16 values whose sum needs at most 25 significant bits,
    # which f64 holds, equal the f32 row bit for bit.
    assert torch.equal(hi + mid + lo, q.double())
    # Each term is bf16-representable (it is a bf16) and the terms shrink:
    # |mid| <= 2^-8 |q|, |lo| <= 2^-16 |q|.
    qa = q.double().abs()
    assert (mid.abs() <= qa * 2.0 ** -8).all() and (lo.abs() <= qa * 2.0 ** -16).all()
    if kind == "integer":  # |q| <= 256: at most 8 significant bits, bf16-exact
        small = qa <= 256
        assert not mid[small].any() and not lo[small].any()
    if kind == "normal":
        assert mid.any() and lo.any()


def test_split_bf16x3_of_bf16_exact_rows_is_the_row():
    # A bf16-exact f32 row (an integer one, or a bf16 row widened) splits
    # into (q, 0, 0): the int8 kernels then score it as the bf16 product.
    q = _split_rows("normal").bfloat16().float()
    hi, mid, lo = kernels.split_bf16x3(q)
    assert torch.equal(hi.float(), q) and not mid.float().any() and not lo.float().any()
    ints = torch.from_numpy(_ints((50, 24), 3))
    hi, mid, lo = kernels.split_bf16x3(ints)
    assert torch.equal(hi.float(), ints) and not mid.float().any() and not lo.float().any()


# ---- the plain int8 kernels ---------------------------------------------------------


def test_int8_plain_kernels_scale_after_the_product():
    q = torch.tensor([[1.0, 2.0, 0.5]])
    codes = torch.zeros((128, 16), dtype=torch.int8)
    codes[0, :3] = torch.tensor([3, -1, 4], dtype=torch.int8)
    codes[1, :3] = torch.tensor([127, 127, 127], dtype=torch.int8)
    scale = torch.zeros(128)
    scale[0], scale[1] = 0.25, 2.0 ** -7
    want = torch.tensor([(3 - 2 + 2) * 0.25, (127 * 3.5) * 2.0 ** -7])
    assert torch.equal(kernels.scores(q, codes, 2, scale=scale)[0], want)
    assert float(kernels.row_max(q, codes, 2, scale=scale)[0]) == float(want.max())
    assert int(kernels.count_above(q, codes, 0.75, 2, scale=scale)[0]) == 2
    assert int(kernels.count_above(q, codes, 0.8, 2, scale=scale)[0]) == 1
    vals, ids = kernels.pool_writer(q, codes, 2, scale=scale)
    assert vals[0, 0].tolist() == sorted(want.tolist(), reverse=True)
    assert ids[0, 0].tolist() == [1, 0]
    top_v, top_i = kernels.fused_topk(q, codes[:2], 2, 3, scale=scale[:2])
    assert top_v[0, :2].tolist() == [float(want[1]), float(want[0])]
    assert top_i[0].tolist() == [1, 0, 0] and top_v[0, 2] == float("-inf")
    # An all-zero valid row (scale 0) scores 0, pad columns past n_valid -inf.
    assert float(kernels.scores(q, codes, 3, scale=scale)[0, 2]) == 0.0


@pytest.mark.parametrize("d", [16, 13])
def test_int8_plain_kernels_with_unit_scales_are_the_f32_kernels(d):
    # With every scale 1 an int8 variant is its f32 kernel on codes.float().
    rng = np.random.RandomState(d)
    q = torch.from_numpy(rng.randn(9, d).astype(np.float32))
    codes = torch.from_numpy(rng.randint(-127, 128, size=(256, d)).astype(np.int8))
    ones, wide = torch.ones(256), codes.float()
    assert torch.equal(kernels.row_max(q, codes, 250, scale=ones),
                       kernels.row_max(q, wide, 250))
    assert torch.equal(kernels.count_above(q, codes, 3.0, 250, scale=ones),
                       kernels.count_above(q, wide, 3.0, 250))
    for a, b in zip(kernels.pool_writer(q, codes, 250, scale=ones),
                    kernels.pool_writer(q, wide, 250)):
        assert torch.equal(a, b)
    for a, b in zip(kernels.fused_topk(q, codes, 250, 7, scale=ones),
                    kernels.fused_topk(q, wide, 250, 7)):
        assert torch.equal(a, b)
    # The wrappers take the searcher's codes padded to 16 columns too.
    padded = kernels.pad_columns(codes, kernels.I8_ROW_ALIGN)
    assert torch.equal(kernels.scores(q, padded, 250, scale=ones),
                       kernels.scores(q, codes, 250, scale=ones))


def test_int8_kernel_checks_refuse_other_pairings():
    q = torch.ones((3, 16))
    codes, scale = torch.ones((128, 16), dtype=torch.int8), torch.ones(128)
    with pytest.raises(TypeError, match="scale"):
        kernels.row_max(q, codes, 100)  # codes without their scales
    with pytest.raises(TypeError, match="f32 queries"):
        kernels.row_max(q.bfloat16(), codes, 100, scale=scale)
    with pytest.raises(TypeError, match="int8 codes only"):
        kernels.count_above(q, codes.float(), 0.0, 100, scale=scale)
    with pytest.raises(ValueError, match="scale"):
        kernels.pool_writer(q, codes, 100, scale=torch.ones(64))
    with pytest.raises(ValueError, match="scale"):
        kernels.scores(q, codes, 100, scale=scale.double())
    with pytest.raises(ValueError, match="shapes"):
        kernels.fused_topk(torch.ones((3, 40)), codes, 100, 4, scale=scale)


# ---- search ----------------------------------------------------------------------------


def test_int8_row_nn_and_row_topk_identical_to_jax():
    q, r = _ints((45, 20), 6), _dyadic_rows(1300, 20, 7)
    js, ts = JaxSearcher(r, dtype=INT8), TorchSearcher(r, dtype=INT8, device="cpu")
    np.testing.assert_array_equal(ts.row_nn(q), js.row_nn(q))
    for e, g in zip(js.row_topk(q, 6), ts.row_topk(q, 6)):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("nq,n,d,k,kappa", [
    (31, 4100, 20, 700, 16),  # planted ties, several deficient rows
    (13, 4096, 12, 60, 4),  # k > nq·κ: τ = −inf, every row searched
    (17, 2100, 1025, 300, 8),  # the DnS width: codes padded to 1,040 columns
])
def test_int8_global_topk_identical_to_jax_on_dyadic_inputs(monkeypatch, mode, nq, n, d,
                                                            k, kappa):
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", mode)
    monkeypatch.setenv(COLLECTION_ENV, mode)
    q, r = _ints((nq, d), nq + d), _dyadic_rows(n, d, n)
    r[10:20] = r[9]  # equal columns in segment 0: ties and ambiguous rows
    q[1] = q[4] = np.sign(r[9])
    want = JaxSearcher(r, dtype=INT8).global_topk(q, k, kappa=kappa)
    ts = TorchSearcher(r, dtype=INT8, device="cpu")
    got = ts.global_topk(q, k, kappa=kappa)
    assert ts.last_stats["mode"] == mode
    for e, g in zip(want, got):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_int8_global_topk_floats_against_the_dequantized_oracle(monkeypatch, mode):
    monkeypatch.setenv(COLLECTION_ENV, mode)
    rng = np.random.RandomState(12)
    for trial in range(3):
        nq, n = int(rng.randint(5, 40)), int(rng.randint(2000, 4000))
        q = rng.randn(nq, 16).astype(np.float32)
        r = rng.randn(n, 16).astype(np.float32)
        k = int(rng.randint(1, 20 * nq))
        ts = TorchSearcher(r, dtype=INT8, device="cpu")
        qi, ri, s = ts.global_topk(q, k, kappa=8)
        assert ts.last_stats["mode"] == mode
        codes, scale = torch_quantize(r)
        dense = (q.astype(np.float64) @ codes.astype(np.float64).T) * scale[None, :]
        assert len(qi) == k and np.all(np.diff(s) <= 0)
        np.testing.assert_allclose(s, dense[qi, ri], rtol=RTOL, atol=ATOL)
        kth = np.sort(dense.ravel())[-k]
        clear = {(a, b) for a, b in zip(*np.nonzero(dense > kth + 2 * ATOL + RTOL * abs(kth)))}
        assert clear <= set(zip(qi.tolist(), ri.tolist()))
        # The same pairs and scores as the JAX int8 searcher.
        jqi, jri, js_ = JaxSearcher(r, dtype=INT8).global_topk(q, k)
        np.testing.assert_allclose(s, js_, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_int8_append_and_keep_equal_a_fresh_stage(monkeypatch, mode):
    monkeypatch.setenv(COLLECTION_ENV, mode)
    rng = np.random.RandomState(7)
    q = _ints((19, 16), 8)
    r1 = rng.randn(2900, 16).astype(np.float32)
    r2 = rng.randn(1300, 16).astype(np.float32)  # the padding grows
    ts = TorchSearcher(r1, dtype=INT8, device="cpu")
    ts.append_rows(r2)
    both = np.concatenate([r1, r2])
    fresh = TorchSearcher(both, dtype=INT8, device="cpu")
    for name in ("_refs", "_scale"):
        assert torch.equal(getattr(ts, name), getattr(fresh, name)), name
    assert ts._ref_norm_max == fresh._ref_norm_max
    for a, b in zip(ts.global_topk(q, 500, kappa=8), fresh.global_topk(q, 500, kappa=8)):
        np.testing.assert_array_equal(a, b)
    keep = np.sort(rng.choice(4200, 1900, replace=False))
    ts.keep_rows(keep)
    fresh = TorchSearcher(both[keep], dtype=INT8, device="cpu")
    for name in ("_refs", "_scale"):
        assert torch.equal(getattr(ts, name), getattr(fresh, name)), name
    for a, b in zip(ts.global_topk(q, 500, kappa=8), fresh.global_topk(q, 500, kappa=8)):
        np.testing.assert_array_equal(a, b)
    # And as JAX grows and shrinks its int8 corpus.
    js = JaxSearcher(r1, dtype=INT8)
    js.append_rows(r2)
    js.keep_rows(keep)
    _check_staged_like_jax(ts, js)


def test_int8_quality_unit_norm_copies_rank_first():
    rng = np.random.RandomState(5)

    def l2n(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    r = l2n(rng.randn(300, 64).astype(np.float32))
    q = l2n(rng.randn(20, 64).astype(np.float32))
    q[:5] = r[100:105]
    qi, ri, s = TorchSearcher(r, dtype=INT8, device="cpu").global_topk(q, 5)
    assert set(zip(qi.tolist(), ri.tolist())) == {(i, 100 + i) for i in range(5)}
    assert (s > 0.99).all()


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_int8_research_scores_on_the_kernels_product(monkeypatch, mode):
    # A re-searched row of an int8 corpus scores on the kernels' own
    # product (kernels.scores_above over the padded queries, the codes and
    # their scales).
    calls = []
    real = kernels.scores_above

    def spy(q, refs, n_valid, floor, capacity=None, scale=None):
        calls.append((q, refs, n_valid, scale))
        return real(q, refs, n_valid, floor, capacity=capacity, scale=scale)

    monkeypatch.setattr(kernels, "scores_above", spy)
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", mode)
    q, r = _ints((11, 13), 53), _dyadic_rows(3000, 13, 54)
    r[10:20] = r[9]
    q[1] = q[4] = np.sign(r[9])
    ts = TorchSearcher(r, dtype=INT8, device="cpu")
    want = JaxSearcher(r, dtype=INT8).global_topk(q, 100, kappa=8)
    for e, g in zip(want, ts.global_topk(q, 100, kappa=8)):
        np.testing.assert_array_equal(g, e)
    assert ts.last_stats["corpus_rows"] > 0
    assert sum(c[0].shape[1] == 16 and c[0].shape[0] for c in calls) == \
        ts.last_stats["corpus_rows"]
    assert all(refs is ts._refs and scale is ts._scale and n == ts.n_refs
               for _, refs, n, scale in calls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", INT8])
@pytest.mark.parametrize("budget_rows", [134, 559, 4329, 128, 127, 67, 1])
def test_row_chunk_fills_the_products_128_row_items(monkeypatch, dtype, budget_rows):
    # The row chunk of the dense scores that are left (the f32 re-search
    # and row_topk), never above the score budget and never below 1 row.
    # Over bf16 rows and int8 codes (widened a block at a time,
    # torch.matmul of any rows): the budget's rows as they are. Over an f32
    # corpus: the budget's rows rounded down to whole groups of
    # F32_RESEARCH_MIN_ROWS (128) where it holds one, since _f32_scores's
    # cuBLAS calls take 128 query rows each and a chunk of whole groups pads
    # none but its last. 134, 559 and 4329 are the budget's rows at the
    # SSCD, serving and DnS corpora.
    n = 1000
    ts = TorchSearcher(_dyadic_rows(n, 12, 60), dtype=dtype, device="cpu")
    monkeypatch.setattr(similarity, "PLAIN_CHUNK_ELEMENTS", budget_rows * n + n - 1)
    group = similarity.F32_RESEARCH_MIN_ROWS
    if dtype == "float32" and budget_rows >= group:
        assert ts._row_chunk() == budget_rows - budget_rows % group
    else:
        assert ts._row_chunk() == budget_rows
    assert ts._row_chunk() <= budget_rows
    monkeypatch.setattr(similarity, "PLAIN_CHUNK_ELEMENTS", n - 1)
    assert ts._row_chunk() == 1


@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("budget_rows,chunks", [
    (134, [134, 134, 32]), (100, [100, 100, 100])])
def test_int8_research_in_whole_items_identical_to_jax(monkeypatch, mode, budget_rows,
                                                       chunks):
    # k over nq·κ and over the pool's entries (2 per segment and row): τ =
    # −inf in both collections, so all 300 rows are re-searched with every
    # entry kept. scores_above then takes chunks of rows whose every entry
    # fits its budget (the budget's rows: here 134 and 100 rows' worth of
    # the 1,100-row corpus; the kernel's 128-row items no longer shape the
    # chunks): pairs, scores and tie order identical to the JAX int8
    # searcher's either way.
    calls = []
    real = kernels.scores_above

    def spy(q, refs, n_valid, floor, capacity=None, scale=None):
        calls.append(q.shape[0])
        return real(q, refs, n_valid, floor, capacity=capacity, scale=scale)

    monkeypatch.setattr(kernels, "scores_above", spy)
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", mode)
    nq, n = 300, 1100
    q, r = _ints((nq, 12), 61), _dyadic_rows(n, 12, 62)
    r[10:20] = r[9]
    q[1] = q[4] = np.sign(r[9])
    want = JaxSearcher(r, dtype=INT8).global_topk(q, 6000, kappa=4)
    ts = TorchSearcher(r, dtype=INT8, device="cpu")
    monkeypatch.setattr(similarity, "ABOVE_BUDGET_ENTRIES", budget_rows * n + n - 1)
    got = ts.global_topk(q, 6000, kappa=4)
    assert ts.last_stats["mode"] == mode and ts.last_stats["corpus_rows"] == nq
    assert calls == chunks
    for e, g in zip(want, got):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype


# ---- score normalization, the SN searcher and the index ------------------------------


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_int8_score_normalize_matches_jax():
    def vids(vf, prefix, n, offset=0):
        g = np.random.RandomState(len(prefix) + n + offset)
        return [vf(f"{prefix}{offset + i:06d}", np.arange(20, dtype=np.float64),
                   _unit_rows(g, 20, 16)) for i in range(n)]

    (jq, jr, jn), (tq, tr, tn) = [
        (vids(vf, "Q", 4), vids(vf, "R", 6), vids(vf, "R", 5, offset=500))
        for vf in (JVF, TVF)]
    jq2, jr2 = jax_score_normalize(jq, jr, jn, beta=1.2, dtype=INT8)
    tq2, tr2 = torch_score_normalize(tq, tr, tn, beta=1.2, dtype=INT8, device="cpu")
    for a, b in zip(jq2 + jr2, tq2 + tr2):
        assert b.feature.dtype == a.feature.dtype == np.float32
        np.testing.assert_allclose(b.feature, a.feature, rtol=0, atol=FLOAT_ATOL)
    # The bias is the int8 noise corpus's row max, not the f32 one.
    f32 = torch_score_normalize(tq, tr, tn, beta=1.2, device="cpu")[0]
    assert not np.array_equal(f32[0].feature[:, -1], tq2[0].feature[:, -1])


def test_int8_sn_searcher_matches_jax():
    # JAX's TestInt8ScoreNorm case: both corpora int8, the SN references'
    # ones column quantized with its row (its code is rint(1/scale), not a
    # clean bias dimension), the queries and the bias f32.
    rng = np.random.RandomState(5)
    q = _unit_rows(rng, 40, 32)
    r = _unit_rows(rng, 300, 32)
    noise = _unit_rows(rng, 120, 32)
    q[3:9] = r[10:16]
    js = JaxSN(r, noise, beta=1.2, dtype=INT8)
    ts = TorchSN(r, noise, beta=1.2, dtype=INT8, device="cpu")
    _check_staged_like_jax(ts.searcher, js.searcher)
    _check_staged_like_jax(ts.noise_searcher, js.noise_searcher)
    # The 1 is each unit row's largest entry: its code is 127 and it
    # dequantizes to 127 × scale, as in JAX.
    assert (ts.searcher._refs[:300, 32].numpy() == 127).all()
    for k in (200, 3000):
        jqi, jri, js_ = js.global_topk(q, k)
        tqi, tri, ts_ = ts.global_topk(q, k)
        np.testing.assert_array_equal(tqi, jqi)
        np.testing.assert_array_equal(tri, jri)
        np.testing.assert_allclose(ts_, js_, rtol=0, atol=FLOAT_ATOL)
    assert ts.last_q_sn.dtype == torch.float32
    np.testing.assert_allclose(ts.last_q_sn.numpy(), np.asarray(js.last_q_sn)[:40],
                               rtol=0, atol=FLOAT_ATOL)
    # Against the dequantized oracle of JAX's own test: the same ids.
    r_sn = np.concatenate([r, np.ones((300, 1), np.float32)], axis=1)
    r_i8, r_sc = jax_quantize(r_sn)
    n_i8, n_sc = jax_quantize(noise)
    bias = ((q @ n_i8.astype(np.float32).T) * n_sc[None, :]).max(axis=1)
    q_sn = np.concatenate([q, (-1.2 * bias)[:, None]], axis=1)
    dense = (q_sn @ r_i8.astype(np.float32).T) * r_sc[None, :]
    order = np.lexsort((np.tile(np.arange(300), 40), np.repeat(np.arange(40), 300),
                        -dense.ravel()))[:200]
    oqi, ori = np.unravel_index(order, dense.shape)
    tqi, tri, _ = ts.global_topk(q, 200)
    np.testing.assert_array_equal(tqi, oqi)
    np.testing.assert_array_equal(tri, ori)


def test_video_index_sq8_codec_and_unported_codecs():
    def refs(vf):
        g = np.random.RandomState(6)
        return [vf(f"R{i:06d}", np.arange(20, dtype=np.float64),
                   g.randint(-3, 4, size=(20, 16)).astype(np.float32)) for i in range(6)]

    jr, tr = refs(JVF), refs(TVF)
    jq = [JVF("Q000000", np.arange(10, dtype=np.float64), jr[2].feature[:10].copy())]
    tq = [TVF("Q000000", np.arange(10, dtype=np.float64), tr[2].feature[:10].copy())]
    j, t = JaxIndex(16, codec_str="SQ8"), TorchIndex(16, codec_str="SQ8", device="cpu")
    assert t.dtype == j.dtype == INT8
    j.add(jr)
    t.add(tr)

    def records(results):
        return sorted((pm.query_id, pm.ref_id, tuple(m.score for m in pm.matches))
                      for pm in results)

    got, want = t.search(tq, 30), j.search(jq, 30)
    assert records(got) == records(want)
    best = max(got, key=lambda pm: max(m.score for m in pm.matches))
    assert best.ref_id == "R000002"
    assert t._searcher._refs.dtype == torch.int8
    assert TorchIndex(16, dtype=INT8, device="cpu").dtype == INT8
    # The IVF codecs parse as JAX's (",SQ8": int8), and the IVF,SQ8 index
    # searches as JAX's (tests/test_torch_ivf.py holds the tier).
    for codec in ("IVF4,SQ8", "IVF16", "IVF8,Flat"):
        ti, ji = TorchIndex(16, codec_str=codec, device="cpu"), JaxIndex(16, codec_str=codec)
        assert (ti.dtype, ti._ivf_nlist) == (ji.dtype, ji._ivf_nlist)
    ti, ji = TorchIndex(16, codec_str="IVF4,SQ8", device="cpu"), JaxIndex(16, codec_str="IVF4,SQ8")
    ti.add(tr)
    ji.add(jr)
    assert records(ti.search(tq, 30)) == records(ji.search(jq, 30)) == records(got)
    with pytest.raises(ValueError, match="codec"):
        TorchIndex(16, codec_str="PQ16", device="cpu")


def test_int8_sn_index_lifecycle_matches_jax():
    (jq, jr, jn, jx), (tq, tr, tn, tx) = _corpus(JVF), _corpus(TVF)
    j = JaxSNIndex(D, jn, beta=BETA, dtype=INT8)
    t = TorchSNIndex(D, tn, beta=BETA, dtype=INT8, device="cpu")
    j.add(jr)
    t.add(tr)
    k = 1200 * len(jq)

    def hits(index, queries):
        from vsc2022_torch.retrieval.candidates import rank_candidates as trank
        from vsc2022_tpu.retrieval.candidates import rank_candidates as jrank

        rank, agg = (trank, TorchAgg()) if index is t else (jrank, JaxAgg())
        return [(c.query_id, c.ref_id, c.score)
                for c in rank(index.search(queries, global_k=k), agg)]

    def same(a, b):
        assert [x[:2] for x in a] == [x[:2] for x in b] and a
        np.testing.assert_allclose([x[2] for x in a], [x[2] for x in b],
                                   rtol=0, atol=FLOAT_ATOL)

    same(hits(t, tq), hits(j, jq))
    j.add(jx)
    t.add(tx)
    j.remove(["R000001"])
    t.remove(["R000001"])
    assert t._searcher.searcher._refs.dtype == torch.int8
    _check_staged_like_jax(t._searcher.searcher, j._searcher.searcher)
    same(hits(t, tq), hits(j, jq))


# ---- the entry points ------------------------------------------------------------------


@pytest.fixture(scope="module")
def int_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8")
    queries, refs, gt = _integer_corpus(np.random.RandomState(5))
    paths = {k: str(root / f"{k}.npz") for k in ("q", "r")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    paths["gt"] = str(root / "gt.csv")
    jm.Match.write_csv(gt, paths["gt"])
    paths["root"] = root
    return paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_sscd_baseline_int8_byte_identical_to_jax(int_files):
    p = int_files
    common = ["--query_features", p["q"], "--ref_features", p["r"], "--int8"]
    jax_out, torch_out = str(p["root"] / "jax"), str(p["root"] / "torch")
    jax_driver.main(jax_driver.parser.parse_args(common + ["--output_path", jax_out]))
    result = torch_driver.main(torch_driver.parser.parse_args(
        common + ["--output_path", torch_out, "--device", "cpu",
                  "--ground_truth", p["gt"]]))
    for name in ("candidates.csv", "matches.csv"):
        got = _read(os.path.join(torch_out, name))
        assert got == _read(os.path.join(jax_out, name)), name
        assert got.count(b"\n") > 2
    # int8 scores differ from the f32 run's: the corpus was quantized.
    f32_out = str(p["root"] / "torch_f32")
    torch_driver.main(torch_driver.parser.parse_args(
        common[:-1] + ["--output_path", f32_out, "--device", "cpu"]))
    assert _read(os.path.join(f32_out, "candidates.csv")) != _read(
        os.path.join(torch_out, "candidates.csv"))
    assert result["candidate_uap"] == 1.0


def test_descriptor_eval_int8_byte_identical_to_jax(int_files, tmp_path):
    p = int_files
    ap, want = evaluate_descriptor_track(p["q"], p["r"], p["gt"],
                                         protocol=DescriptorEvalProtocol(dtype=INT8))
    jm.CandidatePair.write_csv(want, str(tmp_path / "jax.csv"))
    uap = torch_descriptor_eval.main(torch_descriptor_eval.parser.parse_args([
        "--query_features", p["q"], "--ref_features", p["r"], "--ground_truth",
        p["gt"], "--candidates_output", str(tmp_path / "torch.csv"), "--int8",
        "--device", "cpu"]))
    assert _read(tmp_path / "torch.csv") == _read(tmp_path / "jax.csv")
    assert uap == ap.ap


# ---- the server ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_int8")
    queries, refs, noise, extra = _corpus(JVF)
    paths = {k: str(root / f"{k}.npz") for k in ("q", "r", "n", "x")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    store_features(paths["x"], extra, Dataset.REFS)
    paths["root"] = root
    return paths


def test_server_int8_stages_sq8_and_answers_as_jax(served_files):
    # --int8: both servers stage the search and noise corpora as SQ8 codes
    # and keep bf16 localizer tables. The candidates equal JAX's pair for
    # pair (scores within 1e-5: the bias column is a float), the matches
    # rows likewise, and save writes the JAX server's snapshot.
    p, root = served_files, served_files["root"]
    (jargs, ji, jl), (targs, ti, tl) = _servers([
        "--ref_features", p["r"], "--score_norm_features", p["n"], "--matches",
        "--int8", "--beta", "1.2",
    ])
    assert torch_serve.staging_dtype(targs) == jax_serve.staging_dtype(jargs) == INT8
    assert torch_serve.table_dtype(targs) == jax_serve.table_dtype(jargs) == "bfloat16"
    assert tl._table_dtype == torch.bfloat16
    for side in ("jax", "torch"):
        os.makedirs(root / side, exist_ok=True)

    def both(line_of):
        return [mod.serve_request(index, agg, loc, line_of(str(root / side)), args)
                for side, args, index, loc, mod, agg in (
                    ("jax", jargs, ji, jl, jax_serve, JaxAgg()),
                    ("torch", targs, ti, tl, torch_serve, TorchAgg()))]

    def rows(path):
        lines = _read(path).decode().splitlines()
        head = lines[0].split(",")
        score = head.index("score")
        return ([[f for i, f in enumerate(x.split(",")) if i != score] for x in lines[1:]],
                [float(x.split(",")[score]) for x in lines[1:]])

    def search(tag):
        j, t = both(lambda d: f"{p['q']}\t{d}/{tag}_c.csv\t{d}/{tag}_m.csv")
        assert j.split("\t")[0] == t.split("\t")[0] == "ok"
        for suffix in ("c", "m"):
            (a, sa), (b, sb) = (rows(root / side / f"{tag}_{suffix}.csv")
                                for side in ("jax", "torch"))
            assert b == a and b, (tag, suffix)
            np.testing.assert_allclose(sb, sa, rtol=0, atol=FLOAT_ATOL)

    search("a")
    both(lambda d: f"add\t{p['x']}")
    both(lambda d: "remove\tR000001")
    search("g")
    j, t = both(lambda d: "stats")
    assert t == j and t.split("\t")[4] == INT8
    both(lambda d: f"save\t{d}/snap.npz")
    with np.load(root / "jax" / "snap.npz") as a, np.load(root / "torch" / "snap.npz") as b:
        for key in ("video_ids", "features", "timestamps"):
            np.testing.assert_array_equal(b[key], a[key])
    assert ti._searcher.searcher._refs.dtype == torch.int8
    assert ti._searcher.noise_searcher._refs.dtype == torch.int8
    _check_staged_like_jax(ti._searcher.searcher, ji._searcher.searcher)


def test_server_int8_subprocess_matches_in_process_index(served_files, tmp_path):
    # The JAX package's test_int8_staging: the served candidates equal the
    # in-process int8 index's, and stats reports int8.
    from vsc2022_torch.metrics import CandidatePair
    from vsc2022_torch.retrieval.candidates import rank_candidates
    from vsc2022_torch.storage import load_features

    p = served_files
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(tmp_path / "c.csv")
    with ServeClient.spawn(p["r"], score_norm_features=p["n"], int8=True, device="cpu",
                           extra_args=["--beta", str(BETA)], env=env,
                           cwd=REPO) as client:
        client.search(p["q"], candidates_csv=out)
        stats = client.stats()
    assert stats.dtype == INT8
    index = TorchSNIndex(D, load_features(p["n"], Dataset.REFS), beta=BETA, dtype=INT8,
                         device="cpu")
    index.add(load_features(p["r"], Dataset.REFS))
    queries = load_features(p["q"], Dataset.QUERIES)
    want = rank_candidates(index.search(queries, global_k=1200 * len(queries)),
                           TorchAgg())[: 25 * len(queries)]
    got = CandidatePair.read_csv(out)
    assert [(c.query_id, c.ref_id) for c in got] == [(c.query_id, c.ref_id) for c in want]
    np.testing.assert_allclose([c.score for c in got], [c.score for c in want],
                               rtol=0, atol=FLOAT_ATOL)
