"""bf16 storage and search: the port's bfloat16 configuration against the
JAX package's, on the CPU (the kernels' plain versions, which widen bf16
operands to f32 before the product).

- Staging: the corpus and the queries round to bf16 (nearest even) bit
  for bit as the JAX searcher's ``ml_dtypes`` staging does, halfway and
  negative values included; ``searcher_from_arrays`` takes a JAX bf16
  corpus bit for bit.
- Search: on integer inputs (exact in bf16, every product and sum exact)
  ``row_nn`` and ``global_topk`` in both collection modes are identical to
  JAX's, tie order included. Float inputs are held against a dense oracle
  built from the widened bf16 inputs (XLA and torch sum in other orders:
  scores within 1e-5).
- Score normalization, the SN searcher and index, the entry points, the
  localizers' bf16 reference tables and the server with its default
  flags: on dyadic inputs every score is exact on both sides, so the
  selections and CSVs are identical; where a float rounding order
  differs (the f32 localization over an unrounded bias, the DnS chamfer)
  the rows are identical and the scores within 1e-5.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_serve import BETA, D, _corpus, _dns_case, _dyadic, _servers
from vsc2022_torch import descriptor_eval as torch_descriptor_eval
from vsc2022_torch.baseline import dns_baseline as torch_dns
from vsc2022_torch.baseline import sscd_baseline as torch_driver
from vsc2022_torch.convert import searcher_from_arrays
from vsc2022_torch.localization import TNLocalizationMaxSim as TorchMaxSim
from vsc2022_torch.metrics import CandidatePair as TorchPair
from vsc2022_torch.ops import kernels
from vsc2022_torch.ops.similarity import COLLECTION_ENV
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_torch.retrieval import serve as torch_serve
from vsc2022_torch.retrieval.candidates import MaxScoreAggregation as TorchAgg
from vsc2022_torch.retrieval.candidates import rank_candidates as torch_rank
from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex as TorchSNIndex
from vsc2022_torch.retrieval.score_norm import score_normalize as torch_score_normalize
from vsc2022_torch.retrieval.sn_search import ScoreNormalizedSearcher as TorchSN
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu import metrics as jm
from vsc2022_tpu.baseline import dns_baseline as jax_dns
from vsc2022_tpu.baseline import sscd_baseline as jax_driver
from vsc2022_tpu.descriptor_eval_lib import DescriptorEvalProtocol, evaluate_descriptor_track
from vsc2022_tpu.localization import TNLocalizationMaxSim as JaxMaxSim
from vsc2022_tpu.metrics import Dataset
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher
from vsc2022_tpu.retrieval import serve as jax_serve
from vsc2022_tpu.retrieval.candidates import MaxScoreAggregation as JaxAgg
from vsc2022_tpu.retrieval.candidates import rank_candidates as jax_rank
from vsc2022_tpu.retrieval.index import ScoreNormalizedVideoIndex as JaxSNIndex
from vsc2022_tpu.retrieval.score_norm import score_normalize as jax_score_normalize
from vsc2022_tpu.retrieval.sn_search import ScoreNormalizedSearcher as JaxSN
from vsc2022_tpu.storage import store_features
from vsc2022_tpu.types import VideoFeature as JVF

BF16 = "bfloat16"
FLOAT_ATOL = 1e-5  # f32 sums of exact bf16 products in another order


def _bits(x) -> np.ndarray:
    """uint16 bits of a port bf16 tensor or a JAX / ml_dtypes bf16 array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _widened(x) -> np.ndarray:
    """A JAX / ml_dtypes bf16 array, or a port tensor, as f32 values."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)


# ---- staging ----------------------------------------------------------------------


def _rounding_rows(seed):
    """Random floats plus values exactly halfway between two bf16 values
    (which round to the even one), their negatives, and magnitudes from
    tiny to large."""
    rng = np.random.RandomState(seed)
    r = (rng.randn(300, 24) * 10.0 ** rng.randint(-6, 4, size=(300, 1))).astype(np.float32)
    halfway = np.float32(1.0) + np.float32(2.0 ** -8) * np.arange(1, 48, 2, dtype=np.float32)
    r[0] = halfway
    r[1] = -halfway
    r[2] = halfway * np.float32(2.0 ** -20)
    r[3] = -halfway * np.float32(2.0 ** 30)
    return r


def test_bf16_staging_bit_identical_to_jax():
    r = _rounding_rows(0)
    q = _rounding_rows(1)[:37]
    js = JaxSearcher(r, dtype=BF16)
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    assert ts._refs.dtype == torch.bfloat16
    assert ts._refs.shape == js._refs.shape
    np.testing.assert_array_equal(_bits(ts._refs), _bits(js._refs))
    # The halfway values went to the even neighbour, not up.
    assert _bits(ts._refs[0, 0]) == _bits(np.float32(1.0).astype(ml_dtypes.bfloat16))
    jq = js._stage_queries(q, 40)
    np.testing.assert_array_equal(_bits(ts._stage_queries(q)), _bits(jq)[:37])
    # Growth and compaction keep the dtype and the bits.
    new = _rounding_rows(2)[:50]
    js.append_rows(new)
    ts.append_rows(new)
    keep = np.flatnonzero(np.random.RandomState(3).rand(350) < 0.7)
    js.keep_rows(keep)
    ts.keep_rows(keep)
    assert ts._refs.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ts._refs), _bits(js._refs))


def test_searcher_from_a_jax_bf16_corpus_is_bit_identical():
    r = _rounding_rows(4)
    js = JaxSearcher(r, dtype=BF16)
    staged = np.asarray(js._refs)
    assert staged.dtype == ml_dtypes.bfloat16
    ts = searcher_from_arrays(staged, int(js._n_valid), np.asarray(js._ref_sq),
                              device="cpu")
    assert ts.dtype == BF16 and ts.n_refs == 300
    np.testing.assert_array_equal(_bits(ts._refs), _bits(js._refs))


def test_bf16_ref_norm_is_taken_in_f32():
    r = _rounding_rows(5)
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    want = np.linalg.norm(_widened(ts._refs).astype(np.float64), axis=1).max()
    np.testing.assert_allclose(ts._ref_norm_max, want, rtol=1e-6)


# ---- search -------------------------------------------------------------------------


def test_bf16_row_nn_identical_to_jax_on_integers():
    q, r = _ints((45, 20), 6), _ints((1300, 20), 7)
    want = JaxSearcher(r, dtype=BF16).row_nn(q)
    got = TorchSearcher(r, dtype=BF16, device="cpu").row_nn(q)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("nq,n,d,k,kappa", [
    (31, 4100, 20, 700, 16),  # planted ties, several deficient rows
    (13, 4096, 12, 60, 4),  # k > nq·κ: τ = −inf, every row searched
    (17, 2100, 1025, 300, 8),  # the DnS width: the stream reads a padded copy
])
def test_bf16_global_topk_identical_to_jax_on_integers(monkeypatch, mode, nq, n, d, k,
                                                       kappa):
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", mode)
    monkeypatch.setenv(COLLECTION_ENV, mode)
    q, r = _ints((nq, d), nq + d), _ints((n, d), n)
    r[10:20] = 3.0
    q[1] = q[4] = 3.0
    want = JaxSearcher(r, dtype=BF16).global_topk(q, k, kappa=kappa)
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    got = ts.global_topk(q, k, kappa=kappa)
    assert ts.last_stats["mode"] == mode
    for e, g in zip(want, got):
        np.testing.assert_array_equal(g, e)
        assert g.dtype == e.dtype


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_bf16_global_topk_floats_against_the_widened_oracle(monkeypatch, mode):
    monkeypatch.setenv(COLLECTION_ENV, mode)
    rng = np.random.RandomState(8)
    q = rng.randn(40, 32).astype(np.float32)
    r = rng.randn(5000, 32).astype(np.float32)
    r[100:110] = r[99] + 0.01 * rng.randn(10, 32).astype(np.float32)
    q[:3] = r[99]
    k = 900
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    qi, ri, s = ts.global_topk(q, k, kappa=16)
    assert ts.last_stats["mode"] == mode
    # The oracle: f64 products of the bf16-rounded inputs.
    qw = _widened(torch.from_numpy(q).to(torch.bfloat16)).astype(np.float64)
    rw = _widened(ts._refs[:5000]).astype(np.float64)
    scores = qw @ rw.T
    assert len(qi) == k and np.all(np.diff(s) <= 0)
    np.testing.assert_allclose(s, scores[qi, ri], rtol=0, atol=FLOAT_ATOL)
    kth = np.sort(scores.ravel())[-k]
    want = {(a, b) for a, b in zip(*np.nonzero(scores > kth + 2 * FLOAT_ATOL))}
    assert want <= set(zip(qi.tolist(), ri.tolist()))
    # The bf16 scores differ from the f32 corpus's: the rounding happened.
    f32 = TorchSearcher(r, device="cpu").global_topk(q, k, kappa=16)[2]
    assert not np.array_equal(f32, s)


def test_bf16_row_topk_widens_before_the_product():
    q, r = _ints((9, 16), 9), _ints((700, 16), 10)
    r = r * 37.0  # 7-bit integers times 37: some round in bf16
    want_s, want_i = JaxSearcher(r, dtype=BF16).row_topk(q, 6)
    got_s, got_i = TorchSearcher(r, dtype=BF16, device="cpu").row_topk(q, 6)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)


def test_bf16_plain_kernels_widen_instead_of_rounding_the_scores():
    # A bf16 × bf16 torch.matmul rounds its result to bf16; the plain
    # versions widen first, so 257 (not representable in bf16) survives.
    q = torch.tensor([[1.0, 1.0]], dtype=torch.bfloat16)
    r = torch.tensor([[256.0, 1.0], [0.0, 0.0]], dtype=torch.bfloat16)
    assert float(kernels.row_max_plain(q, r, 2)[0]) == 257.0
    assert int(kernels.count_above_plain(q, r, 256.5, 2)[0]) == 1
    rp = torch.zeros((128, 2), dtype=torch.bfloat16)
    rp[:2] = r
    assert float(kernels.pool_writer_plain(q, rp, 2)[0][0, 0, 0]) == 257.0
    assert float(kernels.fused_topk_plain(q, r, 2, 1)[0][0, 0]) == 257.0


# ---- score normalization, the SN searcher and index ----------------------------------


def _sn_features(vf, seed):
    rng = np.random.RandomState(seed)

    def vids(prefix, n, offset=0):
        return [vf(f"{prefix}{offset + i:06d}", np.arange(20, dtype=np.float64),
                   _dyadic(rng, 20)) for i in range(n)]

    return vids("Q", 4), vids("R", 6), vids("R", 5, offset=500)


def test_bf16_score_normalize_identical_to_jax():
    # β = 1.2 makes the bias inexact in bf16: both sides keep it in f32.
    (jq, jr, jn), (tq, tr, tn) = _sn_features(JVF, 11), _sn_features(TVF, 11)
    jq2, jr2 = jax_score_normalize(jq, jr, jn, beta=1.2, dtype=BF16)
    tq2, tr2 = torch_score_normalize(tq, tr, tn, beta=1.2, dtype=BF16, device="cpu")
    for a, b in zip(jq2 + jr2, tq2 + tr2):
        assert b.feature.dtype == a.feature.dtype == np.float32
        np.testing.assert_array_equal(b.feature, a.feature)


def test_bf16_sn_searcher_identical_to_jax():
    # Integer rows: the bias −1.2·s rounds when appended in bf16, on both
    # sides alike, and last_q_sn is that bf16 matrix.
    rng = np.random.RandomState(12)
    refs = rng.randint(-3, 4, size=(700, 16)).astype(np.float32)
    noise = rng.randint(-3, 4, size=(300, 16)).astype(np.float32)
    q = rng.randint(-3, 4, size=(37, 16)).astype(np.float32)
    refs[50:60] = q[3]
    js = JaxSN(refs, noise, beta=1.2, dtype=BF16)
    ts = TorchSN(refs, noise, beta=1.2, dtype=BF16, device="cpu")
    for k in (300, 5000):
        for e, g in zip(js.global_topk(q, k), ts.global_topk(q, k)):
            np.testing.assert_array_equal(g, e)
    assert ts.last_q_sn.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ts.last_q_sn), _bits(js.last_q_sn)[:37])
    assert not np.array_equal(_widened(ts.last_q_sn)[:, -1],
                              ts.normalize_queries(q).numpy()[:, -1])
    # The unfused normalization keeps the f32 bias, as JAX's promotion does.
    np.testing.assert_array_equal(ts.normalize_queries(q).numpy(),
                                  np.asarray(js.normalize_queries(q)))


@pytest.mark.parametrize("d", [13, 16])
def test_bf16_row_max_copy_built_on_first_use_and_dropped_on_change(d):
    # The tensor-core kernels (row_max.bf16 here) read rows of a multiple of
    # 8 values: the searcher keeps a zero-padded copy of its bf16 corpus (the
    # corpus itself when D is a multiple of 8), made on first use and
    # dropped when the corpus changes.
    rng = np.random.RandomState(d)
    r = rng.randint(-3, 4, size=(300, d)).astype(np.float32)
    q = rng.randint(-3, 4, size=(9, d)).astype(np.float32)
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    assert ts._tc_copy is None
    want = JaxSearcher(r, dtype=BF16).row_nn(q)
    np.testing.assert_array_equal(ts.row_nn(q), want)
    copy = ts._tc_copy
    width = kernels.padded_width(d)
    assert copy.dtype == torch.bfloat16 and copy.shape == (ts._refs.shape[0], width)
    assert (copy is ts._refs) == (width == d)
    assert torch.equal(copy[:, :d], ts._refs) and not copy[:, d:].any()
    assert ts.tensor_core_refs() is copy  # kept
    new = rng.randint(-3, 4, size=(40, d)).astype(np.float32)
    ts.append_rows(new)
    assert ts._tc_copy is None
    both = np.concatenate([r, new])
    np.testing.assert_array_equal(ts.row_nn(q), JaxSearcher(both, dtype=BF16).row_nn(q))
    assert ts._tc_copy.shape[0] == ts._refs.shape[0]
    keep = np.arange(0, 340, 3)
    ts.keep_rows(keep)
    assert ts._tc_copy is None
    np.testing.assert_array_equal(ts.row_nn(q),
                                  JaxSearcher(both[keep], dtype=BF16).row_nn(q))
    assert torch.equal(ts.tensor_core_refs()[:, :d], ts._refs)
    # An f32 corpus is read as staged.
    f32 = TorchSearcher(r, device="cpu")
    assert f32.tensor_core_refs() is f32._refs and f32._tc_copy is None


@pytest.mark.parametrize("d", [512, 1025])
def test_tensor_core_copy_built_on_first_use_and_dropped_on_change(monkeypatch, d):
    # The streaming collection reads the tensor-core copy: the staged corpus
    # itself at D = 512 (no memory), a 1,032-column copy at D = 1025; built
    # by the first search and dropped when the corpus changes.
    monkeypatch.setenv(COLLECTION_ENV, "stream")
    rng = np.random.RandomState(d)
    r = rng.randint(-3, 4, size=(300, d)).astype(np.float32)
    q = rng.randint(-3, 4, size=(9, d)).astype(np.float32)
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    assert ts._tc_copy is None
    np.testing.assert_array_equal(ts.global_topk(q, 50)[1],
                                  JaxSearcher(r, dtype=BF16).global_topk(q, 50)[1])
    copy = ts._tc_copy
    assert copy.shape == (ts._refs.shape[0], kernels.padded_width(d))
    assert (copy is ts._refs) == (d == 512)
    assert torch.equal(copy[:, :d], ts._refs) and not copy[:, d:].any()
    ts.global_topk(q, 50)
    assert ts._tc_copy is copy  # kept
    new = rng.randint(-3, 4, size=(40, d)).astype(np.float32)
    ts.append_rows(new)
    assert ts._tc_copy is None
    both = np.concatenate([r, new])
    for e, g in zip(JaxSearcher(both, dtype=BF16).global_topk(q, 50), ts.global_topk(q, 50)):
        np.testing.assert_array_equal(g, e)
    assert ts._tc_copy.shape[0] == ts._refs.shape[0]
    keep = np.arange(0, 340, 3)
    ts.keep_rows(keep)
    assert ts._tc_copy is None
    for e, g in zip(JaxSearcher(both[keep], dtype=BF16).global_topk(q, 50),
                    ts.global_topk(q, 50)):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("d", [16, 13])
def test_collections_hand_each_kernel_its_pair(monkeypatch, d):
    # Each collection pads the queries once and hands both its kernels the
    # same tensors over the tensor-core copy: the stream fused_topk and
    # count_above, the pool pool_writer and count_above (the ambiguous rows
    # of those queries). One bf16 count: count_above takes no partner.
    calls = []
    real = {name: getattr(kernels, name)
            for name in ("fused_topk", "count_above", "pool_writer")}

    def spy(name):
        def call(q, refs, *args, **kwargs):
            assert not kwargs
            calls.append((name, q, refs))
            return real[name](q, refs, *args)
        return call

    for name in real:
        monkeypatch.setattr(kernels, name, spy(name))
    q, r = _ints((11, d), 30 + d), _ints((3000, d), 31 + d)
    r[10:20] = 3.0
    q[1] = q[4] = 3.0
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    for mode in ("stream", "pooled"):
        monkeypatch.setenv(COLLECTION_ENV, mode)
        calls.clear()
        want = JaxSearcher(r, dtype=BF16).global_topk(q, 100, kappa=8)
        for e, g in zip(want, ts.global_topk(q, 100, kappa=8)):
            np.testing.assert_array_equal(g, e)
        assert ts.last_stats["mode"] == mode
        names = [c[0] for c in calls]
        (_, q_first, r_first), (_, q_count, r_count) = calls
        assert r_count is r_first is ts.tensor_core_refs()
        assert q_first.shape[1] == q_count.shape[1] == kernels.padded_width(d)
        if mode == "stream":
            assert names == ["fused_topk", "count_above"]
            assert q_count is q_first
        else:
            assert names == ["pool_writer", "count_above"]
            assert q_count.shape[0] == ts.last_stats["amb_rows"] >= 2
            assert all(any(torch.equal(row, x) for x in q_first) for row in q_count)


@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("d", [16, 13])
def test_research_scores_on_the_kernels_product(monkeypatch, d, mode):
    # A re-searched row of a bf16 corpus scores on the kernels' own product
    # (kernels.scores_above over the padded queries and tensor_core_refs,
    # one call over every re-searched row), as the JAX searcher re-searches
    # with its collection's block product; an f32 corpus re-searches with
    # torch.matmul. Both agree with JAX.
    calls = []
    real = kernels.scores_above

    def spy(q, refs, n_valid, floor, capacity=None):
        calls.append((q, refs, n_valid))
        return real(q, refs, n_valid, floor, capacity=capacity)

    monkeypatch.setattr(kernels, "scores_above", spy)
    monkeypatch.setenv(COLLECTION_ENV, mode)
    q, r = _ints((11, d), 40 + d), _ints((3000, d), 41 + d)
    r[10:20] = 3.0  # 10 equal columns in segment 0: re-searched rows
    q[1] = q[4] = 3.0
    for dtype in (BF16, "float32"):
        calls.clear()
        ts = TorchSearcher(r, dtype=dtype, device="cpu")
        want = JaxSearcher(r, dtype=dtype).global_topk(q, 100, kappa=8)
        for e, g in zip(want, ts.global_topk(q, 100, kappa=8)):
            np.testing.assert_array_equal(g, e)
        assert ts.last_stats["mode"] == mode and ts.last_stats["corpus_rows"] > 0
        if dtype == BF16:
            assert len(calls) == 1
            assert sum(rows.shape[0] for rows, _, _ in calls) == ts.last_stats["corpus_rows"]
            assert all(refs is ts.tensor_core_refs() and n == ts.n_refs
                       and rows.shape[1] == kernels.padded_width(d)
                       for rows, refs, n in calls)
        else:
            assert not calls


def test_bf16_sn_normalize_queries_identical_to_jax_at_odd_width():
    # D = 13: the noise corpus's row_max copy carries 3 zero columns.
    rng = np.random.RandomState(13)
    refs = rng.randint(-3, 4, size=(500, 13)).astype(np.float32)
    noise = rng.randint(-3, 4, size=(400, 13)).astype(np.float32)
    q = rng.randint(-3, 4, size=(21, 13)).astype(np.float32)
    js = JaxSN(refs, noise, beta=1.2, dtype=BF16)
    ts = TorchSN(refs, noise, beta=1.2, dtype=BF16, device="cpu")
    np.testing.assert_array_equal(ts.normalize_queries(q).numpy(),
                                  np.asarray(js.normalize_queries(q)))
    assert ts.noise_searcher._tc_copy.shape[1] == 16
    for e, g in zip(js.global_topk(q, 400), ts.global_topk(q, 400)):
        np.testing.assert_array_equal(g, e)


def test_bf16_sn_index_and_localizer_spaces_identical_to_jax():
    (jq, jr, jn, jx), (tq, tr, tn, tx) = _corpus(JVF), _corpus(TVF)
    j = JaxSNIndex(D, jn, beta=1.2, dtype=BF16)
    t = TorchSNIndex(D, tn, beta=1.2, dtype=BF16, device="cpu")
    j.add(jr)
    t.add(tr)
    k = 1200 * len(jq)

    def hits(index, queries, rank, agg):
        return [(c.query_id, c.ref_id, c.score)
                for c in rank(index.search(queries, global_k=k), agg)]

    assert hits(t, tq, torch_rank, TorchAgg()) == hits(j, jq, jax_rank, JaxAgg())
    for a, b in zip(j.localizer_queries(jq), t.localizer_queries(tq)):
        np.testing.assert_array_equal(b.feature, _widened(a.feature))
    j.add(jx)
    t.add(tx)
    j.remove(["R000001"])
    t.remove(["R000001"])
    assert t._searcher.searcher._refs.dtype == torch.bfloat16
    assert hits(t, tq, torch_rank, TorchAgg()) == hits(j, jq, jax_rank, JaxAgg())


# ---- the entry points ------------------------------------------------------------------


@pytest.fixture(scope="module")
def dyadic_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16")
    queries, refs, noise, _ = _corpus(JVF)
    paths = {k: str(root / f"{k}.npz") for k in ("q", "r", "n")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    gt = [jm.Match("Q000000", "R000001", 1.0, 4.0, 14.0, 2.0, 12.0),
          jm.Match("Q000001", "R000004", 1.0, 10.0, 22.0, 0.0, 12.0)]
    paths["gt"] = str(root / "gt.csv")
    jm.Match.write_csv(gt, paths["gt"])
    paths["root"] = root
    return paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("score_norm", [False, True])
def test_sscd_baseline_bf16_identical_to_jax(dyadic_files, score_norm):
    p = dyadic_files
    tag = "sn" if score_norm else "raw"
    common = ["--query_features", p["q"], "--ref_features", p["r"], "--bf16"]
    if score_norm:
        common += ["--score_norm_features", p["n"]]
    jax_out, torch_out = str(p["root"] / f"jax_{tag}"), str(p["root"] / f"torch_{tag}")
    jax_driver.main(jax_driver.parser.parse_args(common + ["--output_path", jax_out]))
    result = torch_driver.main(torch_driver.parser.parse_args(
        common + ["--output_path", torch_out, "--device", "cpu",
                  "--ground_truth", p["gt"]]))
    cands = _read(os.path.join(torch_out, "candidates.csv"))
    assert cands == _read(os.path.join(jax_out, "candidates.csv"))
    assert cands.count(b"\n") > 2
    want_m = _read(os.path.join(jax_out, "matches.csv")).decode().splitlines()
    got_m = _read(os.path.join(torch_out, "matches.csv")).decode().splitlines()
    if not score_norm:  # exact scores: byte-identical
        assert got_m == want_m
    # With score normalization the f32 localization adds the unrounded
    # bias in each side's summation order: same rows, scores within 1e-5.
    assert len(got_m) == len(want_m) > 1
    score = want_m[0].split(",").index("score")
    for a, b in zip(got_m[1:], want_m[1:]):
        fa, fb = a.split(","), b.split(",")
        assert fa[:score] + fa[score + 1:] == fb[:score] + fb[score + 1:]
        assert abs(float(fa[score]) - float(fb[score])) <= FLOAT_ATOL
    assert 0.0 < result["candidate_uap"] <= 1.0


def test_descriptor_eval_bf16_identical_to_jax(dyadic_files, tmp_path):
    p = dyadic_files
    ap, want = evaluate_descriptor_track(p["q"], p["r"], p["gt"],
                                         protocol=DescriptorEvalProtocol(dtype=BF16))
    jm.CandidatePair.write_csv(want, str(tmp_path / "jax.csv"))
    uap = torch_descriptor_eval.main(torch_descriptor_eval.parser.parse_args([
        "--query_features", p["q"], "--ref_features", p["r"], "--ground_truth",
        p["gt"], "--candidates_output", str(tmp_path / "torch.csv"), "--bf16",
        "--device", "cpu"]))
    assert _read(tmp_path / "torch.csv") == _read(tmp_path / "jax.csv")
    assert uap == ap.ap


# ---- the localizers' bf16 reference tables ---------------------------------------------


def _float_localizer_case(vf):
    """Unit-norm float rows (bf16 rounds them), two planted copies."""
    rng = np.random.RandomState(21)

    def vid(name, n):
        x = rng.randn(n, 24).astype(np.float32)
        return vf(name, np.arange(n, dtype=np.float64),
                  x / np.linalg.norm(x, axis=1, keepdims=True))

    refs = [vid(f"R{i:06d}", 30 + 3 * i) for i in range(5)]
    queries = [vid(f"Q{i:06d}", 28) for i in range(3)]
    queries[0].feature[3:15] = refs[1].feature[5:17]
    queries[2].feature[10:24] = refs[3].feature[0:14]
    extra = [vid("R000100", 26)]
    queries[1].feature[2:12] = extra[0].feature[8:18]
    return queries, refs, extra


def _match_rows(matches):
    return [(m.query_id, m.ref_id, m.query_start, m.query_end, m.ref_start,
             m.ref_end) for m in matches], [m.score for m in matches]


def test_tn_localizer_bf16_tables_match_jax():
    pairs = [("Q000000", "R000001"), ("Q000002", "R000003"), ("Q000001", "R000100"),
             ("Q000002", "R000000")]
    out, tables = {}, {}
    for vf, maxsim, pair in ((JVF, JaxMaxSim, jm.CandidatePair),
                             (TVF, TorchMaxSim, TorchPair)):
        queries, refs, extra = _float_localizer_case(vf)
        kw = {} if vf is JVF else {"device": "cpu"}
        loc = maxsim(queries, refs, model_type="TN", similarity_bias=0.5,
                     table_dtype=BF16, **kw)
        first = loc.localize_all([pair(q, r, 1.0) for q, r in pairs[:2]])
        loc.add_refs(extra)
        loc.remove_refs(["R000000"])
        second = loc.localize_all([pair(q, r, 1.0) for q, r in pairs[:3]])
        out[vf] = (_match_rows(first), _match_rows(second))
        tables[vf] = loc
    for (got, gs), (want, ws) in zip(out[TVF], out[JVF]):
        assert got == want and got
        np.testing.assert_allclose(gs, ws, rtol=0, atol=FLOAT_ATOL)
    # The reference rows are stored in bf16, bit for bit as JAX stores them;
    # the query rows stay f32.
    t, j = tables[TVF], tables[JVF]
    table, offsets = t._tables["ref"]
    assert table.dtype == torch.bfloat16 and t._tables["query"][0].dtype == torch.float32
    for vid, (start, n) in offsets.items():
        js, jn = j._r_offs[vid]
        assert jn == n
        np.testing.assert_array_equal(_bits(table[start:start + n]),
                                      _bits(j._r_table)[js:js + n])


def test_dns_localizer_bf16_tables_match_jax():
    pairs = [("Q000000", "R000001"), ("Q000002", "R000100"), ("Q000001", "R000003")]
    out = {}
    for vf, cls, pair in ((JVF, jax_dns.DnSLocalization, jm.CandidatePair),
                          (TVF, torch_dns.DnSLocalization, TorchPair)):
        queries, refs, extra, qf, rf, xf = _dns_case(vf)
        kw = {} if vf is JVF else {"device": "cpu"}
        loc = cls({}, dict(rf), [], refs, model_type="TN", similarity_bias=0.5,
                  table_dtype=BF16, **kw)
        loc.set_queries(queries, queries_fine=qf)
        first = loc.localize_all([pair(*pairs[0], 1.0)])
        loc.add_refs(extra, refs_fine=xf)
        loc.remove_refs(["R000003"])
        second = loc.localize_all([pair(q, r, 1.0) for q, r in pairs[:2]])
        out[vf] = (_match_rows(first), _match_rows(second))
        if vf is TVF:
            assert loc._tables["ref_fine"][0].dtype == torch.bfloat16
            assert loc._tables["ref"][0].dtype == torch.bfloat16
    for (got, gs), (want, ws) in zip(out[TVF], out[JVF]):
        assert got == want and got
        np.testing.assert_allclose(gs, ws, rtol=0, atol=FLOAT_ATOL)


def test_localizer_rejects_unknown_table_dtype():
    with pytest.raises(ValueError, match="table_dtype"):
        TorchMaxSim([], [], table_dtype="int8", device="cpu")


# ---- the server on the JAX package's default flags -------------------------------------


@pytest.fixture(scope="module")
def served_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_bf16")
    queries, refs, noise, extra = _corpus(JVF)
    paths = {k: str(root / f"{k}.npz") for k in ("q", "r", "n", "x")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    store_features(paths["x"], extra, Dataset.REFS)
    paths["root"] = root
    return paths


def test_server_default_flags_stage_bf16_as_jax(served_files):
    # No dtype flag: both servers stage bf16. β = 1.2 rounds the bias in
    # the bf16 queries the localizer aligns with, alike on both sides.
    p, root = served_files, served_files["root"]
    (jargs, ji, jl), (targs, ti, tl) = _servers([
        "--ref_features", p["r"], "--score_norm_features", p["n"], "--matches",
        "--beta", "1.2",
    ])
    assert torch_serve.staging_dtype(targs) == jax_serve.staging_dtype(jargs) == BF16
    assert tl._table_dtype == torch.bfloat16
    for side in ("jax", "torch"):
        os.makedirs(root / side, exist_ok=True)

    def both(line_of):
        return [mod.serve_request(index, agg, loc, line_of(str(root / side)), args)
                for side, args, index, loc, mod, agg in (
                    ("jax", jargs, ji, jl, jax_serve, JaxAgg()),
                    ("torch", targs, ti, tl, torch_serve, TorchAgg()))]

    def search(tag):
        j, t = both(lambda d: f"{p['q']}\t{d}/{tag}_c.csv\t{d}/{tag}_m.csv")
        assert j.split("\t")[:5:2] == t.split("\t")[:5:2]
        for suffix in ("c", "m"):
            a = _read(root / "jax" / f"{tag}_{suffix}.csv")
            b = _read(root / "torch" / f"{tag}_{suffix}.csv")
            assert b == a and b.count(b"\n") > 1, (tag, suffix)

    search("a")
    both(lambda d: f"add\t{p['x']}")
    both(lambda d: "remove\tR000001")
    search("g")
    j, t = both(lambda d: "stats")
    assert t == j and t.split("\t")[4] == BF16
    assert ti._searcher.searcher._refs.dtype == torch.bfloat16
    assert ti._searcher.noise_searcher._refs.dtype == torch.bfloat16


def test_server_f32_flag_still_stages_f32(served_files):
    _, (targs, ti, tl) = _servers([
        "--ref_features", served_files["r"], "--score_norm_features",
        served_files["n"], "--matches", "--f32", "--beta", str(BETA),
    ])
    reply = torch_serve.serve_request(ti, TorchAgg(), tl, "stats", targs)
    assert reply.split("\t")[4] == "float32"
    assert tl._table_dtype == torch.float32
