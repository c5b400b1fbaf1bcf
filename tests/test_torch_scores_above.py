"""The tensor-core re-search's entries at or above each row's floor
(``kernels.scores_above``, scores_above.bf16 and scores_above.int8 on the
card) on the CPU.

- The plain version is ``scores_plain`` then ``nonzero(>= floor)``: the
  same (row, col) set, each entry once, and bit-identical scores, at odd
  widths (D = 13 keeps pad columns), ``n_valid`` short of the corpus and
  per-row floors that mix −inf, +inf and finite values. The wrapper runs
  it for CPU tensors whatever the capacity hint.
- Over int8 codes the plain version takes their ``scale``: the entries of
  ``scores_plain(..., scale)`` ≥ floor, bit for bit.
- The searcher over a bf16 or int8 corpus re-searches with one
  ``scores_above`` call per ``_corpus_above`` over every re-searched row,
  with a capacity that holds what it returns (int8: with the codes'
  scales), and its ``global_topk`` is the JAX searcher's in both
  collection modes (integer inputs, dyadic int8 rows: every score exact).
  Where τ = −inf keeps every entry, the rows go in chunks whose every
  entry fits the budget, and the answer is still JAX's. An f32 corpus
  re-searches densely.

The kernels themselves are held against this plain version and against
dense scores.bf16 / scores.int8 on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from vsc2022_torch.ops import kernels
from vsc2022_torch.ops import similarity
from vsc2022_torch.ops.similarity import COLLECTION_ENV
from vsc2022_torch.ops.similarity import SimilaritySearcher as TorchSearcher
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher

BF16 = "bfloat16"
INT8 = "int8"


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)


def _unit_rows(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


def _floors(scores: torch.Tensor) -> torch.Tensor:
    """Per-row floors: −inf on every fifth row, +inf on every seventh, and
    elsewhere a score of the row (so ties sit on the floor) at one of
    several depths."""
    m = scores.shape[0]
    ranked = torch.sort(scores, dim=1, descending=True).values
    depth = torch.tensor([0, 3, 17, 60])[torch.arange(m) % 4]
    floor = ranked[torch.arange(m), depth.clamp(max=scores.shape[1] - 1)].clone()
    floor[::5] = float("-inf")
    floor[3::7] = float("inf")
    return floor


def _sorted(entries):
    """(scores, rows, cols) ordered by (row, col), as int64 indices."""
    s, r, c = entries
    r, c = r.long(), c.long()
    order = torch.argsort(r * (int(c.max()) + 1 if c.numel() else 1) + c)
    return s[order], r[order], c[order]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [13, 16, 64])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_plain_is_dense_scores_then_nonzero(d, dtype, kind):
    m, n, n_valid = 37, 1300, 1237  # n_valid: no multiple of 256, short of n
    if kind == "int":
        q, r = torch.from_numpy(_ints((m, d), d)), torch.from_numpy(_ints((n, d), d + 1))
    else:
        q, r = _unit_rows((m, d), d), _unit_rows((n, d), d + 1)
    r[40:45] = r[39]  # ties on a row's floor
    q, r = q.to(dtype), r.to(dtype)
    # A bf16 corpus as the searchers stage it: zero pad columns.
    refs = kernels.pad_columns(r) if dtype == torch.bfloat16 else r
    dense = kernels.scores_plain(q, refs, n_valid)
    floor = _floors(dense)
    rr, cc = torch.nonzero(dense >= floor[:, None], as_tuple=True)
    got = kernels.scores_above_plain(q, refs, n_valid, floor)
    assert got[0].dtype == torch.float32
    assert got[1].dtype == got[2].dtype == torch.int32
    assert got[0].shape == got[1].shape == got[2].shape == rr.shape
    gs, gr, gc = _sorted(got)
    assert torch.equal(gr, rr) and torch.equal(gc, cc)  # each entry once
    assert torch.equal(gs.view(torch.int32), dense[rr, cc].view(torch.int32))
    assert int(gc.max()) < n_valid
    # Every row with a finite floor holds its floor's entry; +inf rows none,
    # −inf rows all of theirs.
    counts = torch.bincount(gr, minlength=m)
    assert (counts[torch.isposinf(floor)] == 0).all()
    assert (counts[torch.isneginf(floor)] == n_valid).all()
    assert (counts[torch.isfinite(floor)] >= 1).all()
    # The wrapper takes the plain version on the CPU, capacity or not.
    for capacity in (None, 0, 1):
        again = kernels.scores_above(q, refs, n_valid, floor, capacity=capacity)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


def _dyadic_rows(n, d, seed):
    """Rows of integer codes in [-127, 127] with one ±127 a row, times
    2⁻ᵏ: the SQ8 scale is 2⁻ᵏ exactly and every score of integer queries
    exact."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(-127, 128, size=(n, d)).astype(np.float32)
    codes[np.arange(n), rng.randint(0, d, size=n)] = rng.choice([-127.0, 127.0], n)
    return codes * (2.0 ** -rng.randint(0, 7, size=(n, 1))).astype(np.float32)


@pytest.mark.parametrize("d", [13, 16, 64])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_plain_int8_is_dense_scores_then_nonzero(d, kind):
    # Over int8 codes (padded to 16 columns, as staged) with their scales.
    m, n, n_valid = 37, 1300, 1237
    if kind == "int":
        q = torch.from_numpy(_ints((m, d), d))
        rows = _dyadic_rows(n, d, d + 1)
    else:
        q, rows = _unit_rows((m, d), d), _unit_rows((n, d), d + 1).numpy()
    codes, scale = similarity.quantize_rows_int8(rows)
    codes = kernels.pad_columns(torch.from_numpy(codes), kernels.I8_ROW_ALIGN)
    scale = torch.from_numpy(scale)
    dense = kernels.scores_plain(q, codes, n_valid, scale=scale)
    floor = _floors(dense)
    rr, cc = torch.nonzero(dense >= floor[:, None], as_tuple=True)
    got = kernels.scores_above_plain(q, codes, n_valid, floor, scale=scale)
    gs, gr, gc = _sorted(got)
    assert torch.equal(gr, rr) and torch.equal(gc, cc)
    assert torch.equal(gs.view(torch.int32), dense[rr, cc].view(torch.int32))
    for capacity in (None, 1):
        again = kernels.scores_above(q, codes, n_valid, floor, capacity=capacity,
                                     scale=scale)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
    # Without the scales the codes' scores differ: the wrapper refuses.
    with pytest.raises(TypeError, match="scale"):
        kernels.scores_above(q, codes, n_valid, floor)


@pytest.mark.parametrize("n_valid", [0, 1, 255])
def test_plain_edges(n_valid):
    q = torch.from_numpy(_ints((5, 16), 3)).bfloat16()
    r = torch.from_numpy(_ints((256, 16), 4)).bfloat16()
    floor = torch.full((5,), float("-inf"))
    s, rr, cc = kernels.scores_above(q, r, n_valid, floor)
    assert s.shape == rr.shape == cc.shape == (5 * n_valid,)
    s, rr, cc = kernels.scores_above(q[:0], r, n_valid, floor[:0])
    assert s.shape == rr.shape == cc.shape == (0,)


def test_scores_above_rejects_what_the_kernel_does_not_take():
    q = torch.ones((3, 8)).bfloat16()
    r = torch.ones((128, 8)).bfloat16()
    floor = torch.zeros(3)
    with pytest.raises(ValueError, match="floor"):
        kernels.scores_above(q, r, 100, torch.zeros(4))
    with pytest.raises(ValueError, match="floor"):
        kernels.scores_above(q, r, 100, floor.double())
    with pytest.raises(ValueError, match="floor"):
        kernels.scores_above(q, r, 100, torch.zeros((3, 1)))
    with pytest.raises(ValueError, match="capacity"):
        kernels.scores_above(q, r, 100, floor, capacity=-1)
    with pytest.raises(ValueError, match="n_valid"):
        kernels.scores_above(q, r, 129, floor)
    with pytest.raises(TypeError, match="share a dtype"):
        kernels.scores_above(q, r.float(), 100, floor)
    with pytest.raises(TypeError, match="scale"):
        kernels.scores_above(q.float(), torch.ones((128, 16), dtype=torch.int8), 100, floor)
    kernels.reset_launches()
    kernels.scores_above(q, r, 100, floor)
    assert kernels.launches[kernels.SCORES_ABOVE] == 0  # the plain version


def _spy(monkeypatch):
    """Records every scores_above call (rows, refs, n_valid, capacity,
    entries returned) and every _corpus_above call (rows, count)."""
    above, corpus = [], []
    real_above = kernels.scores_above
    real_corpus = TorchSearcher._corpus_above

    def scores_above(q, refs, n_valid, floor, capacity=None, scale=None):
        out = real_above(q, refs, n_valid, floor, capacity=capacity, scale=scale)
        above.append((q, refs, n_valid, capacity, out[0].numel(), scale))
        return out

    def corpus_above(self, q_rows, tau, count):
        corpus.append((q_rows.shape[0], count))
        return real_corpus(self, q_rows, tau, count)

    monkeypatch.setattr(kernels, "scores_above", scores_above)
    monkeypatch.setattr(TorchSearcher, "_corpus_above", corpus_above)
    return above, corpus


@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("d", [13, 16, 64])
def test_bf16_research_is_one_launch_and_jax_identical(monkeypatch, d, mode):
    monkeypatch.setenv(COLLECTION_ENV, mode)
    above, corpus = _spy(monkeypatch)
    q, r = _ints((11, d), 50 + d), _ints((3000, d), 51 + d)
    r[10:20] = 3.0  # 10 equal columns in segment 0: re-searched rows
    r[300:330] = 2.0
    q[1] = q[4] = 3.0
    q[7] = 2.0
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    want = JaxSearcher(r, dtype=BF16).global_topk(q, 60, kappa=8)
    for e, g in zip(want, ts.global_topk(q, 60, kappa=8)):
        np.testing.assert_array_equal(g, e)
    stats = ts.last_stats
    assert stats["mode"] == mode and stats["corpus_rows"] > 0 and stats["tau"] > -np.inf
    # One call per re-search, over every re-searched row, on the searcher's
    # padded operands; its capacity holds every entry it returns (so the
    # kernel launches once), and it is the count ≥ τ plus the headroom.
    assert len(corpus) == len(above) == 1
    (rows, refs, n_valid, capacity, entries, scale), (n_rows, count) = above[0], corpus[0]
    assert rows.shape[0] == n_rows == stats["corpus_rows"]
    assert refs is ts.tensor_core_refs() and n_valid == ts.n_refs
    assert rows.shape[1] == kernels.padded_width(d)
    assert capacity == count + similarity.ABOVE_HEADROOM * n_rows
    assert count <= entries <= capacity and scale is None


@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("d", [13, 16, 1025])
def test_int8_research_is_one_launch_and_jax_identical(monkeypatch, d, mode):
    # Over an int8 corpus (dyadic rows, integer queries: every score exact)
    # the re-search is one scores_above call over every re-searched row,
    # on the codes as staged with their scales, and the answer is JAX's.
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setenv("VSC2022_TPU_COLLECTION", mode)
    above, corpus = _spy(monkeypatch)
    q, r = _ints((11, d), 80 + d), _dyadic_rows(3000, d, 81 + d)
    r[10:20] = r[9]  # equal columns in segment 0: re-searched rows
    q[1] = q[4] = np.sign(r[9])
    ts = TorchSearcher(r, dtype=INT8, device="cpu")
    want = JaxSearcher(r, dtype=INT8).global_topk(q, 60, kappa=8)
    for e, g in zip(want, ts.global_topk(q, 60, kappa=8)):
        np.testing.assert_array_equal(g, e)
    stats = ts.last_stats
    assert stats["mode"] == mode and stats["corpus_rows"] > 0 and stats["tau"] > -np.inf
    assert len(corpus) == len(above) == 1
    (rows, refs, n_valid, capacity, entries, scale), (n_rows, count) = above[0], corpus[0]
    assert rows.shape[0] == n_rows == stats["corpus_rows"]
    assert rows.dtype == torch.float32
    assert rows.shape[1] == refs.shape[1] == kernels.padded_width(d, kernels.I8_ROW_ALIGN)
    assert refs is ts._refs and scale is ts._scale and n_valid == ts.n_refs
    assert capacity == count + similarity.ABOVE_HEADROOM * n_rows
    assert count <= entries <= capacity


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_bf16_research_at_minus_inf_chunks_within_the_budget(monkeypatch, mode):
    # τ = −inf keeps every entry: k beyond the rows' κ candidates (stream),
    # or beyond the pool's valid entries (pooled). The rows go in chunks
    # whose every entry fits the (here shrunken) budget.
    monkeypatch.setenv(COLLECTION_ENV, mode)
    monkeypatch.setattr(similarity, "ABOVE_BUDGET_ENTRIES", 1000)
    above, corpus = _spy(monkeypatch)
    q, r = _ints((11, 16), 60), _ints((300, 16), 61)
    kappa = 1 if mode == "pooled" else 8  # the pool holds 6 entries a row
    ts = TorchSearcher(r, dtype=BF16, device="cpu")
    want = JaxSearcher(r, dtype=BF16).global_topk(q, 100, kappa=kappa)
    for e, g in zip(want, ts.global_topk(q, 100, kappa=kappa)):
        np.testing.assert_array_equal(g, e)
    assert ts.last_stats["mode"] == mode and ts.last_stats["tau"] == -np.inf
    assert len(corpus) == 1 and corpus[0] == (11, 11 * 300)
    assert [a[0].shape[0] for a in above] == [3, 3, 3, 2]  # 1000 // 300 rows
    assert all(cap == rows.shape[0] * 300 == entries
               for rows, _, _, cap, entries, _ in above)


def test_f32_and_int8_research_stay_dense(monkeypatch):
    # An f32 corpus re-searches densely with torch.matmul, no scores_above
    # call; an int8 one, whose re-search was dense (scores.int8 chunks)
    # before it moved onto the tensor cores, now takes one scores_above
    # call, as a bf16 one does.
    above, corpus = _spy(monkeypatch)
    q, r = _ints((11, 16), 70), _ints((3000, 16), 71)
    r[10:20] = 3.0
    q[1] = q[4] = 3.0
    for dtype, calls in (("float32", 0), ("int8", 1)):
        ts = TorchSearcher(r, dtype=dtype, device="cpu")
        ts.global_topk(q, 100, kappa=8)
        assert ts.last_stats["corpus_rows"] > 0
        assert len(above) == calls
    assert len(corpus) == 2 and above[0][5] is ts._scale
