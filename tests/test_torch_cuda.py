"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU (and nvcc, to build the kernels); they
skip elsewhere. The file imports nothing of JAX, so it runs on a machine
with the card but no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are integer-valued (randint(-3, 4)), so every score is exact on
both sides and the comparisons are exact, tie-breaks included; the
chamfer is also held on unit-norm floats within 1e-5 (f32 sums of the
products in another order than cuBLAS's). On floats the retrieval kernels
are held against each other bit for bit: they run the same f32 FMA chain
per score, so row_max equals the pool's best winner, count_above the
pool's count wherever the pool holds every entry >= tau, and fused_topk
the pool's best winners. The bf16 variants of count_above, pool_writer and
fused_topk are held bit for bit against the f32 kernels on the widened
inputs, and against each other. row_max.bf16 runs on the tensor cores
(wgmma_gemm.cuh), which sum in their own order: exact on integers, within
BF16_ROW_MAX_ATOL of its plain version on unit-norm floats.
"""

import math

import numpy as np
import pytest
import torch

from vsc2022_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


RAGGED_N = 1337  # not a multiple of the 128-column tile


def _ints(shape, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)
    )


@pytest.mark.parametrize("m,n,d,n_valid", [
    (1, 128, 8, 128), (70, 1000, 33, 999), (200, 4096, 64, 3000),
    (300, 2048, 512, 0),
])
def test_kernels_match_plain(cuda_device, m, n, d, n_valid):
    q, r = _ints((m, d), 1), _ints((n, d), 2)
    r[[5, 7, 40]] = 3.0  # ties inside segment 0
    q[0] = 3.0
    n_pool = -(-n // 128) * 128
    rp = torch.zeros((n_pool, d))
    rp[:n] = r
    qc, rc, rpc = q.to(cuda_device), r.to(cuda_device), rp.to(cuda_device)
    kernels.reset_launches()
    torch.testing.assert_close(
        kernels.row_max(qc, rc, n_valid).cpu(),
        kernels.row_max_plain(q, r, n_valid), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        kernels.count_above(qc, rc, 4.0, n_valid).cpu(),
        kernels.count_above_plain(q, r, 4.0, n_valid), rtol=0, atol=0,
    )
    pv, pi = kernels.pool_writer(qc, rpc, n_valid)
    ev, ei = kernels.pool_writer_plain(q, rp, n_valid)
    torch.testing.assert_close(pv.cpu(), ev, rtol=0, atol=0)
    finite = torch.isfinite(ev)
    assert torch.equal(pi.cpu()[finite], ei[finite])
    assert kernels.launches == {
        "row_max": 1, "count_above": 1, "pool_writer": 1, "fused_topk": 0,
        "chamfer": 0, "row_max.bf16": 0, "count_above.bf16": 0,
        "pool_writer.bf16": 0, "fused_topk.bf16": 0,
    }


@pytest.mark.parametrize("m,n,d,n_valid,kappa", [
    (1, 128, 8, 128, 4), (70, 1000, 33, 999, 32), (200, 4096, 64, 3000, 64),
    (130, 2500, 16, 2400, 7), (300, 2048, 512, 0, 8), (65, 3000, 24, 2990, 192),
    (90, 5000, 16, 4900, 300), (9, 700, 24, 650, 1500),
    # One row tile split among 132 blocks (S = 132), 16-byte copies.
    (60, 20000, 512, 19990, 32),
    # Blocks whose ranges cross row tiles, 4-byte copies at D = 511, 1025.
    (300, 9000, 1025, 8999, 192), (129, 5000, 511, 4999, 1),
    (200, 30000, 512, 29000, 1500), (260, 6000, 1025, 6000, 300),
])
def test_fused_topk_matches_plain(cuda_device, m, n, d, n_valid, kappa):
    q, r = _ints((m, d), 8), _ints((n, d), 9)
    r[[j for j in (5, 7, 40, 300) if j < n]] = 3.0  # ties in and across segments
    q[0] = 3.0
    kernels.reset_launches()
    got_v, got_i = kernels.fused_topk(q.to(cuda_device), r.to(cuda_device),
                                      n_valid, kappa)
    want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
    assert got_v.shape == got_i.shape == (m, kappa)
    torch.testing.assert_close(got_v.cpu(), want_v, rtol=0, atol=0)
    assert torch.equal(got_i.cpu(), want_i)
    assert kernels.launches["fused_topk"] == 1


@pytest.mark.parametrize("slots", [1, 3, 7, 50])
def test_fused_topk_any_grid(cuda_device, monkeypatch, slots):
    # Few blocks: each block's range spans several row tiles, and each
    # row tile's pieces sit in up to S slots.
    monkeypatch.setattr(kernels, "_reduce_slots", lambda t, name, vec: slots)
    q, r = _ints((300, 40), 28), _ints((RAGGED_N, 40), 29)
    r[[3, 700, 701]] = 3.0
    q[:2] = 3.0
    for n_valid, kappa in ((1, 4), (129, 32), (RAGGED_N, 32), (RAGGED_N, 700)):
        got_v, got_i = kernels.fused_topk(q.to(cuda_device), r.to(cuda_device),
                                          n_valid, kappa)
        want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
        assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)


def test_fused_topk_shrinks_its_grid_to_the_scratch_ceiling(cuda_device, monkeypatch):
    m, kappa = 60, 64
    monkeypatch.setattr(kernels, "TOPK_SCRATCH_BYTES", 8 * m * kappa * 3)
    q, r = _ints((m, 16), 30), _ints((20000, 16), 31)
    got_v, got_i = kernels.fused_topk(q.to(cuda_device), r.to(cuda_device),
                                      19000, kappa)
    want_v, want_i = kernels.fused_topk_plain(q, r, 19000, kappa)
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)


@pytest.mark.parametrize("d", [512, 513, 1025])
@pytest.mark.parametrize("kappa", [32, 256])
def test_fused_topk_floats_bit_identical_to_pool_writer(cuda_device, kappa, d):
    # On floats the kernel's candidates are the pool_writer kernel's winners
    # ordered best-first: the same fmaf chain per score, so the same bits.
    rng = np.random.RandomState(10)
    q = torch.from_numpy(rng.randn(150, d).astype(np.float32)).to(cuda_device)
    r = torch.from_numpy(rng.randn(8192, d).astype(np.float32)).to(cuda_device)
    got_v, got_i = kernels.fused_topk(q, r, 8000, kappa)
    pv, pi = kernels.pool_writer(q, r, 8000)
    want_v, want_i = kernels.ordered_topk(pv.view(150, -1), pi.view(150, -1), kappa)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_i, want_i)


def test_wrappers_raise_instead_of_falling_back(cuda_device):
    q = torch.ones((4, 8), device=cuda_device)
    with pytest.raises(ValueError):
        kernels.row_max(q, torch.ones((16, 8)), 16)  # mixed devices
    with pytest.raises(ValueError):
        kernels.row_max(q, torch.ones((8, 16), device=cuda_device).T, 16)
    with pytest.raises(TypeError):
        kernels.count_above(q.half(), q.half(), 0.0, 4)
    with pytest.raises(ValueError):
        kernels.count_above(q, torch.ones((16, 8)), 0.0, 16)  # mixed devices
    with pytest.raises(ValueError):
        kernels.count_above(q, torch.ones((8, 16), device=cuda_device).T, 0.0, 16)
    r = torch.ones((16, 8), device=cuda_device)
    for n_valid in (-1, 17):
        with pytest.raises(ValueError):
            kernels.row_max(q, r, n_valid)
        with pytest.raises(ValueError):
            kernels.count_above(q, r, 0.0, n_valid)
    empty = torch.ones((4, 0), device=cuda_device)  # D = 0: no k-slice
    with pytest.raises(ValueError, match="D >= 1"):
        kernels.row_max(empty, torch.ones((16, 0), device=cuda_device), 16)
    with pytest.raises(ValueError, match="D >= 1"):
        kernels.count_above(empty, torch.ones((16, 0), device=cuda_device), 0.0, 16)


# ---- row_max and count_above: the persistent pipelined product -------------


def _reductions_match_plain(q, r, tau, n_valid):
    """Both kernels against their plain versions on the card (cuBLAS is
    exact on these integer scores), exactly, one launch each."""
    kernels.reset_launches()
    torch.testing.assert_close(kernels.row_max(q, r, n_valid),
                               kernels.row_max_plain(q, r, n_valid), rtol=0, atol=0)
    torch.testing.assert_close(kernels.count_above(q, r, tau, n_valid),
                               kernels.count_above_plain(q, r, tau, n_valid),
                               rtol=0, atol=0)
    expected = int(q.shape[0] > 0)
    assert kernels.launches["row_max"] == kernels.launches["count_above"] == expected


@pytest.mark.parametrize("m", [1, 60, 63, 65, 894])
@pytest.mark.parametrize("d", [1, 33, 511, 512, 1025])
def test_row_reductions_exact_at_ragged_shapes(cuda_device, d, m):
    q = _ints((m, d), 20).to(cuda_device)
    r = _ints((RAGGED_N, d), 21).to(cuda_device)
    r[[3, 700]] = 3.0  # the largest score in the first and a middle tile
    q[0] = 3.0
    tau = float(4 * math.isqrt(d))  # ~the top sixth of the scores
    for n_valid in (0, 1, RAGGED_N - 1, RAGGED_N):
        _reductions_match_plain(q, r, tau, n_valid)


@pytest.mark.parametrize("d", [4, 512])
def test_row_reductions_unaligned_rows_take_4_byte_copies(cuda_device, d):
    # A view 4 bytes into its storage: D % 4 == 0 but the rows are not
    # 16-byte aligned, so the kernels copy 4 bytes at a time.
    q = _ints((65 * d + 1,), 22).to(cuda_device)[1:].view(65, d)
    r = _ints((RAGGED_N * d + 1,), 23).to(cuda_device)[1:].view(RAGGED_N, d)
    assert q.data_ptr() % 16 and r.data_ptr() % 16
    _reductions_match_plain(q, r, float(4 * math.isqrt(d)), RAGGED_N - 5)


@pytest.mark.parametrize("slots", [1, 3, 7, 50])
def test_row_reductions_any_grid(cuda_device, monkeypatch, slots):
    # Few blocks: each block's range spans several row tiles, so it
    # flushes its running values at every row tile it leaves.
    monkeypatch.setattr(kernels, "_reduce_slots", lambda t, name, vec: slots)
    q = _ints((300, 40), 24).to(cuda_device)
    r = _ints((RAGGED_N, 40), 25).to(cuda_device)
    for n_valid in (1, 129, RAGGED_N):
        _reductions_match_plain(q, r, 20.0, n_valid)


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _float_case(cuda_device, d, seed):
    """Unit-norm rows with near-duplicate columns in segment 0 (ambiguous
    rows for the pool), refs zero-padded to whole segments."""
    rng = np.random.RandomState(seed)
    q, r = _unit_rows(rng, 300, d), _unit_rows(rng, 5000, d)
    r[8:14] = r[7] + 0.02 * rng.randn(6, d).astype(np.float32)
    q[:4] = r[7]
    r_pad = np.zeros((-(-5000 // 128) * 128, d), np.float32)
    r_pad[:5000] = r
    return (torch.from_numpy(q).to(cuda_device),
            torch.from_numpy(r_pad).to(cuda_device), 4990)


@pytest.mark.parametrize("d", [511, 512, 1025])
def test_row_max_floats_bit_identical_to_pool_writer(cuda_device, d):
    q, r, n_valid = _float_case(cuda_device, d, 26)
    got = kernels.row_max(q, r, n_valid)
    pv, _ = kernels.pool_writer(q, r, n_valid)
    want = pv.view(q.shape[0], -1).amax(1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("d", [511, 512, 1025])
def test_count_above_floats_equal_pool_counts(cuda_device, d):
    # tau as the pooled collection takes it: the global k-th pool value.
    # Where no segment holds two entries >= tau (amb == 0), the pool holds
    # every entry >= tau, so the corpus count equals the pool count.
    q, r, n_valid = _float_case(cuda_device, d, 27)
    m = q.shape[0]
    pv, _ = kernels.pool_writer(q, r, n_valid)
    tau = float(torch.topk(pv.reshape(-1), 3 * m).values[-1])
    above = pv >= tau
    pool_counts = above.view(m, -1).sum(1)
    amb = above.all(2).sum(1)
    counts = kernels.count_above(q, r, tau, n_valid).long()
    clean = amb == 0
    assert clean.any() and (~clean).any()
    assert torch.equal(counts[clean], pool_counts[clean])
    assert bool((counts >= pool_counts).all())


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("b,nq,nr,d,symmetric", [
    (3, 64, 64, 512, True), (2, 37, 130, 64, True), (5, 128, 32, 32, False),
    (1, 1, 17, 4, True), (4, 50, 50, 100, False),
])
def test_chamfer_matches_plain(cuda_device, kind, b, nq, nr, d, symmetric):
    if kind == "int":
        qf, rf = _ints((b, nq, 9, d), 5), _ints((b, nr, 9, d), 6)
    else:
        rng = np.random.RandomState(7)
        qf = torch.from_numpy(rng.randn(b, nq, 9, d).astype(np.float32))
        rf = torch.from_numpy(rng.randn(b, nr, 9, d).astype(np.float32))
        qf /= qf.norm(dim=3, keepdim=True)
        rf /= rf.norm(dim=3, keepdim=True)
    # Zero-pad frames, as the table gather gives rows past a video's end.
    qf[:, nq - nq // 5 :] = 0.0
    rf[:, nr - nr // 7 :] = 0.0
    kernels.reset_launches()
    got = kernels.chamfer_fine_sims(
        qf.to(cuda_device), rf.to(cuda_device), symmetric
    ).cpu()
    want = kernels.chamfer_fine_sims_plain(qf, rf, symmetric)
    tol = 0.0 if kind == "int" else 1e-5
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    # The plain version on the card too (cuBLAS products, GPU reductions).
    want_card = kernels.chamfer_fine_sims_plain(
        qf.to(cuda_device), rf.to(cuda_device), symmetric
    ).cpu()
    torch.testing.assert_close(got, want_card, rtol=0, atol=tol)
    assert bool((got[:, nq - nq // 5 :] == 0).all())
    assert kernels.launches["chamfer"] == 1


def test_chamfer_wrapper_raises(cuda_device):
    q = torch.zeros((1, 4, 9, 8), device=cuda_device)
    with pytest.raises(NotImplementedError):
        kernels.chamfer_fine_sims(q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        kernels.chamfer_fine_sims(q, torch.zeros((1, 4, 9, 8)))
    with pytest.raises(ValueError):
        kernels.chamfer_fine_sims(q[..., :6].contiguous(), q[..., :6].contiguous())
    with pytest.raises(ValueError):
        kernels.chamfer_fine_sims(q[:, :, :8].contiguous(), q[:, :, :8].contiguous())


def test_global_topk_cuda_equals_cpu(cuda_device):
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    q, r = _ints((60, 32), 3).numpy(), _ints((5000, 32), 4).numpy()
    r[200:220] = 3.0
    q[:5] = 3.0
    got = SimilaritySearcher(r, device=cuda_device).global_topk(q, 3000)
    want = SimilaritySearcher(r, device="cpu").global_topk(q, 3000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["stream", "pooled"])
def test_global_topk_forced_modes_cuda_equal_cpu(cuda_device, monkeypatch, mode):
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher

    monkeypatch.setenv(COLLECTION_ENV, mode)
    q, r = _ints((45, 24), 11).numpy(), _ints((7000, 24), 12).numpy()
    r[300:320] = 3.0
    q[:4] = 3.0
    for k in (600, 45 * 16 + 1):  # the second has k > nq·κ
        searcher = SimilaritySearcher(r, device=cuda_device)
        got = searcher.global_topk(q, k, kappa=16)
        assert searcher.last_stats["mode"] == mode
        want = SimilaritySearcher(r, device="cpu").global_topk(q, k, kappa=16)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- the bf16 variants -------------------------------------------------------


BF16 = torch.bfloat16
# row_max.bf16 against the widened f32 product on unit-norm rows: the
# tensor cores add the D exact bf16 products in f32 in another order than
# cuBLAS (and not as one sequential IEEE chain); each score is a sum of
# magnitude <= 1, a few f32 roundings (2^-24 each) apart.
BF16_ROW_MAX_ATOL = 1e-5


def _bf16_rows(rng, n, d, cuda_device, offset=0):
    """[n, d] bf16 unit-norm rows on the card; ``offset`` elements into
    their storage (1: 2-byte aligned, so the kernels take 2-byte loads)."""
    x = torch.from_numpy(_unit_rows(rng, n, d)).to(BF16)
    flat = torch.zeros(n * d + offset, dtype=BF16)
    flat[offset:] = x.reshape(-1)
    return flat.to(cuda_device)[offset:].view(n, d)


def _bf16_case(cuda_device, d, offset, seed):
    """bf16 rows with near-duplicate columns in segment 0, refs padded to
    whole segments (zero rows past 5000)."""
    rng = np.random.RandomState(seed)
    q = _bf16_rows(rng, 150, d, cuda_device, offset)
    r = _bf16_rows(rng, -(-5000 // 128) * 128, d, cuda_device, offset)
    r[5000:] = 0
    r[8:14] = r[7]
    q[:3] = r[7]
    return q, r, 4990


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_bf16_kernels_bit_identical_to_f32_on_widened_inputs(cuda_device, d, offset):
    q, r, n_valid = _bf16_case(cuda_device, d, offset, 40 + d)
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    qf, rf = q.float(), r.float()
    kernels.reset_launches()
    torch.testing.assert_close(kernels.row_max(q, r, n_valid),
                               kernels.row_max(qf, rf, n_valid),
                               rtol=0, atol=BF16_ROW_MAX_ATOL)
    tau = 0.1
    assert torch.equal(kernels.count_above(q, r, tau, n_valid),
                       kernels.count_above(qf, rf, tau, n_valid))
    pv, pi = kernels.pool_writer(q, r, n_valid)
    ev, ei = kernels.pool_writer(qf, rf, n_valid)
    assert torch.equal(pv.view(torch.int32), ev.view(torch.int32))
    assert torch.equal(pi, ei)
    for kappa in (5, 32, 100):
        got_v, got_i = kernels.fused_topk(q, r, n_valid, kappa)
        want_v, want_i = kernels.fused_topk(qf, rf, n_valid, kappa)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    # Each bf16 call ran its bf16 variant, never the f32 kernel.
    for name, calls in (("row_max", 1), ("count_above", 1), ("pool_writer", 1),
                        ("fused_topk", 3)):
        assert kernels.launches[name] == kernels.launches[name + ".bf16"] == calls


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_bf16_kernels_bit_identical_to_each_other(cuda_device, d, offset):
    q, r, n_valid = _bf16_case(cuda_device, d, offset, 60 + d)
    m = q.shape[0]
    pv, pi = kernels.pool_writer(q, r, n_valid)
    best = pv.view(m, -1).amax(1)
    torch.testing.assert_close(kernels.row_max(q, r, n_valid), best,
                               rtol=0, atol=BF16_ROW_MAX_ATOL)
    got_v, got_i = kernels.fused_topk(q, r, n_valid, 32)
    want_v, want_i = kernels.ordered_topk(pv.view(m, -1), pi.view(m, -1), 32)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    tau = float(torch.topk(pv.reshape(-1), 3 * m).values[-1])
    above = pv >= tau
    pool_counts = above.view(m, -1).sum(1)
    clean = above.all(2).sum(1) == 0
    counts = kernels.count_above(q, r, tau, n_valid).long()
    assert clean.any() and (~clean).any()
    assert torch.equal(counts[clean], pool_counts[clean])
    assert bool((counts >= pool_counts).all())


@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("d", [1, 33, 511, 512, 1025])
def test_bf16_kernels_exact_at_ragged_shapes(cuda_device, d, m):
    # Small integers are exact in bf16: each kernel equals its plain version.
    q = _ints((m, d), 50).to(BF16)
    r = _ints((RAGGED_N, d), 51).to(BF16)
    r[[3, 700]] = 3.0
    q[0] = 3.0
    rp = torch.zeros((-(-RAGGED_N // 128) * 128, d), dtype=BF16)
    rp[:RAGGED_N] = r
    qc, rc, rpc = q.to(cuda_device), r.to(cuda_device), rp.to(cuda_device)
    tau = float(4 * math.isqrt(d))
    for n_valid in (0, 1, RAGGED_N - 1, RAGGED_N):
        assert torch.equal(kernels.row_max(qc, rc, n_valid).cpu(),
                           kernels.row_max_plain(q, r, n_valid))
        assert torch.equal(kernels.count_above(qc, rc, tau, n_valid).cpu(),
                           kernels.count_above_plain(q, r, tau, n_valid))
        pv, pi = kernels.pool_writer(qc, rpc, n_valid)
        ev, ei = kernels.pool_writer_plain(q, rp, n_valid)
        finite = torch.isfinite(ev)
        assert torch.equal(pv.cpu(), ev) and torch.equal(pi.cpu()[finite], ei[finite])
        for kappa in (1, 40):
            got_v, got_i = kernels.fused_topk(qc, rc, n_valid, kappa)
            want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
            assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)


@pytest.mark.parametrize("slots", [1, 7])
def test_bf16_kernels_any_grid(cuda_device, monkeypatch, slots):
    monkeypatch.setattr(kernels, "_reduce_slots", lambda t, name, vec: slots)
    q = _ints((300, 40), 52).to(BF16).to(cuda_device)
    r = _ints((RAGGED_N, 40), 53).to(BF16).to(cuda_device)
    assert torch.equal(kernels.row_max(q, r, 129), kernels.row_max_plain(q, r, 129))
    assert torch.equal(kernels.count_above(q, r, 20.0, RAGGED_N),
                       kernels.count_above_plain(q, r, 20.0, RAGGED_N))
    got_v, got_i = kernels.fused_topk(q, r, RAGGED_N, 700)
    want_v, want_i = kernels.fused_topk_plain(q, r, RAGGED_N, 700)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


def test_bf16_wrappers_raise_on_mixed_dtypes(cuda_device):
    q = torch.ones((4, 8), device=cuda_device)
    r = torch.ones((128, 8), device=cuda_device, dtype=BF16)
    kernels.reset_launches()
    for call in (lambda: kernels.row_max(q, r, 100),
                 lambda: kernels.count_above(q.to(BF16), r.float(), 0.0, 100),
                 lambda: kernels.pool_writer(q, r, 100),
                 lambda: kernels.fused_topk(q.to(BF16), r.float(), 100, 4)):
        with pytest.raises(TypeError, match="share a dtype"):
            call()
    assert set(kernels.launches.values()) == {0}


# ---- row_max.bf16: the tensor-core product (wgmma_gemm.cuh) -------------------


def _bf16_ints(shape, seed, cuda_device, offset=0):
    """Integer-valued bf16 rows on the card, ``offset`` elements into their
    storage (1: 2-byte aligned, so the wrapper pads them into a copy)."""
    x = _ints(shape, seed).to(BF16).reshape(-1)
    flat = torch.zeros(x.numel() + offset, dtype=BF16)
    flat[offset:] = x
    return flat.to(cuda_device)[offset:].view(shape)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [1, 65, 300, 9000])
@pytest.mark.parametrize("d", [1, 33, 511, 512, 513, 1025])
def test_bf16_row_max_exact_on_integers(cuda_device, d, m, offset):
    # Every partial sum is an integer below 2^24: exact in any order.
    q = _bf16_ints((m, d), 70 + d, cuda_device, offset)
    r = _bf16_ints((RAGGED_N, d), 71 + d, cuda_device, offset)
    r[[3, 700]] = 3.0
    q[0] = 3.0
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    for refs in (r, kernels.pad_columns(r)):  # as given, and as staged
        for n_valid in (0, 1, RAGGED_N - 1, RAGGED_N):
            kernels.reset_launches()
            got = kernels.row_max(q, refs, n_valid)
            assert torch.equal(got, kernels.row_max_plain(q, r, n_valid))
            assert kernels.launches["row_max.bf16"] == 1
            assert kernels.launches["row_max"] == 0


@pytest.mark.parametrize("slots", [1, 3, 7, 50])
def test_bf16_row_max_any_grid(cuda_device, monkeypatch, slots):
    # Few blocks: each block's range spans several groups and corpus tiles,
    # and flushes its rows at every group it leaves.
    monkeypatch.setattr(kernels, "_wgmma_slots", lambda t: slots)
    q = _bf16_ints((1500, 40), 72, cuda_device)
    r = _bf16_ints((RAGGED_N, 40), 73, cuda_device)
    for n_valid in (1, 257, RAGGED_N):
        assert torch.equal(kernels.row_max(q, r, n_valid),
                           kernels.row_max_plain(q, r, n_valid))


def test_bf16_row_max_zero_pad_rows_do_not_leak(cuda_device):
    # Every valid score is negative; the corpus's zero rows past n_valid
    # (and the zero rows TMA fills past the tensor) score 0 and must not
    # win.
    q = -_bf16_ints((300, 511), 74, cuda_device).abs() - 1
    r = torch.zeros((2048, 511), dtype=BF16, device=cuda_device)
    r[:1900] = _bf16_ints((1900, 511), 75, cuda_device).abs() + 1
    for n_valid in (1, 1000, 1900):
        got = kernels.row_max(q, kernels.pad_columns(r), n_valid)
        assert bool((got < 0).all())
        assert torch.equal(got, kernels.row_max_plain(q, r, n_valid))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_bf16_row_max_floats_within_tolerance(cuda_device, d, offset):
    rng = np.random.RandomState(80 + d)
    q = _bf16_rows(rng, 700, d, cuda_device, offset)
    r = _bf16_rows(rng, 9000, d, cuda_device, offset)
    r[7000:7010] = q[:10]  # exact self-matches: scores near 1
    for n_valid in (8999, 9000):
        got = kernels.row_max(q, r, n_valid)
        want = kernels.row_max_plain(q, r, n_valid)
        torch.testing.assert_close(got, want, rtol=0, atol=BF16_ROW_MAX_ATOL)


def test_bf16_searcher_row_nn_equals_cpu_on_integers(cuda_device):
    # The searcher's padded row_max copy (D = 511) on the card, against the
    # plain version on the CPU: exact on integers.
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    q, r = _ints((300, 511), 76).numpy(), _ints((5000, 511), 77).numpy()
    gpu = SimilaritySearcher(r, dtype="bfloat16", device=cuda_device)
    got = gpu.row_nn(q)
    assert gpu._row_max_copy.shape == (gpu._refs.shape[0], 512)
    want = SimilaritySearcher(r, dtype="bfloat16", device="cpu").row_nn(q)
    np.testing.assert_array_equal(got, want)
