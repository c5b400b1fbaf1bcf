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
the pool's best winners. The bf16 variants (row_max.bf16,
count_above.bf16, pool_writer.bf16, fused_topk.bf16) all run on one
product, the tensor cores' (wgmma_gemm.cuh), which sum in their own order:
exact on integers, within BF16_TC_ATOL of their plain versions on
unit-norm floats, and bit for bit against each other, as the f32 kernels
are: the pool's best winner is row_max.bf16, fused_topk.bf16 is the pool's
winners ordered, and count_above.bf16 the pool count wherever the pool
holds every entry >= tau, on any subset of the rows. scores.bf16 writes
that product out: its per-segment top 2 is the pool, bit for bit.
scores_above.bf16, the searchers' corpus re-search, emits the entries at
or above each row's floor on the same product: exact against its plain
version on integers, and on floats each entry's score is scores.bf16's
bit for bit and the set nonzero(scores.bf16 >= floor), each entry once,
at any grid and when its capacity runs out (it launches again). So the
pooled and streaming collections return the same pairs and scores. The
int8 (SQ8) variants (row_max.int8, count_above.int8, pool_writer.int8,
fused_topk.int8, scores.int8, scores_above.int8) take f32 queries against
int8 codes and per-row scales on the same tensor-core product, with the
int8 corpus policy (the queries split into three exact bf16 terms, three
passes over the codes widened in shared memory, the scale after the
product): exact against their plain versions on integer queries and
power-of-two scales, within BF16_TC_ATOL on unit-norm floats, bit for bit
against each other (scores_above.int8's entries are nonzero(scores.int8 >=
floor), each once, also on a permuted row subset, launching again when its
capacity runs out), and, with every scale 1 and bf16-exact queries, bit
for bit their bf16 kernels on the widened codes (the mid and lo passes add
zeros); scores.int8 also at row counts around a 128-row tile, every column
tail and any grid, writing nothing past its [M, n_valid] output.
The L2 variants (metric="L2": row_max, count_above, pool_writer and
fused_topk in f32 and bf16, scores_above in bf16) take each score of
their product to the goodness (2 s - ref_sq[j]) - q_sq[i] before their
epilogue: exact against their plain versions on integers, within
BF16_TC_ATOL on unit-norm floats, and bit for bit against each other as
the IP kernels are (the pool's best winner is row_max, its winners
ordered fused_topk's, its count count_above's wherever no segment hides an
entry; scores_above's entries the goodness of scores.bf16, which torch's
elementwise f32 operations give); an L2 search returns the same pairs and
distances in both collections, and an int8 search at precision "default"
those of a bf16 search over the widened codes (the one-pass product).
chamfer.bf16, the DnS chamfer at
precision "default" (TMA and wgmma on the tensor cores, persistent, both
chamfer reductions in registers), is held against its plain version (the
widened f32 chamfer) at frame counts on both sides of its 128 x 16 frame
tiles: exact on integers, within BF16_TC_ATOL on unit-norm rows, zero on
pad frames, writing nothing past its output;
also with the ref tile streamed (D past the resident limit, or fewer
slices forced), at any persistent grid (bit for bit the default's), with
more pairs than a wave of blocks, and across pair boundaries.

The descriptor models (SSCD, DINO ViT-S/16 at 224 and 320 px, L3-iMAC; no
hand kernel: cuDNN and cuBLAS) run through ``DescriptorExtractor`` at full
width on 640x360 uint8 frames: the card's f32 output within
EXTRACT_REL_TOL of the largest value of the same extractor on the CPU
(cuDNN's and oneDNN's f32 sums in other orders; 1.4e-6 read on an H100),
bf16 within cosine 0.999 of f32, the same batch twice bit for bit, and
the f32 forward in f32 even with TF32 switched on around it (the
extractor scopes it off; the global matmul flag comes back).

Training (no hand kernel; ``-k train``): a small SSCD step in float64 on
the card from the CPU's views equals the CPU's within TRAIN_F64_TOL (the
same function; float32 is ill-conditioned through BatchNorm's batch
statistics, so float32 is held only in norm), distillation steps on the
card equal the CPU's, and on a machine with several cards the training
CLI's one-rank-a-card route (NCCL) matches one card's first loss.
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
        "pool_writer.bf16": 0, "fused_topk.bf16": 0, "scores.bf16": 0,
        "scores_above.bf16": 0,
        "chamfer.bf16": 0, "row_max.int8": 0, "count_above.int8": 0,
        "pool_writer.int8": 0, "fused_topk.int8": 0, "scores.int8": 0,
        "scores_above.int8": 0, **{name: 0 for name in kernels.L2_KERNELS},
        **{name: 0 for name in kernels.BLOCK_KERNELS},
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
    # bf16 region features launch chamfer.bf16; mixed dtypes raise, and so
    # does a bf16 row of D % 8 != 0 (16-byte copies of bf16).
    kernels.reset_launches()
    assert (kernels.chamfer_fine_sims(q.bfloat16(), q.bfloat16()) == 0).all()
    assert kernels.launches["chamfer.bf16"] == 1 and kernels.launches["chamfer"] == 0
    with pytest.raises(TypeError, match="share a dtype"):
        kernels.chamfer_fine_sims(q.bfloat16(), q)
    with pytest.raises(ValueError, match="D % 8"):
        kernels.chamfer_fine_sims(q[..., :4].bfloat16().contiguous(),
                                  q[..., :4].bfloat16().contiguous())
    with pytest.raises(ValueError):
        kernels.chamfer_fine_sims(q, torch.zeros((1, 4, 9, 8)))
    with pytest.raises(ValueError):
        kernels.chamfer_fine_sims(q[..., :6].contiguous(), q[..., :6].contiguous())
    with pytest.raises(ValueError):
        kernels.chamfer_fine_sims(q[:, :, :8].contiguous(), q[:, :, :8].contiguous())


# ---- chamfer.bf16: the DnS chamfer at precision "default" (wgmma) -----------

# Frame counts on both sides of the kernel's 128 x 16 frame tiles and of a
# consumer's 64 query frames.
CHAMFER_FRAMES = [1, 17, 32, 64, 100, 128]


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("d", [8, 24, 512])
@pytest.mark.parametrize("nr", CHAMFER_FRAMES)
@pytest.mark.parametrize("nq", CHAMFER_FRAMES)
def test_chamfer_bf16_matches_plain(cuda_device, kind, nq, nr, d):
    # The tensor cores sum the exact bf16 products in f32 in their own
    # order: exact on integers (every partial sum an integer below 2^24),
    # within BF16_TC_ATOL of the widened f32 chamfer on unit-norm rows.
    b, symmetric = 2, (nq + nr + d) % 2 == 0
    if kind == "int":
        qf, rf = _ints((b, nq, 9, d), 80 + nq), _ints((b, nr, 9, d), 81 + nr)
    else:
        rng = np.random.RandomState(82 + d)
        qf = torch.from_numpy(rng.randn(b, nq, 9, d).astype(np.float32))
        rf = torch.from_numpy(rng.randn(b, nr, 9, d).astype(np.float32))
        qf /= qf.norm(dim=3, keepdim=True)
        rf /= rf.norm(dim=3, keepdim=True)
    qf[:, nq - nq // 5 :] = 0.0  # zero-pad frames
    rf[:, nr - nr // 7 :] = 0.0
    qb, rb = qf.to(BF16).to(cuda_device), rf.to(BF16).to(cuda_device)
    kernels.reset_launches()
    got = kernels.chamfer_fine_sims(qb, rb, symmetric)
    assert kernels.launches["chamfer.bf16"] == 1 and kernels.launches["chamfer"] == 0
    want = kernels.chamfer_fine_sims_plain(qb, rb, symmetric)
    tol = 0.0 if kind == "int" else BF16_TC_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert bool((got[:, nq - nq // 5 :] == 0).all())
    assert bool((got[:, :, nr - nr // 7 :] == 0).all())


@pytest.mark.parametrize("nq,nr", [(17, 100), (100, 17), (1, 1), (33, 65)])
def test_chamfer_bf16_writes_nothing_past_its_output(cuda_device, nq, nr):
    # Frames past NQ and NR inside a frame tile are never stored:
    # a [B, NQ, NR] view at the start of a larger buffer leaves the rest.
    b, d = 3, 24
    qf = _ints((b, nq, 9, d), 90).to(BF16).to(cuda_device)
    rf = _ints((b, nr, 9, d), 91).to(BF16).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = kernels.chamfer_bf16_plan(b, nq, nr, d, sms)
    got, rest = _chamfer_planned(qf, rf, True, plan.grid, plan.slots, extra=4096)
    assert bool((rest == 7.0).all())
    assert torch.equal(got, kernels.chamfer_fine_sims_plain(qf, rf, True))


def test_chamfer_bf16_within_tolerance_of_f32_on_the_dns_width(cuda_device):
    # The DnS fine features (D = 512, 9 regions, buckets of 32-128 frames):
    # chamfer.bf16 on the rounded rows against the f32 chamfer kernel on the
    # same rows widened.
    rng = np.random.RandomState(95)
    qf = torch.from_numpy(rng.randn(4, 64, 9, 512).astype(np.float32))
    rf = torch.from_numpy(rng.randn(4, 128, 9, 512).astype(np.float32))
    qf, rf = (x / x.norm(dim=3, keepdim=True) for x in (qf, rf))
    qb, rb = qf.to(BF16).to(cuda_device), rf.to(BF16).to(cuda_device)
    for symmetric in (True, False):
        got = kernels.chamfer_fine_sims(qb, rb, symmetric)
        f32 = kernels.chamfer_fine_sims(qb.float(), rb.float(), symmetric)
        torch.testing.assert_close(got, f32, rtol=0, atol=BF16_TC_ATOL)


def _chamfer_case(device, kind, b, nq, nr, d, seed):
    """bf16 region features on the card: integers, or unit-norm rows
    rounded to bf16, with zero-pad frames at the end of both sides."""
    if kind == "int":
        qf, rf = _ints((b, nq, 9, d), seed), _ints((b, nr, 9, d), seed + 1)
    else:
        rng = np.random.RandomState(seed)
        qf = torch.from_numpy(rng.randn(b, nq, 9, d).astype(np.float32))
        rf = torch.from_numpy(rng.randn(b, nr, 9, d).astype(np.float32))
        qf /= qf.norm(dim=3, keepdim=True)
        rf /= rf.norm(dim=3, keepdim=True)
    qf[:, nq - nq // 5 :] = 0.0
    rf[:, nr - nr // 7 :] = 0.0
    return qf.to(BF16).to(device), rf.to(BF16).to(device)


def _chamfer_planned(qf, rf, symmetric, grid, slots, extra=0):
    """chamfer.bf16 launched with a given grid and ref slices into a buffer
    of ``extra`` more floats, filled with 7.0; returns (output, rest)."""
    b, nq, _, d = qf.shape
    nr = rf.shape[1]
    buf = torch.full((b * nq * nr + extra,), 7.0, device=qf.device)
    rc = kernels._build.library().vsc_chamfer_bf16(
        qf.device.index, qf.data_ptr(), rf.data_ptr(), b, nq, nr, 9, d,
        int(symmetric), grid, slots, buf.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    return buf[: b * nq * nr].view(b, nq, nr), buf[b * nq * nr :]


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("d", [1024, 1032])
@pytest.mark.parametrize("nq,nr", [(100, 37), (64, 130), (17, 16)])
def test_chamfer_bf16_streams_past_the_resident_limit(cuda_device, nq, nr, d, kind,
                                                      symmetric):
    # D > 512: the ref tile's k-slices exceed shared memory beside the
    # query ring, so they stream through the slots once a pass (plan).
    plan = kernels.chamfer_bf16_plan(2, nq, nr, d)
    assert not plan.resident and plan.slots == kernels.CHAMFER_MAX_SLOTS
    qb, rb = _chamfer_case(cuda_device, kind, 2, nq, nr, d, 96 + d % 7)
    kernels.reset_launches()
    got = kernels.chamfer_fine_sims(qb, rb, symmetric)
    assert kernels.launches["chamfer.bf16"] == 1
    want = kernels.chamfer_fine_sims_plain(qb, rb, symmetric)
    tol = 0.0 if kind == "int" else BF16_TC_ATOL
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("grid,slots", [(1, 8), (3, 2), (7, 3), (50, 8), (132, 5)])
@pytest.mark.parametrize("nq,nr", [(128, 128), (64, 100), (130, 33)])
def test_chamfer_bf16_any_grid_and_slots(cuda_device, nq, nr, grid, slots, symmetric):
    # Every persistent grid walks the same items, and a streamed ref tile
    # (slots < 8 at D = 512) sums the same k-slices as a resident one: the
    # output is the default launch's bit for bit, and nothing is written
    # past it.
    b, d = 3, 512
    qb, rb = _chamfer_case(cuda_device, "float", b, nq, nr, d, 97)
    want = kernels.chamfer_fine_sims(qb, rb, symmetric)
    items = kernels.chamfer_bf16_plan(b, nq, nr, d).items
    got, rest = _chamfer_planned(qb, rb, symmetric, min(grid, items), slots, extra=1024)
    assert torch.equal(got, want)
    assert bool((rest == 7.0).all())


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("nq,nr", [(128, 16), (50, 40)])
def test_chamfer_bf16_more_pairs_than_a_wave(cuda_device, nq, nr, symmetric):
    # 700 pairs: more work items than one block per SM takes in one item
    # each, so every block walks several pairs.
    b, d = 700, 64
    qb, rb = _chamfer_case(cuda_device, "int", b, nq, nr, d, 98)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert kernels.chamfer_bf16_plan(b, nq, nr, d, sms).items > 2 * sms
    got = kernels.chamfer_fine_sims(qb, rb, symmetric)
    torch.testing.assert_close(got, kernels.chamfer_fine_sims_plain(qb, rb, symmetric),
                               rtol=0, atol=0)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("nq,nr", [(100, 17), (30, 40), (128, 33)])
def test_chamfer_bf16_keeps_pairs_apart(cuda_device, nq, nr, symmetric):
    # Pair 1 is all zeros between nonzero pairs 0 and 2, and NR is not a
    # multiple of the 16-frame ref tile: the tile past NR of pair b reads
    # zeros (the tensor map's pair dimension), never pair b + 1's frames,
    # so pair 1 scores exactly 0 and the others their plain values.
    b, d = 3, 72
    qf, rf = _ints((b, nq, 9, d), 99), _ints((b, nr, 9, d), 100)
    qf[1] = 0.0
    rf[1] = 0.0
    qb, rb = qf.to(BF16).to(cuda_device), rf.to(BF16).to(cuda_device)
    got = kernels.chamfer_fine_sims(qb, rb, symmetric)
    assert bool((got[1] == 0).all())
    torch.testing.assert_close(got, kernels.chamfer_fine_sims_plain(qb, rb, symmetric),
                               rtol=0, atol=0)
    # Pair 1 alone nonzero: pairs 0 and 2 score exactly 0.
    qf2, rf2 = torch.zeros_like(qf), torch.zeros_like(rf)
    qf2[1], rf2[1] = qf[0], rf[0]
    got = kernels.chamfer_fine_sims(qf2.to(BF16).to(cuda_device),
                                    rf2.to(BF16).to(cuda_device), symmetric)
    assert bool((got[0] == 0).all() and (got[2] == 0).all())


def test_chamfer_bf16_plan_mirrors_the_kernel(cuda_device):
    # kernels.chamfer_bf16_plan's shared memory is the kernel's, and a
    # block fits on an SM.
    import ctypes

    lib = kernels._build.library()
    for slots in range(1, kernels.CHAMFER_MAX_SLOTS + 1):
        assert lib.vsc_chamfer_bf16_smem_bytes(slots) == kernels.chamfer_bf16_smem_bytes(slots)
    blocks, regs, local = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(-1)
    rc = lib.vsc_chamfer_bf16_attributes(
        cuda_device.index or 0, kernels.CHAMFER_MAX_SLOTS, ctypes.byref(blocks),
        ctypes.byref(regs), ctypes.byref(local))
    assert rc == 0 and blocks.value == 1 and regs.value > 0 and local.value >= 0
    # The launch refuses a grid of no block or of more blocks than items,
    # more ref slices than fit, and a streamed tile of one slice (D = 576:
    # nine k-slices; one item).
    qb = torch.zeros((1, 4, 9, 576), dtype=BF16, device=cuda_device)
    out = torch.empty((1, 4, 4), device=cuda_device)
    for grid, slots in ((1, 9), (1, 1), (2, 8), (0, 8)):
        rc = lib.vsc_chamfer_bf16(
            qb.device.index or 0, qb.data_ptr(), qb.data_ptr(), 1, 4, 4, 9, 576, 1, grid,
            slots, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc != 0


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
# The bf16 kernels against the widened f32 product: the tensor cores add
# the D exact bf16 products in f32 in another order than cuBLAS (and not
# as one sequential IEEE chain). On an H100 these tests' unit-norm rows err
# by at most 6.0e-7, chip_smoke.py's pool on the SSCD --bf16 search by
# 1.49e-6 and its DnS request (D = 1025, queries with |q| > 1 from the bias
# column) by 2.92e-6: 1e-5 is chip_smoke.BF16_TC_ATOL, 3.4x above the
# largest reading.
BF16_TC_ATOL = 1e-5


def _bf16_rows(rng, n, d, cuda_device, offset=0):
    """[n, d] bf16 unit-norm rows on the card; ``offset`` elements into
    their storage (1: 2-byte aligned, so the wrappers pad them into a
    copy)."""
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


def _plain_scores(q, r, n_valid):
    """The widened f32 product, columns >= n_valid at -inf, padded with -inf
    to whole 128-column segments: [M, N/128, 128]."""
    s = torch.matmul(q.float(), r[:, : q.shape[1]].float().T)
    s[:, n_valid:] = float("-inf")
    pad = -s.shape[1] % kernels.SEG_LANES
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    return s.view(s.shape[0], -1, kernels.SEG_LANES)


def _check_count_within(got, q, r, tau, n_valid, tol):
    """A count of scores within tol of the plain ones: between the plain
    counts at tau + tol and tau - tol."""
    lo = kernels.count_above_plain(q, r, tau + tol, n_valid)
    hi = kernels.count_above_plain(q, r, tau - tol, n_valid)
    assert bool(((lo <= got) & (got <= hi)).all())


def _check_topk_within(got_v, got_i, q, r, n_valid, kappa, tol):
    """fused_topk.bf16 on floats against the widened product: each value
    within tol of the plain score of its (row, id); the sorted values within
    tol of the plain version's (order statistics move at most tol); and the
    same ids wherever the plain kappa-th and (kappa + 1)-th winners lie more
    than 2 tol apart and no segment's second winner above the boundary has
    a third entry within 2 tol (the only ways a set can change). Returns the
    rows held to the same ids."""
    s3 = _plain_scores(q, r, n_valid)
    m = q.shape[0]
    finite = torch.isfinite(got_v)
    want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
    assert torch.equal(torch.isfinite(want_v), finite)
    if finite.any():
        rows = torch.arange(m, device=q.device)[:, None].expand_as(got_i)
        at = s3.view(m, -1)[rows[finite], got_i[finite].long()]
        assert float((at - got_v[finite]).abs().max()) <= tol
        assert float((want_v[finite] - got_v[finite]).abs().max()) <= tol
    top3 = torch.topk(s3, 3, dim=2).values  # [M, segments, 3]
    winners = torch.sort(top3[:, :, :2].reshape(m, -1), dim=1, descending=True).values
    last = winners[:, kappa - 1] if winners.shape[1] >= kappa else winners[:, -1]
    after = (winners[:, kappa] if winners.shape[1] > kappa
             else torch.full_like(last, float("-inf")))
    swap = ((top3[:, :, 1] - top3[:, :, 2] <= 2 * tol)
            & (top3[:, :, 1] >= last[:, None] - 2 * tol)).any(1)
    clear = (last - after > 2 * tol) & ~swap
    got_sorted = torch.sort(torch.where(finite, got_i, -1), dim=1).values
    want_sorted = torch.sort(torch.where(finite, want_i, -1), dim=1).values
    assert torch.equal(got_sorted[clear], want_sorted[clear])
    return clear


def _segments_above(q, r, n_valid, tau):
    """Per row, the most plain scores >= tau in any one segment."""
    return (_plain_scores(q, r, n_valid) >= tau).sum(2).amax(1)


def _check_stream_pair(q, r, n_valid, kappa=32, k_per_row=3):
    """The streaming pair on the tensor-core copy, bit for bit: row_max.bf16
    is fused_topk.bf16's best value, and with tau the global k-th candidate,
    count_above.bf16 is the number of candidates >= tau on every row whose
    set is not full at tau and where no segment holds more than two plain
    scores >= tau - 2 BF16_TC_ATOL (the pool then holds every entry >= tau),
    and no less elsewhere."""
    rt = kernels.pad_columns(r)
    m = q.shape[0]
    top_v, _ = kernels.fused_topk(q, rt, n_valid, kappa)
    best = kernels.row_max(q, rt, n_valid)
    assert torch.equal(top_v[:, 0].view(torch.int32), best.view(torch.int32))
    tau = float(torch.topk(top_v.reshape(-1), k_per_row * m).values[-1])
    kept = (top_v >= tau).sum(1)
    counts = kernels.count_above(q, rt, tau, n_valid).long()
    clean = ((_segments_above(q, r, n_valid, tau - 2 * BF16_TC_ATOL) <= 2)
             & (top_v[:, -1] < tau))
    assert clean.any()
    assert torch.equal(counts[clean], kept[clean])
    assert bool((counts >= kept).all())
    return clean


def _check_pool_identity(q, r, n_valid, k_per_row=3):
    """The pool against the other bf16 kernels on the tensor-core copy, bit
    for bit: its best winner is row_max.bf16, its winners ordered are
    fused_topk.bf16's (values and ids), and with tau the global k-th pool
    value, count_above.bf16 is the pool count >= tau on every row with
    amb == 0 (no segment holding two entries >= tau: the pool holds every
    entry >= tau) and no less elsewhere. Returns the amb == 0 rows."""
    rt = kernels.pad_columns(r)
    m = q.shape[0]
    pv, pi = kernels.pool_writer(q, rt, n_valid)
    best = kernels.row_max(q, rt, n_valid)
    assert torch.equal(pv.view(m, -1).amax(1).view(torch.int32), best.view(torch.int32))
    for kappa in (5, 32, 100):
        want = kernels.ordered_topk(pv.view(m, -1), pi.view(m, -1), kappa)
        got = kernels.fused_topk(q, rt, n_valid, kappa)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    tau = float(torch.topk(pv.reshape(-1), k_per_row * m).values[-1])
    above = pv >= tau
    pool_counts = above.view(m, -1).sum(1)
    clean = above.all(2).sum(1) == 0
    counts = kernels.count_above(q, rt, tau, n_valid).long()
    assert torch.equal(counts[clean], pool_counts[clean])
    assert bool((counts >= pool_counts).all())
    return clean


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_bf16_kernels_within_tolerance_of_f32_on_widened_inputs(cuda_device, d,
                                                                 offset):
    # Every bf16 kernel sums on the tensor cores: within BF16_TC_ATOL of the
    # f32 kernel on the widened operands (counts: between the f32 counts at
    # tau -+ the tolerance).
    q, r, n_valid = _bf16_case(cuda_device, d, offset, 40 + d)
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    qf, rf = q.float(), r.float()
    kernels.reset_launches()
    torch.testing.assert_close(kernels.row_max(q, r, n_valid),
                               kernels.row_max(qf, rf, n_valid),
                               rtol=0, atol=BF16_TC_ATOL)
    tau = 0.1
    _check_count_within(kernels.count_above(q, r, tau, n_valid),
                        qf, rf, tau, n_valid, BF16_TC_ATOL)
    pv, _ = kernels.pool_writer(q, r, n_valid)
    ev, _ = kernels.pool_writer(qf, rf, n_valid)
    assert torch.equal(torch.isfinite(pv), torch.isfinite(ev))
    torch.testing.assert_close(pv, ev, rtol=0, atol=BF16_TC_ATOL)
    for kappa in (5, 32, 100):
        got_v, _ = kernels.fused_topk(q, r, n_valid, kappa)
        want_v, _ = kernels.fused_topk(qf, rf, n_valid, kappa)
        torch.testing.assert_close(got_v, want_v, rtol=0, atol=BF16_TC_ATOL)
    # Each bf16 call ran its bf16 variant, never the f32 kernel.
    for name, calls in (("row_max", 1), ("pool_writer", 1), ("fused_topk", 3)):
        assert kernels.launches[name] == kernels.launches[name + ".bf16"] == calls
    assert kernels.launches["count_above.bf16"] == 1
    assert kernels.launches["count_above"] == 0  # held by the plain version


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_bf16_kernels_bit_identical_to_each_other(cuda_device, d, offset):
    q, r, n_valid = _bf16_case(cuda_device, d, offset, 60 + d)
    # The pool against row_max.bf16, fused_topk.bf16 and count_above.bf16.
    clean = _check_pool_identity(q, r, n_valid)
    assert clean.any() and (~clean).any()  # the planted ties crowd segment 0
    # The streaming collection's verify on the same product.
    clean = _check_stream_pair(q, r, n_valid)
    assert (~clean).any()


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
    monkeypatch.setattr(kernels, "_wgmma_slots", lambda t, *args: slots)
    q = _ints((300, 40), 52).to(BF16).to(cuda_device)
    r = _ints((RAGGED_N, 40), 53).to(BF16).to(cuda_device)
    assert torch.equal(kernels.row_max(q, r, 129), kernels.row_max_plain(q, r, 129))
    assert torch.equal(kernels.count_above(q, r, 20.0, RAGGED_N),
                       kernels.count_above_plain(q, r, 20.0, RAGGED_N))
    rp = torch.cat([r, r.new_zeros((-RAGGED_N % 128, 40))])
    pv, pi = kernels.pool_writer(q, rp, RAGGED_N)
    ev, ei = kernels.pool_writer_plain(q, rp, RAGGED_N)
    finite = torch.isfinite(ev)
    assert torch.equal(pv, ev) and torch.equal(pi[finite], ei[finite])
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
    # One bf16 count: count_above takes no partner kernel any more.
    with pytest.raises(TypeError):
        kernels.count_above(q.to(BF16), r, 0.0, 100, pair="pooled")
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
        torch.testing.assert_close(got, want, rtol=0, atol=BF16_TC_ATOL)


def test_bf16_searcher_row_nn_equals_cpu_on_integers(cuda_device):
    # The searcher's padded row_max copy (D = 511) on the card, against the
    # plain version on the CPU: exact on integers.
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    q, r = _ints((300, 511), 76).numpy(), _ints((5000, 511), 77).numpy()
    gpu = SimilaritySearcher(r, dtype="bfloat16", device=cuda_device)
    got = gpu.row_nn(q)
    assert gpu._tc_copy.shape == (gpu._refs.shape[0], 512)
    want = SimilaritySearcher(r, dtype="bfloat16", device="cpu").row_nn(q)
    np.testing.assert_array_equal(got, want)


# ---- the streaming pair on the tensor cores (wgmma_gemm.cuh) -----------------


def _stream_pair_exact(q, refs, r, n_valid, taus, kappas):
    """count_above.bf16 and fused_topk.bf16 on (q, refs) against their plain
    versions on (q, r), exactly, one launch each and no other kernel."""
    for tau in taus:
        kernels.reset_launches()
        got = kernels.count_above(q, refs, tau, n_valid)
        assert torch.equal(got, kernels.count_above_plain(q, r, tau, n_valid))
        assert kernels.launches["count_above.bf16"] == int(q.shape[0] > 0)
        assert sum(kernels.launches.values()) == kernels.launches["count_above.bf16"]
    for kappa in kappas:
        kernels.reset_launches()
        got_v, got_i = kernels.fused_topk(q, refs, n_valid, kappa)
        want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
        assert kernels.launches["fused_topk.bf16"] == int(q.shape[0] > 0)
        assert sum(kernels.launches.values()) == kernels.launches["fused_topk.bf16"]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [1, 65, 300, 9000])
@pytest.mark.parametrize("d", [1, 33, 511, 512, 513, 1025])
def test_stream_pair_exact_on_integers(cuda_device, d, m, offset):
    # Every partial sum is an integer below 2^24: exact in any order, ties
    # included (the lower column first).
    q = _bf16_ints((m, d), 90 + d, cuda_device, offset)
    r = _bf16_ints((RAGGED_N, d), 91 + d, cuda_device, offset)
    r[[3, 700, 701]] = 3.0
    q[0] = 3.0
    tau = float(4 * math.isqrt(d))
    for refs in (r, kernels.pad_columns(r)):  # as given, and as staged
        for n_valid in (0, 1, 1000, RAGGED_N):  # 1000: not a multiple of 256
            _stream_pair_exact(q, refs, r, n_valid, (tau, float("-inf")), (32,))


@pytest.mark.parametrize("kappa", [1, 5, 32, 64, 65, 100])
def test_stream_fused_topk_exact_at_every_kappa(cuda_device, kappa):
    # The wrapper keeps the sets in shared memory up to
    # WGMMA_SMEM_SETS_KAPPA_MAX and in the output above it; below it the
    # output placement, forced, is exact too.
    q = _bf16_ints((1100, 40), 92, cuda_device)
    r = _bf16_ints((5000, 40), 93, cuda_device)
    r[[5, 7, 40, 300, 301]] = 3.0  # ties in and across segments
    q[:3] = 3.0
    _stream_pair_exact(q, r, r, 4900, (), (kappa,))
    if kappa <= kernels.WGMMA_SMEM_SETS_KAPPA_MAX:
        got = kernels._fused_topk_tc(q, r, 4900, kappa, smem_sets=False)
        want = kernels.fused_topk_plain(q, r, 4900, kappa)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        with pytest.raises(ValueError, match="shared memory"):
            kernels._fused_topk_tc(q, r, 4900, kappa, smem_sets=True)


def test_stream_pair_all_equal_rows_tie_to_the_lower_column(cuda_device):
    # Every score of a row is equal: each segment's winners are its two
    # lowest columns, and the set takes the lowest of those.
    q = _bf16_ints((200, 24), 94, cuda_device)
    r = torch.ones((3000, 24), dtype=BF16, device=cuda_device)
    for kappa in (1, 5, 32, 46):  # 46: all 23 segments' winners
        v, i = kernels.fused_topk(q, r, 2900, kappa)
        want_v, want_i = kernels.fused_topk_plain(q, r, 2900, kappa)
        assert torch.equal(v, want_v) and torch.equal(i, want_i)
        lowest = torch.tensor([128 * (c // 2) + c % 2 for c in range(kappa)],
                              dtype=torch.int32, device=cuda_device)
        assert torch.equal(i, lowest.expand_as(i))
    sums = q.float().sum(1)
    for tau in (float("-inf"), 0.0):
        want = torch.where(sums >= tau, 2900, 0).int()
        assert torch.equal(kernels.count_above(q, r, tau, 2900), want)


def test_stream_pair_zero_pad_rows_do_not_leak(cuda_device):
    # Every valid score is negative; the corpus's zero rows past n_valid,
    # the zero rows TMA fills past the tensor and the query rows past M
    # score 0 and must neither enter a set nor be counted.
    q = -_bf16_ints((300, 511), 95, cuda_device).abs() - 1
    r = torch.zeros((2048, 511), dtype=BF16, device=cuda_device)
    r[:1900] = _bf16_ints((1900, 511), 96, cuda_device).abs() + 1
    rp = kernels.pad_columns(r)
    for n_valid in (1, 1000, 1900):
        v, i = kernels.fused_topk(q, rp, n_valid, 32)
        want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, 32)
        assert torch.equal(v, want_v) and torch.equal(i, want_i)
        assert bool((v[torch.isfinite(v)] < 0).all())
        assert bool((i < n_valid).all())
        for tau in (float("-inf"), -0.5, 0.0):
            assert torch.equal(kernels.count_above(q, rp, tau, n_valid),
                               kernels.count_above_plain(q, r, tau, n_valid))


@pytest.mark.parametrize("slots", [1, 3, 7, 50])
def test_stream_pair_any_grid(cuda_device, monkeypatch, slots):
    # Few blocks: each block's range spans several groups and corpus tiles
    # (1,500 rows: two groups), and takes a slot in each group it touches.
    monkeypatch.setattr(kernels, "_wgmma_slots", lambda t, *args: slots)
    q = _bf16_ints((1500, 40), 97, cuda_device)
    r = _bf16_ints((RAGGED_N, 40), 98, cuda_device)
    r[[3, 700]] = 3.0
    for n_valid in (1, 257, RAGGED_N):
        _stream_pair_exact(q, r, r, n_valid, (20.0, float("-inf")), (4, 32, 700))


def test_stream_fused_topk_shrinks_its_grid_to_the_scratch_ceiling(cuda_device,
                                                                    monkeypatch):
    m, kappa = 60, 64
    monkeypatch.setattr(kernels, "TOPK_SCRATCH_BYTES", 8 * m * kappa * 3)
    q = _bf16_ints((m, 16), 99, cuda_device)
    r = _bf16_ints((20000, 16), 100, cuda_device)
    _stream_pair_exact(q, r, r, 19000, (), (kappa,))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_stream_pair_floats_within_tolerance(cuda_device, d, offset):
    rng = np.random.RandomState(110 + d)
    q = _bf16_rows(rng, 700, d, cuda_device, offset)
    r = _bf16_rows(rng, 9000, d, cuda_device, offset)
    r[7000:7010] = q[:10]  # exact self-matches: scores near 1
    for n_valid in (8999, 9000):
        for kappa in (5, 32):
            v, i = kernels.fused_topk(q, r, n_valid, kappa)
            assert _check_topk_within(v, i, q, r, n_valid, kappa, BF16_TC_ATOL).any()
        _check_count_within(kernels.count_above(q, r, 0.1, n_valid), q, r, 0.1,
                            n_valid, BF16_TC_ATOL)
        _check_stream_pair(q, r, n_valid)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_stream_fused_topk_placements_agree(cuda_device, d, offset):
    # On floats the sets in the output and in shared memory hold the same
    # winners, bit for bit (one product), both the wrapper's.
    q, r, n_valid = _bf16_case(cuda_device, d, offset, 120 + d)
    for kappa in (5, 32):
        want = kernels.fused_topk(q, r, n_valid, kappa)
        for smem_sets in (False, True):
            got = kernels._fused_topk_tc(q, r, n_valid, kappa, smem_sets)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_searcher_stream_hands_the_pair_the_tensor_core_copy(cuda_device):
    # D = 1025: the searcher's padded copy (1,032 columns) feeds both
    # kernels of the streaming pair, and global_topk equals the CPU's.
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    q, r = _ints((90, 1025), 101).numpy(), _ints((6000, 1025), 102).numpy()
    r[200:220] = 3.0
    q[:5] = 3.0
    gpu = SimilaritySearcher(r, dtype="bfloat16", device=cuda_device)
    kernels.reset_launches()
    got = gpu.global_topk(q, 2000)
    assert gpu.last_stats["mode"] == "stream"
    assert gpu._tc_copy.shape == (gpu._refs.shape[0], 1032)
    assert kernels.launches["fused_topk.bf16"] == kernels.launches["count_above.bf16"] == 1
    assert kernels.launches["count_above"] == kernels.launches["fused_topk"] == 0
    want = SimilaritySearcher(r, dtype="bfloat16", device="cpu").global_topk(q, 2000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bf16_searcher_pooled_hands_the_pool_the_tensor_core_copy(cuda_device,
                                                                  monkeypatch):
    # D = 1025, forced to the pooled collection: the searcher's padded copy
    # (1,032 columns) feeds pool_writer.bf16 and the count of the ambiguous
    # rows, count_above.bf16, and global_topk equals the CPU's.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher

    monkeypatch.setenv(COLLECTION_ENV, "pooled")
    q, r = _ints((90, 1025), 103).numpy(), _ints((6000, 1025), 104).numpy()
    r[200:220] = 3.0  # 20 equal columns in segment 1: ambiguous rows
    q[:5] = 3.0
    gpu = SimilaritySearcher(r, dtype="bfloat16", device=cuda_device)
    kernels.reset_launches()
    got = gpu.global_topk(q, 2000, kappa=16)
    assert gpu.last_stats["mode"] == "pooled" and gpu.last_stats["amb_rows"] > 0
    assert gpu._tc_copy.shape == (gpu._refs.shape[0], 1032)
    assert kernels.launches["pool_writer.bf16"] == kernels.launches["count_above.bf16"] == 1
    # Re-searched rows score on the same product (scores_above.bf16), in
    # one launch; the dense scores.bf16 is off the path.
    research = int(gpu.last_stats["corpus_rows"] > 0)
    assert kernels.launches["scores_above.bf16"] == research
    assert sum(kernels.launches.values()) == 2 + research
    want = SimilaritySearcher(r, dtype="bfloat16", device="cpu").global_topk(
        q, 2000, kappa=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- pool_writer.bf16: the pool on the tensor cores (wgmma_gemm.cuh) -----------


def _segment_rows(n):
    """Rows of an n-row corpus padded to whole 128-row segments."""
    return -(-n // 128) * 128


def _pool_exact(q, refs, r, n_valid):
    """pool_writer.bf16 on (q, refs) against its plain version on (q, r):
    values exactly (the -inf slots and the tail the wrapper fills
    included), ids wherever the value is finite; one launch and no other
    kernel."""
    kernels.reset_launches()
    pv, pi = kernels.pool_writer(q, refs, n_valid)
    ev, ei = kernels.pool_writer_plain(q, r, n_valid)
    finite = torch.isfinite(ev)
    assert torch.equal(pv, ev) and torch.equal(pi[finite], ei[finite])
    assert not torch.isfinite(pv[:, kernels.pool_segments(r.shape[0], n_valid):]).any()
    assert kernels.launches["pool_writer.bf16"] == int(q.shape[0] > 0)
    assert sum(kernels.launches.values()) == kernels.launches["pool_writer.bf16"]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [1, 65, 300, 9000])
@pytest.mark.parametrize("d", [1, 33, 511, 512, 513, 1025])
def test_bf16_pool_writer_exact_on_integers(cuda_device, d, m, offset):
    # Every partial sum is an integer below 2^24: exact in any order, ties
    # in a segment included (the lower column first). RAGGED_N pads to 11
    # segments, an odd count: with every tile valid, the last corpus tile's
    # second segment lies past the pool. n_valid 1 and 1000 leave an -inf
    # tail that the wrapper fills; n_valid = N counts the zero pad rows.
    n = _segment_rows(RAGGED_N)
    q = _bf16_ints((m, d), 130 + d, cuda_device, offset)
    r = _bf16_ints((n, d), 131 + d, cuda_device, offset)
    r[RAGGED_N:] = 0
    r[[3, 700, 701]] = 3.0
    q[0] = 3.0
    for refs in (r, kernels.pad_columns(r)):  # as given, and as staged
        for n_valid in (0, 1, 1000, RAGGED_N, n):
            _pool_exact(q, refs, r, n_valid)


def test_bf16_pool_writer_zero_pad_rows_do_not_leak(cuda_device):
    # Every valid score is negative; the corpus's zero rows past n_valid,
    # the zero rows TMA fills past it and the query rows past M score 0
    # and must not enter the pool.
    q = -_bf16_ints((300, 511), 132, cuda_device).abs() - 1
    r = torch.zeros((2048, 511), dtype=BF16, device=cuda_device)
    r[:1900] = _bf16_ints((1900, 511), 133, cuda_device).abs() + 1
    rp = kernels.pad_columns(r)
    for n_valid in (1, 1000, 1900):
        _pool_exact(q, rp, r, n_valid)
        pv, pi = kernels.pool_writer(q, rp, n_valid)
        finite = torch.isfinite(pv)
        assert bool((pv[finite] < 0).all()) and bool((pi[finite] < n_valid).all())


def test_bf16_pool_writer_all_equal_rows_tie_to_the_lower_column(cuda_device):
    # Every score of a row is equal: each segment's winners are its two
    # lowest columns.
    q = _bf16_ints((200, 24), 134, cuda_device)
    r = torch.ones((3072, 24), dtype=BF16, device=cuda_device)
    _pool_exact(q, r, r, 2900)
    _, pi = kernels.pool_writer(q, r, 2900)
    lowest = torch.tensor([[128 * g, 128 * g + 1] for g in range(23)],
                          dtype=torch.int32, device=cuda_device)
    assert torch.equal(pi[:, :23], lowest.expand(200, 23, 2))


@pytest.mark.parametrize("slots", [1, 3, 7, 50])
def test_bf16_pool_writer_any_grid(cuda_device, monkeypatch, slots):
    # Few blocks: each block's range spans several groups and corpus tiles.
    monkeypatch.setattr(kernels, "_wgmma_slots", lambda t, *args: slots)
    q = _bf16_ints((1500, 40), 135, cuda_device)
    r = _bf16_ints((_segment_rows(RAGGED_N), 40), 136, cuda_device)
    r[[3, 700]] = 3.0
    for n_valid in (1, 257, RAGGED_N):
        _pool_exact(q, r, r, n_valid)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_bf16_pool_writer_floats_within_tolerance(cuda_device, d, offset):
    # Each slot is an order statistic of its segment: within BF16_TC_ATOL of
    # the plain pool's and of the plain score at its id; the ids equal the
    # plain ones wherever no winner lies within twice that of its runner-up.
    rng = np.random.RandomState(140 + d)
    q = _bf16_rows(rng, 700, d, cuda_device, offset)
    r = _bf16_rows(rng, 9088, d, cuda_device, offset)
    r[9000:] = 0
    r[7000:7010] = q[:10]  # exact self-matches: scores near 1
    tol, m = BF16_TC_ATOL, q.shape[0]
    for n_valid in (8999, 9000):
        pv, pi = kernels.pool_writer(q, r, n_valid)
        ev, ei = kernels.pool_writer_plain(q, r, n_valid)
        finite = torch.isfinite(ev)
        assert torch.equal(torch.isfinite(pv), finite)
        assert float((pv[finite] - ev[finite]).abs().max()) <= tol
        s3 = _plain_scores(q, r, n_valid)
        rows = torch.arange(m, device=q.device)[:, None, None].expand_as(pi)
        at = s3.view(m, -1)[rows[finite], pi[finite].long()]
        assert float((at - pv[finite]).abs().max()) <= tol
        top3 = torch.topk(s3, 3, dim=2).values
        first = top3[:, :, 0] - top3[:, :, 1] > 2 * tol
        second = first & (top3[:, :, 1] - top3[:, :, 2] > 2 * tol)
        assert first.any() and second.any()
        assert torch.equal(pi[:, :, 0][first], ei[:, :, 0][first])
        assert torch.equal(pi[:, :, 1][second], ei[:, :, 1][second])


@pytest.mark.parametrize("d", [512, 1025])
def test_bf16_count_above_on_a_row_subset_equals_the_full_call(cuda_device, d):
    # The pooled collection counts its ambiguous rows alone, each at another
    # place in another query tile than in the pool's launch. A tensor-core
    # score does not depend on its row's place: on a permuted subset of the
    # rows the pool and the counts (at taus on pool values, so a score at
    # tau counts) are the full call's rows, bit for bit.
    rng = np.random.RandomState(150 + d)
    q_k = kernels.pad_columns(_bf16_rows(rng, 1100, d, cuda_device))
    rt = kernels.pad_columns(_bf16_rows(rng, 5120, d, cuda_device))
    pv, pi = kernels.pool_writer(q_k, rt, 5000)
    sub = torch.from_numpy(rng.permutation(1100)[:333]).to(cuda_device)
    sv, si = kernels.pool_writer(q_k[sub], rt, 5000)
    assert torch.equal(sv.view(torch.int32), pv[sub].view(torch.int32))
    assert torch.equal(si, pi[sub])
    for k_per_row in (1, 3, 20):
        tau = float(torch.topk(pv.reshape(-1), k_per_row * 1100).values[-1])
        full = kernels.count_above(q_k, rt, tau, 5000)
        assert torch.equal(kernels.count_above(q_k[sub], rt, tau, 5000), full[sub])


# ---- scores.bf16: the re-search's product (wgmma_gemm.cuh) --------------------


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("d", [1, 33, 511, 512, 513, 1025])
def test_bf16_scores_exact_on_integers(cuda_device, d, m, offset):
    # Integers: exact in any order. An odd n_valid leaves every other row's
    # first column at an odd offset (4-byte stores), and the last tile
    # ragged.
    q = _bf16_ints((m, d), 160 + d, cuda_device, offset)
    r = _bf16_ints((RAGGED_N, d), 161 + d, cuda_device, offset)
    for refs in (r, kernels.pad_columns(r)):  # as given, and as staged
        for n_valid in (0, 1, 1000, RAGGED_N - 1, RAGGED_N):
            kernels.reset_launches()
            got = kernels.scores(q, refs, n_valid)
            assert torch.equal(got, kernels.scores_plain(q, r, n_valid))
            assert kernels.launches["scores.bf16"] == int(n_valid > 0)
            assert sum(kernels.launches.values()) == kernels.launches["scores.bf16"]


@pytest.mark.parametrize("slots", [1, 7])
def test_bf16_scores_any_grid(cuda_device, monkeypatch, slots):
    monkeypatch.setattr(kernels, "_wgmma_slots", lambda t, *args: slots)
    q = _bf16_ints((1500, 40), 162, cuda_device)
    r = _bf16_ints((RAGGED_N, 40), 163, cuda_device)
    for n_valid in (1, 257, RAGGED_N):
        assert torch.equal(kernels.scores(q, r, n_valid),
                           kernels.scores_plain(q, r, n_valid))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [511, 512, 513, 1025])
def test_bf16_scores_bit_identical_to_the_other_kernels(cuda_device, d, offset):
    # On floats the scores are the product the other bf16 kernels see: each
    # segment's best 2 (ties to the lower column) are the pool, bit for bit,
    # the row max row_max.bf16, the count >= tau count_above.bf16, and a
    # permuted subset of the rows scores as in the full call; all within
    # BF16_TC_ATOL of the plain version.
    q, r, n_valid = _bf16_case(cuda_device, d, offset, 170 + d)
    rt, m = kernels.pad_columns(r), q.shape[0]
    s = kernels.scores(q, rt, n_valid)
    torch.testing.assert_close(s, kernels.scores_plain(q, r, n_valid),
                               rtol=0, atol=BF16_TC_ATOL)
    full = torch.full((m, r.shape[0]), float("-inf"), device=q.device)
    full[:, :n_valid] = s
    vals, idx = torch.sort(full.view(m, -1, kernels.SEG_LANES), dim=2,
                           descending=True, stable=True)
    seg_base = kernels.SEG_LANES * torch.arange(vals.shape[1], device=q.device)
    want_v, want_i = vals[:, :, :2], idx[:, :, :2].int() + seg_base[None, :, None].int()
    pv, pi = kernels.pool_writer(q, rt, n_valid)
    assert torch.equal(pv.view(torch.int32), want_v.contiguous().view(torch.int32))
    finite = torch.isfinite(want_v)
    assert torch.equal(pi[finite], want_i[finite])
    best = kernels.row_max(q, rt, n_valid)
    assert torch.equal(best.view(torch.int32), s.amax(1).view(torch.int32))
    tau = float(torch.topk(pv.reshape(-1), 3 * m).values[-1])
    assert torch.equal(kernels.count_above(q, rt, tau, n_valid),
                       (s >= tau).sum(1, dtype=torch.int32))
    sub = torch.from_numpy(np.random.RandomState(d).permutation(m)[:50]).to(cuda_device)
    got = kernels.scores(q[sub], rt, n_valid)
    assert torch.equal(got.view(torch.int32), s[sub].view(torch.int32))


@pytest.mark.parametrize("d", [512, 1025])
def test_bf16_searcher_pooled_equals_stream_on_floats(cuda_device, monkeypatch, d):
    # Every score of a bf16 search, re-searched rows included, comes from
    # one product: on floats, where the tensor cores and an f32 chain round
    # apart, the two collections (which re-search different rows) return
    # the same pairs and scores, bit for bit.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher

    rng = np.random.RandomState(180 + d)
    q, r = _unit_rows(rng, 400, d), _unit_rows(rng, 20000, d)
    r[100:140] = r[99] + 0.01 * rng.randn(40, d).astype(np.float32)
    q[:20] = r[99]  # rows whose entries crowd segment 0: re-searched
    searcher = SimilaritySearcher(r, dtype="bfloat16", device=cuda_device)
    out, stats = {}, {}
    for mode in ("stream", "pooled"):
        monkeypatch.setenv(COLLECTION_ENV, mode)
        out[mode] = searcher.global_topk(q, 4000, kappa=16)
        stats[mode] = dict(searcher.last_stats)
        assert stats[mode]["mode"] == mode and stats[mode]["corpus_rows"] > 0
    assert stats["stream"]["corpus_rows"] != stats["pooled"]["corpus_rows"]
    for a, b in zip(out["stream"], out["pooled"]):
        np.testing.assert_array_equal(a, b)



# ---- scores_above.bf16: the re-search's entries >= each row's floor -----------


def _entries(out):
    """scores_above's (scores, rows, cols) ordered by (row, col), indices
    int64; fails unless each (row, col) appears once."""
    s, r, c = out
    assert s.shape == r.shape == c.shape and r.dtype == c.dtype == torch.int32
    key, order = torch.sort(r.long() * (1 << 32) + c.long())
    assert bool((key[1:] != key[:-1]).all()), "an entry appears twice"
    return s[order], r[order].long(), c[order].long()


def _row_floors(scores, seed):
    """Per-row floors over dense scores [M, n_valid]: a score of the row
    at a random depth (its ties sit on the floor), −inf on every 11th row
    and +inf on every 13th from the 5th."""
    m, n_valid = scores.shape
    depth = np.random.RandomState(seed).randint(0, min(200, n_valid), m)
    ranked = torch.sort(scores, dim=1, descending=True).values
    floor = ranked.gather(1, torch.from_numpy(depth).to(scores.device)[:, None])[:, 0]
    floor[::11] = float("-inf")
    floor[5::13] = float("inf")
    return floor.contiguous()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("d", [13, 33, 512, 1025])
def test_bf16_scores_above_exact_on_integers(cuda_device, d, m, offset):
    # Integers: exact in any order, so the kernel's entries are the plain
    # version's, each once; D = 13 and 33 take pad columns, n_valid short
    # of the corpus leaves the last tile ragged. Given the exact count as
    # its capacity, it launches once.
    q = _bf16_ints((m, d), 190 + d, cuda_device, offset)
    r = _bf16_ints((RAGGED_N, d), 191 + d, cuda_device, offset)
    for refs in (r, kernels.pad_columns(r)):  # as given, and as staged
        for n_valid in (1, 1000, RAGGED_N - 1):
            floor = _row_floors(kernels.scores_plain(q, r, n_valid), d + m)
            want = _entries(kernels.scores_above_plain(q, r, n_valid, floor))
            kernels.reset_launches()
            got = _entries(kernels.scores_above(q, refs, n_valid, floor,
                                                capacity=want[0].numel()))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert kernels.launches["scores_above.bf16"] == 1
            assert sum(kernels.launches.values()) == 1


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [13, 511, 512, 1025])
def test_bf16_scores_above_bit_identical_to_dense_scores(cuda_device, d, offset):
    # Floats: each emitted score is the dense scores.bf16 at its (row, col),
    # bit for bit, and the set is nonzero(dense >= floor), on 133 rows (no
    # multiple of 128) and on a permuted subset of them (each row at
    # another place in its tile); within BF16_TC_ATOL of the plain scores.
    q, r, n_valid = _bf16_case(cuda_device, d, offset, 200 + d)
    q, rt = q[:133], kernels.pad_columns(r)
    dense = kernels.scores(q, rt, n_valid)
    floor = _row_floors(dense, d)
    for rows in (torch.arange(133, device=cuda_device),
                 torch.from_numpy(np.random.RandomState(d).permutation(133)[:50])
                 .to(cuda_device)):
        rr, cc = torch.nonzero(dense[rows] >= floor[rows, None], as_tuple=True)
        s, gr, gc = _entries(kernels.scores_above(q[rows], rt, n_valid, floor[rows]))
        assert torch.equal(gr, rr) and torch.equal(gc, cc)
        assert torch.equal(s.view(torch.int32), dense[rows][rr, cc].view(torch.int32))
    plain = kernels.scores_plain(q, r, n_valid)
    torch.testing.assert_close(s, plain[rows][rr, cc], rtol=0, atol=BF16_TC_ATOL)


@pytest.mark.parametrize("capacity", [0, 1, 1000])
def test_bf16_scores_above_relaunches_when_the_capacity_runs_out(cuda_device, capacity):
    # The kernel counts past its capacity, so the wrapper launches once
    # more with exactly the total and returns the full set; with the exact
    # total it launches once.
    q = _bf16_ints((300, 64), 210, cuda_device)
    r = _bf16_ints((RAGGED_N, 64), 211, cuda_device)
    floor = torch.full((300,), 20.0, device=cuda_device)  # ~a quarter of the scores
    want = _entries(kernels.scores_above_plain(q, r, RAGGED_N - 3, floor))
    assert want[0].numel() > capacity
    kernels.reset_launches()
    got = _entries(kernels.scores_above(q, r, RAGGED_N - 3, floor, capacity=capacity))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launches["scores_above.bf16"] == 2
    kernels.reset_launches()
    got = _entries(kernels.scores_above(q, r, RAGGED_N - 3, floor,
                                        capacity=want[0].numel()))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launches["scores_above.bf16"] == 1


@pytest.mark.parametrize("slots", [1, 7])
def test_bf16_scores_above_any_grid(cuda_device, monkeypatch, slots):
    # Few blocks walk many items each, across groups (12 query tiles).
    monkeypatch.setattr(kernels, "_wgmma_slots", lambda t, *args: slots)
    q = _bf16_ints((1500, 40), 212, cuda_device)
    r = _bf16_ints((RAGGED_N, 40), 213, cuda_device)
    floor = torch.full((1500,), 30.0, device=cuda_device)
    for n_valid in (1, 257, RAGGED_N):
        got = _entries(kernels.scores_above(q, r, n_valid, floor))
        want = _entries(kernels.scores_above_plain(q, r, n_valid, floor))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_scores_above_takes_bf16_only(cuda_device):
    q, r = _ints((4, 16), 214).to(cuda_device), _ints((128, 16), 215).to(cuda_device)
    floor = torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        kernels.scores_above(q, r, 100, floor)
    with pytest.raises(ValueError, match="floor"):
        kernels.scores_above(q.to(BF16), r.to(BF16), 100, floor.cpu())


# ---- the int8 (SQ8) variants ----------------------------------------------------

# Unit-norm floats: the tensor cores sum the 3·D exact products of the
# split queries in their own order, torch.matmul the f32 products in its
# own: BF16_TC_ATOL.
INT8_ATOL = BF16_TC_ATOL


def _int8_case(device, m, n, d, seed, kind="int"):
    """f32 queries [m, d], int8 codes [n, padded_width(d, 16)] (zero pad
    columns, as the searchers stage them) and scales [n]: integer queries
    and power-of-two scales (every score exact), or unit-norm float
    queries and the scales of quantized unit rows. Rows past 90% of n are
    zero codes at scale 0 (the searchers' pad rows)."""
    from vsc2022_torch.ops.similarity import quantize_rows_int8

    rng = np.random.RandomState(seed)
    width = kernels.padded_width(d, kernels.I8_ROW_ALIGN)
    codes = np.zeros((n, width), np.int8)
    if kind == "int":
        q = rng.randint(-3, 4, size=(m, d)).astype(np.float32)
        codes[:, :d] = rng.randint(-127, 128, size=(n, d))
        scale = (2.0 ** -rng.randint(0, 8, size=n)).astype(np.float32)
    else:
        q = _unit_rows(rng, m, d)
        codes[:, :d], scale = quantize_rows_int8(_unit_rows(rng, n, d))
    codes[7:12] = codes[5]  # equal columns in segment 0
    scale[7:12] = scale[5]
    live = (9 * n) // 10
    codes[live:], scale[live:] = 0, 0.0
    return (torch.from_numpy(q).to(device), torch.from_numpy(codes).to(device),
            torch.from_numpy(scale).to(device), live)


@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("d", [1, 33, 511, 512, 513, 1025])
def test_int8_kernels_exact_on_integers(cuda_device, d, m):
    # Integer queries, codes and power-of-two scales: every score is exact,
    # so all six variants equal their plain versions exactly, tie order
    # included, at ragged M and N (the pool's N a multiple of 128).
    n = 2560 if d < 1025 else 1280
    q, codes, scale, n_valid = _int8_case(cuda_device, m, n, d, 190 + d + m)
    kernels.reset_launches()
    _int8_kernels_exact(q, codes, scale, n_valid - 3, d + m)  # ragged n_valid
    assert {k: v for k, v in kernels.launches.items() if v} == {
        "row_max.int8": 1, "count_above.int8": 2, "pool_writer.int8": 1,
        "fused_topk.int8": 3, "scores.int8": 1, "scores_above.int8": 1}


def _int8_kernels_exact(q, codes, scale, n_valid, seed):
    """All six int8 variants equal their plain versions exactly on integer
    queries (every score exact), tie order included."""
    n, d = codes.shape[0], q.shape[1]
    kw = {"scale": scale}
    assert torch.equal(kernels.row_max(q, codes, n_valid, **kw),
                       kernels.row_max_plain(q, codes, n_valid, **kw))
    for tau in (40.0, float("-inf")):
        assert torch.equal(kernels.count_above(q, codes, tau, n_valid, **kw),
                           kernels.count_above_plain(q, codes, tau, n_valid, **kw))
    pv, pi = kernels.pool_writer(q, codes, n_valid, **kw)
    ev, ei = kernels.pool_writer_plain(q, codes, n_valid, **kw)
    assert torch.equal(pv, ev)
    finite = torch.isfinite(ev)
    assert torch.equal(pi[finite], ei[finite])
    for kappa in (1, 32, 100):
        got = kernels.fused_topk(q, codes[: n - 5], n_valid, kappa, scale=scale[: n - 5])
        want = kernels.fused_topk_plain(q, codes[: n - 5], n_valid, kappa,
                                        scale=scale[: n - 5])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(kernels.scores(q, codes, n_valid, **kw),
                       kernels.scores_plain(q, codes, n_valid, **kw))
    floor = _row_floors(kernels.scores_plain(q, codes, n_valid, **kw), seed)
    want = _entries(kernels.scores_above_plain(q, codes, n_valid, floor, **kw))
    got = _entries(kernels.scores_above(q, codes, n_valid, floor,
                                        capacity=want[0].numel(), **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _plane_split(plane):
    """A stand-in for kernels.split_bf16x3 on integer rows [M, D] in
    [-3, 3]: the row in one plane (0 hi, 1 mid, 2 lo) and zeros in the
    other two, or (plane 3) the row as three nonzero integer parts, one a
    plane, that sum to it. The true split puts an integer row all in hi."""
    def split(x):
        assert torch.equal(x, x.round()) and x.abs().max() <= 3
        terms = torch.zeros((3,) + tuple(x.shape), dtype=BF16, device=x.device)
        if plane < 3:
            terms[plane] = x
        else:
            a = x.clamp(-1, 1)
            b = (x - a).clamp(-1, 1)
            terms[0], terms[1], terms[2] = a, b, x - a - b
        return terms
    return split


@pytest.mark.parametrize("plane", [0, 1, 2, 3])
@pytest.mark.parametrize("d", [33, 512, 1025])
def test_int8_kernels_load_and_sum_every_query_plane(cuda_device, monkeypatch, d, plane):
    # The split of an integer query is (q, 0, 0), so the exact checks above
    # feed the mid and lo passes zeros, and a kernel that skipped them or
    # read the hi plane thrice would pass; on floats their share of a score
    # is below every tolerance. Here each plane in turn carries the whole
    # integer row (the other two zero), then all three carry parts of it:
    # each of the six kernels must equal its plain version on the row,
    # exactly, which it does only if it loads and sums every plane.
    monkeypatch.setattr(kernels, "split_bf16x3", _plane_split(plane))
    q, codes, scale, n_valid = _int8_case(cuda_device, 130, 2560, d, 240 + d)
    if plane == 3:
        assert all(t.any() for t in _plane_split(3)(q))
    _int8_kernels_exact(q, codes, scale, n_valid - 3, d + plane)


@pytest.mark.parametrize("d", [511, 512, 1025])
def test_int8_kernels_with_unit_scales_are_the_f32_kernels(cuda_device, d):
    # With every scale 1 and bf16-exact queries (the unit rows rounded to
    # bf16), each int8 variant is its bf16 kernel on codes.bfloat16(), bit
    # for bit: the split gives (q, 0, 0), the mid and lo passes add exact
    # zeros, and the hi pass is the bf16 product. (Before the int8 kernels
    # moved onto the tensor cores this held them to the f32 kernels on
    # codes.float(), their product then.)
    q, codes, _, n_valid = _int8_case(cuda_device, 150, 3840, d, 200 + d, "float")
    qb = q.to(BF16)
    q = qb.float()
    ones = torch.ones(codes.shape[0], device=cuda_device)
    wide = codes[:, :d].to(BF16).contiguous()
    kw = {"scale": ones}
    same = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))  # noqa: E731
    assert same(kernels.row_max(q, codes, n_valid, **kw), kernels.row_max(qb, wide, n_valid))
    assert torch.equal(kernels.count_above(q, codes, 20.0, n_valid, **kw),
                       kernels.count_above(qb, wide, 20.0, n_valid))
    (pv, pi), (fv, fi) = (kernels.pool_writer(q, codes, n_valid, **kw),
                          kernels.pool_writer(qb, wide, n_valid))
    assert same(pv, fv) and torch.equal(pi, fi)
    for a, b in zip(kernels.fused_topk(q, codes, n_valid, 32, **kw),
                    kernels.fused_topk(qb, wide, n_valid, 32)):
        assert torch.equal(a, b)
    assert same(kernels.scores(q, codes, n_valid, **kw), kernels.scores(qb, wide, n_valid))
    floor = _row_floors(kernels.scores(qb, wide, n_valid), d)
    for a, b in zip(_entries(kernels.scores_above(q, codes, n_valid, floor, **kw)),
                    _entries(kernels.scores_above(qb, wide, n_valid, floor))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [511, 512, 1025])
def test_int8_kernels_bit_identical_to_each_other(cuda_device, d):
    # On floats the six int8 variants score alike: each segment's best 2
    # of scores.int8 are the pool, the pool's best winner is row_max.int8,
    # its winners ordered are fused_topk.int8's, count_above.int8 counts
    # scores.int8 >= tau, and scores_above.int8 emits nonzero(scores.int8 >=
    # floor) with its scores, also on a permuted subset of the rows; all
    # within INT8_ATOL of the plain versions.
    q, codes, scale, n_valid = _int8_case(cuda_device, 260, 3840, d, 210 + d, "float")
    m, kw = q.shape[0], {"scale": scale}
    s = kernels.scores(q, codes, n_valid, **kw)
    torch.testing.assert_close(s, kernels.scores_plain(q, codes, n_valid, **kw),
                               rtol=0, atol=INT8_ATOL)
    full = torch.full((m, codes.shape[0]), float("-inf"), device=q.device)
    full[:, :n_valid] = s
    vals, idx = torch.sort(full.view(m, -1, kernels.SEG_LANES), dim=2,
                           descending=True, stable=True)
    seg_base = kernels.SEG_LANES * torch.arange(vals.shape[1], device=q.device)
    want_v, want_i = vals[:, :, :2], idx[:, :, :2].int() + seg_base[None, :, None].int()
    pv, pi = kernels.pool_writer(q, codes, n_valid, **kw)
    assert torch.equal(pv.view(torch.int32), want_v.contiguous().view(torch.int32))
    finite = torch.isfinite(want_v)
    assert torch.equal(pi[finite], want_i[finite])
    best = kernels.row_max(q, codes, n_valid, **kw)
    assert torch.equal(best.view(torch.int32), s.amax(1).view(torch.int32))
    top = kernels.fused_topk(q, codes, n_valid, 32, **kw)
    want = kernels.ordered_topk(pv.view(m, -1), pi.view(m, -1), 32)
    assert all(torch.equal(a, b) for a, b in zip(top, want))
    tau = float(torch.topk(pv.reshape(-1), 3 * m).values[-1])
    counts = kernels.count_above(q, codes, tau, n_valid, **kw)
    assert torch.equal(counts, (s >= tau).sum(1, dtype=torch.int32))
    sub = torch.from_numpy(np.random.RandomState(d).permutation(m)[:50]).to(cuda_device)
    assert torch.equal(kernels.count_above(q[sub], codes, tau, n_valid, **kw), counts[sub])
    assert torch.equal(kernels.scores(q[sub], codes, n_valid, **kw).view(torch.int32),
                       s[sub].view(torch.int32))
    floor = _row_floors(s, d)
    for rows in (torch.arange(m, device=cuda_device), sub):
        rr, cc = torch.nonzero(s[rows] >= floor[rows, None], as_tuple=True)
        es, er, ec = _entries(kernels.scores_above(q[rows], codes, n_valid, floor[rows],
                                                   **kw))
        assert torch.equal(er, rr) and torch.equal(ec, cc)
        assert torch.equal(es.view(torch.int32), s[rows][rr, cc].view(torch.int32))
    torch.testing.assert_close(best, kernels.row_max_plain(q, codes, n_valid, **kw),
                               rtol=0, atol=INT8_ATOL)


@pytest.mark.parametrize("slots", [1, 7])
def test_int8_reduce_kernels_any_grid(cuda_device, monkeypatch, slots):
    # Few blocks: each block's range spans several query tiles and groups.
    monkeypatch.setattr(kernels, "_occupancy_slots", lambda t, name, *a: slots)
    q, codes, scale, n_valid = _int8_case(cuda_device, 300, 1408, 40, 220 + slots)
    kw = {"scale": scale}
    assert torch.equal(kernels.row_max(q, codes, n_valid, **kw),
                       kernels.row_max_plain(q, codes, n_valid, **kw))
    assert torch.equal(kernels.count_above(q, codes, 30.0, n_valid, **kw),
                       kernels.count_above_plain(q, codes, 30.0, n_valid, **kw))
    for a, b in zip(kernels.fused_topk(q, codes, n_valid, 40, **kw),
                    kernels.fused_topk_plain(q, codes, n_valid, 40, **kw)):
        assert torch.equal(a, b)
    assert torch.equal(kernels.scores(q, codes, n_valid, **kw),
                       kernels.scores_plain(q, codes, n_valid, **kw))
    pool = kernels.pool_writer(q, codes, n_valid, **kw)
    want = kernels.pool_writer_plain(q, codes, n_valid, **kw)
    finite = torch.isfinite(want[0])
    assert torch.equal(pool[0], want[0]) and torch.equal(pool[1][finite], want[1][finite])
    floor = torch.full((q.shape[0],), 30.0, device=cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(
        _entries(kernels.scores_above(q, codes, n_valid, floor, **kw)),
        _entries(kernels.scores_above_plain(q, codes, n_valid, floor, **kw))))


@pytest.mark.parametrize("capacity", [0, 1, 1000])
def test_int8_scores_above_relaunches_when_the_capacity_runs_out(cuda_device, capacity):
    # As scores_above.bf16: past its capacity the kernel counts on, and the
    # wrapper launches once more with exactly the total.
    q, codes, scale, n_valid = _int8_case(cuda_device, 300, 1408, 64, 275)
    kw = {"scale": scale}
    floor = torch.full((300,), 20.0, device=cuda_device)
    want = _entries(kernels.scores_above_plain(q, codes, n_valid, floor, **kw))
    assert want[0].numel() > capacity
    kernels.reset_launches()
    got = _entries(kernels.scores_above(q, codes, n_valid, floor, capacity=capacity, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launches["scores_above.int8"] == 2
    kernels.reset_launches()
    got = _entries(kernels.scores_above(q, codes, n_valid, floor,
                                        capacity=want[0].numel(), **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launches["scores_above.int8"] == 1


@pytest.mark.parametrize("n_valid", [1408, 1280, 1300, 100])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 134, 559])
@pytest.mark.parametrize("d", [511, 1025])
def test_int8_scores_at_the_research_chunks(cuda_device, d, m, n_valid):
    # scores.int8 at row counts around and inside a 128-row query tile (the
    # int8 re-search's chunks before it took scores_above.int8: 128 and 559
    # rows, 134 in earlier searchers), every column tail (n_valid = n, a
    # multiple of 128 below n, a partial 256-row corpus tile, under one),
    # codes 512 and 1040 wide.
    # Exact on integers; on floats within INT8_ATOL of the plain version,
    # its row max row_max.int8's and its count >= tau count_above.int8's,
    # bit for bit.
    n = 1408
    q, codes, scale, _ = _int8_case(cuda_device, m, n, d, 250 + m + d)
    kw = {"scale": scale}
    kernels.reset_launches()
    got = kernels.scores(q, codes, n_valid, **kw)
    assert got.shape == (m, n_valid) and kernels.launches["scores.int8"] == 1
    assert torch.equal(got, kernels.scores_plain(q, codes, n_valid, **kw))
    q, codes, scale, _ = _int8_case(cuda_device, m, n, d, 260 + m + d, "float")
    kw = {"scale": scale}
    got = kernels.scores(q, codes, n_valid, **kw)
    torch.testing.assert_close(got, kernels.scores_plain(q, codes, n_valid, **kw),
                               rtol=0, atol=INT8_ATOL)
    best = kernels.row_max(q, codes, n_valid, **kw)
    assert torch.equal(best.view(torch.int32), got.amax(1).view(torch.int32))
    tau = float(got.reshape(-1).kthvalue(max(1, got.numel() - 3 * m)).values)
    assert torch.equal(kernels.count_above(q, codes, tau, n_valid, **kw),
                       (got >= tau).sum(1, dtype=torch.int32))


def test_int8_scores_write_nothing_past_their_rows(cuda_device):
    # The kernel's rows >= m inside a 128-row query tile, and columns >=
    # n_valid inside a 256-row corpus tile, are never stored: a [m, n_valid]
    # view at the start of a larger buffer leaves the rest untouched.
    q, codes, scale, _ = _int8_case(cuda_device, 134, 1408, 511, 270)
    m, n_valid = 134, 1300
    terms = kernels.split_bf16x3(kernels.pad_columns(q, kernels.I8_ROW_ALIGN))
    buf = torch.full((m * n_valid + 4096,), 7.0, device=cuda_device)
    rc = kernels._build.library().vsc_scores_int8(
        q.device.index, terms.data_ptr(), codes.data_ptr(),
        scale.data_ptr(), m, codes.shape[0], codes.shape[1], n_valid,
        kernels._int8_grid("scores_int8", q, n_valid), buf.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert (buf[m * n_valid:] == 7.0).all()
    assert torch.equal(buf[: m * n_valid].view(m, n_valid),
                       kernels.scores_plain(q, codes, n_valid, scale=scale))


def test_int8_zero_rows_and_pad_rows(cuda_device):
    # An all-zero valid row (scale 0) scores 0; rows past n_valid never
    # enter, even where every valid score is negative.
    q = -torch.ones((3, 16), device=cuda_device)
    codes = torch.zeros((256, 16), dtype=torch.int8, device=cuda_device)
    codes[:100] = 5
    scale = torch.zeros(256, device=cuda_device)
    scale[:100] = 0.5
    codes[40], scale[40] = 0, 0.0  # valid, all zero
    kw = {"scale": scale}
    assert (kernels.row_max(q, codes, 100, **kw) == 0.0).all()
    codes[40], scale[40] = 5, 0.5
    assert (kernels.row_max(q, codes, 100, **kw) == -40.0).all()
    assert (kernels.count_above(q, codes, -40.0, 100, **kw) == 100).all()
    pv, _ = kernels.pool_writer(q, codes, 100, **kw)
    assert (pv[:, 0] == -40.0).all() and (pv[:, 1] == float("-inf")).all()
    top_v, _ = kernels.fused_topk(q, codes, 100, 8, **kw)  # one segment's 2
    assert (top_v[:, :2] == -40.0).all() and (top_v[:, 2:] == float("-inf")).all()


def test_int8_wrappers_raise_on_cuda_mismatches(cuda_device):
    q = torch.ones((3, 16), device=cuda_device)
    codes = torch.ones((128, 16), dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.row_max(q, codes, 100)
    with pytest.raises(ValueError):
        kernels.scores(q, codes, 100, scale=torch.ones(128))  # scale on the CPU
    with pytest.raises(ValueError):
        kernels.count_above(q, codes.t(), 0.0, 16, scale=torch.ones(16, device=cuda_device))


@pytest.mark.parametrize("d", [512, 1025])
def test_int8_searcher_pooled_equals_stream_on_floats(cuda_device, monkeypatch, d):
    # Every score of an int8 search, re-searched rows included, comes from
    # the int8 kernels' product: the two collections (which re-search
    # different rows, each with one scores_above.int8 launch) return the
    # same pairs and scores, bit for bit; the corpus is staged as codes and
    # scales only.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher

    rng = np.random.RandomState(230 + d)
    q, r = _unit_rows(rng, 400, d), _unit_rows(rng, 20000, d)
    r[100:140] = r[99] + 0.01 * rng.randn(40, d).astype(np.float32)
    q[:20] = r[99]
    searcher = SimilaritySearcher(r, dtype="int8", device=cuda_device)
    assert searcher._refs.dtype == torch.int8 and searcher._tc_copy is None
    out, stats = {}, {}
    for mode in ("stream", "pooled"):
        monkeypatch.setenv(COLLECTION_ENV, mode)
        kernels.reset_launches()
        out[mode] = searcher.global_topk(q, 4000, kappa=16)
        stats[mode] = dict(searcher.last_stats)
        assert stats[mode]["mode"] == mode and stats[mode]["corpus_rows"] > 0
        launched = {k for k, v in kernels.launches.items() if v}
        assert launched <= set(kernels.INT8_KERNELS) and "scores.int8" not in launched
        assert kernels.launches["scores_above.int8"] == 1
    for a, b in zip(out["stream"], out["pooled"]):
        np.testing.assert_array_equal(a, b)
    assert searcher.staged_bytes() == searcher._refs.numel() + 4 * searcher._scale.numel()


def _numpy_sq8(rows):
    """The SQ8 quantization in numpy (the JAX package's formula)."""
    scale = (np.abs(rows).max(axis=1) / 127.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = np.where(scale > 0, 1.0 / scale, 0.0).astype(np.float32)
    return np.clip(np.rint(rows * inv[:, None]), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("d", [13, 512, 1025])
def test_int8_device_quantization_is_numpys(cuda_device, d):
    # The searcher quantizes on the card, a block of rows at a time: the
    # same codes and scales as numpy, bit for bit (a correctly rounded
    # division, product and round half to even), on its stage and append.
    rng = np.random.RandomState(240 + d)
    rows = (rng.randn(3000, d) * 10.0 ** rng.randint(-6, 4, size=(3000, 1))).astype(
        np.float32)
    rows[0] = 0.0
    rows[1] = 5.0  # every code at the clip
    rows[2, :] = 0.0
    rows[2, 0], rows[2, 1:4] = 127.0, [0.5, 1.5, -2.5]  # halfway: to even
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    searcher = SimilaritySearcher(rows[:2000], dtype="int8", device=cuda_device)
    searcher.append_rows(rows[2000:])
    codes, scale = _numpy_sq8(rows)
    assert np.array_equal(searcher._refs[:3000, :d].cpu().numpy(), codes)
    assert np.array_equal(searcher._scale[:3000].cpu().numpy().view(np.uint32),
                          scale.view(np.uint32))
    assert not searcher._refs[:, d:].any() and not searcher._refs[3000:].any()
    assert codes[2, 1:4].tolist() == [0, 2, -2]


# ---- the L2 variants (metric="L2") --------------------------------------------


L2_DTYPES = {"f32": torch.float32, "bf16": BF16}


def _l2_norms(q, r):
    """The squared norms the searchers stage: ref_sq [N], q_sq [M] f32."""
    from vsc2022_torch.ops.similarity import _row_sq

    return {"ref_sq": _row_sq(r), "q_sq": _row_sq(q)}


def _l2_dense(q, r, n_valid, kw):
    """The plain goodness [M, n_valid] (the widened product)."""
    s = kernels.scores_plain(q, r, n_valid)
    return (2 * s - kw["ref_sq"][:n_valid]) - kw["q_sq"][:, None]


def _l2_kernels_exact(q, r, n_valid, seed):
    """Every L2 variant of q's dtype against its plain version, exactly
    (integer inputs), tie order included."""
    n = r.shape[0]
    kw = _l2_norms(q, r)
    assert torch.equal(kernels.row_max(q, r, n_valid, **kw),
                       kernels.row_max_plain(q, r, n_valid, **kw))
    for tau in (-40.0, float("-inf")):
        assert torch.equal(kernels.count_above(q, r, tau, n_valid, **kw),
                           kernels.count_above_plain(q, r, tau, n_valid, **kw))
    pv, pi = kernels.pool_writer(q, r, n_valid, **kw)
    ev, ei = kernels.pool_writer_plain(q, r, n_valid, **kw)
    finite = torch.isfinite(ev)
    assert torch.equal(pv, ev) and torch.equal(pi[finite], ei[finite])
    cut = {"ref_sq": kw["ref_sq"][: n - 5], "q_sq": kw["q_sq"]}
    for kappa in (1, 32, 100):
        got = kernels.fused_topk(q, r[: n - 5], n_valid, kappa, **cut)
        want = kernels.fused_topk_plain(q, r[: n - 5], n_valid, kappa, **cut)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    if q.dtype == BF16:
        floor = _row_floors(_l2_dense(q, r, n_valid, kw), seed)
        want = _entries(kernels.scores_above_plain(q, r, n_valid, floor, **kw))
        got = _entries(kernels.scores_above(q, r, n_valid, floor,
                                            capacity=want[0].numel(), **kw))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 65, 300])
@pytest.mark.parametrize("d", [1, 33, 512, 513, 1025])
def test_l2_kernels_exact_on_integers(cuda_device, d, m, dtype):
    # Integers: every product, norm and goodness is exact, so each L2
    # variant equals its plain version, at ragged M, D and n_valid (the
    # pool's N a multiple of 128), one launch each and no IP kernel.
    n = 2560 if d < 1025 else 1280
    q = _ints((m, d), 300 + d + m).to(L2_DTYPES[dtype]).to(cuda_device)
    r = _ints((n, d), 301 + d).to(L2_DTYPES[dtype]).to(cuda_device)
    r[7:12] = r[5]  # equal columns in segment 0
    q[0] = r[5]
    kernels.reset_launches()
    _l2_kernels_exact(q, r, (9 * n) // 10 - 3, d + m)
    sfx = "" if dtype == "f32" else ".bf16"
    want = {f"row_max{sfx}.l2": 1, f"count_above{sfx}.l2": 2,
            f"pool_writer{sfx}.l2": 1, f"fused_topk{sfx}.l2": 3}
    if dtype == "bf16":
        want["scores_above.bf16.l2"] = 1
    assert {k: v for k, v in kernels.launches.items() if v} == want


@pytest.mark.parametrize("slots", [1, 3, 50])
def test_l2_kernels_any_grid(cuda_device, monkeypatch, slots):
    # Few persistent blocks: each walks several row tiles or groups.
    monkeypatch.setattr(kernels, "_occupancy_slots", lambda t, name, *a: slots)
    for dtype in ("f32", "bf16"):
        q = _ints((300, 40), 310).to(L2_DTYPES[dtype]).to(cuda_device)
        r = _ints((2560, 40), 311).to(L2_DTYPES[dtype]).to(cuda_device)
        _l2_kernels_exact(q, r, 2500, slots)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [511, 512, 1025])
def test_l2_kernels_floats_bit_identical_to_each_other(cuda_device, d, dtype):
    # Unit-norm floats: the L2 kernels of one product score every pair
    # alike, bit for bit, as each collection needs: the pool's best winner
    # is row_max, its winners ordered fused_topk's, its count count_above's
    # wherever no segment holds two entries >= tau (and no less elsewhere),
    # also on a permuted subset of the rows; each within BF16_TC_ATOL of
    # the plain goodness.
    q, r, n_valid = _float_case(cuda_device, d, 320 + d)
    q, r = q.to(L2_DTYPES[dtype]), r.to(L2_DTYPES[dtype])
    kw = _l2_norms(q, r)
    m = q.shape[0]
    pv, pi = kernels.pool_writer(q, r, n_valid, **kw)
    best = kernels.row_max(q, r, n_valid, **kw)
    assert torch.equal(pv.view(m, -1).amax(1).view(torch.int32), best.view(torch.int32))
    torch.testing.assert_close(best, kernels.row_max_plain(q, r, n_valid, **kw),
                               rtol=0, atol=BF16_TC_ATOL)
    for kappa in (5, 32, 100):
        want = kernels.ordered_topk(pv.view(m, -1), pi.view(m, -1), kappa)
        got = kernels.fused_topk(q, r, n_valid, kappa, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    tau = float(torch.topk(pv.reshape(-1), 3 * m).values[-1])
    above = pv >= tau
    clean = above.all(2).sum(1) == 0
    for rows in (torch.arange(m, device=cuda_device),
                 torch.from_numpy(np.random.RandomState(d).permutation(m)[:90])
                 .to(cuda_device)):
        sub = {"ref_sq": kw["ref_sq"], "q_sq": kw["q_sq"][rows]}
        counts = kernels.count_above(q[rows], r, tau, n_valid, **sub).long()
        pool_counts = above[rows].view(len(rows), -1).sum(1)
        assert torch.equal(counts[clean[rows]], pool_counts[clean[rows]])
        assert bool((counts >= pool_counts).all())
    assert clean.any() and (~clean).any()


@pytest.mark.parametrize("d", [13, 511, 512, 1025])
def test_l2_scores_above_bit_identical_to_dense_goodness(cuda_device, d):
    # Each emitted entry is the goodness of scores.bf16 at its (row, col),
    # (2 s - ref_sq) - q_sq in torch's f32 elementwise operations, bit for
    # bit, and the set is nonzero(goodness >= floor), also on a permuted
    # row subset.
    q, r, n_valid = _bf16_case(cuda_device, d, 0, 330 + d)
    q, rt = q[:133], kernels.pad_columns(r)
    kw = _l2_norms(q, r)
    dense = (2 * kernels.scores(q, rt, n_valid) - kw["ref_sq"][:n_valid]) - kw["q_sq"][:, None]
    floor = _row_floors(dense, d)
    for rows in (torch.arange(133, device=cuda_device),
                 torch.from_numpy(np.random.RandomState(d).permutation(133)[:50])
                 .to(cuda_device)):
        rr, cc = torch.nonzero(dense[rows] >= floor[rows, None], as_tuple=True)
        s, gr, gc = _entries(kernels.scores_above(
            q[rows], rt, n_valid, floor[rows], ref_sq=kw["ref_sq"], q_sq=kw["q_sq"][rows]))
        assert torch.equal(gr, rr) and torch.equal(gc, cc)
        assert torch.equal(s.view(torch.int32), dense[rows][rr, cc].view(torch.int32))
    torch.testing.assert_close(s, _l2_dense(q, r, n_valid, kw)[rows][rr, cc],
                               rtol=0, atol=BF16_TC_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [512, 1025])
def test_l2_searcher_pooled_equals_stream_on_floats(cuda_device, monkeypatch, d, dtype):
    # An L2 search (re-searched rows included) scores on one product: the
    # two collections return the same pairs and squared distances, bit for
    # bit, through the L2 kernels alone.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher

    rng = np.random.RandomState(340 + d)
    q, r = _unit_rows(rng, 400, d), _unit_rows(rng, 20000, d)
    r[100:140] = r[99] + 0.01 * rng.randn(40, d).astype(np.float32)
    q[:20] = r[99]
    searcher = SimilaritySearcher(r, metric="L2", dtype=dtype, device=cuda_device)
    out = {}
    for mode in ("stream", "pooled"):
        monkeypatch.setenv(COLLECTION_ENV, mode)
        kernels.reset_launches()
        out[mode] = searcher.global_topk(q, 4000, kappa=16)
        assert searcher.last_stats["mode"] == mode and searcher.last_stats["corpus_rows"] > 0
        launched = {k for k, v in kernels.launches.items() if v}
        assert launched and launched <= set(kernels.L2_KERNELS)
    for a, b in zip(out["stream"], out["pooled"]):
        np.testing.assert_array_equal(a, b)
    assert (out["stream"][2] >= -1e-5).all()


def test_default_f32_searcher_is_the_bf16_searcher(cuda_device):
    # precision="default" over an f32 corpus: every product on the bf16
    # kernels over the bf16 copy, so ids and scores are a bf16 searcher's on
    # the same rows, bit for bit, in both collections.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher

    rng = np.random.RandomState(350)
    q, r = _unit_rows(rng, 300, 512), _unit_rows(rng, 20000, 512)
    r[100:140] = r[99] + 0.01 * rng.randn(40, 512).astype(np.float32)
    q[:20] = r[99]
    a = SimilaritySearcher(r, precision="default", device=cuda_device)
    b = SimilaritySearcher(r, dtype="bfloat16", device=cuda_device)
    for mode in ("stream", "pooled"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(COLLECTION_ENV, mode)
            kernels.reset_launches()
            got = a.global_topk(q, 3000, kappa=16)
            assert {k for k, v in kernels.launches.items() if v} <= {
                name + kernels.BF16 for name in kernels.TENSOR_CORE_KERNELS}
            for x, y in zip(got, b.global_topk(q, 3000, kappa=16)):
                np.testing.assert_array_equal(x, y)


def test_default_int8_searcher_is_the_one_pass_product(cuda_device):
    # int8 at "default": the queries rounded to bf16 before the split, so
    # the three-pass product adds exact zeros to the one bf16 pass. With
    # codes at unit scale (each row holds a code of 127 at max|row| = 127)
    # that is a bf16 search over the widened codes, bit for bit.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher

    rng = np.random.RandomState(360)
    codes = rng.randint(-127, 128, size=(20000, 512)).astype(np.float32)
    codes[:, 0] = 127.0
    q = _unit_rows(rng, 300, 512)
    a = SimilaritySearcher(codes, dtype="int8", precision="default", device=cuda_device)
    assert bool((a._scale[: a.n_refs] == 1.0).all())
    b = SimilaritySearcher(codes, dtype="bfloat16", device=cuda_device)
    for mode in ("stream", "pooled"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(COLLECTION_ENV, mode)
            got = a.global_topk(q, 3000, kappa=16)
            for x, y in zip(got, b.global_topk(q, 3000, kappa=16)):
                np.testing.assert_array_equal(x, y)


# ---- the descriptor models on the card ---------------------------------------------

EXTRACT_REL_TOL = 1e-5
BF16_COSINE_MIN = 0.999


def _extraction_models():
    from vsc2022_torch.inference.cli import _Flatten
    from vsc2022_torch.inference.transforms import InferenceTransforms as IT
    from vsc2022_torch.models.dns import L3iMACExtractor
    from vsc2022_torch.models.init import init_flax_like
    from vsc2022_torch.models.sscd import SSCDModel
    from vsc2022_torch.models.vit import DinoViT

    g = torch.Generator().manual_seed(0)
    sscd, l3 = SSCDModel(), L3iMACExtractor()
    for m in (sscd, l3):
        init_flax_like(m, g)
        with torch.no_grad():
            for bn in m.modules():
                if isinstance(bn, torch.nn.BatchNorm2d):
                    bn.running_mean.normal_(0.0, 0.1, generator=g)
                    bn.running_var.uniform_(0.5, 1.5, generator=g)
    dino = DinoViT()
    dino.init_weights(g)
    return {"sscd": (sscd, IT.RESIZE_320_CENTER), "dino224": (dino, IT.RESIZE_224_SQUARE),
            "dino320": (dino, IT.RESIZE_320_CENTER),
            "l3imac": (_Flatten(l3), IT.RESIZE_320_CENTER)}


def _frames(n, seed=0):
    blocks = np.random.RandomState(seed).randint(0, 256, (n, 45, 80, 3)).astype(np.uint8)
    return torch.from_numpy(np.repeat(np.repeat(blocks, 8, axis=1), 8, axis=2))


@pytest.mark.parametrize("name", ["sscd", "dino224", "dino320", "l3imac"])
def test_descriptor_models_on_card_match_cpu(cuda_device, name):
    import copy

    from vsc2022_torch.inference.pipeline import DescriptorExtractor

    model, transform = _extraction_models()[name]
    frames = _frames(4)
    want = DescriptorExtractor(copy.deepcopy(model), transform, batch_size=4,
                               device="cpu").forward(frames).numpy()
    card = DescriptorExtractor(copy.deepcopy(model), transform, batch_size=4,
                               device=cuda_device)
    on_card = frames.to(cuda_device)
    got = card.forward(on_card).cpu().numpy()
    assert np.abs(got - want).max() <= EXTRACT_REL_TOL * np.abs(want).max()
    assert np.array_equal(card.forward(on_card).cpu().numpy(), got)  # deterministic
    bf16 = DescriptorExtractor(copy.deepcopy(model), transform, batch_size=4,
                               compute_dtype="bfloat16", device=cuda_device)
    half = bf16.forward(on_card).cpu().numpy()
    assert half.dtype == np.float32
    cos = (half * got).sum(1) / (np.linalg.norm(half, axis=1) * np.linalg.norm(got, axis=1))
    assert cos.min() >= BF16_COSINE_MIN


def test_f32_forward_runs_without_tf32(cuda_device):
    from vsc2022_torch.inference.pipeline import DescriptorExtractor
    from vsc2022_torch.inference.transforms import preprocess

    model, transform = _extraction_models()["sscd"]
    extractor = DescriptorExtractor(model, transform, batch_size=4, device=cuda_device)
    frames = _frames(4, seed=1).to(cuda_device)
    f32 = extractor.forward(frames)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert torch.equal(extractor.forward(frames), f32)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with torch.inference_mode():  # the same model with TF32 on: other numbers
            tf32 = extractor.model(preprocess(frames, transform).permute(0, 3, 1, 2))
        assert not torch.equal(tf32.float(), f32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# ---- the corpus sharded over one card ------------------------------------------


def _shard_case(cuda_device, kind, n, d, seed):
    rng = np.random.RandomState(seed)
    if kind == "int":
        q = rng.randint(-3, 4, size=(45, d)).astype(np.float32)
        r = rng.randint(-3, 4, size=(n, d)).astype(np.float32)
        r[300:320] = 3.0  # ties across the first shard boundaries
        q[:4] = 3.0
    else:
        q = rng.standard_normal((45, d)).astype(np.float32)
        r = rng.standard_normal((n, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        r /= np.linalg.norm(r, axis=1, keepdims=True)
    return q, r


# The kernels each collection launches over a corpus of each dtype.
_COLLECTION_KERNELS = {"stream": ("fused_topk", "count_above"), "pooled": ("pool_writer",)}


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype,metric", [("float32", "IP"), ("float32", "L2"),
                                          ("bfloat16", "IP"), ("bfloat16", "L2"),
                                          ("int8", "IP")])
@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_sharded_search_equals_single_device(cuda_device, monkeypatch, shards, dtype,
                                             metric, mode, kind):
    # Shards as views into one staged tensor on the card: the same pairs,
    # scores and tie order as the single-device searcher, bit for bit, on
    # integers and on unit-norm floats (the f32 re-search is one cuBLAS
    # call over the run of shards, the single-device call); each shard
    # launches its collection's kernels once.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher
    from vsc2022_torch.parallel import Mesh
    from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher

    monkeypatch.setenv(COLLECTION_ENV, mode)
    q, r = _shard_case(cuda_device, kind, 7000, 24, shards)
    single = SimilaritySearcher(r, metric=metric, dtype=dtype, device=cuda_device)
    sharded = ShardedSimilaritySearcher(r, Mesh([cuda_device] * shards), metric=metric,
                                        dtype=dtype)
    suffix = {"float32": "", "bfloat16": ".bf16", "int8": ".int8"}[dtype]
    suffix += ".l2" if metric == "L2" else ""
    for k in (600, 45 * 16 + 1):  # the second has k > nq·κ
        want = single.global_topk(q, k, kappa=16)
        kernels.reset_launches()
        got = sharded.global_topk(q, k, kappa=16)
        assert sharded.last_stats["mode"] == mode
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for name in _COLLECTION_KERNELS[mode]:
            assert kernels.launches[name + suffix] == shards, (name, kernels.launches)
    np.testing.assert_array_equal(sharded.row_nn(q), single.row_nn(q))


@pytest.mark.parametrize("d", [13, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_search_shards_as_separate_tensors(cuda_device, monkeypatch, d, dtype):
    # The same search with each shard its own allocation (as on separate
    # cards) and at an odd D (the f32 chain's 4-byte copies; bf16 rows a
    # padded copy), through append_rows and keep_rows: bit for bit. bf16
    # and int8: every score, the re-search's too, is a hand kernel's. f32:
    # the re-search runs per allocation, on the single-device searcher's
    # cuBLAS calls of one shape (_f32_scores: its column blocks begin at
    # the same corpus rows), so on unit-norm floats too.
    from vsc2022_torch.ops.similarity import SimilaritySearcher
    from vsc2022_torch.parallel import Mesh
    from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher

    monkeypatch.setattr(ShardedSimilaritySearcher, "_allocations",
                        lambda self: [[s] for s in range(self.n_dev)])
    for kind in ("int", "float") if dtype == "float32" else ("float",):
        q, r = _shard_case(cuda_device, kind, 3000, d, 5)
        single = SimilaritySearcher(r, dtype=dtype, device=cuda_device)
        sharded = ShardedSimilaritySearcher(r, Mesh([cuda_device] * 3), dtype=dtype,
                                            col_block=256)
        assert len({t.untyped_storage().data_ptr() for t in sharded._shard["refs"]}) == 3

        def check(k):
            got, want = sharded.global_topk(q, k, kappa=8), single.global_topk(q, k, kappa=8)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)

        check(900)
        extra = _shard_case(cuda_device, kind, 2000, d, 6)[1]
        sharded.append_rows(extra)
        single.append_rows(extra)
        check(900)
        keep = np.flatnonzero(np.random.RandomState(7).rand(5000) < 0.4)
        sharded.keep_rows(keep)
        single.keep_rows(keep)
        check(900)


@pytest.mark.parametrize("dtype,metric", [("float32", "IP"), ("float32", "L2"),
                                          ("bfloat16", "IP"), ("bfloat16", "L2"),
                                          ("int8", "IP")])
@pytest.mark.parametrize("mode", ["stream", "pooled"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_sharded_search_one_shard_per_card(cuda_device, monkeypatch, dtype, metric, mode,
                                           kind):
    # One shard a card, over every card (the merges copy card to card): the
    # single-device searcher's pairs, scores and tie order, bit for bit, an
    # f32 search on floats too (its re-search runs a card at a time on the
    # single-device searcher's cuBLAS calls of one shape); each card
    # launches its collection's kernels once.
    from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher
    from vsc2022_torch.parallel import Mesh
    from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: one shard a card")
    monkeypatch.setenv(COLLECTION_ENV, mode)
    q, r = _shard_case(cuda_device, kind, 7000, 24, cards)
    single = SimilaritySearcher(r, metric=metric, dtype=dtype, device="cuda:0")
    mesh = Mesh([torch.device("cuda", i) for i in range(cards)])
    sharded = ShardedSimilaritySearcher(r, mesh, metric=metric, dtype=dtype)
    assert [t.device for t in sharded._shard["refs"]] == list(mesh.devices)
    suffix = {"float32": "", "bfloat16": ".bf16", "int8": ".int8"}[dtype]
    suffix += ".l2" if metric == "L2" else ""
    for k in (600, 45 * 16 + 1):
        want = single.global_topk(q, k, kappa=16)
        kernels.reset_launches()
        got = sharded.global_topk(q, k, kappa=16)
        assert sharded.last_stats["mode"] == mode
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for name in _COLLECTION_KERNELS[mode]:
            assert kernels.launches[name + suffix] == cards, (name, kernels.launches)
    np.testing.assert_array_equal(sharded.row_nn(q), single.row_nn(q))


def _every_card():
    from vsc2022_torch.parallel import Mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: one shard a card")
    return Mesh([torch.device("cuda", i) for i in range(cards)])


def _dyadic_rows(rng, n, d):
    """[n, d]: dimension 0 at zero, ±1 on four of the others (exact sums)."""
    x = np.zeros((n, d), np.float32)
    cols = 1 + np.argsort(rng.rand(n, d - 1), axis=1)[:, :4]
    np.put_along_axis(x, cols, rng.choice([-1.0, 1.0], size=(n, 4)), axis=1)
    return x


def _dns_lifecycle_rows(**kw):
    """DnSLocalization through set_queries, add_refs and remove_refs on
    planted copies: the matches of its two localize_all calls."""
    from vsc2022_torch.baseline.dns_baseline import DnSLocalization
    from vsc2022_torch.metrics import CandidatePair
    from vsc2022_torch.types import VideoFeature

    rng = np.random.RandomState(3)

    def videos(prefix, lengths, offset=0):
        return [VideoFeature(f"{prefix}{offset + i:06d}", np.arange(n, dtype=np.float64),
                             _dyadic_rows(rng, n, 12)) for i, n in enumerate(lengths)]

    def fine(vids):
        return {v.video_id: VideoFeature(v.video_id, v.timestamps, 0.5 * _dyadic_rows(
            rng, len(v.timestamps) * 9, 8).reshape(len(v.timestamps), -1)) for v in vids}

    refs, extra = videos("R", rng.randint(16, 40, size=10)), videos("R", [28, 18], 100)
    queries = videos("Q", [24, 30, 20, 26])
    queries[0].feature[4:14] = refs[1].feature[2:12]
    queries[2].feature[3:15] = extra[0].feature[8:20]
    qf, rf, xf = fine(queries), fine(refs), fine(extra)
    qf["Q000000"].feature[4:14] = rf["R000001"].feature[2:12]
    qf["Q000002"].feature[3:15] = xf["R000100"].feature[8:20]
    pairs = [("Q000000", "R000001"), ("Q000002", "R000100"), ("Q000001", "R000003")]
    loc = DnSLocalization({}, dict(rf), [], refs, model_type="TN", similarity_bias=0.5, **kw)
    loc.set_queries(queries[:2], queries_fine={k: qf[k] for k in ("Q000000", "Q000001")})
    first = loc.localize_all([CandidatePair(*pairs[0], 1.0), CandidatePair(*pairs[2], 1.0)])
    loc.add_refs(extra, refs_fine=xf)
    loc.remove_refs(["R000003"])
    loc.set_queries(queries, queries_fine=qf)
    second = loc.localize_all([CandidatePair(q, r, 1.0) for q, r in pairs[:2]])
    return [[(m.query_id, m.ref_id, m.query_start, m.query_end, m.ref_start, m.ref_end,
              m.score) for m in ms] for ms in (first, second)]


def test_sharded_tables_and_extraction_one_shard_per_card(cuda_device):
    # DnSLocalization with row-sharded coarse and fine tables, one shard a
    # card (each pair tile's chamfer kernel on its card), through add_refs
    # and remove_refs: the rows of the same localizer on cuda:0, scores
    # within BF16_TC_ATOL (the f32 chamfer on exact dyadic rows). The
    # extractor over every card: within EXTRACT_REL_TOL of one card.
    from vsc2022_torch.inference.pipeline import DescriptorExtractor

    mesh = _every_card()
    kernels.reset_launches()
    got = _dns_lifecycle_rows(mesh=mesh, shard_ref_table=True)
    assert kernels.launches["chamfer"] >= mesh.size
    assert torch.cuda.current_device() == 0  # each card's launches left it current
    want = _dns_lifecycle_rows(device="cuda:0")
    assert [len(ms) for ms in got] == [len(ms) for ms in want] and want[1]
    for g, w in zip(got, want):
        assert [m[:6] for m in g] == [m[:6] for m in w]
        np.testing.assert_allclose([m[6] for m in g], [m[6] for m in w], rtol=0,
                                   atol=BF16_TC_ATOL)

    model, transform = _extraction_models()["sscd"]
    frames = _frames(3 * mesh.size, seed=2).numpy()

    class Frames:
        def iter_decoded(self):
            for i, n in enumerate((mesh.size + 1, 2 * mesh.size - 1)):
                yield f"Q{i:06d}", frames[:n], np.stack([np.arange(n), np.arange(n) + 1.0], 1)

    one = DescriptorExtractor(model, transform, batch_size=2 * mesh.size, device="cuda:0")
    every = DescriptorExtractor(model, transform, batch_size=2 * mesh.size, mesh=mesh)
    want = np.concatenate([vf.feature for vf in one.extract(Frames())])
    got = np.concatenate([vf.feature for vf in every.extract(Frames())])
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= EXTRACT_REL_TOL * np.abs(want).max()


# A pod of one rank per card, over NCCL: the worker each rank runs.
NCCL_POD_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

RANK, WORLD, PORT = (int(a) for a in sys.argv[1:4])
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
from test_torch_cuda import BF16_TC_ATOL, _dns_lifecycle_rows
from vsc2022_torch.ops import kernels
from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher
from vsc2022_torch.parallel import corpus_mesh, initialize_distributed
from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher

dev = initialize_distributed(f"localhost:{PORT}", WORLD, RANK, device="cuda")
assert dev == torch.device("cuda", RANK) and dist.get_backend() == "nccl", dev
torch.backends.cuda.matmul.allow_tf32 = False
mesh = corpus_mesh()
assert mesh.size == WORLD and mesh.local == (RANK,) and mesh.lead == dev, mesh
rng = np.random.RandomState(0)
q = rng.randint(-3, 4, size=(45, 24)).astype(np.float32)
q[:4] = 3.0
r = rng.randint(-3, 4, size=(7000, 24)).astype(np.float32)
r[300:320] = 3.0  # ties across shard boundaries
codes = r.copy()  # over int8 each row's max is 127: scale 1, codes exact
codes[np.arange(7000), rng.randint(0, 24, 7000)] = rng.choice([-127.0, 127.0], 7000)
unit = rng.standard_normal((7000, 24)).astype(np.float32)
unit /= np.linalg.norm(unit, axis=1, keepdims=True)
suffix = {"float32": "", "bfloat16": ".bf16", "int8": ".int8"}
cases = [("float32", "IP", r), ("float32", "L2", r), ("bfloat16", "IP", r),
         ("bfloat16", "L2", r), ("int8", "IP", codes), ("bfloat16", "IP", unit)]
for dtype, metric, rows in cases:
    for mode in ("stream", "pooled"):
        os.environ[COLLECTION_ENV] = mode
        pod = ShardedSimilaritySearcher(rows, mesh, metric=metric, dtype=dtype)
        for n_rows in (7000, 8500, 4250):
            if n_rows == 8500:  # rows move card to card over NCCL
                pod.append_rows(rows[:1500])
                held = np.concatenate([rows, rows[:1500]])
            elif n_rows == 4250:
                pod.keep_rows(np.arange(0, 8500, 2))
                held = held[::2]
            else:
                held = rows
            single = SimilaritySearcher(held, metric=metric, dtype=dtype, device=dev)
            for k in (600, 45 * 16 + 1):
                want = single.global_topk(q, k, kappa=16)
                kernels.reset_launches()
                got = pod.global_topk(q, k, kappa=16)
                assert pod.last_stats["mode"] == mode, pod.last_stats
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                name = "pool_writer" if mode == "pooled" else "fused_topk"
                assert kernels.launches[name + suffix[dtype] + (".l2" if metric == "L2"
                                                                 else "")] == 1
            np.testing.assert_array_equal(pod.row_nn(q), single.row_nn(q))
kernels.reset_launches()
got = _dns_lifecycle_rows(mesh=mesh, shard_ref_table=True)
# Each chunk's first tile is rank 0's (the others may have no tile).
assert RANK or kernels.launches["chamfer"] >= 1, kernels.launches
want = _dns_lifecycle_rows(device=dev)
assert [[m[:6] for m in g] for g in got] == [[m[:6] for m in w] for w in want] and want[1]
for g, w in zip(got, want):
    np.testing.assert_allclose([m[6] for m in g], [m[6] for m in w], rtol=0,
                               atol=BF16_TC_ATOL)
dist.destroy_process_group()
print("NCCL RANK", RANK, "OK", flush=True)
"""


def test_pod_one_rank_per_card_over_nccl(cuda_device):
    # One process a card, joined over NCCL (initialize_distributed's rule
    # on cards): the pod searcher over corpus_mesh() (one shard a rank)
    # equals a single-device searcher on the rank's card bit for bit in
    # every dtype and metric, both collections, through append_rows and
    # keep_rows (rows cross cards in all_to_all); each rank launches its
    # collection's kernel once a search; the DnS localizer with row-sharded
    # tables holds one card's matches. Needs two or more cards.
    import os
    import socket
    import subprocess
    import sys

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: one rank a card")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_POD_WORKER, str(rank), str(cards),
                               str(port)], cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(cards)]
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0 and f"NCCL RANK {rank} OK" in out, out[-4000:]
    finally:
        for p in procs:
            p.kill()


# ---- the block subsets (the IVF tier's scans) -------------------------------------

# Rows a block: a multiple of the tensor cores' 256-row tile. Six blocks,
# the last partial (n_valid 2,900 of 3,072 staged rows).
BLOCK_COL = 512
BLOCK_N, BLOCK_VALID = 6 * BLOCK_COL, 2900
BLOCK_LISTS = ([0], [5], [3], [0, 2, 5], [1, 2, 3, 4, 5])
BLOCK_SUFFIX = {"float32": "", "bfloat16": ".bf16", "int8": ".int8"}


def _block_case(device, dtype, kind, seed, d=64):
    """(q, refs, scale, n_valid) over BLOCK_N staged rows in the dtype's
    staging: integer rows (int8: integer queries, power-of-two scales) or
    unit-norm floats; rows past n_valid zero."""
    if dtype == "int8":
        q, codes, scale, _ = _int8_case(device, 300, BLOCK_N, d, seed, kind)
        codes[BLOCK_VALID:], scale[BLOCK_VALID:] = 0, 0.0
        return q, codes, scale, BLOCK_VALID
    rng = np.random.RandomState(seed)
    if kind == "int":
        q = rng.randint(-3, 4, size=(300, d)).astype(np.float32)
        r = rng.randint(-3, 4, size=(BLOCK_N, d)).astype(np.float32)
    else:
        q, r = _unit_rows(rng, 300, d), _unit_rows(rng, BLOCK_N, d)
    r[BLOCK_VALID:] = 0
    dt = BF16 if dtype == "bfloat16" else torch.float32
    return (torch.from_numpy(q).to(dt).to(device), torch.from_numpy(r).to(dt).to(device),
            None, BLOCK_VALID)


def _listed(ids, r, scale, n_valid):
    """(listed rows, their refs as one contiguous corpus, its kernel kwargs)."""
    rows = kernels.block_rows(ids, BLOCK_COL, n_valid)
    kw = {} if scale is None else {"scale": scale[rows].contiguous()}
    return rows, r[rows].contiguous(), kw


@pytest.mark.parametrize("blocks", BLOCK_LISTS)
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_blocks_equal_the_full_kernel_on_the_listed_rows(cuda_device, dtype, kind, blocks):
    # A score does not depend on where its tile sits in the schedule, so a
    # subset kernel gives the full-corpus kernel's result on a corpus made of
    # the listed blocks' rows, bit for bit, ids mapped back.
    q, r, scale, n_valid = _block_case(cuda_device, dtype, kind, 300 + len(blocks))
    kw = {} if scale is None else {"scale": scale}
    ids = torch.tensor(blocks, dtype=torch.int32, device=cuda_device)
    rows, sub, sub_kw = _listed(ids, r, scale, n_valid)
    sub_blocks = {"blocks": ids, "col_block": BLOCK_COL}
    kernels.reset_launches()
    for tau in ((6.0, -2.0, float("-inf")) if kind == "int" else (0.15, float("-inf"))):
        got = kernels.count_above(q, r, tau, n_valid, **kw, **sub_blocks)
        assert torch.equal(got, kernels.count_above(q, sub, tau, rows.numel(), **sub_kw))
    for kappa in (8, 32, 100):
        gv, gi = kernels.fused_topk(q, r, n_valid, kappa, **kw, **sub_blocks)
        wv, wi = kernels.fused_topk(q, sub, rows.numel(), kappa, **sub_kw)
        assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
        assert torch.equal(gi, torch.where(torch.isfinite(wv), rows[wi.long()], 0).int())
    sfx = BLOCK_SUFFIX[dtype]
    n_tau = 3 if kind == "int" else 2
    assert {k: v for k, v in kernels.launches.items() if v} == {
        f"count_above{sfx}.blocks": n_tau, f"count_above{sfx}": n_tau,
        f"fused_topk{sfx}.blocks": 3, f"fused_topk{sfx}": 3}


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_blocks_match_plain(cuda_device, dtype, kind):
    # Against the plain versions with the same list: exact on integers,
    # within BF16_TC_ATOL on unit-norm floats (the int8 plain product: the
    # dequantized rows).
    q, r, scale, n_valid = _block_case(cuda_device, dtype, kind, 320)
    kw = {} if scale is None else {"scale": scale}
    for blocks in BLOCK_LISTS:
        ids = torch.tensor(blocks, dtype=torch.int32, device=cuda_device)
        sub_blocks = {"blocks": ids, "col_block": BLOCK_COL}
        rows, sub, sub_kw = _listed(ids, r, scale, n_valid)
        tau, kappa = (6.0 if kind == "int" else 0.15), 32
        got = kernels.count_above(q, r, tau, n_valid, **kw, **sub_blocks)
        gv, gi = kernels.fused_topk(q, r, n_valid, kappa, **kw, **sub_blocks)
        if kind == "int":
            assert torch.equal(got, kernels.count_above_plain(q, r, tau, n_valid, **kw,
                                                              **sub_blocks))
            wv, wi = kernels.fused_topk_plain(q, r, n_valid, kappa, **kw, **sub_blocks)
            assert torch.equal(gv, wv) and torch.equal(gi, wi)
            continue
        # The listed rows as the plain product reads them (int8: dequantized)
        # and the kernel's ids in their numbering.
        ref = sub if scale is None else sub.float() * sub_kw["scale"][:, None]
        local = torch.where(torch.isfinite(gv), torch.searchsorted(rows, gi.long()), 0)
        _check_count_within(got, q, ref, tau, rows.numel(), BF16_TC_ATOL)
        _check_topk_within(gv, local, q, ref, rows.numel(), kappa, BF16_TC_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_blocks_edge_cases(cuda_device, dtype):
    # An empty list launches nothing: counts 0 and kappa-sets of -inf (ids
    # 0). Ids out of range, unordered or repeated raise; so does L2 and, on
    # the tensor cores, a col_block that is not a whole number of 256-row
    # tiles.
    q, r, scale, n_valid = _block_case(cuda_device, dtype, "int", 330)
    kw = {} if scale is None else {"scale": scale}
    kernels.reset_launches()
    empty = {"blocks": torch.empty(0, dtype=torch.int32, device=cuda_device),
             "col_block": BLOCK_COL}
    assert int(kernels.count_above(q, r, -1e9, n_valid, **kw, **empty).abs().sum()) == 0
    gv, gi = kernels.fused_topk(q, r, n_valid, 16, **kw, **empty)
    assert bool(torch.isneginf(gv).all()) and int(gi.abs().sum()) == 0
    assert not any(kernels.launches.values())
    for bad in ([6], [-1], [2, 2], [3, 1]):
        ids = torch.tensor(bad, dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError, match="ascending"):
            kernels.count_above(q, r, 0.0, n_valid, **kw, blocks=ids, col_block=BLOCK_COL)
        with pytest.raises(ValueError, match="ascending"):
            kernels.fused_topk(q, r, n_valid, 8, **kw, blocks=ids, col_block=BLOCK_COL)
    one = torch.tensor([0], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="on cuda"):
        kernels.count_above(q, r, 0.0, n_valid, **kw, blocks=one.cpu(), col_block=BLOCK_COL)
    if dtype != "float32":
        with pytest.raises(ValueError, match="multiple of 256"):
            kernels.fused_topk(q, r, n_valid, 8, **kw, blocks=one, col_block=128)
    if dtype != "int8":
        l2 = {"ref_sq": torch.ones(BLOCK_N, device=cuda_device),
              "q_sq": torch.ones(q.shape[0], device=cuda_device)}
        with pytest.raises(ValueError, match="metric IP"):
            kernels.count_above(q, r, 0.0, n_valid, blocks=one, col_block=BLOCK_COL, **l2)


@pytest.mark.parametrize("slots", [1, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_blocks_any_grid(cuda_device, monkeypatch, dtype, slots):
    # Few blocks: a block's range spans row tiles (groups) and several of
    # the listed blocks; the pieces land in up to S slots.
    q, r, scale, n_valid = _block_case(cuda_device, dtype, "int", 340)
    kw = {} if scale is None else {"scale": scale}
    ids = torch.tensor([0, 2, 5], dtype=torch.int32, device=cuda_device)
    sub_blocks = {"blocks": ids, "col_block": BLOCK_COL}
    want_c = kernels.count_above_plain(q, r, 6.0, n_valid, **kw, **sub_blocks)
    want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, 32, **kw, **sub_blocks)
    monkeypatch.setattr(kernels, "_occupancy_slots", lambda t, name, *args: slots)
    assert torch.equal(kernels.count_above(q, r, 6.0, n_valid, **kw, **sub_blocks), want_c)
    got_v, got_i = kernels.fused_topk(q, r, n_valid, 32, **kw, **sub_blocks)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_blocks_ivf_searcher_equals_plain(cuda_device, dtype):
    # The IVF searcher on the card (its scans on the subset kernels) against
    # the plain searcher: the same pairs and scores, ties included.
    from vsc2022_torch.ops.ivf import IVFSimilaritySearcher
    from vsc2022_torch.ops.similarity import SimilaritySearcher

    rng = np.random.RandomState(350)
    centers = rng.randint(-12, 13, size=(8, 16)) * 8
    truth = np.arange(40_000) % 8
    rows = (centers[truth] + rng.randint(-2, 3, size=(40_000, 16))).astype(np.float32)
    ivf = IVFSimilaritySearcher(rows, nlist=8, dtype=dtype, device=cuda_device)
    plain = SimilaritySearcher(rows, dtype=dtype, device=cuda_device)
    q = rows[truth == 3][:64] + 1.0
    sfx = BLOCK_SUFFIX[dtype]
    for k in (10, 500):
        kernels.reset_launches()
        got = ivf.global_topk(q, k)
        assert ivf.last_search_stats["pruned"] is True, ivf.last_search_stats
        assert kernels.launches[f"fused_topk{sfx}.blocks"] == 1
        assert kernels.launches[f"count_above{sfx}.blocks"] == 1
        assert kernels.launches[f"fused_topk{sfx}"] == kernels.launches[f"count_above{sfx}"] == 0
        want = plain.global_topk(q, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- training -------------------------------------------------------------------

TRAIN_SMALL = dict(stage_sizes=(1, 1, 1, 1), stage_features=(16, 32, 64, 128), dims=64)
TRAIN_F64_TOL = 1e-9


def _train_step(device, dtype, views):
    """One step of the small SSCD (seed 12) on ``device`` in ``dtype``:
    the loss, the gradients and the running statistics, as numpy."""
    from vsc2022_torch.models.sscd import SSCDModel
    from vsc2022_torch.train import create_train_state, make_train_step

    model = SSCDModel(**TRAIN_SMALL)
    state = create_train_state(model, 1e-4, 1e-2, seed=12, device=device)
    model.to(dtype)
    state, loss = make_train_step(model)(
        state, {k: v.to(device, dtype) for k, v in views.items()})
    return (float(loss), {n: p.grad.double().cpu().numpy() for n, p in model.named_parameters()},
            {n: b.cpu().numpy() for n, b in model.named_buffers() if "running" in n})


def test_train_step_float64_on_the_card_is_the_cpus(cuda_device):
    # Views of 16 frames (seed 7) at 32 x 32, made on the CPU: the float64
    # step on the card equals the CPU's within TRAIN_F64_TOL; the card's
    # float32 step lies within 1e-2 of it in norm (1.2e-3 read at phase
    # 12a's shape) with the loss within 1e-5.
    from vsc2022_torch.train.augment import two_views

    rng = np.random.RandomState(7)
    frames = torch.from_numpy((rng.rand(16, 40, 48, 3) * 255).astype(np.uint8))
    va, vb = two_views(torch.Generator().manual_seed(8), frames, 32)
    views = {"view_a": va, "view_b": vb}
    loss, grads, stats = _train_step("cpu", torch.float64, views)
    got_loss, got_grads, got_stats = _train_step(cuda_device, torch.float64, views)
    assert abs(got_loss - loss) <= TRAIN_F64_TOL * abs(loss)
    for n, g in grads.items():
        assert np.abs(got_grads[n] - g).max() <= TRAIN_F64_TOL * np.abs(g).max(), n
    for n, b in stats.items():
        assert np.abs(got_stats[n] - b).max() <= TRAIN_F64_TOL, n
    f32_loss, f32_grads, _ = _train_step(cuda_device, torch.float32, views)
    num = sum(((f32_grads[n] - g) ** 2).sum() for n, g in grads.items())
    den = sum((g ** 2).sum() for g in grads.values())
    assert abs(f32_loss - loss) <= 1e-5 * abs(loss)
    assert (num / den) ** 0.5 <= 1e-2


@pytest.mark.parametrize("student,fg_type,qw", [("fg", "att", 0.0), ("fg", "bin", 0.1),
                                                ("cg", "att", 0.0)])
def test_train_distill_step_on_the_card_is_the_cpus(cuda_device, student, fg_type, qw):
    # 8 pairs of 3 frames (seed 21), seed 5's init: the loss within 1e-5
    # and every gradient within 1e-3 of its largest value (fg bin's
    # quantization term kinks at 0 and 1, where the two devices' codes may
    # round to either side).
    from vsc2022_torch.train import dns_distill

    rng = np.random.RandomState(21)
    batch = {"q_regions": rng.randn(8, 3, 9, 3840).astype(np.float32),
             "r_regions": rng.randn(8, 3, 9, 3840).astype(np.float32),
             "teacher_sim": rng.rand(8).astype(np.float32)}
    out = {}
    for dev in ("cpu", cuda_device):
        module = dns_distill.build_student_module(student, fg_type)
        state = dns_distill.create_distill_state(module, 1e-3, seed=5, device=dev)
        state, loss = dns_distill.make_distill_step(module, student, qw)(state, batch)
        out[str(dev)] = (float(loss), {n: p.grad.cpu().numpy()
                                       for n, p in module.named_parameters()})
    (loss, grads), (got_loss, got_grads) = out["cpu"], out[str(cuda_device)]
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    for n, g in grads.items():
        assert np.abs(got_grads[n] - g).max() <= 1e-3 * np.abs(g).max(), n


def test_train_cli_one_rank_a_card(cuda_device, tmp_path):
    # The training CLI with --device cuda on a machine with several cards
    # starts one rank a card (NCCL): its first loss equals one card's
    # (--device cuda:0) within 1e-4 relative (the same global batch; the
    # sums over ranks in another order), rank 0 writes the checkpoint with
    # one card's tree. SSCD (ResNet-50, 8 frames at 64 x 64) and fg bin
    # distillation. Needs two or more cards.
    import json
    import os
    import subprocess
    import sys

    from vsc2022_torch.utils.checkpoint import load_variables

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: one rank a card")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    batch = 2 * cards
    for flags in (["--synthetic", "16", "--image_size", "64"],
                  ["--objective", "dns_distill", "--student", "fg", "--fg_type", "bin",
                   "--synthetic", "16"]):
        runs = {}
        for device in ("cuda:0", "cuda"):
            out = str(tmp_path / f"{device.replace(':', '')}.npz")
            proc = subprocess.run(
                [sys.executable, "-m", "vsc2022_torch.train.cli", *flags, "--steps", "2",
                 "--batch_size", str(batch), "--checkpoint_out", out, "--device", device],
                cwd=repo, capture_output=True, text=True, timeout=900)
            assert proc.returncode == 0, proc.stderr[-4000:]
            line = [x for x in proc.stderr.splitlines() if " summary " in x][-1]
            runs[device] = (json.loads(line.split(" summary ", 1)[1]), load_variables(out))
        (one, one_tree), (pod, pod_tree) = runs["cuda:0"], runs["cuda"]
        assert one["ranks"] == 1 and pod["ranks"] == cards
        assert abs(pod["losses"][0] - one["losses"][0]) <= 1e-4 * abs(one["losses"][0])
        assert _tree_keys(pod_tree) == _tree_keys(one_tree)


def _tree_keys(tree, prefix=""):
    """The '/'-joined leaf paths of a nested dict, sorted."""
    keys = []
    for k, v in tree.items():
        keys += _tree_keys(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k]
    return sorted(keys)


# ---- the last entry points: serve's probe, adapt_model, the s2d stem --------------


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_f32_research_scores_as_the_f32_kernels(cuda_device):
    # The f32 re-search's fixed-shape cuBLAS calls (_f32_scores) sum each
    # score as the kernels' fmaf chain does, at the searchers' widths (D =
    # 512 and the score-normalized 513): its row max is row_max's, bit for
    # bit, on unit-norm floats; and any run of corpus rows scores alike.
    from vsc2022_torch.ops.similarity import _f32_scores

    rng = np.random.RandomState(23)
    for d in (512, 513):
        q = torch.from_numpy(_unit_rows(rng, 300, d)).to(cuda_device)
        r = torch.from_numpy(_unit_rows(rng, 40_000, d)).to(cuda_device)
        whole = _f32_scores(q, r, r.shape[0])
        assert torch.equal(whole.max(dim=1).values, kernels.row_max(q, r, r.shape[0]))
        part = _f32_scores(q, r[12_345:30_000], r.shape[0], 12_345)
        assert torch.equal(part, whole[:, 12_345:30_000])


def _probe_corpus(tmp_path):
    from vsc2022_torch.metrics import Dataset
    from vsc2022_torch.storage import store_features
    from vsc2022_torch.types import VideoFeature

    rng = np.random.RandomState(31)

    def videos(prefix, n, frames, offset=0):
        return [VideoFeature(f"{prefix}{offset + i:06d}", np.arange(frames, dtype=np.float64),
                             _unit_rows(rng, frames, 64)) for i in range(n)]

    refs, noise, queries = videos("R", 200, 40), videos("R", 50, 40, 1000), videos("Q", 8, 30)
    for i in range(4):  # planted copies
        queries[i].feature[5:20] = refs[3 * i].feature[10:25]
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("q", "r", "n")}
    store_features(paths["q"], queries, Dataset.QUERIES)
    store_features(paths["r"], refs, Dataset.REFS)
    store_features(paths["n"], noise, Dataset.REFS)
    return paths


@pytest.mark.parametrize("dtype_flag", ["--f32", None, "--int8"])
def test_probe_times_the_searchs_kernels_on_the_card(cuda_device, tmp_path, dtype_flag):
    from vsc2022_torch.retrieval import serve
    from vsc2022_torch.retrieval.candidates import MaxScoreAggregation

    p = _probe_corpus(tmp_path)
    args = serve.parser.parse_args(
        ["--ref_features", p["r"], "--score_norm_features", p["n"], "--matches"]
        + ([dtype_flag] if dtype_flag else []))
    index, refs, _ = serve.build_index(args, cuda_device)
    loc = serve.build_localizer(index, refs, args, cuda_device)
    kernels.reset_launches()
    serve.serve_request(index, MaxScoreAggregation(), loc,
                        f"{p['q']}\t{tmp_path}/c.csv\t{tmp_path}/m.csv", args)
    search_keys = {k for k, v in kernels.launches.items() if v}
    kernels.reset_launches()
    reply = serve.serve_request(index, MaxScoreAggregation(), loc, f"probe\t{p['q']}", args)
    tag, name, search_s, tn_s = reply.split("\t")
    assert (tag, name) == ("ok", "probe")
    assert 0 < float(search_s) < 1.0 and float(tn_s) > 0
    probe_keys = {k for k, v in kernels.launches.items() if v}
    assert probe_keys == search_keys and len(probe_keys) >= 3


def test_adapt_model_verify_on_the_card(cuda_device, tmp_path):
    from vsc2022_torch import convert
    from vsc2022_torch.baseline import adapt_model
    from vsc2022_torch.utils.checkpoint import load_variables

    model, _ = _extraction_models()["sscd"]
    ts = str(tmp_path / "sscd.pt")
    with torch.no_grad():
        torch.jit.save(torch.jit.trace(model.eval(), torch.zeros(1, 3, 64, 64)), ts)
    out = str(tmp_path / "sscd.npz")
    adapt_model.main(adapt_model.parser.parse_args(
        ["--input_torchscript", ts, "--output_checkpoint", out, "--verify",
         "--device", "cuda"]))
    want = convert.sscd_to_jax(model.state_dict())
    got = load_variables(out)
    assert _tree_keys(got) == _tree_keys(want)
    np.testing.assert_array_equal(got["params"]["backbone"]["conv1"]["kernel"],
                                  want["params"]["backbone"]["conv1"]["kernel"])


def test_s2d_stem_on_the_card(cuda_device):
    from vsc2022_torch.inference.pipeline import f32_numerics
    from vsc2022_torch.models.fold import s2d_stem
    from vsc2022_torch.models.sscd import SSCDModel

    model, _ = _extraction_models()["sscd"]
    s2d = SSCDModel(stem_s2d=True)
    s2d.load_state_dict(s2d_stem(model.state_dict()))
    x = torch.from_numpy(np.random.RandomState(4).randn(8, 3, 224, 224).astype(np.float32))
    x = x.to(cuda_device)
    with torch.no_grad(), f32_numerics(cuda_device):
        want = model.to(cuda_device).eval()(x)
        got = s2d.to(cuda_device).eval()(x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
