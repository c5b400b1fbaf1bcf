"""The port's hand kernels: plain versions against the JAX Pallas kernels
(run in interpret mode, as tests/test_pallas_kernels.py runs them). The
CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.

Tolerances: exact on randint(-3, 4) inputs (every product and sum is an
integer far below 2^24); atol=1e-5 on unit-norm random floats at D <= 64,
where XLA and torch sum the f32 products in different orders; for the
chamfer rtol=atol=1e-5 on unnormalized randn regions, as
tests/test_pallas_kernels.py holds the Pallas chamfer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc2022_torch.ops import kernels
from vsc2022_tpu.ops.pallas_kernels import (
    COL_TILE,
    POOL_COL_TILE,
    POOL_ROW_TILE,
    POOL_TILES_PER_BAND,
    ROW_TILE,
    chamfer_fine_sims,
    fused_count_above,
    fused_row_max,
    pool_writer,
    pool_writer_band,
)

SEG = 128


def _inputs(kind, m, n, d, seed):
    rng = np.random.RandomState(seed)
    if kind == "int":
        q = rng.randint(-3, 4, size=(m, d)).astype(np.float32)
        r = rng.randint(-3, 4, size=(n, d)).astype(np.float32)
    else:
        q = rng.randn(m, d).astype(np.float32)
        r = rng.randn(n, d).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        r /= np.linalg.norm(r, axis=1, keepdims=True)
    return q, r


def _check(got, expect, kind):
    if kind == "int":
        np.testing.assert_array_equal(got, expect)
    else:
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5)


def _jax_pool_per_segment(pv, pi):
    """JAX pool (band-major, tile t of a band at [ppt·t, ppt·t+ppt) as
    [m1 × ppt/2 | m2 × ppt/2]) → per-segment [M, N/128, 2]."""
    pv, pi = np.asarray(pv), np.asarray(pi)
    m = pv.shape[0]
    seg_per_tile = POOL_COL_TILE // SEG

    def norm(a):
        return a.reshape(m, -1, 2, seg_per_tile).transpose(0, 1, 3, 2).reshape(
            m, -1, 2
        )

    return norm(pv), norm(pi)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("n_valid_cut", [0, 50, 1024])
def test_row_max_plain_matches_pallas(kind, n_valid_cut):
    q, r = _inputs(kind, ROW_TILE, 2 * COL_TILE, 32, seed=1)
    n_valid = r.shape[0] - n_valid_cut
    expect = np.asarray(fused_row_max(
        jnp.asarray(q), jnp.asarray(r), jnp.int32(n_valid), interpret=True
    ))
    got = kernels.row_max(torch.from_numpy(q), torch.from_numpy(r), n_valid)
    _check(got.numpy(), expect, kind)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_count_above_plain_matches_pallas(kind):
    q, r = _inputs(kind, ROW_TILE, 2 * COL_TILE, 16, seed=2)
    n_valid = r.shape[0] - 100
    tau = 5.0 if kind == "int" else 0.3
    expect = np.asarray(fused_count_above(
        jnp.asarray(q), jnp.asarray(r), jnp.float32(tau), jnp.int32(n_valid),
        interpret=True,
    ))
    got = kernels.count_above(
        torch.from_numpy(q), torch.from_numpy(r), tau, n_valid
    )
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), expect)
    else:
        # A score within float noise of τ may count on one side only.
        assert np.abs(got.numpy() - expect).max() <= 1


def _pool_inputs(kind, seed):
    m, d = POOL_ROW_TILE, 16
    n = POOL_TILES_PER_BAND * POOL_COL_TILE
    q, r = _inputs(kind, m, n, d, seed)
    # Exact ties inside one segment: best-2 keeps both, lowest column first.
    if kind == "int":
        r[[5, 7, 40]] = 3.0
    else:
        r[[5, 40]] = r[7]
    q[3] = r[7]
    return q, r


@pytest.mark.parametrize("writer", ["pool_writer", "pool_writer_band"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_pool_writer_plain_matches_pallas(writer, kind):
    q, r = _pool_inputs(kind, seed=3)
    # 137 padding columns: the last segment is fully padded, the one
    # before it ragged.
    n_valid = r.shape[0] - 137
    fn = pool_writer if writer == "pool_writer" else pool_writer_band
    jv, ji = _jax_pool_per_segment(*fn(
        jnp.asarray(q), jnp.asarray(r), jnp.int32(n_valid), interpret=True
    ))
    pv, pi = kernels.pool_writer(
        torch.from_numpy(q), torch.from_numpy(r), n_valid
    )
    pv, pi = pv.numpy(), pi.numpy()
    assert pv.shape == jv.shape == (q.shape[0], r.shape[0] // SEG, 2)
    assert np.isneginf(pv[:, -1]).all() and np.isneginf(jv[:, -1]).all()
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(finite, np.isfinite(pv))
    if kind == "int":
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pi[finite], ji[finite])
        # The planted tie: columns 5 and 7 (and 40) tie at the top of
        # segment 0 for row 3; the lower two columns win.
        np.testing.assert_array_equal(pi[3, 0], [5, 7])
    else:
        np.testing.assert_allclose(pv[finite], jv[finite], rtol=0, atol=1e-5)
        scores = q @ r.T
        rows = np.broadcast_to(np.arange(q.shape[0])[:, None, None], pi.shape)
        np.testing.assert_allclose(
            scores[rows[finite], pi[finite]], pv[finite], rtol=0, atol=1e-5
        )
        # Where the two slots are clearly apart, the ids agree too.
        with np.errstate(invalid="ignore"):  # −inf − −inf in padded slots
            apart = finite & (np.abs(jv[..., :1] - jv[..., 1:]) > 1e-4)
        np.testing.assert_array_equal(pi[apart], ji[apart])


def test_pool_writer_plain_small_corpus_and_order():
    # A corpus smaller than one segment; values best-first per segment.
    q, r = _inputs("int", 7, SEG, 8, seed=4)
    pv, pi = kernels.pool_writer(torch.from_numpy(q), torch.from_numpy(r), 90)
    scores = q @ r[:90].T
    np.testing.assert_array_equal(pv[:, 0, 0].numpy(), scores.max(1))
    assert (pv[:, 0, 0] >= pv[:, 0, 1]).all()
    assert (pi.numpy() < 90).all()


@pytest.mark.parametrize("n_valid", [1, 100, 200, 256, 300, 384])
@pytest.mark.parametrize("d", [13, 16])
def test_bf16_pool_writer_plain_matches_pallas_default_precision(d, n_valid):
    # The pooled collection over a bf16 corpus: JAX's pool_writer with
    # precision="default" (one bf16 pass, f32 accumulation), one 128-column
    # tile per band step so that N = 384 holds 3 segments, an odd count.
    # n_valid 1, 100 and 200 lie inside the first 256-row corpus tile of the
    # tensor-core kernel, 300 inside the second, whose second segment is
    # past the pool. The port's bf16 pool (the plain version, and so the
    # wrapper on the CPU) equals it on the corpus as given and on
    # pad_columns' padded copy (D = 13: 3 zero columns), ids included.
    q, r = _inputs("int", 16, 384, d, seed=5 + d)
    r[[5, 7, 40, 300]] = 3.0  # ties inside segments 0 and 2
    q[3] = 3.0
    jv, ji = pool_writer(
        jnp.asarray(q), jnp.asarray(r), jnp.int32(n_valid), precision="default",
        interpret=True, row_tile=16, col_tile=SEG, tiles_per_band=3,
    )
    jv, ji = np.asarray(jv).reshape(16, 3, 2), np.asarray(ji).reshape(16, 3, 2)
    qb, rb = torch.from_numpy(q).bfloat16(), torch.from_numpy(r).bfloat16()
    assert kernels.pad_columns(rb).shape[1] == 16
    for refs in (rb, kernels.pad_columns(rb)):
        pv, pi = kernels.pool_writer(qb, refs, n_valid)
        np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_array_equal(pi.numpy(), ji)
    assert np.isneginf(jv[:, -(-n_valid // SEG):]).all()
    assert np.isfinite(jv[:, : -(-n_valid // SEG)]).any()
    if n_valid >= 41:
        np.testing.assert_array_equal(pi[3, 0].numpy(), [5, 7])


@pytest.mark.parametrize(
    "nq,nr,symmetric",
    [(64, 64, True), (32, 128, True), (128, 32, False), (32, 32, True)],
)
def test_chamfer_plain_matches_pallas(nq, nr, symmetric):
    # tests/test_pallas_kernels.py::TestChamferKernel's shapes and inputs.
    rng = np.random.RandomState(17)
    b, r, d = 3, 9, 32
    qf = rng.randn(b, nq, r, d).astype(np.float32)
    rf = rng.randn(b, nr, r, d).astype(np.float32)
    # Zero-pad frames, as the table gather produces past a video's end.
    qf[:, nq - 5:] = 0.0
    rf[:, nr - 3:] = 0.0
    expect = np.asarray(chamfer_fine_sims(
        jnp.asarray(qf), jnp.asarray(rf),
        symmetric=symmetric, precision="highest", interpret=True,
    ))
    got = kernels.chamfer_fine_sims(
        torch.from_numpy(qf), torch.from_numpy(rf), symmetric
    ).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    assert (got[:, nq - 5:] == 0).all() and (got[:, :, nr - 3:] == 0).all()
