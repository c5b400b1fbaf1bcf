"""The DnS fine similarity at precision "default" (the bf16 chamfer) against
the JAX package on the CPU, where the port's wrappers run their plain
versions (bf16 operands widened to f32: exact products, f32 sums).

- The kernel's function: the port's ``chamfer_fine_sims`` on bf16 tensors
  against JAX's ``chamfer_fine_sims(precision="default")``, the Pallas
  kernel's bf16 branch run in interpret mode. On integer inputs every
  region product and sum is exact on both sides, so the integer sums
  (9 x the result, 18 x when symmetric) are identical; the last step
  rounds apart (XLA multiplies by 1/9, the port divides by 9, as its f32
  kernel does), so the values agree within 1e-5, as on floats.
- The fused functions ``_chamfer_fuse`` and ``_fused_fine_coarse_sims``
  and the gathered ``_gathered_dns_sims``, at "default" and "highest",
  against JAX's. JAX on the CPU computes DEFAULT in f32, so JAX is fed
  the bf16-rounded values (the port rounds them itself); results within
  1e-5 (f32 sums in other orders).
- ``DnSLocalization`` stays at "highest": its sims are those of the
  explicit f32 gather and fuse, bit for bit.
- An unknown precision raises.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vsc2022_torch.baseline import dns_baseline as torch_dns
from vsc2022_torch.metrics import CandidatePair as TorchPair
from vsc2022_torch.ops import kernels
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu.baseline import dns_baseline as jax_dns
from vsc2022_tpu.ops.pallas_kernels import chamfer_fine_sims as jax_chamfer

R = 9
ATOL = 1e-5


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """f32 values of ``x`` rounded to bf16 (nearest even)."""
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _fine(rng, kind, b, n, d, pad):
    """[b, n, 9, d] region features, the last ``pad`` frames zero (the
    table gather's pad row past a video's end)."""
    if kind == "int":
        x = rng.randint(-3, 4, size=(b, n, R, d)).astype(np.float32)
    else:
        x = rng.randn(b, n, R, d).astype(np.float32)
        x /= np.linalg.norm(x, axis=3, keepdims=True)
    x[:, n - pad:] = 0.0
    return x


# ---- the kernel's function -----------------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("b,nq,nr,d", [(2, 32, 64, 16), (3, 64, 32, 32), (2, 48, 40, 24)])
def test_bf16_chamfer_matches_pallas_bf16_branch(kind, symmetric, b, nq, nr, d):
    rng = np.random.RandomState(11 + d)
    qf, rf = _fine(rng, kind, b, nq, d, 5), _fine(rng, kind, b, nr, d, 3)
    want = np.asarray(jax_chamfer(
        jnp.asarray(qf), jnp.asarray(rf), symmetric=symmetric,
        precision="default", interpret=True,
    ))
    got = kernels.chamfer_fine_sims(
        torch.from_numpy(qf).bfloat16(), torch.from_numpy(rf).bfloat16(), symmetric
    )
    assert got.dtype == torch.float32 and got.shape == (b, nq, nr)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if kind == "int":
        scale = 18 if symmetric else 9
        np.testing.assert_array_equal(np.rint(got * scale), np.rint(want * scale))
    assert (got[:, nq - 5:] == 0).all() and (got[:, :, nr - 3:] == 0).all()


def test_bf16_chamfer_plain_is_the_f32_chamfer_of_the_widened_values():
    kernels.reset_launches()
    rng = np.random.RandomState(5)
    qf = torch.from_numpy(_fine(rng, "float", 2, 33, 16, 4)).bfloat16()
    rf = torch.from_numpy(_fine(rng, "float", 2, 17, 16, 2)).bfloat16()
    for symmetric in (True, False):
        got = kernels.chamfer_fine_sims(qf, rf, symmetric)
        assert torch.equal(got, kernels.chamfer_fine_sims_plain(qf, rf, symmetric))
        assert torch.equal(got, kernels.chamfer_fine_sims(qf.float(), rf.float(), symmetric))
    assert kernels.launches[kernels.CHAMFER_BF16] == 0  # the plain version ran


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float64, torch.float64), (torch.float16, torch.float16),
])
def test_chamfer_wrapper_takes_one_dtype_f32_or_bf16(dtypes):
    fine = torch.ones((1, 4, R, 8))
    with pytest.raises(TypeError, match="share a dtype"):
        kernels.chamfer_fine_sims(fine.to(dtypes[0]), fine.to(dtypes[1]))


# ---- the fused functions -------------------------------------------------------


def _fuse_case(seed, b=2, nq=32, nr=64, d=16, dc=24):
    rng = np.random.RandomState(seed)
    qf, rf = _fine(rng, "float", b, nq, d, 4), _fine(rng, "float", b, nr, d, 6)
    qc = rng.randn(b, nq, dc).astype(np.float32) / np.sqrt(dc)
    rc = rng.randn(b, nr, dc).astype(np.float32) / np.sqrt(dc)
    return qf, rf, qc, rc


@pytest.mark.parametrize("symmetric", [True, False])
def test_chamfer_fuse_default_matches_jax_pallas_bf16_branch(monkeypatch, symmetric):
    qf, rf, qc, rc = _fuse_case(23)
    monkeypatch.setenv("VSC2022_TPU_CHAMFER_PALLAS", "interpret")
    want = np.asarray(jax_dns._chamfer_fuse(
        *(jnp.asarray(_bf16_values(x)) for x in (qf, rf, qc, rc)),
        jnp.float32(0.5), symmetric, jax.lax.Precision.DEFAULT,
    ))
    got = torch_dns._chamfer_fuse(
        *(torch.from_numpy(x) for x in (qf, rf, qc, rc)), 0.5, symmetric, "default"
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # The port rounds its operands itself: already-rounded ones give the
    # same sims, bit for bit.
    again = torch_dns._chamfer_fuse(
        *(torch.from_numpy(_bf16_values(x)) for x in (qf, rf, qc, rc)), 0.5,
        symmetric, "default",
    )
    assert torch.equal(got, again)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_fused_fine_coarse_sims_match_jax(symmetric, precision):
    qf, rf, qc, rc = _fuse_case(29, nq=40, nr=24)
    rounded = (_bf16_values if precision == "default" else np.asarray)
    want = np.asarray(jax_dns._fused_fine_coarse_sims(
        *(jnp.asarray(rounded(x)) for x in (qf, rf, qc, rc)), jnp.float32(0.5),
        symmetric=symmetric, precision=precision,
    ))
    got = torch_dns._fused_fine_coarse_sims(
        *(torch.from_numpy(x) for x in (qf, rf, qc, rc)), 0.5,
        symmetric=symmetric, precision=precision,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_default_is_the_highest_sims_of_the_rounded_operands():
    # What "default" changes is the operands' rounding and nothing else:
    # exact bf16 products, f32 sums.
    qf, rf, qc, rc = _fuse_case(31)
    got = torch_dns._fused_fine_coarse_sims(
        *(torch.from_numpy(x) for x in (qf, rf, qc, rc)), 0.5, precision="default"
    )
    want = torch_dns._fused_fine_coarse_sims(
        *(torch.from_numpy(_bf16_values(x)) for x in (qf, rf, qc, rc)), 0.5,
        precision="highest",
    )
    assert torch.equal(got, want)
    highest = torch_dns._fused_fine_coarse_sims(
        *(torch.from_numpy(x) for x in (qf, rf, qc, rc)), 0.5, precision="highest"
    )
    assert not torch.equal(got, highest)


# ---- the gathered function -----------------------------------------------------


def _tables(seed, d=16, dc=24, tq=90, tr=140):
    """Query and ref tables (row 0 the zero pad row) and the index
    matrices of 3 pairs of 32 query by 64 ref frames, pad rows past each
    video's end."""
    rng = np.random.RandomState(seed)

    def table(n, width, norm):
        t = rng.randn(1 + n, width).astype(np.float32) / np.sqrt(norm)
        t[0] = 0.0
        return t

    tabs = {"qc": table(tq, dc, dc), "rc": table(tr, dc, dc),
            "qf": table(tq, R * d, d), "rf": table(tr, R * d, d)}
    idx = {}
    for side, total, n, lengths in (("q", tq, 32, (32, 20, 7)), ("r", tr, 64, (64, 41, 3))):
        rows = np.zeros((3, n), dtype=np.int64)
        for i, length in enumerate(lengths):
            start = 1 + rng.randint(0, total - length)
            rows[i, :length] = np.arange(start, start + length)
        idx[side] = rows
    return tabs, idx


def _jax_gathered(tabs, idx, symmetric, precision, ref_dtype):
    return np.asarray(jax_dns._gathered_dns_sims(
        jnp.asarray(tabs["qc"]), jnp.asarray(tabs["rc"], dtype=ref_dtype),
        jnp.asarray(tabs["qf"]), jnp.asarray(tabs["rf"], dtype=ref_dtype),
        jnp.asarray(idx["q"]), jnp.asarray(idx["r"]),
        jnp.asarray(idx["q"]), jnp.asarray(idx["r"]),
        jnp.float32(0.5), symmetric=symmetric, precision=precision,
    ))


def _torch_gathered(tabs, idx, symmetric, precision, ref_dtype):
    t = {k: torch.from_numpy(v) for k, v in tabs.items()}
    t["rc"], t["rf"] = t["rc"].to(ref_dtype), t["rf"].to(ref_dtype)
    return torch_dns._gathered_dns_sims(
        t["qc"], t["rc"], t["qf"], t["rf"], idx["q"], idx["r"], idx["q"], idx["r"],
        0.5, symmetric=symmetric, precision=precision,
    )


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("ref_tables", ["float32", "bfloat16"])
def test_gathered_dns_sims_match_jax(symmetric, precision, ref_tables):
    tabs, idx = _tables(37)
    got = _torch_gathered(tabs, idx, symmetric, precision, getattr(torch, ref_tables))
    if precision == "default":  # JAX on the CPU computes DEFAULT in f32
        tabs = {k: _bf16_values(v) for k, v in tabs.items()}
    jax_ref = jnp.bfloat16 if ref_tables == "bfloat16" else jnp.float32
    want = _jax_gathered(tabs, idx, symmetric, precision, jax_ref)
    assert got.shape == want.shape == (3, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # Pad frames of either side: zero fine similarity, so sqrt(0.5 * cg).
    assert torch.isfinite(got).all()


def test_gathered_default_hands_bf16_rows_to_the_chamfer(monkeypatch):
    seen = []
    chamfer = kernels.chamfer_fine_sims

    def spy(qf, rf, symmetric=True):
        seen.append((qf.dtype, rf.dtype, tuple(qf.shape), tuple(rf.shape)))
        return chamfer(qf, rf, symmetric)

    monkeypatch.setattr(kernels, "chamfer_fine_sims", spy)
    tabs, idx = _tables(41)
    for precision in ("default", "highest"):
        for ref in (torch.float32, torch.bfloat16):
            _torch_gathered(tabs, idx, True, precision, ref)
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = ((3, 32, R, 16), (3, 64, R, 16))
    assert seen == [(bf16, bf16, *shapes)] * 2 + [(f32, f32, *shapes)] * 2


# ---- DnSLocalization stays at "highest" ---------------------------------------


def _video(rng, prefix, i, n, width):
    x = rng.randn(n, width).astype(np.float32)
    return TVF(f"{prefix}{i:06d}", np.arange(n, dtype=np.float64), x / np.sqrt(width))


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_dns_localization_sims_unchanged_at_highest(monkeypatch, table_dtype):
    rng = np.random.RandomState(43)
    d, dc = 16, 24
    q_fine = {v.video_id: v for v in (_video(rng, "Q", i, n, R * d)
                                      for i, n in enumerate((30, 17)))}
    r_fine = {v.video_id: v for v in (_video(rng, "R", i, n, R * d)
                                      for i, n in enumerate((26, 32, 9)))}
    q_coarse = [_video(rng, "Q", i, n, dc) for i, n in enumerate((30, 17))]
    r_coarse = [_video(rng, "R", i, n, dc) for i, n in enumerate((26, 32, 9))]
    pairs = [TorchPair(q, r, 1.0) for q in q_fine for r in r_fine]

    def localizer():
        return torch_dns.DnSLocalization(
            q_fine, r_fine, q_coarse, r_coarse, model_type="TN", tn_max_step=5,
            min_length=4, similarity_bias=0.5, table_dtype=table_dtype, device="cpu",
        )

    got = localizer()._batch_sims(pairs, 32, 32)

    def explicit(qc_tab, rc_tab, qf_tab, rf_tab, qc_idx, rc_idx, qf_idx, rf_idx,
                 bias, symmetric=True, device=None):
        # The f32 gather and fuse DnSLocalization ran before "default" was
        # ported: the rows widened to f32, the f32 chamfer (on the device
        # the batch is gathered onto).
        loc = localizer()
        qc, rc, qf, rf = (loc._gather(t, i, device) for t, i in (
            (qc_tab, qc_idx), (rc_tab, rc_idx), (qf_tab, qf_idx), (rf_tab, rf_idx)))
        b, nq, nr = qc.shape[0], qc.shape[1], rc.shape[1]
        return torch_dns._chamfer_fuse(
            qf.view(b, nq, R, -1), rf.view(b, nr, R, -1), qc, rc, bias, symmetric
        )

    monkeypatch.setattr(torch_dns, "_gathered_dns_sims", explicit)
    want = localizer()._batch_sims(pairs, 32, 32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == (len(pairs), 32, 32)


# ---- precisions that are not ported -------------------------------------------


@pytest.mark.parametrize("precision", ["high", "float32"])
def test_unknown_precision_raises(precision):
    qf, rf, qc, rc = (torch.from_numpy(x) for x in _fuse_case(47, nq=8, nr=8))
    with pytest.raises(NotImplementedError, match=repr(precision)):
        torch_dns._chamfer_fuse(qf, rf, qc, rc, 0.5, True, precision)
    with pytest.raises(NotImplementedError, match=repr(precision)):
        torch_dns._fused_fine_coarse_sims(qf, rf, qc, rc, 0.5, precision=precision)
    tabs, idx = _tables(47)
    with pytest.raises(NotImplementedError, match=repr(precision)):
        _torch_gathered(tabs, idx, True, precision, torch.float32)
