"""The port's two-view augmentation (``vsc2022_torch.train.augment``)
against the JAX package's ``two_views``, on the CPU.

``jax.random`` cannot be reproduced in torch, so the test recomputes the
draws JAX's ``two_views`` takes from a key (the same ``split`` /
``uniform`` / ``randint`` / ``bernoulli`` calls, in its order) and feeds
them to the port's pure ``augment``: the views must equal JAX's within
4e-6 (the per-view mean sums in another order; values reach ~2.6 after
ImageNet normalization). The port's own draws come from a
``torch.Generator``: their ranges, determinism and the data-parallel
slicing are held here too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vsc2022_torch.train.augment import ViewDraws, augment, draw_views, two_views
from vsc2022_tpu.train.augment import two_views as jax_two_views

ATOL = 4e-6


def jax_draws(key, b, h, w):
    """The draws JAX's two_views takes from ``key`` for each view, as
    ViewDraws (augment.py: split into k_a, k_b; each into b keys; each
    into crop, flip, brightness, contrast; crop into scale, x, y)."""
    views = []
    for k_view in jax.random.split(key):
        cols = {f: [] for f in ViewDraws._fields}
        for k in jax.random.split(k_view, b):
            k_crop, k_flip, k_bright, k_contrast = jax.random.split(k, 4)
            k_scale, k_x, k_y = jax.random.split(k_crop, 3)
            cols["scale"].append(jax.random.uniform(k_scale, (), minval=0.55, maxval=1.0))
            cols["top"].append(jax.random.randint(k_y, (), 0, h))
            cols["left"].append(jax.random.randint(k_x, (), 0, w))
            cols["flip"].append(jax.random.bernoulli(k_flip))
            cols["brightness"].append(jax.random.uniform(k_bright, (), minval=0.7, maxval=1.3))
            cols["contrast"].append(jax.random.uniform(k_contrast, (), minval=0.7, maxval=1.3))
        views.append(ViewDraws(
            scale=torch.from_numpy(np.array(cols["scale"], np.float32)),
            top=torch.from_numpy(np.array(cols["top"], np.int64)),
            left=torch.from_numpy(np.array(cols["left"], np.int64)),
            flip=torch.from_numpy(np.array(cols["flip"], bool)),
            brightness=torch.from_numpy(np.array(cols["brightness"], np.float32)),
            contrast=torch.from_numpy(np.array(cols["contrast"], np.float32))))
    return views


# (seed, (B, H, W), out_hw): JAX's test shapes (48 x 64 → 32, 40 x 40 → 24),
# odd sides, and a crop smaller than the output (sampled up).
CASES = [(0, (4, 48, 64), 32), (7, (2, 40, 40), 24), (3, (5, 37, 53), 29),
         (12, (3, 16, 20), 24), (5, (6, 64, 48), 17)]


@pytest.mark.parametrize("seed,shape,out_hw", CASES)
def test_augment_matches_jax_on_its_draws(seed, shape, out_hw):
    b, h, w = shape
    rng = np.random.RandomState(seed)
    frames = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    ja, jb = jax_two_views(jax.random.PRNGKey(seed), jnp.asarray(frames), out_hw=out_hw)
    da, db = jax_draws(jax.random.PRNGKey(seed), b, h, w)
    for draws, want in ((da, ja), (db, jb)):
        got = augment(torch.from_numpy(frames), draws, out_hw)
        assert got.shape == (b, 3, out_hw, out_hw) and got.dtype == torch.float32
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_jax_draws_cover_both_flips():
    """The cases above see flipped and unflipped views (the flip is held)."""
    flips = [bool(f) for seed, (b, h, w), _ in CASES
             for d in jax_draws(jax.random.PRNGKey(seed), b, h, w) for f in d.flip]
    assert any(flips) and not all(flips)


def test_draws_lie_in_their_ranges():
    g = torch.Generator().manual_seed(0)
    d = draw_views(g, 4096, 37, 53)
    assert d.scale.dtype == torch.float32 and d.brightness.dtype == torch.float32
    assert 0.55 <= float(d.scale.min()) and float(d.scale.max()) < 1.0
    for x in (d.brightness, d.contrast):
        assert 0.7 <= float(x.min()) and float(x.max()) < 1.3
    assert 0 <= int(d.top.min()) and int(d.top.max()) < 37
    assert 0 <= int(d.left.min()) and int(d.left.max()) < 53
    assert 0.45 < float(d.flip.float().mean()) < 0.55
    # The interval is covered, not a corner of it.
    assert float(d.scale.min()) < 0.56 and float(d.scale.max()) > 0.99


def test_two_views_are_deterministic_given_the_seed():
    rng = np.random.RandomState(1)
    frames = torch.from_numpy((rng.rand(3, 40, 40, 3) * 255).astype(np.uint8))
    a1, b1 = two_views(torch.Generator().manual_seed(7), frames, out_hw=24)
    a2, b2 = two_views(torch.Generator().manual_seed(7), frames, out_hw=24)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, b1)
    assert torch.isfinite(a1).all() and a1.shape == (3, 3, 24, 24)
    # View A's draws, then view B's, from the one generator.
    g = torch.Generator().manual_seed(7)
    da, db = draw_views(g, 3, 40, 40), draw_views(g, 3, 40, 40)
    assert torch.equal(augment(frames, da, 24), a1) and torch.equal(augment(frames, db, 24), b1)


def test_a_ranks_slice_of_the_draws_gives_its_rows():
    """Data parallel: rank r's frames with draws.rows(...) are rows of the
    global batch's views."""
    rng = np.random.RandomState(2)
    frames = torch.from_numpy((rng.rand(6, 30, 34, 3) * 255).astype(np.uint8))
    d = draw_views(torch.Generator().manual_seed(3), 6, 30, 34)
    whole = augment(frames, d, 20)
    for lo, hi in ((0, 3), (3, 6), (2, 5)):
        assert torch.equal(augment(frames[lo:hi], d.rows(lo, hi), 20), whole[lo:hi])
