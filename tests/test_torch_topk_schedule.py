"""The launch plan of the fused_topk kernel and the merge of its pieces,
checked on the CPU (no nvcc, no card).

``ops/csrc/fused_topk.cu`` runs on the persistent schedule of
``reduce_gemm.cuh`` (``kernels.reduce_schedule``): block b folds the
winners of its items into one κ-set per row, and writes its piece of row
tile rt into slot b − ``topk_first_block(rt · col_tiles)`` of an
[M, S, κ] output (S = ``kernels.topk_pieces``); ``ordered_topk`` merges
the pieces. Here a CPU emulation builds the same pieces from
``pool_writer_plain`` over each block's items and merges them: the result
must be ``fused_topk_plain``'s, and the JAX Pallas ``fused_topk``'s (in
interpret mode) on distinct integer scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc2022_torch.ops import kernels
from vsc2022_tpu.ops.pallas_kernels import fused_topk as jax_fused_topk

# (query rows, valid ref columns): the serving, one-video and DnS calls,
# then ragged shapes.
SHAPES = [(9000, 240_000), (60, 240_000), (7682, 31_004), (1, 1), (1, 129),
          (129, 129), (300, 1000), (65, 1337), (2000, 128)]
# A few blocks, odd counts, and one wave of 1, 2 or 4 blocks per SM on an
# H100's 132 SMs.
SLOTS = [1, 7, 132, 264, 528]
INT_MAX = 2**31 - 1


def _slots_of(m, n_valid, grid):
    """{block: [(item, row tile, slot), ...]} as the kernel assigns them."""
    _, col_tiles = kernels.reduce_tiles(m, n_valid)
    ranges = kernels.reduce_schedule(m, n_valid, grid)
    items = ranges[-1][1]
    out = {}
    for b, (begin, end) in enumerate(ranges):
        out[b] = [(x, x // col_tiles,
                   b - kernels.topk_first_block(x // col_tiles * col_tiles, items, grid))
                  for x in range(begin, end)]
    return out


@pytest.mark.parametrize("m,n_valid", SHAPES)
def test_every_item_has_one_block_and_slot(m, n_valid):
    row_tiles, col_tiles = kernels.reduce_tiles(m, n_valid)
    items = row_tiles * col_tiles
    for slots in SLOTS:
        grid = kernels.reduce_grid(m, n_valid, slots)
        pieces = kernels.topk_pieces(m, n_valid, grid)
        owner = {}
        blocks_of_tile = {}
        for b, its in _slots_of(m, n_valid, grid).items():
            for x, rt, slot in its:
                # The block holding an item is the one the kernel computes.
                assert kernels.topk_first_block(x, items, grid) == b
                assert 0 <= slot < pieces
                assert x not in owner
                owner[x] = (b, slot)
                blocks_of_tile.setdefault(rt, {}).setdefault(slot, set()).add(b)
        assert sorted(owner) == list(range(items))
        # Distinct blocks of one row tile take distinct slots, and S is
        # the most blocks any row tile has.
        for rt, by_slot in blocks_of_tile.items():
            assert all(len(bs) == 1 for bs in by_slot.values())
        assert pieces == max(len(v) for v in blocks_of_tile.values())


def test_pieces_at_the_path_shapes():
    # One wave of 132 blocks: the serving call (71 row tiles) gives each
    # row tile two or three blocks; one video's single row tile is split
    # among all 132.
    assert kernels.topk_pieces(9000, 240_000, 132) == 3
    assert kernels.topk_pieces(60, 240_000, 132) == 132
    assert kernels.topk_pieces(7682, 31_004, 132) == 4
    assert kernels.topk_pieces(1, 1, 1) == 1
    assert kernels.topk_pieces(100, 0, 0) == 1


@pytest.mark.parametrize("m,n_valid,kappa,limit", [
    (9000, 240_000, 32, 1 << 30),   # fits: the one-wave grid stays
    (9000, 240_000, 1500, 1 << 28),  # shrinks to S = 2
    (60, 240_000, 1500, 1 << 22),    # one row tile: shrinks until S fits
    (300, 1000, 64, 1),              # nothing fits: down to one block
])
def test_grid_shrinks_under_the_scratch_ceiling(monkeypatch, m, n_valid, kappa, limit):
    monkeypatch.setattr(kernels, "TOPK_SCRATCH_BYTES", limit)
    start = kernels.reduce_grid(m, n_valid, 132)
    grid, pieces = kernels.topk_grid(m, n_valid, kappa, start)
    assert 1 <= grid <= start
    assert pieces == kernels.topk_pieces(m, n_valid, grid)
    assert 8 * m * pieces * kappa <= limit or grid == 1
    # The largest grid that fits: every larger one (up to one wave) overflows.
    for g in range(grid + 1, start + 1):
        assert 8 * m * kernels.topk_pieces(m, n_valid, g) * kappa > limit


def _emulate(q, r, n_valid, kappa, grid):
    """The kernel's [M, S, κ] pieces, from pool_writer_plain's winners over
    each block's items, then ordered_topk over [M, S·κ]."""
    m = q.shape[0]
    n = r.shape[0]
    n_seg = -(-n // kernels.SEG_LANES)
    rp = torch.zeros((n_seg * kernels.SEG_LANES, r.shape[1]))
    rp[:n] = r
    pv, pi = kernels.pool_writer_plain(q, rp, n_valid)
    pieces = kernels.topk_pieces(m, n_valid, grid)
    out_v = torch.full((m, pieces, kappa), float("-inf"))
    out_i = torch.full((m, pieces, kappa), INT_MAX, dtype=torch.int32)
    tile = kernels.REDUCE_TILE
    _, col_tiles = kernels.reduce_tiles(m, n_valid)
    runs = {}
    for b, its in _slots_of(m, n_valid, grid).items():
        for x, rt, slot in its:
            runs.setdefault((b, rt, slot), []).append(x % col_tiles)
    for (_, rt, slot), cts in runs.items():
        rows = slice(rt * tile, min((rt + 1) * tile, m))
        v = pv[rows, cts[0]:cts[-1] + 1].reshape(pv[rows].shape[0], -1)
        i = pi[rows, cts[0]:cts[-1] + 1].reshape(v.shape)
        # The kernel's κ-set: the κ best finite winners, unfilled slots
        # at (-inf, INT_MAX).
        sv, si = kernels.ordered_topk(v, i, kappa)
        out_v[rows, slot] = sv
        out_i[rows, slot] = torch.where(torch.isfinite(sv), si, INT_MAX)
    return kernels.ordered_topk(out_v.view(m, -1), out_i.view(m, -1), kappa)


def _tied_ints(m, n, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, size=(m, d)).astype(np.float32)
    r = rng.randint(-3, 4, size=(n, d)).astype(np.float32)
    r[[j for j in (5, 7, 40, 300, 301, 1500) if j < n]] = 3.0  # ties in and across segments
    q[0] = 3.0
    return torch.from_numpy(q), torch.from_numpy(r)


@pytest.mark.parametrize("m", [1, 60, 129, 300])
@pytest.mark.parametrize("slots", [1, 7, 132])
def test_emulated_pieces_merge_to_the_plain_version(m, slots):
    n, n_valid = 2000, 1990
    q, r = _tied_ints(m, n, 12, seed=m)
    grid = kernels.reduce_grid(m, n_valid, slots)
    for kappa in (1, 5, 32, 100):  # 100: more than some pieces' winners
        got_v, got_i = _emulate(q, r, n_valid, kappa, grid)
        want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("m", [1, 60, 129, 300])
def test_emulated_pieces_identical_to_jax_on_distinct_scores(m):
    # One-hot queries against permuted-integer columns: every score of a
    # row is a distinct integer, so the candidate set, its order and the
    # ids are fully determined on both sides.
    n, n_valid, d, kappa = 1500, 1450, 8, 24
    rng = np.random.RandomState(m)
    q = np.zeros((m, d), np.float32)
    q[np.arange(m), np.arange(m) % d] = 1.0
    r = np.stack([rng.permutation(n) for _ in range(d)], axis=1).astype(np.float32)
    es, ei = jax_fused_topk(jnp.asarray(q), jnp.asarray(r), jnp.int32(n_valid),
                            kappa, interpret=True)
    es, ei = np.asarray(es), np.asarray(ei)
    finite = np.isfinite(es)
    for slots in (7, 132):
        grid = kernels.reduce_grid(m, n_valid, slots)
        gs, gi = _emulate(torch.from_numpy(q), torch.from_numpy(r), n_valid, kappa, grid)
        np.testing.assert_array_equal(gs.numpy(), es)
        np.testing.assert_array_equal(gi.numpy()[finite], ei[finite])
        assert (gi.numpy()[~finite] == 0).all()
