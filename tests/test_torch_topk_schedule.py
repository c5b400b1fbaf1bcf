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
interpret mode) on distinct integer scores. The same holds for the bf16
variant's pieces on the tensor-core plan (``kernels.wgmma_pieces``).
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


# ---- fused_topk.bf16: the pieces of the tensor-core plan (wgmma_gemm.cuh) ----
#
# Items are numbered group major, then corpus tile (256 rows: two pool
# segments), then query tile (``kernels.wgmma_item``); block b walks
# ``block_ranges`` and writes its κ-sets of a group's rows into slot
# b − ``topk_first_block(first item of the group)``; S =
# ``kernels.wgmma_pieces``. Both placements of the sets (the output, groups
# of WGMMA_GROUP; shared memory, groups of WGMMA_SMEM_SETS_GROUP) share it.

GROUPS = [kernels.WGMMA_GROUP, kernels.WGMMA_SMEM_SETS_GROUP]


def _wgmma_slots_of(m, n_valid, grid, group):
    """{block: [(item, group, query tile, corpus tile, slot), ...]} as the
    kernel assigns them."""
    q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
    items = q_tiles * c_tiles
    out = {}
    for b, (begin, end) in enumerate(kernels.block_ranges(items, grid)):
        x = np.arange(begin, end)
        g, qt, ct = kernels.wgmma_item(x, m, n_valid, group)
        first = [kernels.topk_first_block(int(gg) * c_tiles * group, items, grid)
                 for gg in g]
        out[b] = list(zip(x.tolist(), g.tolist(), qt.tolist(), ct.tolist(),
                          (b - np.array(first, dtype=np.int64)).tolist()))
    return out


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m,n_valid", SHAPES)
def test_wgmma_every_item_has_one_block_and_slot(m, n_valid, group):
    q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
    items = q_tiles * c_tiles
    for slots in SLOTS:
        grid = kernels.wgmma_grid(m, n_valid, slots)
        pieces = kernels.wgmma_pieces(m, n_valid, grid, group)
        owner, blocks_of_group = {}, {}
        for b, its in _wgmma_slots_of(m, n_valid, grid, group).items():
            for x, g, qt, ct, slot in its:
                assert kernels.topk_first_block(x, items, grid) == b
                assert 0 <= slot < pieces
                assert (qt, ct) not in owner
                owner[(qt, ct)] = (b, slot)
                blocks_of_group.setdefault(g, {}).setdefault(slot, set()).add(b)
        # Every (query tile, corpus tile) in exactly one block's piece.
        assert sorted(owner) == [(t, c) for t in range(q_tiles) for c in range(c_tiles)]
        # Distinct blocks of one group take distinct slots, and S is the
        # most blocks any group has.
        for by_slot in blocks_of_group.values():
            assert all(len(bs) == 1 for bs in by_slot.values())
        assert pieces == max(len(v) for v in blocks_of_group.values())


def test_wgmma_pieces_at_the_path_shapes():
    # One wave of 132 blocks. Serving: 71 query tiles in 9 groups of 8 over
    # 938 corpus tiles, about 15 blocks a group; DnS: 61 tiles in 8 groups
    # over 122; one video's single query tile is split among all 132. The
    # shared-memory sets' groups of 2 hold a quarter of the items, so fewer blocks.
    assert kernels.wgmma_pieces(9000, 240_000, 132) == 16
    assert kernels.wgmma_pieces(7682, 31_004, 132) == 19
    assert kernels.wgmma_pieces(60, 240_000, 132) == 132
    assert kernels.wgmma_pieces(9000, 240_000, 132, 2) == 5
    assert kernels.wgmma_pieces(7682, 31_004, 132, 2) == 6
    assert kernels.wgmma_pieces(1, 1, 1) == 1
    assert kernels.wgmma_pieces(100, 0, 0) == 1
    # The serving output at κ = 32: 36.9 MB, far under the ceiling.
    assert kernels.wgmma_topk_grid(9000, 240_000, 32, 132) == (132, 16)


def test_wgmma_grid_shrinks_under_the_scratch_ceiling(monkeypatch):
    monkeypatch.setattr(kernels, "TOPK_SCRATCH_BYTES", 1 << 22)
    m, n_valid, kappa = 60, 240_000, 1500
    grid, pieces = kernels.wgmma_topk_grid(m, n_valid, kappa, 132)
    assert pieces == kernels.wgmma_pieces(m, n_valid, grid)
    assert 8 * m * pieces * kappa <= 1 << 22 < 8 * m * kernels.wgmma_pieces(
        m, n_valid, grid + 1) * kappa


def _emulate_wgmma(q, r, n_valid, kappa, grid, group):
    """The bf16 kernel's [M, S, κ] pieces, from pool_writer_plain's winners
    over each block's items (a corpus tile's two segments), then
    ordered_topk over [M, S·κ]."""
    m = q.shape[0]
    q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
    rp = torch.zeros((max(c_tiles, 1) * kernels.WGMMA_COLS, r.shape[1]))
    rp[: r.shape[0]] = r[: rp.shape[0]]
    pv, pi = kernels.pool_writer_plain(q, rp, n_valid)
    pieces = kernels.wgmma_pieces(m, n_valid, grid, group)
    out_v = torch.full((m, pieces, kappa), float("-inf"))
    out_i = torch.full((m, pieces, kappa), INT_MAX, dtype=torch.int32)
    runs = {}
    for its in _wgmma_slots_of(m, n_valid, grid, group).values():
        for _, _, qt, ct, slot in its:
            runs.setdefault((qt, slot), []).append(ct)
    for (qt, slot), cts in runs.items():
        rows = slice(qt * kernels.WGMMA_ROWS, min((qt + 1) * kernels.WGMMA_ROWS, m))
        segs = [2 * c + h for c in sorted(cts) for h in (0, 1)]
        v = pv[rows][:, segs].reshape(pv[rows].shape[0], -1)
        i = pi[rows][:, segs].reshape(v.shape)
        sv, si = kernels.ordered_topk(v, i, kappa)
        out_v[rows, slot] = sv
        out_i[rows, slot] = torch.where(torch.isfinite(sv), si, INT_MAX)
    return kernels.ordered_topk(out_v.view(m, -1), out_i.view(m, -1), kappa)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", [1, 60, 129, 1100])  # 1100: two groups of 8 tiles
@pytest.mark.parametrize("slots", [1, 7, 132])
def test_wgmma_emulated_pieces_merge_to_the_plain_version(m, slots, group):
    n, n_valid = 2000, 1990
    q, r = _tied_ints(m, n, 12, seed=m)
    grid = kernels.wgmma_grid(m, n_valid, slots)
    for kappa in (1, 5, 32, 100):  # 100: more than some pieces' winners
        got_v, got_i = _emulate_wgmma(q, r, n_valid, kappa, grid, group)
        want_v, want_i = kernels.fused_topk_plain(q, r, n_valid, kappa)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("m", [1, 60, 129, 300])
def test_wgmma_emulated_pieces_identical_to_jax_on_distinct_scores(m):
    n, n_valid, d, kappa = 1500, 1450, 8, 24
    rng = np.random.RandomState(100 + m)
    q = np.zeros((m, d), np.float32)
    q[np.arange(m), np.arange(m) % d] = 1.0
    r = np.stack([rng.permutation(n) for _ in range(d)], axis=1).astype(np.float32)
    es, ei = jax_fused_topk(jnp.asarray(q), jnp.asarray(r), jnp.int32(n_valid),
                            kappa, interpret=True)
    es, ei = np.asarray(es), np.asarray(ei)
    finite = np.isfinite(es)
    for slots, group in ((7, kernels.WGMMA_GROUP), (132, kernels.WGMMA_GROUP),
                         (7, kernels.WGMMA_SMEM_SETS_GROUP)):
        grid = kernels.wgmma_grid(m, n_valid, slots)
        gs, gi = _emulate_wgmma(torch.from_numpy(q), torch.from_numpy(r), n_valid,
                                kappa, grid, group)
        np.testing.assert_array_equal(gs.numpy(), es)
        np.testing.assert_array_equal(gi.numpy()[finite], ei[finite])
        assert (gi.numpy()[~finite] == 0).all()
