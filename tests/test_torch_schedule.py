"""The launch plans of the row_max, count_above and fused_topk kernels
(reduce_gemm.cuh) and of row_max.bf16 (wgmma_gemm.cuh), the zero padding
of the rows row_max.bf16 reads, and the ctypes declarations of every
kernel, checked on the CPU (no nvcc, no card).

The persistent schedule lives in ``vsc2022_torch/ops/kernels.py``
(``reduce_tiles``, ``reduce_grid``, ``reduce_schedule``); the kernel in
``ops/csrc/reduce_gemm.cuh`` walks the same ranges. A C signature that
changes under a stale ctypes declaration cuts pointers to 32 bits on the
card, so the declarations are held against the sources here.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from vsc2022_torch.ops import _build, kernels

# (query rows, valid ref columns) of the calls the three paths make.
PATH_SHAPES = [
    (9000, 250_020),   # SSCD: row_max, the noise NN
    (894, 1_000_020),  # SSCD: count_above over the ambiguous rows
    (7682, 7_248),     # DnS: row_max
    (7682, 31_004),    # DnS: count_above over every row (stream)
    (9000, 240_000),   # serving: count_above over every row (stream)
    (9000, 60_000),    # serving: row_max, the bias
    (60, 240_000),     # serving: one query video
]
RAGGED_SHAPES = [(1, 1), (1, 128), (1, 129), (128, 1), (129, 129), (300, 1000),
                 (65, 1337)]
# A few blocks, odd counts, and one wave of 1, 2 or 4 blocks per SM on an
# H100's 132 SMs.
SLOTS = [1, 7, 132, 264, 528]


@pytest.mark.parametrize("m,n_valid", PATH_SHAPES + RAGGED_SHAPES)
def test_schedule_covers_every_tile_once_and_balances(m, n_valid):
    row_tiles, col_tiles = kernels.reduce_tiles(m, n_valid)
    assert row_tiles * kernels.REDUCE_TILE >= m > (row_tiles - 1) * kernels.REDUCE_TILE
    assert col_tiles * kernels.REDUCE_TILE >= n_valid > (col_tiles - 1) * kernels.REDUCE_TILE
    n_items = row_tiles * col_tiles
    for slots in SLOTS:
        grid = kernels.reduce_grid(m, n_valid, slots)
        assert grid == min(slots, n_items)  # one wave, no idle block
        ranges = kernels.reduce_schedule(m, n_valid, grid)
        assert len(ranges) == grid
        lengths = np.array([end - begin for begin, end in ranges])
        # Balanced within one item, and no block without work.
        assert lengths.min() >= 1 and lengths.max() - lengths.min() <= 1
        items = np.concatenate([np.arange(b, e) for b, e in ranges])
        rt, ct = np.divmod(items, col_tiles)
        assert rt.min() >= 0 and rt.max() < row_tiles and ct.max() < col_tiles
        # Every (row tile, column tile) exactly once.
        seen = np.zeros((row_tiles, col_tiles), dtype=np.int64)
        np.add.at(seen, (rt, ct), 1)
        assert (seen == 1).all()
        # A block's range touches as few row tiles as its length allows:
        # it flushes once per row tile it leaves, and once at its end.
        for (begin, end), n in zip(ranges, lengths):
            touched = (end - 1) // col_tiles - begin // col_tiles + 1
            assert touched <= -(-int(n) // col_tiles) + 1


@pytest.mark.parametrize("m,n_valid", [(0, 100), (100, 0), (0, 0)])
def test_schedule_of_an_empty_call_has_no_block(m, n_valid):
    assert kernels.reduce_grid(m, n_valid, 264) == 0
    assert kernels.reduce_schedule(m, n_valid, 0) == []


def test_each_row_tile_is_split_evenly_at_the_path_shapes():
    # With fewer row tiles than blocks, each row tile's columns go to
    # blocks whose shares differ by at most one column tile (the blocks
    # that straddle two row tiles hold the remainder).
    for m, n_valid in PATH_SHAPES:
        row_tiles, col_tiles = kernels.reduce_tiles(m, n_valid)
        ranges = kernels.reduce_schedule(m, n_valid, kernels.reduce_grid(m, n_valid, 132))
        for r in range(row_tiles):
            lo, hi = r * col_tiles, (r + 1) * col_tiles
            shares, inner = [], []
            for b, e in ranges:
                if b < hi and e > lo:
                    shares.append(min(e, hi) - max(b, lo))
                    if lo <= b and e <= hi:
                        inner.append(e - b)
            assert sum(shares) == col_tiles
            if inner:
                assert max(inner) - min(inner) <= 1


# ---- ctypes declarations against the C sources -------------------------------

_SIGNATURE = re.compile(r'extern "C" int (vsc_\w+)\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _ctype(param: str):
    words = param.split()
    if "*" in param:
        return ctypes.c_void_p
    return _SCALARS[" ".join(words[:-1])]


def _c_signatures():
    sigs = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _SIGNATURE.findall(src.read_text()):
            sigs[name] = [_ctype(p) for p in params.split(",") if p.strip()]
    return sigs


class _RecordingLib:
    """Stands in for the loaded library: records what _declare sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.__dict__["fns"].setdefault(name, types.SimpleNamespace())


def _declared():
    lib = _RecordingLib()
    _build._declare(lib)
    return lib.fns


@pytest.mark.parametrize("name", sorted(_c_signatures()))
def test_ctypes_declaration_matches_c_signature(name):
    fn = _declared().get(name)
    assert fn is not None, f"{name} is exported but not declared in _build._declare"
    assert fn.argtypes == _c_signatures()[name]
    assert fn.restype is ctypes.c_int


def test_every_declaration_names_an_exported_function():
    sigs = _c_signatures()
    assert set(_declared()) == set(sigs)
    # The retrieval wrappers' launchers take the device first and the
    # stream last.
    for name in ("vsc_row_max", "vsc_count_above", "vsc_pool_writer",
                 "vsc_fused_topk", "vsc_chamfer"):
        assert sigs[name][0] is ctypes.c_int and sigs[name][-1] is ctypes.c_void_p


# ---- the work plan of the tensor-core product (row_max.bf16) -----------------

# (query rows, valid corpus rows) of the row_max.bf16 calls on the paths:
# the SSCD noise NN, the serving bias, the DnS shape rounded to bf16.
WGMMA_SHAPES = [(9000, 250_020), (9000, 60_000), (7682, 7_248)]


def _wgmma_order(m, n_valid):
    """Items in the order wgmma_gemm.cuh numbers them, built directly:
    groups of WGMMA_GROUP query tiles, then corpus tiles, then the group's
    query tiles."""
    q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
    order = []
    for g0 in range(0, q_tiles, kernels.WGMMA_GROUP):
        tiles = range(g0, min(g0 + kernels.WGMMA_GROUP, q_tiles))
        order += [(g0 // kernels.WGMMA_GROUP, t, c) for c in range(c_tiles) for t in tiles]
    return np.array(order).reshape(-1, 3)


@pytest.mark.parametrize("m,n_valid", WGMMA_SHAPES + RAGGED_SHAPES + [(1025, 3000)])
def test_wgmma_plan_covers_every_item_once(m, n_valid):
    q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
    assert q_tiles * kernels.WGMMA_ROWS >= m > (q_tiles - 1) * kernels.WGMMA_ROWS
    assert c_tiles * kernels.WGMMA_COLS >= n_valid > (c_tiles - 1) * kernels.WGMMA_COLS
    items = q_tiles * c_tiles
    got = np.stack(kernels.wgmma_item(np.arange(items), m, n_valid), axis=1)
    np.testing.assert_array_equal(got, _wgmma_order(m, n_valid))
    # Every (query tile, corpus tile) exactly once.
    seen = np.zeros((q_tiles, c_tiles), dtype=np.int64)
    np.add.at(seen, (got[:, 1], got[:, 2]), 1)
    assert (seen == 1).all()
    # The scalar form agrees with the array form.
    for i in {0, items // 2, items - 1}:
        assert tuple(int(v) for v in kernels.wgmma_item(i, m, n_valid)) == tuple(got[i])
    for slots in SLOTS:
        grid = kernels.wgmma_grid(m, n_valid, slots)
        assert grid == min(slots, items)
        ranges = kernels.block_ranges(items, grid)
        lengths = np.array([e - b for b, e in ranges])
        assert lengths.min() >= 1 and lengths.max() - lengths.min() <= 1
        assert ranges[0][0] == 0 and ranges[-1][1] == items
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_wgmma_plan_of_an_empty_call_has_no_block():
    assert kernels.wgmma_grid(0, 100, 132) == 0
    assert kernels.wgmma_grid(100, 0, 132) == 0
    assert kernels.wgmma_corpus_passes(100, 0, 0) == 0.0


@pytest.mark.parametrize("m,n_valid", WGMMA_SHAPES)
def test_wgmma_plan_reads_the_corpus_once_per_group(m, n_valid):
    # The row-tile-major order streams the corpus once per 128-row query
    # tile; the grouped order once per group of WGMMA_GROUP query tiles,
    # plus at most one tile per block boundary.
    q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
    groups = -(-q_tiles // kernels.WGMMA_GROUP)
    grid = kernels.wgmma_grid(m, n_valid, 132)
    passes = kernels.wgmma_corpus_passes(m, n_valid, grid)
    assert groups <= passes <= groups + grid / c_tiles
    row_tile_passes = kernels.reduce_tiles(m, n_valid)[0]
    assert row_tile_passes >= 60 and passes * 4 < row_tile_passes
    # One block walking everything reads each corpus tile once per group.
    assert kernels.wgmma_corpus_passes(m, n_valid, 1) == groups


# ---- the bf16 rows row_max.bf16 reads ----------------------------------------


@pytest.mark.parametrize("d", [1, 2, 7, 8, 9, 15, 16, 33, 511, 512, 513, 1025])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pad_columns_keeps_the_values_and_zero_pads(d, dtype):
    x = torch.from_numpy(np.random.RandomState(d).randn(13, d).astype(np.float32)).to(dtype)
    y = kernels.pad_columns(x)
    width = kernels.padded_width(d)
    assert width % kernels.ROW_ALIGN == 0 and d <= width < d + kernels.ROW_ALIGN
    assert y.shape == (13, width) and y.dtype == dtype and y.is_contiguous()
    assert y.data_ptr() % 16 == 0
    assert torch.equal(y[:, :d], x)
    assert torch.equal(y[:, d:], torch.zeros((13, width - d), dtype=dtype))
    # Already padded and aligned: no copy.
    assert (y is x) == (width == d)
    assert kernels.pad_columns(y) is y


def test_pad_columns_copies_an_unaligned_view():
    flat = torch.arange(8 * 16 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(8, 16)  # 2 bytes into its storage
    assert x.data_ptr() % 16
    y = kernels.pad_columns(x)
    assert y.shape == x.shape and y.data_ptr() % 16 == 0 and torch.equal(y, x)


def test_bf16_row_max_takes_padded_refs_on_the_cpu():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randint(-3, 4, (20, 13)).astype(np.float32)).bfloat16()
    r = torch.from_numpy(rng.randint(-3, 4, (300, 13)).astype(np.float32)).bfloat16()
    want = kernels.row_max(q, r, 290)
    assert torch.equal(kernels.row_max(q, kernels.pad_columns(r), 290), want)
    assert torch.equal(want, kernels.row_max_plain(q.float(), r.float(), 290))
    with pytest.raises(ValueError):  # neither D nor padded_width(D) columns
        kernels.row_max(q, torch.zeros((300, 24), dtype=torch.bfloat16), 290)
    with pytest.raises(ValueError):  # only bf16 refs may carry the padding
        kernels.row_max(q.float(), kernels.pad_columns(r).float(), 290)


def test_bf16_stream_pair_takes_padded_refs_on_the_cpu():
    # The plain versions of count_above, scores and fused_topk (and so the
    # wrappers on the CPU) give on pad_columns' padded refs what they give
    # on the unpadded ones.
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randint(-3, 4, (20, 13)).astype(np.float32)).bfloat16()
    r = torch.from_numpy(rng.randint(-3, 4, (300, 13)).astype(np.float32)).bfloat16()
    r[[5, 7, 200]] = 3.0  # ties in and across segments
    rp = kernels.pad_columns(r)
    assert rp.shape == (300, 16)
    for tau in (float("-inf"), 3.0):
        want = kernels.count_above_plain(q, r, tau, 290)
        assert torch.equal(kernels.count_above_plain(q, rp, tau, 290), want)
        assert torch.equal(kernels.count_above(q, rp, tau, 290), want)
    want = kernels.scores_plain(q, r, 290)
    assert torch.equal(want, torch.matmul(q.float(), r[:290].float().T))
    for got in (kernels.scores_plain(q, rp, 290), kernels.scores(q, rp, 290)):
        assert torch.equal(got, want)
    for kappa in (1, 7, 40):
        want_v, want_i = kernels.fused_topk_plain(q, r, 290, kappa)
        for got_v, got_i in (kernels.fused_topk_plain(q, rp, 290, kappa),
                             kernels.fused_topk(q, rp, 290, kappa)):
            assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    with pytest.raises(ValueError):  # only bf16 refs may carry the padding
        kernels.count_above(q.float(), rp.float(), 0.0, 290)
    with pytest.raises(ValueError):
        kernels.fused_topk(q.float(), rp.float(), 290, 4)
    with pytest.raises(TypeError):  # one bf16 count: no partner to name
        kernels.count_above(q, r, 0.0, 290, pair="pooled")


@pytest.mark.parametrize("m,n_valid", [(9000, 240_000), (7682, 31_004), (60, 240_000)])
def test_wgmma_topk_plans_at_the_path_shapes(m, n_valid):
    # The streaming pair's launches at the serving, DnS and one-video
    # shapes: one wave of 132 blocks, each corpus tile from HBM about once
    # per group (the shared-memory sets' groups of 2: four times as often).
    grid = kernels.wgmma_grid(m, n_valid, 132)
    q_tiles, c_tiles = kernels.wgmma_tiles(m, n_valid)
    assert grid == min(132, q_tiles * c_tiles)
    for group in (kernels.WGMMA_GROUP, kernels.WGMMA_SMEM_SETS_GROUP):
        groups = -(-q_tiles // group)
        passes = kernels.wgmma_corpus_passes(m, n_valid, grid, group)
        assert groups <= passes <= groups + grid / c_tiles


@pytest.mark.parametrize("n,n_valid", [
    (384, 0), (384, 1), (384, 128), (384, 200), (384, 256), (384, 257), (384, 384),
    (1408, 1000), (1408, 1337), (1408, 1408), (1024, 1024), (8192, 5000),
])
def test_pool_segments_mirror_the_plain_pool_tail(n, n_valid):
    # pool_writer.bf16's kernel writes the two segments of every corpus tile
    # its plan covers (256 rows, up to n_valid), at most N/128 of them (with
    # N/128 odd the last tile's second segment lies past the pool), and the
    # wrapper fills the rest at -inf: the plain pool holds no valid column
    # there, and every segment that holds one is written.
    written = kernels.pool_segments(n, n_valid)
    assert written == min(2 * kernels.wgmma_tiles(1, n_valid)[1], n // kernels.SEG_LANES)
    q = torch.ones((3, 8), dtype=torch.bfloat16)
    pv, _ = kernels.pool_writer_plain(q, torch.ones((n, 8), dtype=torch.bfloat16), n_valid)
    valid = torch.isfinite(pv[:, :, 0]).all(0)
    assert not torch.isfinite(pv[:, written:]).any()
    assert int(valid.sum()) == -(-n_valid // kernels.SEG_LANES)
    assert bool(valid[: int(valid.sum())].all())
    assert 0 <= written - int(valid.sum()) <= 1
