"""IVF pruned tier: a cluster-contiguous corpus and per-block score bounds.

Counterpart of ``vsc2022_tpu/ops/ivf.py``. The reference's ``codec_str``
reaches ``faiss.index_factory`` (vsc/index.py:78-82), whose IVF indexes scan
only the ``nprobe`` nearest of nlist k-means cells per query. Here the search
stays EXACT and pruning is a property of the corpus layout:

1. Build: Lloyd k-means (``kmeans_assign``: assignment by one product per
   row block, the centroid update a one-hot product) orders the rows so that
   each cell is contiguous, cells chained by ``order_clusters``; the staged
   corpus is that permutation of the rows.
2. Per column block of the staged corpus (``col_block`` rows, the unit the
   kernels' block lists take): the centroid c_b and radius r_b of its rows,
   from the values the kernels read (``_block_stats``). For every query q and
   row x of block b: q·x ≤ q·c_b + ‖q‖·r_b (Cauchy-Schwarz).
3. Search (``IVFSimilaritySearcher.global_topk``): every row's bound on every
   block (+ BOUND_EPS), each row's top-``nprobe`` blocks, their union (the
   probed blocks) and the per-block max bound over the rows. The candidates
   come from ``fused_topk`` over the probed blocks only, τ is their global
   k-th, and one ``count_above`` over the probed blocks and the certified
   ones (unprobed blocks whose bound reaches τ: every other block provably
   holds no entry ≥ τ) gives every row's exact corpus count ≥ τ. Rows whose
   kept candidates fall short of it are re-searched over the whole corpus,
   as in the plain searcher's streaming collection, whose code this is
   (``SimilaritySearcher._collect_stream`` with a block scope).

The candidate and count passes run on the block-subset variants of the
port's kernels (``kernels.fused_topk`` / ``count_above`` with ``blocks=``;
``ops/csrc/block_list.cuh``): the same product as the full-corpus kernels,
so the candidates, the counts and the re-search of a dtype compare one
product's scores bit for bit. The result is the plain searcher's exactly,
ties included: ids map back to the caller's before the final (q, r) sort.

Differences from the JAX tier: the block list goes to the kernels as it is
(JAX pads it to a power of two for XLA's compile cache), and the candidates
are always the segment winners' top-κ, where JAX's XLA collection takes an
exact per-block top-κ when the padded list has fewer segment winners than κ
(tiny column blocks): there τ, and so ``certified_extra`` and the repairs,
may differ; the results do not. JAX's fallback for an uneven row-block
staging has no counterpart (the port's kernels take every query row in one
launch).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.ops.kernels import PLAIN_CHUNK_ELEMENTS, SEG_LANES
from vsc2022_torch.ops.similarity import (
    COL_BLOCK, NEG_INF, SimilaritySearcher, _ceil_to, _check_keep_idx, _host_f32,
)

# Slack added to every block bound, JAX's value: it covers the f32 (and the
# tensor cores') summation error of the kernels' scores (about D·eps·‖q‖‖x‖,
# 1e-4 at D = 513 on unit rows) with an order of magnitude to spare. Too
# small risks a skipped block; too large only counts extra blocks.
BOUND_EPS = 1e-3


@contextlib.contextmanager
def _f32_products(device: torch.device):
    """Full f32 products on the card (no TF32) for the block, the previous
    matmul setting restored afterwards."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _lloyd(rows: torch.Tensor, n_valid: int, cent: torch.Tensor, nlist: int,
           iters: int, block: int):
    """Lloyd k-means over rows [N_pad, D] f32 (zero pad rows; the first
    n_valid are the data) from centroids cent [nlist, D]: (centroids,
    assignment [N_pad] int64), as JAX's ``_lloyd``. The assignment is
    argmax(x·c − ‖c‖²/2) (the lowest cell on ties); the update sums each
    cell's rows by a one-hot product per row block (no atomics: the same
    layout on every run); an empty cell keeps its centroid. Pad rows join
    the last cell."""
    n_pad = rows.shape[0]
    cells = torch.arange(nlist, device=rows.device)

    def assign(blk, half_sq, start):
        a = torch.argmax(torch.matmul(blk, cent.T) - half_sq[None, :], dim=1)
        valid = torch.arange(start, start + blk.shape[0], device=rows.device) < n_valid
        return a, valid

    for _ in range(iters):
        half_sq = 0.5 * (cent * cent).sum(1)
        sums = torch.zeros_like(cent)
        counts = torch.zeros(nlist, dtype=torch.float32, device=rows.device)
        for start in range(0, n_pad, block):
            blk = rows[start : start + block]
            a, valid = assign(blk, half_sq, start)
            onehot = ((a[:, None] == cells[None, :]) & valid[:, None]).float()
            sums += torch.matmul(onehot.T, blk)
            counts += onehot.sum(0)
        new = sums / counts.clamp(min=1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new, cent)
    half_sq = 0.5 * (cent * cent).sum(1)
    parts = []
    for start in range(0, n_pad, block):
        a, valid = assign(rows[start : start + block], half_sq, start)
        parts.append(torch.where(valid, a, nlist - 1))
    return cent, torch.cat(parts)


def kmeans_assign(rows, nlist: int, iters: int = 8, seed: int = 0,
                  device: DeviceLike = "cuda"):
    """(assignment [N] int32, centroids [nlist, D] f32) of every row (host
    in, host out; computed on ``device``), as JAX's ``kmeans_assign``: the
    initial centroids are a seeded subsample of the rows
    (``np.random.RandomState(seed).choice``), the row block keeps a [block,
    nlist] score tile near 64 MB."""
    rows = _host_f32(rows)
    n = rows.shape[0]
    rng = np.random.RandomState(seed)
    init = rows[rng.choice(n, size=nlist, replace=False)].astype(np.float32)
    block = max(512, min(65536, (1 << 24) // max(nlist, 1)))
    block = 1 << (block - 1).bit_length()
    n_pad = _ceil_to(n, block)
    dev = resolve_device(device)
    padded = torch.zeros((n_pad, rows.shape[1]), dtype=torch.float32, device=dev)
    padded[:n] = torch.from_numpy(rows).to(dev)
    with _f32_products(dev):
        cent, assign = _lloyd(padded, n, torch.from_numpy(init).to(dev), nlist,
                              iters, block)
    return assign[:n].int().cpu().numpy(), cent.cpu().numpy()


def order_clusters(cent: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbour chain over the centroids (JAX's, on the
    host): the bound's unit is the column block, and a block that straddles
    two cells keeps a tight radius only if those cells lie close, so
    neighbouring cells are laid out next to each other."""
    n = cent.shape[0]
    if n <= 2:
        return np.arange(n, dtype=np.int64)
    c = cent.astype(np.float64)
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    order = [0]
    used = np.zeros(n, dtype=bool)
    used[0] = True
    for _ in range(n - 1):
        row = d2[order[-1]].copy()
        row[used] = np.inf
        nxt = int(np.argmin(row))
        order.append(nxt)
        used[nxt] = True
    return np.asarray(order, dtype=np.int64)


class _BlockScope:
    """The pruned scan of one search, for ``_collect_stream``: the
    candidates over the probed blocks, the counts over the probed and the
    certified ones (``counts``: None when τ is −inf, where the subset's
    counts cannot drive the repair)."""

    def __init__(self, probed: np.ndarray, mask: np.ndarray, rowmax: np.ndarray,
                 col_block: int, device: torch.device):
        self._probed, self._mask, self._rowmax = probed, mask, rowmax
        self._col_block, self._device = col_block, device
        self.candidates = self._kw(probed)
        self.certified = 0

    def _kw(self, ids: np.ndarray) -> dict:
        blocks = torch.from_numpy(ids.astype(np.int32)).to(self._device)
        return {"blocks": blocks, "col_block": self._col_block}

    def counts(self, tau: float) -> Optional[dict]:
        if tau == NEG_INF:
            return None
        extra = np.nonzero(~self._mask & (self._rowmax >= tau))[0]
        self.certified = int(extra.size)
        return self._kw(np.union1d(self._probed, extra))


class IVFSimilaritySearcher(SimilaritySearcher):
    """Exact searcher with IVF block pruning (module docstring), metric
    "IP" in any storage dtype.

    ``nlist``: k-means cells; by default about 2 column blocks a cell (at
    most 4096), since the bound's unit is the block. ``nprobe``: blocks
    probed per query row (default n_blocks // 8); exactness never depends
    on it. ``col_block``: the column block (the staging pads to it, as the
    JAX searcher's ``col_block`` does; clamped to the corpus rounded up to
    128). Over a bf16 or int8 corpus on the card it must be a multiple of
    256, the tensor-core kernels' tile. ``last_search_stats``: n_blocks,
    probed, certified_extra and pruned of the last search that probed
    (None when it did not: fewer than 4 blocks, or nothing to search).
    """

    def __init__(
        self,
        refs,
        nlist: Optional[int] = None,
        nprobe: Optional[int] = None,
        kmeans_iters: int = 8,
        seed: int = 0,
        col_block: int = COL_BLOCK,
        metric: str = "IP",
        precision: str = "highest",
        dtype: str = "float32",
        device: DeviceLike = "cuda",
    ):
        if metric != "IP":
            raise ValueError(
                "IVF supports metric='IP' only (the production metric; "
                "reference pipelines never use codec L2 — vsc/index.py:78)"
            )
        if col_block <= 0 or col_block % SEG_LANES:
            raise ValueError(f"col_block {col_block} is not a positive multiple of "
                             f"{SEG_LANES}")
        refs = _host_f32(refs)
        if refs.ndim != 2:
            raise ValueError(f"refs must be [N, D]; got {refs.shape}")
        n = refs.shape[0]
        self._col_block_req = col_block
        if nlist is None:
            cb = self._col_block_of(n)
            nlist = max(1, min(4096, (_ceil_to(max(n, 1), cb) // cb) // 2))
        self.nlist = min(nlist, max(n, 1))
        self.nprobe = nprobe
        if n > self.nlist > 1:
            assign, cent = kmeans_assign(refs, self.nlist, iters=kmeans_iters,
                                         seed=seed, device=device)
            # Chain-ordered cells, stable within a cell.
            rank = np.empty(self.nlist, dtype=np.int64)
            rank[order_clusters(cent)] = np.arange(self.nlist)
            self._perm = np.argsort(rank[assign], kind="stable").astype(np.int64)
        else:
            self._perm = np.arange(n, dtype=np.int64)
        super().__init__(refs[self._perm], metric=metric, precision=precision,
                         dtype=dtype, device=device)
        self._stats_cache = None
        self.last_search_stats: Optional[dict] = None

    # ---- the layout ------------------------------------------------------

    def _col_block_of(self, n_rows: int) -> int:
        return min(self._col_block_req, _ceil_to(max(n_rows, 1), SEG_LANES))

    @property
    def col_block(self) -> int:
        """The column block of the staged corpus (JAX's ``col_block``)."""
        return self._col_block_of(self.n_refs)

    def _padded_refs(self, n_rows: int) -> int:
        return _ceil_to(max(n_rows, 1), self._col_block_of(n_rows))

    # ---- id translation --------------------------------------------------

    def _map_ref_ids(self, flat_r: np.ndarray) -> np.ndarray:
        if not flat_r.size:
            return flat_r
        return self._perm[np.clip(flat_r, 0, self.n_refs - 1)]

    def row_topk(self, queries, k: int):
        out_s, out_i = super().row_topk(queries, k)
        return out_s, self._map_ref_ids(out_i)

    # ---- mutations keep the caller's ids -----------------------------------

    def append_rows(self, new_rows) -> None:
        """Appended rows land after the clustered region, in their own
        blocks' bounds (looser until a rebuild, never wrong)."""
        n_ext = self._perm.size
        super().append_rows(new_rows)
        self._perm = np.concatenate(
            [self._perm, np.arange(n_ext, self.n_refs, dtype=np.int64)])
        self._stats_cache = None

    def keep_rows(self, keep_idx) -> None:
        """``keep_idx``: survivors in the caller's ids (strictly increasing),
        renumbered by keep order; they compact in their staged (clustered)
        order, so the bounds stay tight."""
        keep_idx = _check_keep_idx(keep_idx, self.n_refs)
        inv = np.empty(self.n_refs, dtype=np.int64)
        inv[self._perm] = np.arange(self.n_refs, dtype=np.int64)
        pos = inv[keep_idx]
        order = np.argsort(pos, kind="stable")
        super().keep_rows(pos[order])
        # Staged row j now holds keep_idx[order[j]], whose new id is order[j].
        self._perm = order.astype(np.int64)
        self._stats_cache = None

    # ---- the pruned candidate phase ----------------------------------------

    def _block_stats(self):
        """(centroid [B, D], radius [B], has-valid [B]) of every column block
        of the staged corpus, from the values the kernels read: f32 rows as
        staged (bf16 at precision "default"), bf16 rows widened, int8 codes
        times their scales; valid rows only. Cached until the corpus
        changes."""
        if self._stats_cache is None:
            cb, d = self.col_block, self.dim
            n_blocks = self._refs.shape[0] // cb
            step = max(1, PLAIN_CHUNK_ELEMENTS // (cb * max(d, 1)))
            parts = []
            for b0 in range(0, n_blocks, step):
                rows = slice(b0 * cb, min(b0 + step, n_blocks) * cb)
                blk = self._refs[rows, :d].float()
                if self._scale is not None:
                    blk = blk * self._scale[rows, None]
                blk = blk.view(-1, cb, d)
                valid = (torch.arange(rows.start, rows.stop, device=self.device)
                         < self.n_refs).view(-1, cb)
                v = valid.float()
                cnt = v.sum(1)
                cent = (blk * v[..., None]).sum(1) / cnt.clamp(min=1.0)[:, None]
                d2 = ((blk - cent[:, None, :]) ** 2).sum(2)
                rad = torch.sqrt(torch.where(valid, d2, torch.zeros_like(d2)).amax(1))
                parts.append((cent, rad, cnt > 0))
            self._stats_cache = tuple(torch.cat(p) for p in zip(*parts))
        return self._stats_cache

    def _effective_nprobe(self, n_blocks: int) -> int:
        if self.nprobe is not None:
            return max(1, min(self.nprobe, n_blocks))
        return max(1, n_blocks // 8)

    def _probe(self, q: torch.Tensor, n_blocks: int):
        """(probe mask [B] bool, per-block max bound over the rows [B] f32)
        for staged queries: each row's bound on each block, q·c_b + ‖q‖·r_b +
        BOUND_EPS (−inf on a block with no valid row), over the queries as
        the product takes them; a row probes its top-nprobe blocks."""
        cent, rad, has = self._block_stats()
        q32 = self._product_queries(q).float()
        with _f32_products(self.device):
            b = torch.matmul(q32, cent.T)
        b = b + torch.sqrt((q32 * q32).sum(1))[:, None] * rad[None, :] + BOUND_EPS
        b = torch.where(has[None, :], b, torch.full_like(b, NEG_INF))
        k = min(self._effective_nprobe(n_blocks), n_blocks)
        thresh = torch.topk(b, k, dim=1).values[:, -1]
        probe = (b >= thresh[:, None]) & (b > NEG_INF)
        return probe.any(0).cpu().numpy(), b.amax(0).cpu().numpy()

    def global_topk(self, queries, k: int, kappa: Optional[int] = None):
        self.last_search_stats = None  # set again if the probe runs
        return super().global_topk(queries, k, kappa)

    def _collect(self, q: torch.Tensor, kappa: int, k_eff: int, clock):
        """The pruned collection (module docstring), or the plain one when
        the corpus has fewer than 4 blocks, when the probed blocks cover all
        but one (or 7/8) of them, or when τ over the candidates is −inf."""
        n_blocks = self._refs.shape[0] // self.col_block
        if n_blocks < 4:
            return super()._collect(q, kappa, k_eff, clock)
        mask, rowmax = self._probe(q, n_blocks)
        probed = np.nonzero(mask)[0]
        stats = {"n_blocks": n_blocks, "probed": int(probed.size),
                 "certified_extra": 0, "pruned": False}
        self.last_search_stats = stats
        clock.mark("probe")
        if probed.size >= max(n_blocks - 1, (7 * n_blocks) // 8):
            return super()._collect(q, kappa, k_eff, clock)
        scope = _BlockScope(probed, mask, rowmax, self.col_block, self.device)
        out = self._collect_stream(q, kappa, k_eff, clock, scope)
        if out is None:
            return super()._collect(q, kappa, k_eff, clock)
        stats.update(certified_extra=scope.certified, pruned=True)
        return ("ivf", *out)
