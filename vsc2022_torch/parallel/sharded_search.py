"""Corpus-sharded brute-force search over a device mesh (counterpart of
``vsc2022_tpu/parallel/sharded_search.py``).

Each mesh entry holds 1/n of the reference corpus; the queries are staged
once, on the lead device, and copied to each shard's device. Every
product a search runs is one of ``SimilaritySearcher``'s kernel calls
(``_row_max``, ``_fused_topk``, ``_count_above``, ``_pool``,
``_scores_above``, ``_dense_above``, ``_dense_scores``); this class runs
each on every shard that holds a valid row, with that shard's hand kernel,
then merges on the lead device in plain torch: the row max is the max over
the shards, the counts their sum, the per-row top-κ ``ordered_topk`` over
the shards' top-κ with ids offset by each shard's base (score descending,
then global id ascending: equal scores keep the lower shard), the winner
pool the shards' pools side by side, the re-searches' entries
concatenated. Both collections of ``SimilaritySearcher`` (one copy of
each) then run on the merged results, routed as JAX routes a sharded
search (``_collection_mode``).

Exact: shards begin at multiples of ``shard_rows``, itself a multiple of
the 128-column pool segment, so the shards' pools side by side are the
one-device pool (plus −inf segments at the tail), each shard's top-κ
holds its part of the global top-κ, and every score is computed whole on
one shard by the kernel that computes it on one device. So a sharded
search returns the single-device searcher's pairs, scores and tie order.
The f32 re-search (``_dense_above``, ``_dense_scores``) runs per
allocation, on the single-device searcher's fixed-shape cuBLAS calls
(``_f32_scores``: its column blocks begin at the same corpus rows, a block
that straddles a shard boundary padded with zero rows), so its scores are
the single-device ones too, in one allocation or one a card.

Geometry, as JAX's: ``per_dev`` = N rounded up to the mesh size, over
the mesh size; ``col_block`` = min(``col_block``, ``per_dev`` rounded up
to 128); ``shard_rows`` = ``per_dev`` rounded up to ``col_block``; all
padding at the tail, so shard s holds the valid rows [s·shard_rows,
min(N, (s+1)·shard_rows)). The shards of each run of consecutive mesh
entries on one device are views into one staged tensor (on one card: the
one-device layout of the padded corpus); on separate cards each has its
own. ``append_rows`` and ``keep_rows`` land on the layout a fresh stage
of the result gives, moving resident rows device to device, never
through the host.

Every shard's kernel is launched on its device's current stream before the
host reads any result (τ, a count), so on several cards the shards
overlap; on one card they queue. The re-search over a bf16 or int8 corpus
(``kernels.scores_above``) reads its entry count per launch, so its
shards run one after another.

A pod (a mesh that spans processes, ``parallel/mesh.py``): every rank
holds the full corpus on the host, as every JAX process does before
``jax.device_put`` of a global array, and stages only the shards of its
own entries (``staged_bytes`` counts those). Every rank runs the same host
program; each kernel call runs on the rank's shards, merges on its lead
device, then merges over the group (``parallel/collectives.py``): the row
max with ``pmax``, the counts with ``psum``, the top-κ, the pools and the
re-searches' entries with a ragged ``all_gather`` in rank order. So every
rank holds the one-process merge's tensors, bit for bit, and every rank
ends a search with the same result. The pooled collection gathers whole
pools to every rank (8·M·P bytes: the pools' values and ids), where JAX
keeps them sharded. ``append_rows`` and ``keep_rows`` move resident rows
between ranks with one ``all_to_all`` a field (``exchange``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vsc2022_torch.ops import kernels
from vsc2022_torch.ops.ivf import IVFSimilaritySearcher
from vsc2022_torch.ops.kernels import PLAIN_CHUNK_ELEMENTS, SEG_KEEP, SEG_LANES
from vsc2022_torch.ops.similarity import (
    COL_BLOCK,
    COLLECTION_ENV,
    POOL_BYTES_BUDGET,
    POOL_MIN_CORPUS,
    SimilaritySearcher,
    _ceil_to,
    _check_keep_idx,
    _f32_scores,
    _host_f32,
    _max_row_norm,
    _quantize,
    _widened_scores,
)
from vsc2022_torch.parallel import collectives
from vsc2022_torch.parallel.mesh import Mesh, on_device, process_index

# A shard's fields: its rows (f32 / bf16 rows or int8 codes), and the
# per-row int8 scales or L2 squared norms where the corpus has them.
_FIELDS = ("refs", "scale", "ref_sq")


def make_searcher(refs, mesh: Optional[Mesh] = None, device="cuda",
                  ivf_nlist: Optional[int] = None, ivf_nprobe: Optional[int] = None,
                  **kw) -> SimilaritySearcher:
    """A ``ShardedSimilaritySearcher`` over ``mesh``, or without one a
    ``SimilaritySearcher`` on ``device`` (with ``ivf_nlist``, the IVF tier's
    ``IVFSimilaritySearcher``, ``ivf_nprobe`` its probe width: single-device
    only, as in JAX); ``kw``: metric, precision, dtype."""
    if ivf_nlist is not None:
        if mesh is not None:
            raise ValueError("IVF codecs are single-chip for now: shard the "
                             "corpus (mesh) OR prune it (IVF), not both")
        return IVFSimilaritySearcher(refs, nlist=ivf_nlist, nprobe=ivf_nprobe,
                                     device=device, **kw)
    if mesh is None:
        return SimilaritySearcher(refs, device=device, **kw)
    return ShardedSimilaritySearcher(refs, mesh, **kw)


class ShardedSimilaritySearcher(SimilaritySearcher):
    """Drop-in ``SimilaritySearcher`` over a 1-D corpus mesh."""

    def __init__(
        self,
        refs,
        mesh: Mesh,
        metric: str = "IP",
        precision: str = "highest",
        dtype: str = "float32",
        col_block: int = COL_BLOCK,
    ):
        self._configure(dtype, mesh.lead, metric, precision)
        self.mesh = mesh
        self.n_dev = mesh.size
        self._col_block_req = col_block
        refs = _host_f32(refs)
        if refs.ndim != 2:
            raise ValueError(f"refs must be [N, D]; got {refs.shape}")
        self.n_refs, self.dim = refs.shape
        self._set_layout(self._allocate(self._geometry(self.n_refs)))
        self._ref_norm_max = self._write_rows(refs, 0)

    # ---- layout ------------------------------------------------------------

    def _geometry(self, total: int) -> Tuple[int, int]:
        """(shard_rows, col_block) of a fresh stage of ``total`` rows, as
        the JAX sharded searcher computes them."""
        per_dev = _ceil_to(max(total, 1), self.n_dev) // self.n_dev
        col_block = min(self._col_block_req, _ceil_to(per_dev, SEG_LANES))
        return _ceil_to(per_dev, col_block), col_block

    def _allocations(self) -> List[List[int]]:
        """The shards that share one allocation: each run of consecutive
        mesh entries of this process on one device (on one card, every
        shard of the process)."""
        groups: List[List[int]] = []
        for s in self.mesh.local:
            dev = self.mesh.devices[s]
            if groups and groups[-1][-1] == s - 1 and self.mesh.devices[groups[-1][-1]] == dev:
                groups[-1].append(s)
            else:
                groups.append([s])
        return groups

    def _allocate(self, geometry: Tuple[int, int]) -> dict:
        """Zero shards of ``geometry``: per allocation (``_allocations``),
        one tensor per field holding its shards' rows one after another,
        and each shard's view into it."""
        shard_rows, _ = geometry
        width = (kernels.padded_width(self.dim, kernels.I8_ROW_ALIGN)
                 if self._int8 else self.dim)
        shapes = {"refs": ((width,), self.torch_dtype)}
        shapes.update({name: ((), torch.float32) for name, on in
                       (("scale", self._int8), ("ref_sq", self._l2)) if on})
        fields: dict = {"geometry": geometry, "groups": []}
        fields.update({name: [None] * self.n_dev for name in shapes})
        for shards in self._allocations():
            dev = self.mesh.devices[shards[0]]
            whole = {name: torch.zeros((len(shards) * shard_rows, *shape), dtype=dtype,
                                       device=dev)
                     for name, (shape, dtype) in shapes.items()}
            fields["groups"].append((shards, whole))
            for i, s in enumerate(shards):
                for name, t in whole.items():
                    fields[name][s] = t[i * shard_rows : (i + 1) * shard_rows]
        return fields

    def _set_layout(self, fields: dict) -> None:
        self.shard_rows, self.col_block = fields["geometry"]
        self._groups: List[Tuple[List[int], Dict[str, torch.Tensor]]] = fields["groups"]
        self._shard = {name: fields.get(name) for name in _FIELDS}
        # The tensor-core kernels' copies of bf16 shards (tensor_core_refs).
        self._tc_shards: List[Optional[torch.Tensor]] = [None] * self.n_dev

    def _n_valid(self, s: int) -> int:
        return min(max(self.n_refs - s * self.shard_rows, 0), self.shard_rows)

    def _shards(self) -> List[Tuple[int, torch.device, int, int]]:
        """(index, device, base, valid rows) of every shard of this process
        holding a valid row, in mesh order."""
        return [(s, self.mesh.devices[s], s * self.shard_rows, self._n_valid(s))
                for s in self.mesh.local if self._n_valid(s)]

    def _write_rows(self, rows: np.ndarray, start: int) -> float:
        """Stage host rows as global rows [start, start + len(rows)) into
        this process's shards that own them (int8: quantized on the shard's
        device, a block at a time; L2: with their squared norms). Returns
        the largest row norm written over the mesh (``_max_row_norm``, its
        max over the ranks)."""
        norm_max, sr = 0.0, self.shard_rows
        for s in self.mesh.local:
            dev = self.mesh.devices[s]
            g0, g1 = max(start, s * sr), min(start + rows.shape[0], (s + 1) * sr)
            if g0 >= g1:
                continue
            block, at = rows[g0 - start : g1 - start], g0 - s * sr
            refs = self._shard["refs"][s]
            if self._int8:
                scale = self._shard["scale"][s]
                step = max(1, PLAIN_CHUNK_ELEMENTS // 4 // max(self.dim, 1))
                for i in range(0, block.shape[0], step):
                    codes, sc = _quantize(torch.from_numpy(block[i : i + step]).to(dev))
                    refs[at + i : at + i + codes.shape[0], : self.dim] = codes
                    scale[at + i : at + i + codes.shape[0]] = sc
                norm_max = max(norm_max, _max_row_norm(refs[at : at + block.shape[0]],
                                                       scale[at : at + block.shape[0]]))
                continue
            t = torch.from_numpy(block).to(dev)
            staged = refs[at : at + block.shape[0]]
            staged.copy_(t)
            if self._l2:
                self._shard["ref_sq"][s][at : at + block.shape[0]] = self._norms_of(t, staged)
            norm_max = max(norm_max, _max_row_norm(staged))
        return self._pmax(norm_max)

    def _move_rows(self, fields: dict, idx: np.ndarray) -> None:
        """Fill the new layout ``fields`` with the staged global rows
        ``idx`` (increasing) as its first rows, each field gathered on its
        owner shard and copied device to device; in a pod, rows whose new
        shard lies on another rank cross in one ``exchange`` a field."""
        new_rows, _ = fields["geometry"]
        ranks, me = self.mesh.ranks, process_index()
        # (new shard, old shard, its rows [p0, p1) of the new shard, the old
        # shard's local rows), in mesh order: every rank lists the same.
        blocks = []
        for s in range(self.n_dev):
            part = idx[s * new_rows : (s + 1) * new_rows]
            owner = part // self.shard_rows
            for o in np.unique(owner):
                p0, p1 = np.searchsorted(owner, [o, o + 1])
                blocks.append((s, int(o), int(p0), int(p1), part[p0:p1] - o * self.shard_rows))
        remote = [b for b in blocks if ranks[b[0]] != ranks[b[1]]]
        for name in _FIELDS:
            if self._shard[name] is None:
                continue
            old = self._shard[name]

            def rows(o, local):
                dev = self.mesh.devices[o]
                return old[o].index_select(0, torch.from_numpy(local).to(dev))

            for s, o, p0, p1, local in blocks:
                if ranks[s] == ranks[o] == me:
                    fields[name][s][p0:p1] = rows(o, local).to(self.mesh.devices[s])
            if not remote:
                continue
            send = {r: torch.cat([rows(o, local).to(self.mesh.lead)
                                  for s, o, _, _, local in remote
                                  if ranks[o] == me and ranks[s] == r])
                    for r in {ranks[s] for s, o, *_ in remote if ranks[o] == me}}
            recv = {}
            for s, o, p0, p1, _ in remote:
                if ranks[s] == me:
                    recv[ranks[o]] = recv.get(ranks[o], 0) + p1 - p0
            got = collectives.exchange(self.mesh, send, recv, old[self.mesh.local[0]])
            at = dict.fromkeys(got, 0)
            for s, o, p0, p1, _ in remote:
                if ranks[s] == me:
                    r = ranks[o]
                    fields[name][s][p0:p1] = got[r][at[r] : at[r] + p1 - p0].to(
                        self.mesh.devices[s])
                    at[r] += p1 - p0

    def _pmax(self, x: float) -> float:
        """The largest of the ranks' host floats ``x``, on every rank."""
        t = torch.tensor([x], dtype=torch.float64)
        return float(collectives.pmax(self.mesh, [t], t))

    def _norm_max(self) -> float:
        return self._pmax(max(
            [_max_row_norm(self._shard["refs"][s][:n],
                           None if self._shard["scale"] is None else self._shard["scale"][s][:n])
             for s, _, _, n in self._shards()], default=0.0))

    def append_rows(self, new_rows) -> None:
        """Grow the sharded corpus: only the new rows cross the host link.
        When the shards must grow, the resident rows move device to device
        onto the fresh-stage geometry, so searches are bit-identical to a
        full rebuild."""
        new_rows = _host_f32(new_rows)
        if new_rows.ndim != 2 or new_rows.shape[1] != self.dim:
            raise ValueError(f"rows must be [N, {self.dim}]; got {new_rows.shape}")
        start = self.n_refs
        geometry = self._geometry(start + new_rows.shape[0])
        if geometry != (self.shard_rows, self.col_block):
            fields = self._allocate(geometry)
            self._move_rows(fields, np.arange(start))
            self._set_layout(fields)
        self._tc_shards = [None] * self.n_dev
        self._ref_norm_max = max(self._ref_norm_max, self._write_rows(new_rows, start))
        self.n_refs = start + new_rows.shape[0]

    def keep_rows(self, keep_idx) -> None:
        """Shrink the sharded corpus to exactly these surviving rows: one
        gather per (new shard, old shard) pair, device to device, onto the
        fresh-stage geometry; only the index vector crosses."""
        keep_idx = _check_keep_idx(keep_idx, self.n_refs)
        fields = self._allocate(self._geometry(keep_idx.size))
        self._move_rows(fields, keep_idx)
        self._set_layout(fields)
        self.n_refs = int(keep_idx.size)
        self._ref_norm_max = self._norm_max()

    def staged_bytes(self) -> int:
        """Device bytes of this process's shards' fields and tensor-core
        copies."""
        tensors = [t for _, whole in self._groups for t in whole.values()]
        tensors += [t for s, t in enumerate(self._tc_shards)
                    if t is not None and t is not self._shard["refs"][s]]
        return sum(t.numel() * t.element_size() for t in tensors)

    def shard_refs(self, s: int) -> torch.Tensor:
        """Shard s's rows as its kernels read them (``tensor_core_refs``
        of the shard)."""
        if not self._tensor_cores:
            return self._shard["refs"][s]
        if self._tc_shards[s] is None:
            self._tc_shards[s] = kernels.pad_columns(self._shard["refs"][s])
        return self._tc_shards[s]

    def _shard_kw(self, s: int) -> dict:
        """Shard s's corpus keyword arguments (``_corpus_kw``)."""
        return self._corpus_kw(**{name: self._shard[name][s] for name in ("scale", "ref_sq")
                                  if self._shard[name] is not None})

    # ---- the kernel calls, on every shard ----------------------------------

    @staticmethod
    def _copied(copies: dict, dev: torch.device, tensors) -> tuple:
        """``tensors`` (or dicts of them) on ``dev``, copied once per device
        (``copies`` keeps them) without blocking."""
        if dev not in copies:
            copies[dev] = tuple(
                {k: v.to(dev, non_blocking=True) for k, v in t.items()}
                if isinstance(t, dict) else t.to(dev, non_blocking=True)
                for t in tensors)
        return copies[dev]

    def _per_shard(self, fn, *tensors):
        """``fn(s, base, n_valid, *tensors on the shard's device)`` for every
        shard of this process holding a valid row, in mesh order."""
        copies: dict = {}
        out = []
        for s, dev, base, n in self._shards():
            with on_device(dev):
                out.append(fn(s, base, n, *self._copied(copies, dev, tensors)))
        return out

    def _runs(self) -> List[Tuple[torch.device, int, int, dict]]:
        """The valid rows of each of this process's allocations, in mesh
        order, for the dense f32 products (``_f32_scores``): (device, base,
        valid rows, {field: those rows}). Padding lies at the tail, so an
        allocation's valid rows are its first."""
        runs = []
        for shards, whole in self._groups:
            n = sum(self._n_valid(s) for s in shards)
            if n:
                runs.append((self.mesh.devices[shards[0]], shards[0] * self.shard_rows, n,
                             {name: t[:n] for name, t in whole.items()}))
        return runs

    def _per_run(self, fn, *tensors):
        """``fn(base, n_valid, fields, *tensors on the run's device)`` for
        every run of ``_runs``."""
        copies: dict = {}
        return [fn(base, n, views, *self._copied(copies, dev, tensors))
                for dev, base, n, views in self._runs()]

    def _empty(self, m: int, dtype=torch.float32, width: Optional[int] = 0) -> torch.Tensor:
        """A process's stand-in where it has no shard with a valid row:
        [m, width] (``width`` None: [m]) on the lead device."""
        shape = (m,) if width is None else (m, width)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _row_max(self, q_k, qkw):
        parts = self._per_shard(
            lambda s, base, n, q, kw: kernels.row_max(
                q, self.shard_refs(s), n, **self._shard_kw(s), **kw), q_k, qkw)
        return collectives.pmax(self.mesh, parts,
                                self._empty(q_k.shape[0], width=None).fill_(float("-inf")))

    def _fused_topk(self, q_k, kappa, qkw):
        def topk(s, base, n, q, kw):
            vals, ids = kernels.fused_topk(q, self.shard_refs(s), n, min(kappa, n),
                                           **self._shard_kw(s), **kw)
            return vals, ids + base

        parts = self._per_shard(topk, q_k, qkw)
        m = q_k.shape[0]
        vals = collectives.all_gather(self.mesh, [v for v, _ in parts], 1, self._empty(m))
        ids = collectives.all_gather(self.mesh, [i for _, i in parts], 1,
                                     self._empty(m, torch.int32))
        return kernels.ordered_topk(vals, ids, kappa)

    def _count_above(self, q_k, tau, qkw):
        parts = self._per_shard(
            lambda s, base, n, q, kw: kernels.count_above(
                q, self.shard_refs(s), tau, n, **self._shard_kw(s), **kw), q_k, qkw)
        return collectives.psum(self.mesh, parts,
                                self._empty(q_k.shape[0], torch.int32, None).zero_())

    def _pool(self, q_k, qkw):
        def pool(s, base, n, q, kw):
            vals, ids = kernels.pool_writer(q, self.shard_refs(s), n,
                                            **self._shard_kw(s), **kw)
            m = q.shape[0]
            return vals.view(m, -1), ids.view(m, -1) + base

        parts = self._per_shard(pool, q_k, qkw)
        m = q_k.shape[0]
        return (collectives.all_gather(self.mesh, [v for v, _ in parts], 1, self._empty(m)),
                collectives.all_gather(self.mesh, [i for _, i in parts], 1,
                                       self._empty(m, torch.int32)))

    def _merge_entries(self, parts):
        """The re-searches' (scores, rows, ref ids), concatenated over the
        shards and the ranks."""
        return tuple(collectives.all_gather(self.mesh, [p[j] for p in parts], 0,
                                            self._empty(0, dtype, None))
                     for j, dtype in enumerate((torch.float32, torch.int64, torch.int64)))

    def _scores_above(self, q_k, floor, capacity, qkw):
        def above(s, base, n, q, fl, kw):
            vals, rows, cols = kernels.scores_above(
                q, self.shard_refs(s), n, fl, capacity=capacity,
                **self._shard_kw(s), **kw)
            return vals, rows.long(), cols.long() + base

        return self._merge_entries(self._per_shard(above, q_k, floor, qkw))

    def _dense_above(self, rows, floor, q_sq):
        kw = {} if q_sq is None else {"q_sq": q_sq}

        def above(base, n, run, r, fl, kw):
            sc = self._goodness(_f32_scores(r, run["refs"], self.n_refs, base),
                                kw.get("q_sq"), run.get("ref_sq"))
            rr, cc = torch.nonzero(sc >= fl[:, None], as_tuple=True)
            return sc[rr, cc], rr, cc + base

        return self._merge_entries(self._per_run(above, rows, floor, kw))

    def _dense_scores(self, rows, q_sq):
        kw = {} if q_sq is None else {"q_sq": q_sq}

        def scores(base, n, run, r, kw):
            if self._tensor_cores or self._int8:
                sc = _widened_scores(r, run["refs"], run.get("scale"), n, self.dim)
            else:
                sc = _f32_scores(r, run["refs"], self.n_refs, base)
            return self._goodness(sc, kw.get("q_sq"), run.get("ref_sq"))

        return collectives.all_gather(self.mesh, self._per_run(scores, rows, kw), 1,
                                      self._empty(rows.shape[0]))

    # ---- routing -----------------------------------------------------------

    def _collection_mode(self, m: int, kappa: int) -> str:
        """"pooled" when each SHARD is at the scale where the pool wins
        (``POOL_MIN_CORPUS`` rows), its pool fits the budget and κ leaves
        the extraction room over the mesh's pools; "stream" otherwise, as
        the JAX sharded searcher routes. ``VSC2022_TORCH_COLLECTION``
        forces a mode ("pooled" still streams when the pool is
        infeasible)."""
        p_shard = SEG_KEEP * (self.shard_rows // SEG_LANES)
        pool_ok = (
            self.col_block % SEG_LANES == 0
            and p_shard >= SEG_KEEP
            and 8 * m * p_shard <= POOL_BYTES_BUDGET
            and 4 * kappa <= p_shard * self.n_dev
        )
        forced = os.environ.get(COLLECTION_ENV, "")
        if forced == "stream":
            return "stream"
        if forced == "pooled":
            return "pooled" if pool_ok else "stream"
        if pool_ok and self.shard_rows >= POOL_MIN_CORPUS:
            return "pooled"
        return "stream"
