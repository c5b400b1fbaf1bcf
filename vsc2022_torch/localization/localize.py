"""Host-side localization drivers over the batched TN alignment.

Counterpart of ``vsc2022_tpu/localization/localize.py`` (single-device
path; reference API: vsc/baseline/localization.py). The candidates'
query and ref frame rows are staged on the device as two tables (row 0
a zero pad row), each video once; candidate pairs are bucketed by padded
(query_len, ref_len) shape, each bucket gathers its rows from the
tables and its similarity matrices are one batched f32 matmul on the
device, and TN alignment runs over the whole batch (ops/tn_align.py).
``table_dtype="bfloat16"`` stores the reference tables in bf16 (the
serving default): their rows are widened to f32 as they are gathered,
before the similarity, so only the stored values round. Query tables stay
f32.

With ``mesh`` (``vsc2022_torch.parallel.Mesh``) each chunk of candidate
pairs splits into one tile of ⌈B/n⌉ pairs per mesh entry (JAX pads the
batch to the mesh multiple; here the last tiles are shorter): the tile's
rows are gathered onto the entry's device and its similarities and TN DP
run there, and the packed boxes merge on the lead device. Each pair's DP
is independent of the others, so the boxes are the unsplit batch's.
``shard_ref_table`` also row-shards the reference tables over the mesh
(``RowShardedTable``): a tile's rows come from the shards that own them,
copied whole, so the gathered rows and every similarity are bit-identical
to the unsharded ones.

Over a pod mesh (``Mesh.spans_processes``) every rank runs the same
alignment calls: a rank holds the reference rows of its own entries, the
tiles of a chunk run on the entries that own them (each rank its own),
a tile reads the rows other ranks hold through one collective a table and
chunk (``RowShardedTable.fetch``), and the chunk's packed boxes are
gathered so that every rank holds every match.

Box → Match conversion keeps reference semantics: boxes are inclusive
frame-index rectangles; query_start = get_timestamps(x1)[0],
query_end = get_timestamps(x2)[1] (reference:
vsc/baseline/localization.py:65-75).
"""

from __future__ import annotations

import abc
import contextlib
import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.metrics import CandidatePair, Match
from vsc2022_torch.ops.tn_align import TNParams, tn_align_packed
from vsc2022_torch.parallel import collectives
from vsc2022_torch.parallel.mesh import on_device, process_index
from vsc2022_torch.types import VideoFeature

logger = logging.getLogger(__name__)

# The reference tables' storage dtypes (the alignment reads raw
# similarities: an int8 search corpus keeps bf16 tables).
TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Per-chunk progress lines only matter on runs big enough to have
# waited for: single small calls (tests, per-pair probes) stay quiet.
_PROGRESS_MIN = 256


class RowShardedTable:
    """A device table of frame rows split by rows over a mesh (the JAX
    localizer's ``shard_ref_table``): its ``rows`` logical rows pad with
    zero rows to a multiple of the mesh size, and shard s holds rows
    [s·shard_rows, (s+1)·shard_rows) on entry s's device (the shards on
    one device views into one tensor). Offsets address rows absolutely,
    so the tail padding is invisible to every gather. In a pod a rank
    holds its own entries' shards (the others' are None)."""

    def __init__(self, mesh, rows: int, width: int, dtype: torch.dtype, fill):
        """``fill(wants)``: given, for each mesh entry, the global rows it
        holds (an index array; None where it holds none), the rows of this
        process's entries on their devices (``fetch``'s result)."""
        self.mesh, self.rows, self.dtype = mesh, rows, dtype
        self.shard_rows = -(-max(rows, 1) // mesh.size)
        devices = [mesh.devices[s] for s in mesh.local]
        count = {dev: devices.count(dev) for dev in dict.fromkeys(devices)}
        whole = {dev: torch.zeros((k * self.shard_rows, width), dtype=dtype, device=dev)
                 for dev, k in count.items()}
        taken = dict.fromkeys(count, 0)
        self.shards = [None] * mesh.size
        for s in mesh.local:
            dev = mesh.devices[s]
            i, taken[dev] = taken[dev], taken[dev] + 1
            self.shards[s] = whole[dev][i * self.shard_rows : (i + 1) * self.shard_rows]
        wants = []
        for s in range(mesh.size):
            g0, g1 = s * self.shard_rows, min(rows, (s + 1) * self.shard_rows)
            wants.append(np.arange(g0, g1) if g1 > g0 else None)
        for s, got in enumerate(fill(wants)):
            if got is not None:
                self.shards[s][: got.shape[0]] = got.to(dtype)

    @classmethod
    def of(cls, mesh, rows: torch.Tensor, dtype: torch.dtype) -> "RowShardedTable":
        """The table of ``rows`` (anywhere; every rank of a pod passes
        them all), stored in ``dtype`` (rounded on each shard's device)."""
        def fill(wants):
            return [None if w is None or not mesh.is_local(s)
                    else rows[int(w[0]) : int(w[-1]) + 1].to(mesh.devices[s])
                    for s, w in enumerate(wants)]

        return cls(mesh, rows.shape[0], rows.shape[1], dtype, fill)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.shards[self.mesh.local[0]].shape[1])

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    def _owned(self, flat: np.ndarray, device: torch.device) -> torch.Tensor:
        """This process's rows at the row indices ``flat`` (1-D, each held
        by one of its shards), on ``device``, in the stored dtype."""
        out = torch.zeros((flat.size, self.shape[1]), dtype=self.dtype, device=device)
        owner = flat // self.shard_rows
        for s in np.unique(owner):
            at = np.nonzero(owner == s)[0]
            view = self.shards[s]
            local = torch.from_numpy(flat[at] - s * self.shard_rows).to(view.device)
            out[torch.from_numpy(at).to(device)] = view.index_select(0, local).to(device)
        return out

    def gather(self, idx, device: torch.device) -> torch.Tensor:
        """Rows at the row indices ``idx`` (numpy, any shape) on ``device``,
        [*idx.shape, d] in the stored dtype: each shard hands over the rows
        it owns, copied whole (one process's shards: in a pod, rows cross
        ranks in ``fetch``)."""
        idx = np.asarray(idx, dtype=np.int64)
        return self._owned(idx.reshape(-1), device).view(*idx.shape, self.shape[1])

    def fetch(self, wants) -> list:
        """For each mesh entry s, the rows at its row indices ``wants[s]``
        (numpy, any shape; None for no rows) on entry s's device, [*shape,
        d] in the stored dtype, for this process's entries (None for the
        others'). In a pod every rank passes the same ``wants``, and the
        rows another rank holds cross in one ``exchange``."""
        mesh = self.mesh
        if not mesh.spans_processes:
            return [None if w is None else self.gather(w, mesh.devices[s])
                    for s, w in enumerate(wants)]
        me, ranks = process_index(), np.asarray(mesh.ranks)
        flat = [None if w is None else np.asarray(w, dtype=np.int64).reshape(-1)
                for w in wants]
        # The rank that holds each wanted row.
        holder = [None if f is None else ranks[f // self.shard_rows] for f in flat]
        send = {}
        for r in sorted(set(mesh.ranks) - {me}):
            rows = [f[h == me] for s, (f, h) in enumerate(zip(flat, holder))
                    if f is not None and ranks[s] == r]
            rows = np.concatenate(rows) if rows else np.empty(0, np.int64)
            if rows.size:
                send[r] = self._owned(rows, mesh.lead)
        recv = {}
        for s, (f, h) in enumerate(zip(flat, holder)):
            if f is not None and ranks[s] == me:
                for r in np.unique(h[h != me]):
                    recv[int(r)] = recv.get(int(r), 0) + int((h == r).sum())
        got = collectives.exchange(mesh, send, recv, self.shards[mesh.local[0]])
        at = dict.fromkeys(got, 0)
        out = [None] * mesh.size
        for s, (f, h, w) in enumerate(zip(flat, holder, wants)):
            if f is None or ranks[s] != me:
                continue
            dev = mesh.devices[s]
            rows = torch.zeros((f.size, self.shape[1]), dtype=self.dtype, device=dev)
            mine = np.nonzero(h == me)[0]
            if mine.size:
                rows[torch.from_numpy(mine).to(dev)] = self._owned(f[mine], dev)
            for r in np.unique(h[h != me]):
                r, pos = int(r), np.nonzero(h == r)[0]
                rows[torch.from_numpy(pos).to(dev)] = got[r][at[r] : at[r] + pos.size].to(dev)
                at[r] += pos.size
            out[s] = rows.view(*np.shape(w), self.shape[1])
        return out

    def append(self, new: torch.Tensor) -> "RowShardedTable":
        """The table grown by the rows ``new``, on the fresh layout of its
        new size: resident rows move shard to shard (rank to rank in a
        pod), only ``new`` comes in."""
        old, mesh = self.rows, self.mesh

        def fill(wants):
            resident = self.fetch([None if w is None or w[0] >= old else w[w < old]
                                   for w in wants])
            out = []
            for s, (w, rows) in enumerate(zip(wants, resident)):
                if w is None or not mesh.is_local(s):
                    out.append(None)
                    continue
                parts = [] if rows is None else [rows]
                if w[-1] >= old:
                    g0 = max(int(w[0]), old)
                    parts.append(new[g0 - old : int(w[-1]) + 1 - old].to(mesh.devices[s])
                                 .to(self.dtype))
                out.append(torch.cat(parts))
            return out

        return RowShardedTable(mesh, old + new.shape[0], self.shape[1], self.dtype, fill)

    def take(self, idx: np.ndarray) -> "RowShardedTable":
        """A table of the rows ``idx``, in that order, on the fresh layout
        of its size (the compaction)."""
        return RowShardedTable(self.mesh, idx.size, self.shape[1], self.dtype,
                               lambda wants: self.fetch([None if w is None else idx[w]
                                                         for w in wants]))


def gather_rows(table, idx, device=None) -> torch.Tensor:
    """[B, n_pad, d] rows of ``table`` (a tensor or a ``RowShardedTable``)
    at the [B, n_pad] row indices ``idx`` (numpy or torch), in its dtype,
    on ``device`` (default the table's)."""
    device = table.device if device is None else device
    if isinstance(table, RowShardedTable):
        return table.gather(torch.as_tensor(idx).cpu().numpy(), device)
    idx = torch.as_tensor(idx, device=table.device)
    rows = table.index_select(0, idx.reshape(-1)).view(*idx.shape, table.shape[1])
    return rows.to(device, non_blocking=True)


def _bucket(n: int, minimum: int = 32) -> int:
    """Round up to the next power of two (≥ minimum) for shape bucketing."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


class Localization(abc.ABC):
    @abc.abstractmethod
    def localize(self, candidate: CandidatePair) -> List[Match]:
        ...

    def localize_all(self, candidates: List[CandidatePair]) -> List[Match]:
        matches = []
        for candidate in candidates:
            matches.extend(self.localize(candidate))
        return matches


class LocalizationWithMetadata(Localization):
    def __init__(self, queries: List[VideoFeature], refs: List[VideoFeature]):
        self.queries = {m.video_id: m for m in queries}
        self.refs = {m.video_id: m for m in refs}


class TNLocalization(LocalizationWithMetadata):
    """Temporal-network localization, batched on the device.

    Accepts the reference's construction signature
    (model_type="TN", tn_max_step, min_length, concurrency,
    similarity_bias; reference: vsc/baseline/sscd_baseline.py:118-135).
    ``concurrency`` is accepted and ignored — batching replaces the CPU
    process pool.
    """

    # Max elements per batched similarity tensor (B·NQ·NR); bounds device
    # memory (the TN pass keeps a few tensors of this size alive). A
    # subclass whose similarity needs more live memory per element sets
    # a smaller one.
    sim_element_budget = 64 * 1024 * 1024

    def __init__(
        self,
        queries: List[VideoFeature],
        refs: List[VideoFeature],
        model_type: str = "TN",
        similarity_bias: float = 0.0,
        tn_max_step: int = 5,
        min_length: int = 4,
        concurrency: int = 0,
        min_sim: float = 0.2,
        top_k_per_row: int = 10,
        max_paths: int = 10,
        adaptive_sigma: float = 2.5,
        vcsl_faithful: bool = False,
        table_dtype: str = "float32",
        device: DeviceLike = "cuda",
        mesh=None,
        shard_ref_table: bool = False,
        **kwargs,
    ):
        """``mesh``: split each chunk of pairs over its entries (its lead
        device stands for ``device``); ``shard_ref_table``: also row-shard
        the reference tables over it (module docstring)."""
        super().__init__(queries, refs)
        if model_type != "TN":
            raise ValueError(f"Unsupported alignment model type: {model_type}")
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(f"Unsupported table_dtype: {table_dtype}")
        if shard_ref_table and mesh is None:
            raise ValueError("shard_ref_table requires a mesh")
        del concurrency, kwargs
        self.similarity_bias = similarity_bias
        # The storage dtype of the reference tables ("ref", "ref_fine").
        self._table_dtype = TABLE_DTYPES[table_dtype]
        self.mesh = mesh
        self._shard_ref_table = shard_ref_table
        self.device = mesh.lead if mesh is not None else resolve_device(device)
        # Device tables of frame rows by name: (table, {video: (start, n)}).
        self._tables: Dict[str, Tuple[torch.Tensor, Dict]] = {}
        if vcsl_faithful:
            self.params = TNParams.vcsl_faithful(
                max_step=tn_max_step, min_length=min_length,
                max_paths=max_paths,
            )
        else:
            self.params = TNParams(
                max_step=tn_max_step,
                min_length=min_length,
                max_paths=max_paths,
                min_sim=min_sim,
                top_k_per_row=top_k_per_row,
                adaptive_sigma=adaptive_sigma,
            )

    def _stage(self, name: str, source: Dict, video_ids: Sequence, row_fn=None):
        """The device table ``name`` of frame rows (row 0 a zero pad row
        for masked gathers; a ``RowShardedTable`` for a reference table
        under ``shard_ref_table``) and its per-video (start, n) offsets, holding
        at least the rows of ``video_ids``: the videos it lacks are
        appended, so each video's rows cross to the device once. Only the
        videos asked for are staged: a one-shot run localizes a few
        hundred pairs of a corpus that may hold a million frames.
        ``row_fn`` maps a VideoFeature to its [n, d] f32 rows (default:
        its features as f32; the DnS fine features rescale and flatten).
        Reference tables (names starting "ref") store their rows in the
        table dtype (bf16 rounds to nearest even), query tables in f32."""
        table, offsets = self._tables.get(name, (None, {}))
        missing = [v for v in dict.fromkeys(video_ids) if v not in offsets]
        if not missing:
            return table, offsets
        cursor = 1 if table is None else int(table.shape[0])
        rows = []
        for vid in missing:
            if row_fn is None:
                feat = np.asarray(source[vid].feature, dtype=np.float32)
            else:
                feat = row_fn(source[vid])
            offsets[vid] = (cursor, feat.shape[0])
            rows.append(feat)
            cursor += feat.shape[0]
        if table is None:
            rows.insert(0, np.zeros((1, rows[0].shape[1]), np.float32))
        dtype = self._table_dtype if name.startswith("ref") else torch.float32
        new = torch.from_numpy(np.concatenate(rows, axis=0))
        if name.startswith("ref") and self._shard_ref_table:
            table = (RowShardedTable.of(self.mesh, new, dtype) if table is None
                     else table.append(new))
            self._tables[name] = (table, offsets)
            return table, offsets
        new = new.to(self.device).to(dtype)
        table = new if table is None else torch.cat([table, new])
        self._tables[name] = (table, offsets)
        return table, offsets

    # -- serving lifecycle (JAX localize.py:266-336) -------------------------

    def set_queries(self, queries: List[VideoFeature]) -> None:
        """Replace the query set; the staged reference rows stay on the
        device, so each request moves only its own query rows."""
        self.queries = {m.video_id: m for m in queries}
        self._tables.pop("query", None)

    def add_refs(self, refs: List[VideoFeature]) -> None:
        """Extend the reference set (serving ``add``); a staged ref table
        grows on the device by the new videos' rows only."""
        for m in refs:
            self.refs[m.video_id] = m
        with self._or_drop("ref"):
            self._grow_table("ref", self.refs, [m.video_id for m in refs])

    def remove_refs(self, video_ids) -> None:
        """Drop reference videos (serving ``remove``); a staged ref table
        compacts on the device. Unknown ids raise before anything
        changes."""
        drop = set(video_ids)
        missing = [str(v) for v in drop if v not in self.refs]
        if missing:
            raise KeyError(f"Video ids not staged: {sorted(missing)[:5]}")
        for v in drop:
            del self.refs[v]
        with self._or_drop("ref"):
            self._compact_table("ref", self.refs)

    @contextlib.contextmanager
    def _or_drop(self, *names: str):
        """Drop the staged tables ``names`` if the block raises: the host
        dicts already hold the change, and the next alignment restages
        from them instead of serving a table whose offsets disagree."""
        try:
            yield
        except Exception:
            for name in names:
                self._tables.pop(name, None)
            raise

    def _grow_table(self, name: str, source: Dict, video_ids: Sequence,
                    row_fn=None) -> None:
        """Append these videos' rows to the staged table ``name`` (a
        re-added id's offsets move to its new rows; the old rows are dead
        weight until a compaction). Without a staged table there is
        nothing to do: alignment stages what it asks for."""
        if name not in self._tables:
            return
        offsets = self._tables[name][1]
        for vid in video_ids:
            offsets.pop(vid, None)
        self._stage(name, source, video_ids, row_fn)

    def _compact_table(self, name: str, source: Dict) -> None:
        """Keep only the staged rows of the videos still in ``source``:
        one gather on the device onto the layout a fresh staging in the
        same order gives (pad row 0, then each video's rows); only the
        index vector crosses."""
        if name not in self._tables:
            return
        table, offsets = self._tables[name]
        spans = [(offsets[vid], vid) for vid in offsets if vid in source]
        idx = np.concatenate(
            [np.zeros(1, dtype=np.int64)]
            + [np.arange(start, start + n) for (start, n), _ in spans]
        )
        new_offs = {}
        cursor = 1
        for (_, n), vid in spans:
            new_offs[vid] = (cursor, n)
            cursor += n
        if isinstance(table, RowShardedTable):
            self._tables[name] = (table.take(idx), new_offs)
            return
        flat = torch.from_numpy(idx).to(self.device)
        self._tables[name] = (table.index_select(0, flat), new_offs)

    def _pair_tables(self, candidates: Sequence[CandidatePair]):
        """Separate query and ref device tables holding the candidates'
        rows: (query table, offsets, ref table, offsets)."""
        return (
            *self._stage("query", self.queries, [c.query_id for c in candidates]),
            *self._stage("ref", self.refs, [c.ref_id for c in candidates]),
        )

    @staticmethod
    def _indices_from(offsets, video_ids: Sequence, n_pad: int):
        """[B, n_pad] row indices into one table (0 = pad row) and [B]
        lengths. Videos longer than the pad truncate (DnS: ragged fine vs
        coarse frame counts bucket by the coarse side)."""
        idx = np.zeros((len(video_ids), n_pad), dtype=np.int64)
        lengths = np.empty(len(video_ids), dtype=np.int32)
        for i, vid in enumerate(video_ids):
            start, n = offsets[vid]
            n = min(n, n_pad)
            idx[i, :n] = np.arange(start, start + n)
            lengths[i] = n
        return idx, lengths

    def _gather(self, table, idx: np.ndarray, device: torch.device = None) -> torch.Tensor:
        """[B, n_pad, d] f32 rows of ``table`` at ``idx``, gathered onto
        ``device`` (default the table's; a bf16 table's rows widened after
        the gather)."""
        return gather_rows(table, idx, device).float()

    def _tile_index(self, candidates: Sequence[CandidatePair], nq: int, nr: int):
        """The rows a tile of same-bucket pairs reads: ({table name: [B, n]
        row indices}, [B] query lengths, [B] ref lengths). Stages the
        tables it reads from."""
        _, q_offs, _, r_offs = self._pair_tables(candidates)
        q_idx, q_len = self._indices_from(q_offs, [c.query_id for c in candidates], nq)
        r_idx, r_len = self._indices_from(r_offs, [c.ref_id for c in candidates], nr)
        return {"query": q_idx, "ref": r_idx}, q_len, r_len

    def _batch_sims(
        self, candidates: Sequence[CandidatePair], nq: int, nr: int,
        device: torch.device = None, rows: Optional[Dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[B, nq, nr] biased similarity matrices of same-bucket pairs, on
        ``device`` (default the localizer's), from the tile's ``rows`` (a
        mesh's tile: ``_fetch_tiles``) or else rows gathered out of the
        staged tables."""
        device = self.device if device is None else device
        idx, q_len, r_len = self._tile_index(candidates, nq, nr)
        if rows is None:
            rows = {name: self._gather(self._tables[name][0], ix, device)
                    for name, ix in idx.items()}
        q, r = rows["query"].float(), rows["ref"].float()
        sims = torch.bmm(q, r.transpose(1, 2)) + float(self.similarity_bias)
        return (
            sims,
            torch.from_numpy(q_len).to(device),
            torch.from_numpy(r_len).to(device),
        )

    def _fetch_tiles(self, tiles, nq: int, nr: int) -> List[Optional[Dict]]:
        """A mesh's chunk: for each tile, the rows it reads ({table name:
        [B, n, d]} in the stored dtype, on its entry's device; None for a
        tile another rank runs). A row-sharded table hands its rows over in
        one ``fetch`` (in a pod, one collective that every rank calls
        alike); a whole table is gathered."""
        mesh = self.mesh
        indices = [self._tile_index(tile, nq, nr)[0] for tile in tiles]
        rows = [{} if mesh.is_local(i) else None for i in range(len(tiles))]
        for name in indices[0]:
            table = self._tables[name][0]
            wants = [ix[name] for ix in indices]
            if isinstance(table, RowShardedTable):
                got = table.fetch(wants + [None] * (mesh.size - len(tiles)))
            else:
                got = [gather_rows(table, w, mesh.devices[i]) if mesh.is_local(i) else None
                       for i, w in enumerate(wants)]
            for i, r in enumerate(got[: len(tiles)]):
                if r is not None:
                    rows[i][name] = r
        return rows

    def _align(self, chunk: Sequence[CandidatePair], nq: int, nr: int) -> np.ndarray:
        """The packed TN boxes of one chunk of same-bucket pairs; with a
        mesh, one tile of pairs per entry, each on its device, every tile
        launched before any is read. In a pod each rank runs its entries'
        tiles, and every rank receives every tile's boxes."""
        if self.mesh is None:
            sims, q_len, r_len = self._batch_sims(chunk, nq, nr)
            return tn_align_packed(sims, q_len, r_len, self.params).cpu().numpy()
        tile = -(-len(chunk) // self.mesh.size)
        tiles = [chunk[i * tile : (i + 1) * tile] for i in range(-(-len(chunk) // tile))]
        rows = self._fetch_tiles(tiles, nq, nr)
        packed = []
        for i, dev in enumerate(self.mesh.devices[: len(tiles)]):
            if not self.mesh.is_local(i):
                continue
            with on_device(dev):
                sims, q_len, r_len = self._batch_sims(tiles[i], nq, nr, dev, rows[i])
                packed.append(tn_align_packed(sims, q_len, r_len, self.params))
        empty = torch.zeros((0, self.params.max_paths, 6))
        return collectives.all_gather(self.mesh, packed, 0, empty).cpu().numpy()

    def localize_all(self, candidates: List[CandidatePair]) -> List[Match]:
        if candidates:  # one staging pass for all the call's chunks
            self._pair_tables(candidates)
        buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for idx, c in enumerate(candidates):
            qf = self.queries[c.query_id].feature
            rf = self.refs[c.ref_id].feature
            buckets[(_bucket(qf.shape[0]), _bucket(rf.shape[0]))].append(idx)

        matches: List[Match] = []
        done = 0
        for (nq, nr), idxs in sorted(buckets.items()):
            max_b = max(1, self.sim_element_budget // (nq * nr))
            for chunk_start in range(0, len(idxs), max_b):
                chunk = [
                    candidates[i] for i in idxs[chunk_start : chunk_start + max_b]
                ]
                matches.extend(self._finish_bucket(chunk, self._align(chunk, nq, nr)))
                done += len(chunk)
                if done < len(candidates) or done > _PROGRESS_MIN:
                    logger.info(
                        "%d/%d pairs aligned (%d predictions)",
                        done, len(candidates), len(matches),
                    )
        return matches

    def _finish_bucket(
        self, chunk: Sequence[CandidatePair], packed: np.ndarray
    ) -> List[Match]:
        boxes = packed[..., :4].astype(np.int32)
        valid = packed[..., 4] > 0.5
        box_scores = packed[..., 5]

        matches = []
        for bi, candidate in enumerate(chunk):
            query = self.queries[candidate.query_id]
            ref = self.refs[candidate.ref_id]
            for pi in range(boxes.shape[1]):
                if not valid[bi, pi]:
                    continue
                x1, y1, x2, y2 = (int(v) for v in boxes[bi, pi])
                matches.append(
                    Match(
                        query_id=candidate.query_id,
                        ref_id=candidate.ref_id,
                        query_start=query.get_timestamps(x1)[0],
                        query_end=query.get_timestamps(x2)[1],
                        ref_start=ref.get_timestamps(y1)[0],
                        ref_end=ref.get_timestamps(y2)[1],
                        score=self.score(candidate, float(box_scores[bi, pi])),
                    )
                )
        return matches

    def localize(self, candidate: CandidatePair) -> List[Match]:
        return self.localize_all([candidate])

    def score(self, candidate: CandidatePair, box_max_sim: float) -> float:
        return 1.0


class TNLocalizationMaxSim(TNLocalization):
    """Score = max similarity inside the box, bias-corrected
    (reference: vsc/baseline/localization.py:88-91)."""

    def score(self, candidate: CandidatePair, box_max_sim: float) -> float:
        return box_max_sim - self.similarity_bias


class TNLocalizationCandidateScore(TNLocalization):
    """Score = the candidate pair's retrieval score
    (reference: vsc/baseline/localization.py:94-96)."""

    def score(self, candidate: CandidatePair, box_max_sim: float) -> float:
        return candidate.score
