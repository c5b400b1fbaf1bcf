"""Frame-level video search index over the similarity searcher.

Counterpart of ``vsc2022_tpu/retrieval/index.py`` (reference:
vsc/index.py:74-177). Per-video features are flattened into one
frame-level corpus with side arrays mapping frame rows back to
(video_id, frame_idx); search returns frame matches regrouped per
(query video, ref video) pair.

The index grows and shrinks in place (``add`` and ``remove``, the
serving lifecycle): once a searcher is staged, new rows append on the
device and removed rows compact away there, onto exactly the layout a
fresh stage gives. ``ScoreNormalizedVideoIndex`` serves score-normalized
search from one staged corpus and noise corpus.

Search modes:
  * ``global_k >= 0``: global top-k over all query-frame × ref-frame
    pairs (the VSC-rules-conforming mode): scores comparable across
    queries, since µAP ranks one global list.
  * ``global_k < 0``: per-frame KNN with k = −global_k (against the VSC
    rules; provided for comparison, like the reference,
    vsc/index.py:108-117): the searcher's ``row_topk``.

``codec_str`` "Flat" (with ``dtype`` "float32", "bfloat16" or "int8"),
"SQ8" (``dtype="int8"``) and "IVF{nlist}[,Flat|SQ8]" (the exact pruned
tier, ``ops/ivf.py``; ",SQ8" stages int8; ``ivf_nprobe`` its probe
width), ``metric`` "IP" or "L2" (the score-normalized index and the IVF
tier: IP only, as in JAX), ``precision`` "highest" or "default", and
``mesh`` (the corpus sharded over a ``vsc2022_torch.parallel.Mesh``:
``ShardedSimilaritySearcher``; over a pod's mesh every rank holds the whole
host corpus and stages its own shards, and every rank's search returns the
same hits). An IVF codec with a mesh raises ``ValueError``, as in JAX:
sharding and pruning exclude each other; other codec strings raise
``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import re
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.ops.similarity import STORAGE_DTYPES, SimilaritySearcher
from vsc2022_torch.parallel.sharded_search import make_searcher
from vsc2022_torch.types import PairMatch, PairMatches, VideoFeature

logger = logging.getLogger(__name__)

SearchIndices = Tuple[int, int, float]


class VideoIndex:
    def __init__(
        self,
        dim: int,
        codec_str: str = "Flat",
        metric: str = "IP",
        precision: str = "highest",
        dtype: str = "float32",
        device: DeviceLike = "cuda",
        mesh=None,
        ivf_nprobe: Optional[int] = None,
    ):
        """``codec_str`` mirrors the reference's FAISS factory argument
        (reference: vsc/index.py:78): "Flat" is the exact search over the
        staged dtype, "SQ8" FAISS's 8-bit scalar quantizer, here per-row
        int8 storage (``dtype="int8"``: a quarter of f32's device memory,
        search exact over the dequantized corpus, IP only).
        "IVF{nlist}[,Flat|SQ8]" (e.g. "IVF1024,Flat") selects the pruned
        tier (``ops/ivf.py``): a k-means cluster-contiguous layout whose
        per-block score bounds let the candidate phase scan a block subset;
        unlike FAISS IVF the search stays exact, ties included.
        ``ivf_nprobe`` (FAISS sets nprobe at run time) tunes its speed,
        never its result.
        ``dtype="bfloat16"`` stores and searches the corpus in bf16
        (scores at bf16 resolution, f32 accumulation). ``metric`` "L2"
        scores by squared distance (lower is better), ``precision``
        "default" runs every product as one bf16 pass; both reach the
        searcher (``ops/similarity.py``). ``mesh``: an optional
        ``vsc2022_torch.parallel.Mesh`` to shard the reference corpus over
        (``parallel/sharded_search.py``); its lead device stands for
        ``device``."""
        self._ivf_nlist = None
        ivf = re.fullmatch(r"IVF(\d+)(?:,(Flat|SQ8))?", codec_str)
        if ivf:
            self._ivf_nlist = int(ivf.group(1))
            if ivf.group(2) == "SQ8":
                dtype = "int8"
        elif codec_str == "SQ8":
            dtype = "int8"
        elif codec_str != "Flat":
            raise ValueError(
                f"Unsupported codec {codec_str!r}: Flat (f32/bf16/int8), "
                "SQ8 (int8) or IVF{nlist}[,Flat|SQ8]"
            )
        if ivf and mesh is not None:
            raise ValueError(
                "IVF codecs are single-chip for now: shard the corpus "
                "(mesh) OR prune it (IVF), not both"
            )
        self._ivf_nprobe = ivf_nprobe
        if dtype not in STORAGE_DTYPES:
            raise NotImplementedError(
                f"dtype={dtype!r} storage is not ported yet "
                "(float32, bfloat16 and int8 only)"
            )
        self.dim = dim
        self.metric = metric
        self.precision = precision
        self.dtype = dtype
        self.mesh = mesh
        self.device = mesh.lead if mesh is not None else resolve_device(device)
        self.video_clip_idx: List[int] = []
        self.video_clip_to_video_ids: List[str] = []
        self.video_metadata = {}
        self._feature_blocks: List[np.ndarray] = []
        # Each add keeps its own block and metadata (a repeated id keeps
        # both blocks, like FAISS add; video_metadata holds the last).
        self._block_meta: List = []
        self._searcher: Optional[SimilaritySearcher] = None

    def add(self, db: List[VideoFeature]) -> None:
        """Append reference videos (repeatable, like FAISS add;
        reference: vsc/index.py:87-94). Before the first search this only
        records host blocks; once a searcher is staged, only the new rows
        cross to the device. If that append fails, the host bookkeeping
        already holds the rows: the staged searcher is dropped (the next
        search restages) and the error raised."""
        self._validate_add(db)
        new_blocks = []
        for vf in db:
            n = vf.feature.shape[0]
            self.video_clip_idx.extend(range(n))
            self.video_clip_to_video_ids.extend([vf.video_id] * n)
            self.video_metadata[vf.video_id] = vf.metadata()
            block = np.asarray(vf.feature, dtype=np.float32)
            self._feature_blocks.append(block)
            self._block_meta.append(vf.metadata())
            new_blocks.append(block)
        if self._searcher is not None and new_blocks:
            try:
                self._append_to_searcher(np.concatenate(new_blocks, axis=0))
            except Exception:
                self._searcher = None
                raise

    def remove(self, video_ids) -> int:
        """Drop reference videos (the FAISS ``remove_ids`` analog). A
        staged searcher compacts on the device onto the fresh-stage
        layout, so later searches equal those of an index built over the
        survivors. Returns the number of frame rows removed; unknown ids
        raise before anything changes."""
        drop = set(video_ids)
        missing = [str(v) for v in drop if v not in self.video_metadata]
        if missing:
            raise KeyError(f"Video ids not indexed: {sorted(missing)[:5]}")
        row_ids = np.asarray(self.video_clip_to_video_ids, dtype=object)
        keep_mask = ~np.isin(row_ids, list(drop))
        keep_idx = np.flatnonzero(keep_mask)
        n_removed = int(keep_mask.size - keep_idx.size)
        clip_idx = np.asarray(self.video_clip_idx, dtype=np.int64)
        self.video_clip_idx = [int(i) for i in clip_idx[keep_mask]]
        self.video_clip_to_video_ids = [v for v in row_ids[keep_mask]]
        for vid in drop:
            del self.video_metadata[vid]
        survivors = [
            (b, m)
            for b, m in zip(self._feature_blocks, self._block_meta)
            if m.video_id not in drop
        ]
        self._feature_blocks = [b for b, _ in survivors]
        self._block_meta = [m for _, m in survivors]
        if self._searcher is not None:
            try:
                self._remove_from_searcher(keep_idx)
            except Exception:
                # The host bookkeeping shrank consistently; the next
                # search restages.
                self._searcher = None
                raise
        return n_removed

    def features(self) -> List[VideoFeature]:
        """The indexed reference videos exactly as added (host features,
        add order: the corpus row order). Serving's ``save`` snapshots
        through this; restarting on the snapshot reproduces the index."""
        return [
            VideoFeature(
                video_id=meta.video_id,
                timestamps=meta.timestamps,
                feature=block,
            )
            for block, meta in zip(self._feature_blocks, self._block_meta)
        ]

    def _validate_add(self, db: List[VideoFeature]) -> None:
        """All-or-nothing validation before any state changes."""
        for vf in db:
            f = vf.feature
            if f.ndim != 2 or f.shape[1] != self.dim:
                raise ValueError(
                    f"Video {vf.video_id}: feature shape {f.shape} "
                    f"does not match index dimension {self.dim}"
                )

    def _append_to_searcher(self, new_rows: np.ndarray) -> None:
        self._searcher.append_rows(new_rows)

    def _remove_from_searcher(self, keep_idx: np.ndarray) -> None:
        self._searcher.keep_rows(keep_idx)

    def _corpus(self) -> np.ndarray:
        if self._feature_blocks:
            return np.concatenate(self._feature_blocks, axis=0)
        return np.zeros((0, self.dim), dtype=np.float32)

    def _get_searcher(self):
        if self._searcher is None:
            self._searcher = make_searcher(
                self._corpus(), self.mesh, self.device, metric=self.metric,
                precision=self.precision, dtype=self.dtype,
                ivf_nlist=self._ivf_nlist, ivf_nprobe=self._ivf_nprobe)
        return self._searcher

    def search(
        self,
        queries: List[VideoFeature],
        global_k: int,
    ) -> List[PairMatches]:
        if not queries:
            return []
        query_ids: List[str] = []
        query_indices: List[int] = []
        for q in queries:
            query_ids.extend([q.video_id] * len(q))
            query_indices.extend(range(len(q)))
        query_metadatas = {q.video_id: q.metadata() for q in queries}
        query_features = self._prep_query_features(
            np.concatenate([q.feature for q in queries])
        )

        t0 = time.perf_counter()
        self._get_searcher()  # stages the corpus on first use
        t1 = time.perf_counter()
        if global_k < 0:
            logger.warning(
                "Per-query KNN mode violates the VSC rules: it makes each "
                "query-ref prediction depend on the other references. "
                "Use it for comparison only; global-k is the conforming mode."
            )
            hits = self._knn_search(query_features, -global_k)
        else:
            hits = self._global_search(query_features, global_k)
        t2 = time.perf_counter()
        pair_nns = collections.defaultdict(list)
        for i, j, score in hits:
            query_id = query_ids[i]
            ref_id = self.video_clip_to_video_ids[j]
            match = PairMatch(
                query_timestamps=query_metadatas[query_id].get_timestamps(
                    query_indices[i]
                ),
                ref_timestamps=self.video_metadata[ref_id].get_timestamps(
                    self.video_clip_idx[j]
                ),
                score=score,
            )
            pair_nns[query_id, ref_id].append(match)
        logger.info(
            "search: stage corpus %.3f s, %s %.3f s, regroup %.3f s", t1 - t0,
            "row_topk" if global_k < 0 else "global_topk", t2 - t1,
            time.perf_counter() - t2,
        )
        return [
            PairMatches(query_id, ref_id, matches)
            for ((query_id, ref_id), matches) in pair_nns.items()
        ]

    def _prep_query_features(self, q: np.ndarray) -> np.ndarray:
        """Per-search query transform (identity here; the score-normalized
        index drops its dimension and L2-normalizes)."""
        return q

    def _global_search(
        self, query_features: np.ndarray, global_k: int
    ) -> Iterable[SearchIndices]:
        qi, ri, scores = self._get_searcher().global_topk(query_features, global_k)
        return zip(qi.tolist(), ri.tolist(), scores.tolist())

    @staticmethod
    def _yield_rows(scores: np.ndarray, ids: np.ndarray) -> Iterable[SearchIndices]:
        """(query row, ref row, score) of every entry of per-row results,
        row by row, best first."""
        for i in range(ids.shape[0]):
            for j in range(ids.shape[1]):
                yield (i, int(ids[i, j]), float(scores[i, j]))

    def _knn_search(
        self, query_features: np.ndarray, k: int
    ) -> Iterable[SearchIndices]:
        scores, ids = self._get_searcher().row_topk(query_features, k)
        return self._yield_rows(scores, ids)


class ScoreNormalizedVideoIndex(VideoIndex):
    """A persistent frame index whose searches are score-normalized on
    the device: the CSLS noise-NN bias rides an extra descriptor
    dimension (retrieval/score_norm.py semantics; reference:
    vsc/baseline/score_normalization.py:31-105), computed per search by
    the ``row_max`` kernel over the staged noise corpus.

    Built for resident serving (retrieval/serve.py): the reference and
    noise corpora stage once; each query batch pays only the bias and
    the search. The one-off transforms (the min-variance dimension drop
    chosen on the noise corpus, row L2 normalization) follow the
    reference exactly; their query side is applied per search.
    """

    def __init__(
        self,
        dim: int,
        noise_features: List[VideoFeature],
        beta: float = 1.2,
        l2_normalize: bool = True,
        replace_dim: bool = True,
        **kwargs,
    ):
        super().__init__(dim, **kwargs)
        from vsc2022_torch.retrieval.score_norm import (
            l2_normalize_rows,
            min_variance_dim,
        )

        if self.metric != "IP":
            raise ValueError(
                "Score-normalized search realizes the CSLS bias as an "
                "extra inner-product dimension; only metric='IP' is "
                f"meaningful (got {self.metric!r})"
            )
        self._l2 = l2_normalize_rows if l2_normalize else (lambda x: x)
        self.beta = beta
        noise_flat = np.concatenate(
            [np.asarray(f.feature, dtype=np.float32) for f in noise_features],
            axis=0,
        )
        self._noise_ids = {f.video_id for f in noise_features}
        if replace_dim:
            self._victim = min_variance_dim(noise_flat)
            logger.info(f"Dropping min-variance dimension {self._victim}")
            noise_flat = np.delete(noise_flat, self._victim, axis=1)
        else:
            self._victim = None
        self._noise_flat = self._l2(noise_flat)

    def _prep_query_features(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.float32)
        if self._victim is not None:
            q = np.delete(q, self._victim, axis=1)
        return self._l2(q)

    def _get_searcher(self):
        if self._searcher is None:
            from vsc2022_torch.retrieval.score_norm import check_independent_ids
            from vsc2022_torch.retrieval.sn_search import ScoreNormalizedSearcher

            check_independent_ids(self.video_metadata, self._noise_ids)
            self._searcher = ScoreNormalizedSearcher(
                self._prep_query_features(self._corpus()),
                self._noise_flat,
                beta=self.beta,
                precision=self.precision,
                dtype=self.dtype,
                device=self.device,
                mesh=self.mesh,
                ivf_nlist=self._ivf_nlist,
                ivf_nprobe=self._ivf_nprobe,
            )
        return self._searcher

    def _knn_search(
        self, query_features: np.ndarray, k: int
    ) -> Iterable[SearchIndices]:
        sn = self._get_searcher()
        scores, ids = sn.searcher.row_topk(sn.normalize_queries(query_features), k)
        return self._yield_rows(scores, ids)

    def _validate_add(self, db: List[VideoFeature]) -> None:
        from vsc2022_torch.retrieval.score_norm import check_independent_ids

        super()._validate_add(db)
        check_independent_ids((vf.video_id for vf in db), self._noise_ids)

    def _append_to_searcher(self, new_rows: np.ndarray) -> None:
        self._searcher.append_refs(self._prep_query_features(new_rows))

    def _remove_from_searcher(self, keep_idx: np.ndarray) -> None:
        self._searcher.keep_refs(keep_idx)

    # -- serving-side feature spaces -------------------------------------

    def localizer_ref_features(
        self, refs: List[VideoFeature]
    ) -> List[VideoFeature]:
        """Reference features in the score-normalized space the matching
        pipeline localizes in (dimension drop + L2 + the constant-1 CSLS
        dimension; reference: vsc/baseline/sscd_baseline.py:192-203)."""
        out = []
        for vf in refs:
            f = self._prep_query_features(vf.feature)
            f = np.concatenate([f, np.ones_like(f[:, :1])], axis=1)
            out.append(dataclasses.replace(vf, feature=f))
        return out

    def localizer_queries(
        self, queries: List[VideoFeature]
    ) -> List[VideoFeature]:
        """Query features in the same space (dimension drop + L2 + the
        −β·noise-NN bias dimension). Reuses the bias-augmented queries of
        the search just before when they cover these queries (the
        single-threaded serving pattern); recomputes them otherwise. The
        rows come back as f32 (a bf16 search's values widened exactly)."""
        sn = self._get_searcher()
        total = sum(len(q) for q in queries)
        q_dev = sn.last_q_sn
        if q_dev is not None and q_dev.shape[0] >= total:
            q_sn = q_dev[:total].float().cpu().numpy()
        else:
            flat = self._prep_query_features(
                np.concatenate([q.feature for q in queries], axis=0)
            )
            q_sn = sn.normalize_queries(flat).cpu().numpy()
        out = []
        offset = 0
        for q in queries:
            out.append(
                dataclasses.replace(q, feature=q_sn[offset : offset + len(q)])
            )
            offset += len(q)
        return out
