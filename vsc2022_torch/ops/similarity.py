"""Exact brute-force similarity search over a staged reference matrix.

Counterpart of ``vsc2022_tpu/ops/similarity.py``: ``SimilaritySearcher``
with ``metric`` "IP" or "L2", ``precision`` "highest" or "default" and
``dtype`` "float32", "bfloat16" or "int8" (IP only, as in JAX). It ports
the contracts, not the TPU machinery.
``global_topk`` collects candidates in one of the JAX searcher's two
modes, routed as it routes them (``_collection_mode``):

* **stream** (corpora under ``POOL_MIN_CORPUS`` rows, or a pool over its
  memory budget): the ``fused_topk`` kernel gives each query row its
  top-κ of the winner pool; τ is the global k-th candidate (−inf when k
  exceeds the rows' κ candidates); the ``count_above`` kernel counts
  every row's corpus entries ≥ τ exactly; rows whose kept candidates ≥ τ
  fall short of that count are re-searched over the corpus.
* **pooled**:
  1. The ``pool_writer`` kernel builds the winner pool: the best 2 of
     every 128-column segment of every query row's scores.
  2. τ is the exact global k-th valid pool value (``torch.topk``). The
     true k-th corpus score is ≥ τ, so collecting every corpus entry ≥ τ
     is enough for the exact answer.
  3. Per row: the pool count ≥ τ, ``amb`` (segments whose both slots are
     ≥ τ — the only way a corpus entry ≥ τ can be missing from the pool)
     and the extracted top-κ.
  4. Rows with kept < pool count and ``amb == 0`` repair from the pool.
     Rows with ``amb > 0`` get an exact corpus count (the ``count_above``
     kernel); only a count above the row's pool count triggers an exact
     corpus re-search, and a count equal to
     the kept entries needs no repair at all. Never repair ``amb > 0``
     rows without that count prune.

Both end in the exact global cut: score descending, ties by (q, r)
ascending. The kernels of one dtype share one tile product, so both
collections compare bit-identical scores: the stream's candidates with
its counts, the pool with its count (f32: the CUDA cores' fmaf chain;
bf16 and int8: the tensor-core product, where both collections pad the
queries once and read ``tensor_core_refs``). A re-searched row's scores
come from that product too over a bf16 or int8 corpus
(``kernels.scores_above``: only the entries at or above the row's floor,
one launch over every re-searched row), and from a chunked
``torch.matmul`` over an f32 one; the search collects down to a rounding
margin below τ, since the f32 re-search may differ from the kernels' in
the last bits (over a bf16 or int8 corpus, where the re-search shares the
kernels' product, the margin is only defensive).

The corpus stages as the JAX searcher stages it: zero rows pad it to a
multiple of ``min(COL_BLOCK, N rounded up to 128)``, so the routing sees
the same padded sizes. ``append_rows`` and ``keep_rows`` grow and compact
it on the device onto exactly the layout a fresh stage gives.

``dtype="bfloat16"`` stages the corpus, and every query, in bf16 rounded
to nearest even (as ``ml_dtypes`` rounds for the JAX searcher): half the
device memory and bytes moved. Scores are bf16 × bf16 products with f32
accumulation, from the kernels' bf16 variants, the re-searches' included
(``kernels.scores_above``); ``row_topk`` widens both sides to f32 before
``torch.matmul``.

``dtype="int8"`` is the SQ8 tier (``quantize_rows_int8``): the corpus
stages as int8 codes, zero-padded to a multiple of 16 columns, with one
f32 scale per row, a quarter of f32's device memory and no f32 copy. The
queries stay f32. A score is (q · float(codes[j])) × scale[j] over the
dequantized corpus, from the kernels' int8 variants (the tensor cores:
three exact bf16 passes of the split queries over the widened codes,
then the scale once per score), the re-searches' included
(``kernels.scores_above``), so both collections compare bit-identical
scores.
``append_rows`` and ``keep_rows`` carry each row's scale with its codes.

``metric="L2"`` (FAISS's ``METRIC_L2``, f32 and bf16 storage): every score
is the goodness (2·q·r − ‖r‖²) − ‖q‖², the negated squared distance, so
"better" stays "larger" in every step above; callers get squared
distances (``row_topk``, ``row_nn``, ``global_topk``). ‖r‖² is staged once
per corpus row (``_ref_sq``: of the f32 rows, or of the bf16 rows widened
where the corpus is bf16, as JAX stages it; carried by ``append_rows`` and
``keep_rows``) and ‖q‖² taken per search from the staged queries, each by
``_row_sq`` (a fixed order of f32 operations, so a row's value depends on
nothing but the row). The kernels' L2 variants apply the expression to
their product's scores (``kernels`` ``ref_sq`` / ``q_sq``), the f32
re-search to ``torch.matmul``'s, with its margin re-derived for it.

``precision="default"`` is the JAX searcher's one bf16 pass per product
(XLA's DEFAULT on a TPU; the Pallas pool spells it out,
``pallas_kernels.py:315-320``). Over an f32 corpus the rows stage in bf16
(rounded to nearest even, no f32 copy on the device) and the queries stay
f32 until the product, which casts them to bf16 once: every product runs
on the bf16 kernels and the re-search on ``scores_above.bf16``. ‖r‖² and
‖q‖² still come from the f32 rows and queries, as JAX's do. Over a bf16
corpus "default" is "highest". Over int8 codes the f32 queries are rounded
to bf16 before the product, whose split then has zero mid and lo terms:
the three-pass product gives the one-pass one bit for bit.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from vsc2022_torch.device import DeviceLike, resolve_device
from vsc2022_torch.ops import kernels
from vsc2022_torch.ops.kernels import (
    PLAIN_CHUNK_ELEMENTS, SEG_KEEP, SEG_LANES,
)

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")

# Staging and routing constants at the JAX searcher's values
# (vsc2022_tpu/ops/similarity.py). The corpus pads to a multiple of its
# column block; the query rows to the JAX row-block plan.
COL_BLOCK = 8192
ROW_BLOCK = 16384
# Winner-pool memory budget (values + ids, bytes) and the device memory
# kept free for transients when the budget is measured.
POOL_BYTES_BUDGET = 3 << 30
POOL_HBM_RESERVE = 4 << 30
# Corpus floor for the pooled collection. Measured on a TPU v5e by the JAX
# package; not yet re-derived for the H100.
POOL_MIN_CORPUS = 1 << 18
# Forces a collection mode: "pooled" (still streams when the pool is
# infeasible) or "stream". The port's name for VSC2022_TPU_COLLECTION.
COLLECTION_ENV = "VSC2022_TORCH_COLLECTION"
# The re-search margin over a bf16 corpus (the tensor cores score), in
# units of the f32 one (``SimilaritySearcher._corpus_above`` derives it).
TENSOR_CORE_SLACK = 2.0
# The same over an int8 corpus, whose scores sum 3·D tensor-core addends
# (three bf16 passes): three times the bf16 one.
INT8_TENSOR_CORE_SLACK = 3 * TENSOR_CORE_SLACK
# The tensor-core re-search (``kernels.scores_above``): the entries a row
# may hold between its floor and τ beyond those the caller counted ≥ τ (its
# capacity's headroom), the bytes of one entry (score, row, column) and the
# entries one launch may hold: the 512 MB of a dense chunk of
# PLAIN_CHUNK_ELEMENTS scores.
ABOVE_HEADROOM = 64
ABOVE_ENTRY_BYTES = 12
ABOVE_BUDGET_ENTRIES = 4 * PLAIN_CHUNK_ELEMENTS // ABOVE_ENTRY_BYTES
# The query rows of every cuBLAS call of the f32 re-search (zero rows pad
# the last group). cuBLAS's f32 product sums each score in k order, the
# kernels' fmaf chain, at the searchers' shapes (on an H100 the row_max
# kernel equals torch.matmul's row max on 9,000 rows at D = 512 and 513),
# but a call of a few rows takes another algorithm: an 8-row chunk scored
# the same pairs a few ulps apart, and the two collections, which
# re-search different rows, returned different scores.
F32_RESEARCH_MIN_ROWS = 128
# The corpus rows of every cuBLAS call of the f32 re-search (fewer where
# the corpus is smaller). At phase 4's shape on an H100 (PERF.md) 65,536
# was the fastest of 8,192 (too few tiles a call for the card's SMs),
# 65,536, 262,144 and 1,048,576 (a wider block pads more corpus rows into
# the copy of a corpus's last, partial block).
F32_RESEARCH_COLS = 1 << 16


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _host_f32(x) -> np.ndarray:
    """A C-contiguous, writable f32 copy-if-needed of a host array."""
    return np.require(x, np.float32, ["C_CONTIGUOUS", "WRITEABLE"])


# The storage dtypes, by name.
STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}
METRICS = ("IP", "L2")
PRECISIONS = ("highest", "default")


def _f32_scores(rows: torch.Tensor, refs: torch.Tensor, n_refs: int,
                base: int = 0) -> torch.Tensor:
    """rows · refsᵀ in f32, [m, len(refs)], for ``refs`` the corpus rows
    [base, base + len(refs)) of a corpus of ``n_refs`` rows (bf16 rows
    widened). Every product is one ``torch.matmul`` of the same shape:
    F32_RESEARCH_MIN_ROWS query rows by ``_research_cols(n_refs)`` corpus rows,
    the corpus cut into blocks at multiples of that width from its first
    row, zero rows padding a block that ``refs`` covers in part and the
    last group of query rows (whose padded scores are not kept: the result
    holds ``m`` rows). cuBLAS picks its algorithm by the shape of
    the call, so a score depends only on its query row, its corpus row and
    the corpus size: a searcher that holds its corpus as one tensor and
    one that holds it as shards score every pair alike, bit for bit,
    wherever the shards begin."""
    m, n, d = rows.shape[0], refs.shape[0], rows.shape[1]
    g, w = F32_RESEARCH_MIN_ROWS, _research_cols(n_refs)
    rows = torch.cat([rows.float(), rows.new_zeros((_ceil_to(max(m, 1), g) - m, d),
                                                   dtype=torch.float32)])
    first, end = base // w, -(-(base + n) // w)
    out = rows.new_empty((m, (end - first) * w))
    for b in range(first, end):
        lo, hi = b * w - base, (b + 1) * w - base  # the block's rows of ``refs``
        if lo >= 0 and hi <= n:
            block = refs[lo:hi].float()
        else:
            block = refs.new_zeros((w, refs.shape[1]), dtype=torch.float32)
            block[max(lo, 0) - lo : min(hi, n) - lo] = refs[max(lo, 0) : min(hi, n)]
        cols = slice((b - first) * w, (b - first + 1) * w)
        for r in range(0, m, g):
            out[r : r + g, cols] = torch.matmul(rows[r : r + g], block.T)[: m - r]
    skip = base - first * w
    return out[:, skip : skip + n]


def _row_sq(rows: torch.Tensor) -> torch.Tensor:
    """Each row's squared L2 norm in f32 ([N]; bf16 rows widened): the sum
    over k, in order, of r[k]·r[k], one rounding per product and per sum.
    Elementwise torch operations in a fixed order, so a row's value
    depends on nothing but the row: not on the rows staged or searched
    with it, nor on the device."""
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for k in range(rows.shape[1]):
        col = rows[:, k].float()
        acc += col * col
    return acc


def _quantize(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SQ8 codes and scales of f32 rows [N, D], on their device: f32
    operations only, each correctly rounded (a division, a product and a
    round half to even), so every device gives the same bytes as numpy.
    The divisor 127 is a tensor on the device: on the GPU torch divides by
    a Python scalar as a product with its reciprocal, one rounding off."""
    if rows.shape[1] == 0:
        scale = rows.new_zeros(rows.shape[0])
    else:
        scale = rows.abs().amax(1) / rows.new_tensor(127.0)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    codes = torch.round(rows * inv[:, None]).clamp_(-127, 127).to(torch.int8)
    return codes, scale


def quantize_rows_int8(rows) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization (the FAISS SQ8 analog), as the
    JAX package quantizes: scale = max|row| / 127 in f32, inv = 1/scale (0
    where the scale is 0), codes = clip(rint(row · inv), −127, 127).
    Returns (codes [N, D] int8, scale [N] f32). Scores over the codes are
    defined over the dequantized rows: (q · codes[j]) × scale[j]. The
    searchers quantize the same way on their device, a block of rows at a
    time."""
    codes, scale = _quantize(torch.from_numpy(_host_f32(rows)))
    return codes.numpy(), scale.numpy()


def _widened_scores(q: torch.Tensor, codes: torch.Tensor, scale: Optional[torch.Tensor],
                    n_valid: int, dim: int) -> torch.Tensor:
    """q·rᵀ over the first ``n_valid`` rows of a bf16 corpus or of int8
    codes in f32: the rows widened a block at a time (no f32 copy of the
    corpus), ``torch.matmul``, then the codes' scales."""
    step = max(1, PLAIN_CHUNK_ELEMENTS // max(dim, 1))
    parts = []
    for c in range(0, n_valid, step):
        s = torch.matmul(q, codes[c : min(c + step, n_valid), :dim].float().T)
        parts.append(s if scale is None else s * scale[c : min(c + step, n_valid)])
    return torch.cat(parts, 1)


def _max_row_norm(rows: torch.Tensor, scale: Optional[torch.Tensor] = None) -> float:
    """The largest L2 row norm, taken in f32 (a bf16 tensor's own norm is
    bf16; int8 codes' norms times their scales: the dequantized rows'),
    chunked so that no f32 copy of a large corpus is made."""
    if rows.shape[0] == 0:
        return 0.0
    step = max(1, PLAIN_CHUNK_ELEMENTS // max(rows.shape[1], 1))
    norms = (rows[i : i + step].float().norm(dim=1) for i in range(0, rows.shape[0], step))
    if scale is not None:
        norms = (nrm * scale[i : i + step]
                 for i, nrm in zip(range(0, rows.shape[0], step), norms))
    return max(float(nrm.max()) for nrm in norms)


def _col_block(n_rows: int) -> int:
    return min(COL_BLOCK, _ceil_to(max(n_rows, 1), SEG_LANES))


def _research_cols(n_rows: int) -> int:
    """The corpus rows of one cuBLAS call of the f32 re-search of a corpus
    of ``n_rows`` rows (``_f32_scores``)."""
    return min(F32_RESEARCH_COLS, _ceil_to(max(n_rows, 1), SEG_LANES))


def _padded_rows(nq: int) -> int:
    """The JAX searcher's staged query rows for nq queries: near-even row
    blocks of at most ROW_BLOCK rows, each a multiple of 8."""
    if nq <= ROW_BLOCK:
        return _ceil_to(max(nq, 1), 8)
    n_blocks = -(-nq // ROW_BLOCK)
    block = _ceil_to(-(-nq // n_blocks), 8)
    return _ceil_to(nq, block)


def _check_keep_idx(keep_idx, n_refs: int) -> np.ndarray:
    """Validate a ``keep_rows`` survivor-index vector: 1-D, strictly
    increasing, inside [0, n_refs)."""
    keep_idx = np.ascontiguousarray(keep_idx, dtype=np.int64)
    if keep_idx.ndim != 1:
        raise ValueError(f"keep_idx must be 1-D, got shape {keep_idx.shape}")
    if keep_idx.size:
        if keep_idx[0] < 0 or keep_idx[-1] >= n_refs:
            raise ValueError(
                f"keep_idx outside [0, {n_refs}): "
                f"{int(keep_idx[0])}..{int(keep_idx[-1])}"
            )
        if not np.all(np.diff(keep_idx) > 0):
            raise ValueError("keep_idx must increase strictly")
    return keep_idx


class _StepClock:
    """Host seconds between consecutive marks."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t, 6)
        self._t = now


def _empty_result():
    return (
        np.empty(0, dtype=np.int64),
        np.empty(0, dtype=np.int64),
        np.empty(0, dtype=np.float32),
    )


class SimilaritySearcher:
    """Brute-force searcher over a fixed reference matrix.

    The references are staged to ``device`` once, in ``dtype``
    ("float32", "bfloat16" or "int8": codes and scales), zero-padded to a
    multiple of min(COL_BLOCK, N rounded up to 128) rows, as the JAX
    searcher pads them; ``n_refs`` rows are valid. ``metric`` is "IP" or
    "L2" (squared distances out; f32 and bf16 storage only), ``precision``
    "highest" or "default" (one bf16 pass per product; module docstring).
    An f32 corpus at "default" stages in bf16 (``torch_dtype``) and keeps
    its queries f32 (``query_dtype``) until the product.
    """

    def __init__(
        self,
        refs,
        metric: str = "IP",
        precision: str = "highest",
        dtype: str = "float32",
        device: DeviceLike = "cuda",
    ):
        self._configure(dtype, device, metric, precision)
        refs = _host_f32(refs)
        if refs.ndim != 2:
            raise ValueError(f"refs must be [N, D]; got {refs.shape}")
        if self._int8:
            self.n_refs, self.dim = refs.shape
            self._stage_int8(self.n_refs)
            self._quantize_into(refs, 0)
            self._ref_norm_max = _max_row_norm(self._refs, self._scale)
            return
        refs_t = torch.from_numpy(refs)
        self.n_refs, self.dim = refs_t.shape
        n_pad = self._padded_refs(self.n_refs)
        self._refs = self._zeros(n_pad)
        rows = refs_t.to(self.device)
        # Rounded to bf16 (nearest even) on the device, in the copy.
        self._refs[: self.n_refs] = rows
        if self._l2:
            self._ref_sq = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
            self._ref_sq[: self.n_refs] = self._norms_of(rows, self._refs[: self.n_refs])
        self._ref_norm_max = _max_row_norm(self._refs)

    @classmethod
    def from_int8(cls, codes, scale, device: DeviceLike = "cuda",
                  precision: str = "highest") -> "SimilaritySearcher":
        """An int8 searcher over codes [N, D] int8 and their scales [N] f32
        taken as they are (not quantized again), e.g. a JAX int8
        searcher's valid rows; the layout a fresh int8 stage of rows with
        these codes gives."""
        self = cls.__new__(cls)
        self._configure("int8", device, "IP", precision)
        codes = np.require(codes, np.int8, ["C_CONTIGUOUS", "WRITEABLE"])
        scale = np.require(scale, np.float32, ["C_CONTIGUOUS", "WRITEABLE"])
        if codes.ndim != 2 or scale.shape != (codes.shape[0],):
            raise ValueError(f"codes {codes.shape} with scale {scale.shape}")
        self.n_refs, self.dim = codes.shape
        self._stage_int8(self.n_refs)
        self._refs[: self.n_refs, : self.dim] = torch.from_numpy(codes).to(self.device)
        self._scale[: self.n_refs] = torch.from_numpy(scale).to(self.device)
        self._ref_norm_max = _max_row_norm(self._refs, self._scale)
        return self

    def _configure(self, dtype: str, device: DeviceLike, metric: str,
                   precision: str) -> None:
        if dtype not in STORAGE_DTYPES:
            raise NotImplementedError(
                f"dtype={dtype!r} storage is not ported yet "
                "(float32, bfloat16 and int8 only)"
            )
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        if dtype == "int8" and metric != "IP":
            # As the JAX searcher asserts: the scales ride the ref_sq slot.
            raise NotImplementedError("int8 storage supports metric='IP' only")
        self.dtype, self.metric, self.precision = dtype, metric, precision
        self._l2 = metric == "L2"
        # Corpus staging dtype; the kernels' variant follows it (an f32
        # corpus at "default" stages in bf16). The queries stage in
        # query_dtype: f32 but over a bf16 corpus; the product casts them.
        self.torch_dtype = (torch.bfloat16 if (dtype, precision) == ("float32", "default")
                            else STORAGE_DTYPES[dtype])
        self._int8 = dtype == "int8"
        self.query_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.device = resolve_device(device)
        # int8: the per-row scales [N_pad] f32 (0 on the pad rows).
        self._scale: Optional[torch.Tensor] = None
        # L2: each staged row's squared norm [N_pad] f32 (0 on the pad rows).
        self._ref_sq: Optional[torch.Tensor] = None
        # The tensor-core kernels' copy of a bf16 corpus
        # (kernels.pad_columns), built on first use; dropped whenever the
        # corpus changes.
        self._tc_copy: Optional[torch.Tensor] = None
        self.last_stats: dict = {}

    def _norms_of(self, rows: torch.Tensor, staged: torch.Tensor) -> torch.Tensor:
        """The squared norms of rows as JAX stages them: of the f32 rows
        (``rows``) over an f32 corpus, at either precision; of the staged
        bf16 rows widened over a bf16 one."""
        return _row_sq(staged if self.dtype == "bfloat16" else rows)

    def _stage_int8(self, n_rows: int) -> None:
        """The zero int8 corpus of ``n_rows`` rows as it stages: codes rows
        padded with zero columns to a multiple of ``kernels.I8_ROW_ALIGN``
        (the int8 kernels' 16-byte copies) and zero rows to the padded row
        count, at scale 0."""
        n_pad = self._padded_refs(n_rows)
        self._refs = self._zeros(n_pad)
        self._scale = torch.zeros(n_pad, dtype=torch.float32, device=self.device)

    def _quantize_into(self, rows: np.ndarray, start: int) -> None:
        """Quantize f32 host rows on the device, a block at a time (no f32
        copy of the corpus stays there), into staged rows [start, start +
        len(rows))."""
        step = max(1, PLAIN_CHUNK_ELEMENTS // 4 // max(self.dim, 1))
        for i in range(0, rows.shape[0], step):
            block = torch.from_numpy(rows[i : i + step]).to(self.device)
            codes, scale = _quantize(block)
            at = start + i
            self._refs[at : at + block.shape[0], : self.dim] = codes
            self._scale[at : at + block.shape[0]] = scale

    def _zeros(self, n_rows: int) -> torch.Tensor:
        width = (kernels.padded_width(self.dim, kernels.I8_ROW_ALIGN)
                 if self._int8 else self.dim)
        return torch.zeros(
            (n_rows, width), dtype=self.torch_dtype, device=self.device
        )

    def staged_bytes(self) -> int:
        """Device bytes of the staged corpus: the rows (int8: the codes
        and the scales; L2: the squared norms) and the tensor-core copy, if
        one is held apart from the rows (at a D of a multiple of 8 the
        kernels read the staged rows themselves)."""
        copy = None if self._tc_copy is self._refs else self._tc_copy
        return sum(t.numel() * t.element_size()
                   for t in (self._refs, self._scale, self._ref_sq, copy)
                   if t is not None)

    @staticmethod
    def _padded_refs(n_rows: int) -> int:
        return _ceil_to(max(n_rows, 1), _col_block(n_rows))

    def append_rows(self, new_rows) -> None:
        """Grow the staged corpus: only the new rows cross to the device,
        landing right after the valid ones; the resident rows are copied
        device-side when the padding must grow. The result is the layout
        a fresh stage of all the rows gives."""
        new_rows = _host_f32(new_rows)
        if new_rows.ndim != 2 or new_rows.shape[1] != self.dim:
            raise ValueError(
                f"rows must be [N, {self.dim}]; got {new_rows.shape}"
            )
        start, total = self.n_refs, self.n_refs + new_rows.shape[0]
        n_pad = self._padded_refs(total)
        if n_pad > self._refs.shape[0]:
            refs = self._zeros(n_pad)
            refs[:start] = self._refs[:start]
            self._refs = refs
            if self._int8:
                self._scale = self._grown(self._scale, start, n_pad)
            if self._l2:
                self._ref_sq = self._grown(self._ref_sq, start, n_pad)
        if self._int8:  # new rows bring their own scales
            self._quantize_into(new_rows, start)
        else:
            rows = torch.from_numpy(new_rows).to(self.device)
            self._refs[start:total] = rows
            if self._l2:  # and their own squared norms
                self._ref_sq[start:total] = self._norms_of(rows, self._refs[start:total])
        self._ref_norm_max = max(
            self._ref_norm_max,
            _max_row_norm(self._refs[start:total],
                          None if self._scale is None else self._scale[start:total]),
        )
        self.n_refs = total
        self._tc_copy = None

    def _grown(self, vec: torch.Tensor, n_valid: int, n_pad: int) -> torch.Tensor:
        """A per-row f32 vector grown to n_pad rows, its first n_valid kept
        and the rest 0."""
        out = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
        out[:n_valid] = vec[:n_valid]
        return out

    def keep_rows(self, keep_idx) -> None:
        """Shrink the staged corpus to exactly these surviving rows
        (strictly increasing indices to KEEP), by one gather on the
        device: only the index vector crosses. The result is the layout a
        fresh stage of the survivors gives, zero padding included."""
        keep_idx = _check_keep_idx(keep_idx, self.n_refs)
        total = int(keep_idx.size)
        n_pad = self._padded_refs(total)
        refs = self._zeros(n_pad)
        idx = torch.from_numpy(keep_idx).to(self.device)
        refs[:total] = self._refs.index_select(0, idx)
        if self._int8:  # the scales compact with their rows
            self._scale = self._grown(self._scale.index_select(0, idx), total, n_pad)
        if self._l2:  # and the squared norms
            self._ref_sq = self._grown(self._ref_sq.index_select(0, idx), total, n_pad)
        self._refs, self.n_refs = refs, total
        self._ref_norm_max = _max_row_norm(refs, self._scale)
        self._tc_copy = None

    def _stage_queries(self, queries) -> torch.Tensor:
        """The queries on the device as contiguous rows of the query dtype
        (bf16 rounds to nearest even; an int8 corpus takes f32 queries); a
        tensor already there (e.g. bias-augmented queries) passes
        through."""
        if isinstance(queries, torch.Tensor):
            q = queries
        else:
            q = torch.from_numpy(_host_f32(queries))
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries must be [M, {self.dim}]; got {tuple(q.shape)}"
            )
        return q.to(self.device).to(self.query_dtype).contiguous()

    def _row_chunk(self) -> int:
        """Query rows per chunk of dense scores over the corpus (the f32
        re-search, ``row_topk``): the PLAIN_CHUNK_ELEMENTS budget's rows,
        at least one. Over an f32 corpus (``_f32_scores``, whose cuBLAS
        calls take F32_RESEARCH_MIN_ROWS query rows each) rounded down to
        whole groups of those rows where the budget holds one, so that no
        group but a chunk's last is padded: 134 rows, the budget at
        1,000,020 corpus rows, padded to two groups, cost half again the f32
        re-search's time. Each row's scores are independent of its chunk."""
        rows = max(1, PLAIN_CHUNK_ELEMENTS // max(self.n_refs, 1))
        if self._tensor_cores or self._int8 or rows < F32_RESEARCH_MIN_ROWS:
            return rows  # widened blocks take any rows; under a group, the budget's
        return rows - rows % F32_RESEARCH_MIN_ROWS

    # ---- per-row searches ------------------------------------------------

    @property
    def _tensor_cores(self) -> bool:
        """Whether the corpus is bf16 (its kernels read a copy of rows of a
        multiple of 8 values); int8 codes score on the tensor cores too, on
        the codes as staged."""
        return self.torch_dtype == torch.bfloat16

    def tensor_core_refs(self) -> torch.Tensor:
        """The staged corpus as the kernels read it: an f32 corpus and
        int8 codes (rows of a multiple of 16 values) as staged; a bf16
        one as the tensor-core product reads it, rows of a
        multiple of 8 values (``kernels.pad_columns``): the staged corpus
        itself when its D is one (serving's and SSCD's D = 512 cost no
        memory), else a zero-padded copy (the DnS corpus's D = 1025: 1,032
        columns), made on first use and kept until ``append_rows`` or
        ``keep_rows`` changes the corpus."""
        if not self._tensor_cores:
            return self._refs
        if self._tc_copy is None:
            self._tc_copy = kernels.pad_columns(self._refs)
        return self._tc_copy

    def _product_queries(self, q: torch.Tensor) -> torch.Tensor:
        """Staged queries as the product takes them: at "default" an f32
        query goes to bf16 once (over a bf16 corpus, its kernels' dtype;
        over int8 codes rounded and kept f32); as they are otherwise."""
        if self.precision != "default" or q.dtype != torch.float32:
            return q
        q = q.to(torch.bfloat16)
        return q if self._tensor_cores else q.float()

    def row_max(self, q: torch.Tensor) -> torch.Tensor:
        """Best score per row of staged queries (``_stage_queries``), on
        the device: the ``row_max`` kernel (under L2 the best goodness,
        i.e. minus the squared distance)."""
        return self._row_max(*self._query_operands(q))

    def row_nn(self, queries) -> np.ndarray:
        """Best score per row (k=1), e.g. for score normalization; the
        ``row_max`` kernel on the device. L2: the squared distance to the
        nearest row."""
        best = self.row_max(self._stage_queries(queries)).cpu().numpy()
        return -best if self._l2 else best

    def _goodness(self, s: torch.Tensor, q_sq: torch.Tensor,
                  ref_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scores s [m, n] of a chunk of rows against the first n staged
        rows as the kernels give them: under L2 the goodness (2·s − ‖r‖²)
        − ‖q‖² (``q_sq``: the chunk's; ``ref_sq``: the rows' squared norms,
        by default the staged corpus's), in place, each step one f32
        rounding as in the kernels."""
        if not self._l2:
            return s
        ref_sq = self._ref_sq if ref_sq is None else ref_sq
        return s.mul_(2.0).sub_(ref_sq[: s.shape[1]]).sub_(q_sq[:, None])

    def row_topk(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact per-row top-k: (scores [Nq, k], idx [Nq, k]), best-first,
        ties to the lower index (a chunked ``torch.matmul`` in f32, bf16
        rows and int8 codes widened, plus a stable sort). L2 scores are
        squared distances, ascending."""
        k = min(k, self.n_refs)
        q = self._stage_queries(queries)
        q_sq = _row_sq(q) if self._l2 else None
        q = self._product_queries(q).float()
        nq = q.shape[0]
        out_s = np.empty((nq, k), dtype=np.float32)
        out_i = np.empty((nq, k), dtype=np.int64)
        step = self._row_chunk()
        for start in range(0, nq, step):
            s = self._dense_scores(q[start : start + step],
                                   None if q_sq is None else q_sq[start : start + step])
            vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
            out_s[start : start + step] = vals[:, :k].cpu().numpy()
            out_i[start : start + step] = idx[:, :k].cpu().numpy()
        if self._l2:
            np.negative(out_s, out=out_s)  # goodness → squared distance
        return out_s, out_i

    # ---- global top-k ------------------------------------------------------

    def _plan(self, nq: int, k: int, kappa: Optional[int] = None):
        """Per-row candidate budget κ and the effective k (as the JAX
        searcher plans them)."""
        if kappa is None:
            kappa = max(32, math.ceil(1.5 * k / max(nq, 1)))
            kappa = 1 << (kappa - 1).bit_length()  # next power of two
        return min(kappa, self.n_refs), min(k, nq * self.n_refs)

    def _corpus_above(self, q_rows: torch.Tensor, tau: float, count: int,
                      q_sq: Optional[torch.Tensor] = None):
        """Every corpus entry ≥ τ of the given query rows, and a few below
        it: (scores, local row index, ref id), in no particular order.
        ``count``: the entries ≥ τ these rows hold as the kernels count
        them (the capacity hint of the tensor-core re-search). ``q_sq``:
        under L2 the rows' squared norms, as the kernels took them.

        The scores: over a bf16 or int8 corpus the kernels' own product
        (the tensor cores, on the card), as the JAX searcher re-searches
        with its collection's block product, so a re-searched pair scores
        as the kernels score it and both collections, which re-search
        different rows, rank every pair alike; over an f32 corpus
        ``torch.matmul``. A bf16 or int8 corpus takes
        ``kernels.scores_above``: one launch over all the rows keeps the
        entries at or above each row's floor and makes no dense score
        matrix (chunks of rows only where its capacity, ``count`` plus
        ABOVE_HEADROOM a row, would pass ABOVE_BUDGET_ENTRIES: τ = −inf
        keeps every entry). An f32 corpus scores chunks of rows densely and
        keeps the same entries (``_f32_scores``: cuBLAS calls of one shape).

        The margin: τ and the counts come from the kernels' scores, and a
        product that sums differently may round the same (q, r) product
        differently, so entries are kept down to a floor a margin below τ:
        no entry the kernels scored ≥ τ is lost, and the exact final cut
        drops the surplus. Two f32 sums of D exact products differ by at
        most 2·D·u·‖q‖·‖r‖ (u = 2⁻²⁴): the f32 margin, which the f32
        re-search needs. Over a bf16 or int8 corpus the re-search shares
        the kernels' product bit for bit, so its margin is only defensive:
        what a re-search by an f32 sum would need against the tensor
        cores. They add N exact products in blocks, each addend truncated
        to the block's largest exponent: at most 3·N·u·Σ|products| off the
        exact sum. Over bf16, N = D and Σ|products| ≤ ‖q‖·‖r‖: 3·D·u off
        the exact sum, 4·D·u·‖q‖·‖r‖ off an f32 sum, so TENSOR_CORE_SLACK
        (2) times the f32 margin. Over int8 the query is split into hi +
        mid + lo (|mid| ≤ 2⁻⁸|q|, |lo| ≤ 2⁻¹⁶|q| elementwise), so N = 3·D
        addends whose absolute values sum to at most (1 + 2⁻⁷)·‖q‖·‖r‖ (r
        the dequantized row, ``_ref_norm_max``: ‖codes‖ · scale):
        9·(1 + 2⁻⁷)·D·u off the exact sum, plus D·u for an f32 sum and one
        rounding for the scale (≤ D·u): 11.1·D·u·‖q‖·‖r‖ at most, under
        INT8_TENSOR_CORE_SLACK (6) times the f32 margin, 12·D·u. It costs
        only re-searched entries, which the final cut drops.

        Under L2 the kernels and the re-search compute g = (2·s − ‖r‖²) −
        ‖q‖² on the same ‖r‖² and ‖q‖² from products s, s' at most δ (the
        margin above) apart: 2·s and 2·s' are 2δ apart, and each of the two
        subtractions rounds its result once, by at most u times its
        magnitude, which is at most (‖q‖ + ‖r‖)² (1 + u) (|2·s − ‖r‖²| ≤
        2‖q‖‖r‖ + ‖r‖², |g| ≤ (‖q‖ + ‖r‖)²). So |g − g'| ≤ 2δ + 4u·(1 +
        u)·(‖q‖ + ‖r‖)², under the floor's L2 margin: twice the IP margin
        plus 4·eps·(‖q‖ + R)² (eps = 2u, R = ``_ref_norm_max``), twice that
        rounding term (``tests/test_torch_l2.py`` pins it with a stand-in
        kernel).
        """
        eps = float(torch.finfo(torch.float32).eps)
        slack = self.dim * eps * self._ref_norm_max
        if self._tensor_cores:
            slack *= TENSOR_CORE_SLACK
        elif self._int8:
            slack *= INT8_TENSOR_CORE_SLACK
        q_norm = q_rows.float().norm(dim=1)
        margin = slack * q_norm
        if self._l2:
            margin = 2.0 * margin + 4.0 * eps * (q_norm + self._ref_norm_max) ** 2
        floor = tau - margin
        parts_s, parts_q, parts_r = [], [], []
        if self._tensor_cores or self._int8:
            q_rows, qkw = self._query_operands(q_rows, q_sq)
            m = q_rows.shape[0]
            capacity = count + ABOVE_HEADROOM * m
            step = m if capacity <= ABOVE_BUDGET_ENTRIES else max(
                1, ABOVE_BUDGET_ENTRIES // self.n_refs)
            for start in range(0, m, step):
                rows = q_rows[start : start + step]
                cap = capacity if step == m else rows.shape[0] * self.n_refs
                s, rr, cc = self._scores_above(
                    rows, floor[start : start + step], cap,
                    self._rows_kw(qkw, slice(start, start + step)))
                parts_s.append(s)
                parts_q.append(rr.long() + start)
                parts_r.append(cc.long())
            return torch.cat(parts_s), torch.cat(parts_q), torch.cat(parts_r)
        step = self._row_chunk()
        for start in range(0, q_rows.shape[0], step):
            s, rr, cc = self._dense_above(
                q_rows[start : start + step], floor[start : start + step],
                None if q_sq is None else q_sq[start : start + step])
            parts_s.append(s)
            parts_q.append(rr + start)
            parts_r.append(cc)
        return torch.cat(parts_s), torch.cat(parts_q), torch.cat(parts_r)

    def _pool_budget_bytes(self, pool_bytes: int) -> int:
        """Winner-pool memory budget for a pool that needs ``pool_bytes``:
        the static budget, or, when the pool outgrows it on a GPU, the
        device's free memory now (the allocator's cached blocks included)
        less POOL_HBM_RESERVE for the transients."""
        if pool_bytes <= POOL_BYTES_BUDGET or self.device.type != "cuda":
            return POOL_BYTES_BUDGET
        free, _ = torch.cuda.mem_get_info(self.device)
        cached = (torch.cuda.memory_reserved(self.device)
                  - torch.cuda.memory_allocated(self.device))
        return max(POOL_BYTES_BUDGET, free + cached - POOL_HBM_RESERVE)

    def _collection_mode(self, m: int, kappa: int) -> str:
        """"pooled" or "stream" for an m-row (padded) query block, as the
        JAX searcher routes it: the pool when the corpus is large enough
        for it to win and the pool fits its budget and κ leaves the
        extraction room (4κ ≤ pool width); the stream otherwise.
        ``VSC2022_TORCH_COLLECTION=pooled|stream`` forces a mode ("pooled"
        still streams when the pool is infeasible)."""
        n_pad = self._refs.shape[0]
        p_total = SEG_KEEP * (n_pad // SEG_LANES)
        pool_bytes = 8 * m * p_total
        pool_budget = self._pool_budget_bytes(pool_bytes)
        pool_ok = pool_bytes <= pool_budget and 4 * kappa <= p_total
        forced = os.environ.get(COLLECTION_ENV, "")
        if forced == "stream":
            return "stream"
        if forced == "pooled":
            return "pooled" if pool_ok else "stream"
        if pool_ok and n_pad >= POOL_MIN_CORPUS:
            return "pooled"
        if n_pad >= POOL_MIN_CORPUS and pool_bytes > pool_budget:
            logger.warning(
                "pooled collection falls back to streaming: pool needs "
                "%.2f GiB for %d query rows (budget %.2f GiB); "
                "<=%d query rows per search would stay pooled",
                pool_bytes / 2**30, m, pool_budget / 2**30,
                pool_budget // (8 * p_total) if p_total else 0,
            )
        return "stream"

    def global_topk(
        self, queries, k: int, kappa: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact global top-k over all (query row, ref row) pairs.

        ``queries``: [M, D] host array, or a tensor (kept on the device).
        Returns (query_idx, ref_idx, score) sorted by score best-first,
        ties by (query_idx, ref_idx) ascending; L2 scores are squared
        distances (ascending).
        """
        nq = len(queries)
        if nq * self.n_refs == 0 or k <= 0:
            return _empty_result()
        kappa, k_eff = self._plan(nq, k, kappa)
        # Host seconds per step, read where the host waits for the device
        # anyway (each .item()-like pull synchronizes).
        clock = _StepClock()
        q = self._stage_queries(queries)
        clock.mark("stage_queries")
        mode, flat, stats = self._collect(q, kappa, k_eff, clock)
        clock.mark("repair")
        qi, ri, scores = self._final_cut(*flat, k_eff)
        if self._l2:
            np.negative(scores, out=scores)  # goodness → squared distance
        clock.mark("final_cut")
        self.last_stats = dict(mode=mode, kappa=kappa, **stats,
                               seconds=clock.seconds)
        logger.info("global_topk k=%d: %s", k_eff, self.last_stats)
        return qi, ri, scores

    def _collect(self, q: torch.Tensor, kappa: int, k_eff: int, clock):
        """(mode, flat, stats) of the collection mode routed for these
        staged query rows (``_collect_stream`` / ``_collect_pooled``). The
        IVF tier (ops/ivf.py) collects over its probed blocks here."""
        mode = self._collection_mode(_padded_rows(q.shape[0]), kappa)
        collect = self._collect_pooled if mode == "pooled" else self._collect_stream
        return (mode, *collect(q, kappa, k_eff, clock))

    def _query_operands(self, q: torch.Tensor, q_sq: Optional[torch.Tensor] = None):
        """(queries, keyword arguments) as a collection hands them to its
        kernels: the queries as the product takes them
        (``_product_queries``), over a bf16 corpus padded once, over an int8
        one padded once to the codes' width; under L2 with their squared
        norms (``q_sq``, else taken here from the staged queries). The
        corpus side is ``_corpus_kw`` and ``tensor_core_refs``. So the
        candidates and the counts score on one product."""
        kw = {"q_sq": _row_sq(q) if q_sq is None else q_sq} if self._l2 else {}
        q = self._product_queries(q)
        if self._tensor_cores:
            q = kernels.pad_columns(q)
        elif self._int8:
            q = kernels.pad_columns(q, kernels.I8_ROW_ALIGN)
        return q, kw

    def _corpus_kw(self, scale: Optional[torch.Tensor] = None,
                   ref_sq: Optional[torch.Tensor] = None) -> dict:
        """The corpus's keyword arguments to its kernels: under L2 the rows'
        squared norms, over int8 codes their scales (the staged corpus's,
        or those given: a shard's)."""
        if self._l2:
            return {"ref_sq": self._ref_sq if ref_sq is None else ref_sq}
        if self._int8:
            return {"scale": self._scale if scale is None else scale}
        return {}

    # ---- the kernel calls --------------------------------------------------
    # Every product a search runs goes through one of these, over the whole
    # staged corpus, with the query operands of ``_query_operands``
    # (``qkw``: their keyword arguments); the IVF tier's scans pass a block
    # list (``blocks``: the kernels' blocks= and col_block=).
    # ShardedSimilaritySearcher (vsc2022_torch/parallel) runs each on every
    # shard and merges.

    def _row_max(self, q_k: torch.Tensor, qkw: dict) -> torch.Tensor:
        return kernels.row_max(q_k, self.tensor_core_refs(), self.n_refs,
                               **self._corpus_kw(), **qkw)

    def _fused_topk(self, q_k: torch.Tensor, kappa: int, qkw: dict, **blocks):
        return kernels.fused_topk(q_k, self.tensor_core_refs(), self.n_refs, kappa,
                                  **self._corpus_kw(), **qkw, **blocks)

    def _count_above(self, q_k: torch.Tensor, tau: float, qkw: dict,
                     **blocks) -> torch.Tensor:
        return kernels.count_above(q_k, self.tensor_core_refs(), tau, self.n_refs,
                                   **self._corpus_kw(), **qkw, **blocks)

    def _pool(self, q_k: torch.Tensor, qkw: dict):
        """The winner pool as [M, P] values and ids (slot pairs adjacent
        per segment)."""
        pv, pi = kernels.pool_writer(q_k, self.tensor_core_refs(), self.n_refs,
                                     **self._corpus_kw(), **qkw)
        return pv.view(q_k.shape[0], -1), pi.view(q_k.shape[0], -1)

    def _scores_above(self, q_k: torch.Tensor, floor: torch.Tensor, capacity: int,
                      qkw: dict):
        """The tensor-core re-search: (scores, rows, ref ids) at or above
        each row's floor (``kernels.scores_above``)."""
        return kernels.scores_above(q_k, self.tensor_core_refs(), self.n_refs, floor,
                                    capacity=capacity, **self._corpus_kw(), **qkw)

    def _dense_above(self, rows: torch.Tensor, floor: torch.Tensor,
                     q_sq: Optional[torch.Tensor]):
        """The f32 re-search of a chunk of staged query rows: (scores, rows,
        ref ids) at or above each row's floor, from ``_f32_scores``."""
        s = self._goodness(_f32_scores(rows, self._refs[: self.n_refs], self.n_refs),
                           q_sq)
        rr, cc = torch.nonzero(s >= floor[:, None], as_tuple=True)
        return s[rr, cc], rr, cc

    def _dense_scores(self, rows: torch.Tensor, q_sq: Optional[torch.Tensor]):
        """``row_topk``'s scores of a chunk of f32 query rows against every
        valid row, [m, n_refs] (``_f32_scores``; bf16 rows and int8 codes
        widened a block at a time)."""
        if self._tensor_cores or self._int8:
            s = _widened_scores(rows, self._refs, self._scale if self._int8 else None,
                                self.n_refs, self.dim)
        else:
            s = _f32_scores(rows, self._refs[: self.n_refs], self.n_refs)
        return self._goodness(s, q_sq)

    @staticmethod
    def _rows_kw(kw: dict, rows) -> dict:
        """The keyword arguments of ``_query_operands`` for a subset of its
        query rows (under L2 their ``q_sq``)."""
        return {**kw, "q_sq": kw["q_sq"][rows]} if "q_sq" in kw else kw

    @staticmethod
    def _q_sq_of(kw: dict, rows) -> dict:
        """What ``_corpus_above`` takes besides its rows: under L2 (``kw``
        of ``_query_operands`` with ``q_sq``) those rows' ``q_sq``."""
        return {"q_sq": kw["q_sq"][rows]} if "q_sq" in kw else {}

    def _collect_stream(self, q: torch.Tensor, kappa: int, k_eff: int, clock,
                        scope=None):
        """The streaming collection: per-row top-κ candidates, τ, exact
        corpus counts for every row, and a corpus re-search of the rows
        whose candidates ≥ τ fall short of their count. Returns the
        (scores, query rows, ref ids) holding every entry that can make
        the cut, and the stats.

        ``scope``: the IVF tier's pruned scan (ops/ivf.py): the candidates
        over ``scope.candidates`` (a block list's keyword arguments), the
        counts over ``scope.counts(τ)`` (the blocks that can hold an entry
        ≥ τ, so the counts stay exact corpus counts), or None returned when
        that is None (τ = −inf)."""
        nq = q.shape[0]
        q_k, qkw = self._query_operands(q)
        top_s, top_i = self._fused_topk(q_k, kappa, qkw,
                                        **(scope.candidates if scope else {}))
        clock.mark("candidates")
        # τ is the global k-th candidate; with k beyond the rows' κ
        # candidates the true k-th is unknowable from them: −inf.
        if k_eff > nq * kappa:
            tau = NEG_INF
        else:
            tau = float(torch.topk(top_s.reshape(-1), k_eff).values[-1])
        counted = {}
        if scope is not None:
            counted = scope.counts(tau)
            if counted is None:
                return None
        counts = self._count_above(q_k, tau, qkw, **counted).long()
        above = (top_s >= tau) & torch.isfinite(top_s)
        kept = above.sum(1)
        # counts are exact corpus counts, so kept ≠ count flags exactly
        # the deficient rows (with τ = −inf every row is suspect, and a
        # row holding all its entries is complete).
        deficient = kept != counts
        clock.mark("tau_and_counts")
        keep = above & ~deficient[:, None]
        kq, kc = torch.nonzero(keep, as_tuple=True)
        parts_s, parts_q, parts_r = [top_s[kq, kc]], [kq], [top_i[kq, kc].long()]
        corpus_rows = torch.nonzero(deficient, as_tuple=True)[0]
        if corpus_rows.numel():
            cs, cq, cr = self._corpus_above(q[corpus_rows], tau,
                                            int(counts[corpus_rows].sum()),
                                            **self._q_sq_of(qkw, corpus_rows))
            parts_s.append(cs)
            parts_q.append(corpus_rows[cq])
            parts_r.append(cr)
        flat = (torch.cat(parts_s), torch.cat(parts_q), torch.cat(parts_r))
        return flat, {"tau": tau, "corpus_rows": int(corpus_rows.numel())}

    def _collect_pooled(self, q: torch.Tensor, kappa: int, k_eff: int, clock):
        """The pooled collection (module docstring, steps 1-4); returns
        what ``_collect_stream`` returns."""
        nq = q.shape[0]
        q_k, qkw = self._query_operands(q)
        pv, pi = self._pool(q_k, qkw)  # [nq, P]
        n_valid_pool = int((pv > NEG_INF).sum())
        clock.mark("pool")
        if n_valid_pool < k_eff:
            # Fewer valid pool entries than k: every row is suspect, so
            # every row is searched exactly (τ = −inf keeps everything).
            return self._corpus_above(q, NEG_INF, nq * self.n_refs,
                                      **self._q_sq_of(qkw, slice(None))), {
                "tau": NEG_INF, "corpus_rows": nq,
            }
        tau = float(torch.topk(pv.reshape(-1), k_eff).values[-1])
        clock.mark("tau")

        above = pv >= tau
        pool_counts = above.sum(1)
        amb = above.view(nq, -1, SEG_KEEP).all(2).sum(1)
        kx = min(kappa, pv.shape[1])
        top_s, sel = torch.topk(pv, kx, dim=1)
        top_i = torch.gather(pi, 1, sel)
        kept = (top_s >= tau).sum(1)
        flagged = (kept != pool_counts) | (amb > 0)

        ambiguous = flagged & (amb > 0)
        pool_repair = flagged & (amb == 0)
        corpus_rows = torch.empty(0, dtype=torch.long, device=q.device)
        corpus_count = 0
        amb_rows = torch.nonzero(ambiguous, as_tuple=True)[0]
        if amb_rows.numel():
            totals = self._count_above(q_k[amb_rows], tau,
                                       self._rows_kw(qkw, amb_rows)).long()
            complete = totals == kept[amb_rows]
            hidden = totals > pool_counts[amb_rows]
            pool_repair[amb_rows[~complete & ~hidden]] = True
            corpus_rows = amb_rows[hidden & ~complete]
            corpus_count = int(totals[hidden & ~complete].sum())
            flagged[amb_rows[complete]] = False  # pruned: nothing missing
        clock.mark("select_and_count")

        # Unflagged rows keep their extraction (entries ≥ τ only: the
        # rest can never make the cut).
        keep = (top_s >= tau) & ~flagged[:, None]
        kq, kc = torch.nonzero(keep, as_tuple=True)
        parts_s, parts_q, parts_r = [top_s[kq, kc]], [kq], [top_i[kq, kc].long()]
        pool_rows = torch.nonzero(pool_repair, as_tuple=True)[0]
        if pool_rows.numel():
            sub = pv[pool_rows]
            rr, cc = torch.nonzero(sub >= tau, as_tuple=True)
            parts_s.append(sub[rr, cc])
            parts_q.append(pool_rows[rr])
            parts_r.append(pi[pool_rows][rr, cc].long())
        if corpus_rows.numel():
            cs, cq, cr = self._corpus_above(q[corpus_rows], tau, corpus_count,
                                            **self._q_sq_of(qkw, corpus_rows))
            parts_s.append(cs)
            parts_q.append(corpus_rows[cq])
            parts_r.append(cr)
        flat = (torch.cat(parts_s), torch.cat(parts_q), torch.cat(parts_r))
        return flat, {
            "tau": tau,
            "flagged_rows": int(flagged.sum()),
            "amb_rows": int(amb_rows.numel()),
            "pool_repair_rows": int(pool_rows.numel()),
            "corpus_rows": int(corpus_rows.numel()),
        }

    def _map_ref_ids(self, flat_r: np.ndarray) -> np.ndarray:
        """Staged row ids as the caller's: the identity here; the IVF tier
        (ops/ivf.py) maps its cluster-contiguous rows back."""
        return flat_r

    def _final_cut(self, flat_s, flat_q, flat_r, k_eff: int):
        """Exact global sort and cut on the host: score descending, then
        (q, r) ascending on the caller's ids (``_map_ref_ids`` first)."""
        flat_s = flat_s.cpu().numpy()
        flat_q = flat_q.cpu().numpy().astype(np.int64)
        flat_r = self._map_ref_ids(flat_r.cpu().numpy().astype(np.int64))
        if k_eff < flat_s.size:
            tau = np.partition(flat_s, flat_s.size - k_eff)[flat_s.size - k_eff]
            keep = flat_s >= tau
            flat_s, flat_q, flat_r = flat_s[keep], flat_q[keep], flat_r[keep]
        order = np.lexsort((flat_r, flat_q, -flat_s))[:k_eff]
        return flat_q[order], flat_r[order], flat_s[order]
