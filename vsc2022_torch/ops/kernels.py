"""The port's hand kernels: wrappers, plain versions, launch counts.

Counterpart of ``vsc2022_tpu/ops/pallas_kernels.py``. Each kernel is CUDA
C++ for sm_90a in ``ops/csrc`` (built by ``ops/_build.py`` at first use)
and comes with:

  * a wrapper (``row_max``, ``count_above``, ``pool_writer`` and
    ``fused_topk`` for the retrieval path, ``scores_above`` for its
    re-search over a bf16 or int8 corpus, ``scores`` for the dense
    product, ``chamfer_fine_sims`` for the DnS alignment) that, for
    a CUDA tensor, launches the kernel or raises, and for a CPU tensor
    runs the plain version. Nothing else selects the plain version: there
    is no fallback when a build or a launch fails;
  * a plain PyTorch version (``*_plain``) of the same function, a chunked
    ``torch.matmul`` / ``torch.bmm`` plus the reduction, with the
    kernel's tie rules;
  * a launch count in ``launches``, bumped by the wrapper where it
    launches its kernel and nowhere else.

The four retrieval kernels take f32 or bf16 operands (q and refs of one
dtype; the outputs stay f32 / int32). A bf16 pair launches the kernel's
bf16 variant, counted under ``<name>.bf16``: the counterpart of the
Pallas kernels' bf16 branch (one bf16 pass, f32 accumulation). A bf16
CUDA tensor never reaches the f32 kernel. Each dtype scores on one
product, which every kernel of that dtype shares, so the searcher's
collections compare their candidates with their counts bit for bit:

* f32: the CUDA cores' fmaf chain (``ops/csrc/reduce_gemm.cuh``, and
  ``tile_gemm.cuh`` for ``pool_writer``), one sequential sum per score.
* bf16: the tensor cores (``ops/csrc/wgmma_gemm.cuh``: TMA, wgmma, bf16
  in, f32 accumulation), for ``row_max``, ``count_above``,
  ``pool_writer`` and ``fused_topk`` alike, for ``scores``, which writes
  the product out, and for ``scores_above``, which keeps only the entries
  at or above a floor per row for the searchers' corpus re-search (bf16
  only: in f32 the re-search is ``torch.matmul``). The tensor cores sum in their
  own order: exact on integer inputs, within a few f32 roundings of the
  plain versions elsewhere, and equal to each other bit for bit (the
  pool's best winner is ``row_max``, its winners ordered are
  ``fused_topk``'s, its entries ≥ τ are what ``count_above`` counts
  wherever no segment hides one). Their rows hold a multiple of 8 values
  (``pad_columns``): the searchers keep a padded copy of a bf16 corpus
  (``SimilaritySearcher.tensor_core_refs``), and the wrappers pad
  whatever is not.

* int8 (SQ8 storage; ``<name>.int8``): f32 queries against int8 codes
  with one f32 scale per corpus row (``scale=``); a score is (q ·
  float(codes[j])) × scale[j]. The tensor-core product of
  ``wgmma_gemm.cuh`` with its int8 corpus policy, for all six kernels:
  each query row split exactly into three bf16 rows (``split_bf16x3``),
  three bf16 passes over the codes widened to bf16 in shared memory into
  one f32 sum, then the scale once per finished score, before the max,
  the count or the selection. Every product is exact, so the scores are
  exact on integer queries and within the tensor cores' summation error
  elsewhere; the six int8 kernels agree with each other bit for bit, and
  with unit scales and bf16-exact queries each equals its bf16 kernel on
  the widened codes (the mid and lo passes add zeros). Codes rows hold a
  multiple of 16 values (``pad_columns(codes, I8_ROW_ALIGN)``; the
  searchers stage them so), the queries as many (zero columns: the
  wrappers pad them).

The DnS chamfer takes f32 or bf16 region features (qf and rf of one
dtype; the output stays f32): f32 (precision "highest") runs ``chamfer``,
the CUDA cores' fmaf chain (``ops/csrc/chamfer.cu``); bf16 (precision
"default") runs ``chamfer.bf16``, the counterpart of the Pallas chamfer's
bf16 branch: TMA and ``wgmma`` on the tensor cores, exact bf16 products
summed in f32 in their own order, both chamfer reductions in registers
(``ops/csrc/chamfer_bf16.cu``, rows of a multiple of 8 values; its work
plan is ``chamfer_bf16_plan``).

* L2 (metric="L2"; ``<name>.l2`` and ``<name>.bf16.l2``): the f32 and bf16
  retrieval kernels and ``scores_above``'s bf16 kernel take ``ref_sq`` (the
  squared norm of each corpus row, [N] f32) and ``q_sq`` (of each query
  row, [M] f32), and each score of their product becomes the goodness
  (2·s − ref_sq[j]) − q_sq[i] in f32 and in that order (JAX's
  ``2.0 * s - rs - q_sq``), before the max, the count or the selection
  (``ops/csrc/l2_goodness.cuh``). The L2 kernels of one product agree with
  each other bit for bit, as the IP ones do; int8 codes take no L2.

* Block subsets (``blocks=``, ``col_block=``; ``<name>[.bf16|.int8].blocks``):
  ``count_above`` and ``fused_topk`` over a list of corpus blocks of
  ``col_block`` rows (ascending, distinct ids; an int32 tensor on q's
  device), the IVF tier's candidate and count passes (``ops/ivf.py``). The
  kernels walk the listed blocks' tiles in place (``ops/csrc/
  block_list.cuh``); ids and ``n_valid`` keep the whole corpus's numbering,
  and each result is the full-corpus kernel's on a corpus made of the listed
  blocks' rows, bit for bit. Inner product only (the IVF tier's metric).

No wrapper gives way from one variant to another.

The plain versions widen bf16 inputs and int8 codes to f32 before
``torch.matmul`` (whose bf16 product would round every score to bf16),
then multiply by the scales; they take the int8 queries in f32, unsplit.

The source notes in ``ops/csrc/*.cu`` say which TPU kernel each one
replaces, what bounds it on an H100 and what its design does about it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vsc2022_torch.ops import _build

SEG_LANES = 128  # columns per winner-pool segment
SEG_KEEP = 2  # entries the pool keeps per segment
# Query rows and ref columns of one work item of reduce_gemm.cuh (the f32
# row_max, count_above and fused_topk): 128 rows by one 128-column pool
# segment.
REDUCE_TILE = 128

# Query rows and corpus rows of one work item of the tensor-core product
# (wgmma_gemm.cuh: every bf16 and int8 kernel), and
# the query tiles of one group: a block walks a group's corpus tiles with
# the group's query tiles inner, so each corpus tile comes from HBM about
# once per group.
WGMMA_ROWS = 128
WGMMA_COLS = 256
WGMMA_GROUP = 8
# fused_topk.bf16's (and .int8's) κ-sets: in shared memory beside a
# 3-stage ring, which leaves room for groups of WGMMA_SMEM_SETS_GROUP query
# tiles and κ up to WGMMA_SMEM_SETS_KAPPA_MAX (1.6x faster than the other
# placement at the serving shape on an H100, PERF.md section 6), else in
# its [M, S, κ] output.
WGMMA_SMEM_SETS_GROUP = 2
WGMMA_SMEM_SETS_KAPPA_MAX = 38
# bf16 values per 16 bytes: TMA wants rows whose stride is a multiple.
ROW_ALIGN = 8
# int8 codes per 16 bytes: TMA wants codes rows of whole 16-byte pieces.
I8_ROW_ALIGN = 16

# Elements of one score chunk in the plain versions (512 MB of f32).
PLAIN_CHUNK_ELEMENTS = 1 << 27

# Ceiling on fused_topk's [M, S, κ] output: large κ takes a smaller grid.
TOPK_SCRATCH_BYTES = 1 << 30

# scores_above's capacity per query row when the caller gives none.
SCORES_ABOVE_ROW_CAPACITY = 256

# The retrieval kernels, each with a bf16 and an int8 variant.
RETRIEVAL_KERNELS = ("row_max", "count_above", "pool_writer", "fused_topk")
BF16 = ".bf16"  # suffix of a bf16 variant's launch count
INT8 = ".int8"  # suffix of an int8 variant's launch count
L2 = ".l2"  # suffix of an L2 variant's launch count (after the dtype's)
BLOCKS = ".blocks"  # suffix of a block-subset variant's (after the dtype's)

# The product written out (off the searchers' paths: the dense reference of
# scores_above), and the re-search's entries at or above a floor, over a
# bf16 and over an int8 corpus.
SCORES = "scores" + BF16
SCORES_INT8 = "scores" + INT8
SCORES_ABOVE = "scores_above" + BF16
SCORES_ABOVE_INT8 = "scores_above" + INT8
# The kernels whose bf16 and int8 variants run on the tensor cores
# (wgmma_gemm.cuh).
TENSOR_CORE_KERNELS = RETRIEVAL_KERNELS + ("scores", "scores_above")
# The int8 variants.
INT8_KERNELS = tuple(name + INT8 for name in TENSOR_CORE_KERNELS)

# The DnS chamfer over bf16 region features (precision="default").
CHAMFER_BF16 = "chamfer" + BF16

# The L2 variants: the four retrieval kernels in f32 and bf16, and the
# re-search over a bf16 corpus.
L2_KERNELS = (tuple(name + L2 for name in RETRIEVAL_KERNELS)
              + tuple(name + BF16 + L2 for name in RETRIEVAL_KERNELS)
              + (SCORES_ABOVE + L2,))

# The block-subset variants: count_above and fused_topk in f32, bf16 and int8.
BLOCK_KERNELS = tuple(name + dtype + BLOCKS for name in ("count_above", "fused_topk")
                      for dtype in ("", BF16, INT8))

launches: Dict[str, int] = {
    **{name: 0 for name in RETRIEVAL_KERNELS}, "chamfer": 0,
    **{name + BF16: 0 for name in RETRIEVAL_KERNELS}, SCORES: 0, SCORES_ABOVE: 0,
    CHAMFER_BF16: 0,
    **{name: 0 for name in INT8_KERNELS},
    **{name: 0 for name in L2_KERNELS},
    **{name: 0 for name in BLOCK_KERNELS},
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _row_chunk(n_cols: int) -> int:
    return max(1, PLAIN_CHUNK_ELEMENTS // max(n_cols, 1))


# ---- plain versions -------------------------------------------------------


def _plain_scores(q: torch.Tensor, r: torch.Tensor,
                  scale: Optional[torch.Tensor],
                  ref_sq: Optional[torch.Tensor] = None,
                  q_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q·rᵀ in f32 (r widened), times the per-column ``scale`` (int8), or
    under L2 (``ref_sq`` per column, ``q_sq`` per row) the goodness
    (2·s − ref_sq) − q_sq, each step one f32 rounding, in place."""
    s = torch.matmul(q.float(), r.T)
    if ref_sq is not None:
        return s.mul_(2.0).sub_(ref_sq).sub_(q_sq[:, None])
    return s if scale is None else s * scale


def _rows(x: Optional[torch.Tensor], start: int, step: int) -> Optional[torch.Tensor]:
    """Rows [start, start + step) of an optional per-row vector."""
    return None if x is None else x[start : start + step]


def row_max_plain(q: torch.Tensor, refs: torch.Tensor, n_valid: int,
                  scale: Optional[torch.Tensor] = None,
                  ref_sq: Optional[torch.Tensor] = None,
                  q_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """max_j q·refs[j]ᵀ (× scale[j] for int8 codes; the L2 goodness with
    ``ref_sq`` and ``q_sq``) over j < n_valid, per row ([M] f32; −inf when
    n_valid == 0). Pad columns of refs past q's width are left out."""
    m, d = q.shape
    out = torch.full((m,), float("-inf"), dtype=torch.float32, device=q.device)
    if n_valid == 0:
        return out
    # bf16 and int8 widen (exactly); f32 is returned as is.
    r = refs[:n_valid, :d].float()
    sc = None if scale is None else scale[:n_valid]
    rs = None if ref_sq is None else ref_sq[:n_valid]
    step = _row_chunk(n_valid)
    for start in range(0, m, step):
        out[start : start + step] = _plain_scores(
            q[start : start + step], r, sc, rs, _rows(q_sq, start, step)).amax(1)
    return out


def block_rows(blocks: torch.Tensor, col_block: int, n_valid: int) -> torch.Tensor:
    """The corpus rows of the listed blocks (ids ascending, ``col_block``
    rows each) below n_valid, ascending ([R] int64 on the list's device)."""
    offsets = torch.arange(col_block, device=blocks.device)
    rows = (blocks.long()[:, None] * col_block + offsets).reshape(-1)
    return rows[rows < n_valid]


def _listed(refs: torch.Tensor, scale: Optional[torch.Tensor], rows: torch.Tensor):
    """(refs, scale) of the given corpus rows."""
    return refs[rows], None if scale is None else scale[rows]


def count_above_plain(
    q: torch.Tensor, refs: torch.Tensor, tau: float, n_valid: int,
    scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
    q_sq: Optional[torch.Tensor] = None, blocks: Optional[torch.Tensor] = None,
    col_block: Optional[int] = None,
) -> torch.Tensor:
    """Per-row count of q·refs[j]ᵀ (× scale[j] for int8 codes; the L2
    goodness with ``ref_sq`` and ``q_sq``) ≥ τ over j < n_valid ([M]
    int32); with ``blocks``, over the listed blocks' rows j < n_valid
    (``block_rows``). Pad columns of refs past q's width are left out."""
    if blocks is not None:
        rows = block_rows(blocks, col_block, n_valid)
        r, sc = _listed(refs, scale, rows)
        return count_above_plain(q, r, tau, rows.numel(), sc)
    m, d = q.shape
    out = torch.zeros((m,), dtype=torch.int32, device=q.device)
    if n_valid == 0:
        return out
    r = refs[:n_valid, :d].float()
    sc = None if scale is None else scale[:n_valid]
    rs = None if ref_sq is None else ref_sq[:n_valid]
    step = _row_chunk(n_valid)
    for start in range(0, m, step):
        s = _plain_scores(q[start : start + step], r, sc, rs, _rows(q_sq, start, step))
        out[start : start + step] = (s >= tau).sum(1, dtype=torch.int32)
    return out


def scores_plain(q: torch.Tensor, refs: torch.Tensor, n_valid: int,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q·refs[j]ᵀ (× scale[j] for int8 codes) for j < n_valid, [M,
    n_valid] f32 (bf16 and int8 widened). Pad columns of refs past q's
    width are left out."""
    return _plain_scores(q, refs[:n_valid, : q.shape[1]].float(),
                         None if scale is None else scale[:n_valid])


def scores_above_plain(q: torch.Tensor, refs: torch.Tensor, n_valid: int,
                       floor: torch.Tensor, scale: Optional[torch.Tensor] = None,
                       ref_sq: Optional[torch.Tensor] = None,
                       q_sq: Optional[torch.Tensor] = None):
    """Every (i, j < n_valid) whose score q·refs[j]ᵀ (bf16 and int8
    widened; × scale[j] for int8 codes; the L2 goodness with ``ref_sq``
    and ``q_sq``) is ≥ floor[i]: (scores [E] f32, rows [E] int32, cols [E]
    int32) in row-major order. ``scores_plain``, then ``nonzero``, chunked
    over rows. Pad columns of refs past q's width are left out."""
    r = refs[:n_valid, : q.shape[1]].float()
    sc = None if scale is None else scale[:n_valid]
    rs = None if ref_sq is None else ref_sq[:n_valid]
    parts_s, parts_r, parts_c = [], [], []
    step = _row_chunk(n_valid)
    for start in range(0, q.shape[0] if n_valid else 0, step):
        s = _plain_scores(q[start : start + step], r, sc, rs, _rows(q_sq, start, step))
        rr, cc = torch.nonzero(s >= floor[start : start + step, None], as_tuple=True)
        parts_s.append(s[rr, cc])
        parts_r.append((rr + start).int())
        parts_c.append(cc.int())
    if not parts_s:
        return _no_entries(q.device)
    return torch.cat(parts_s), torch.cat(parts_r), torch.cat(parts_c)


def _no_entries(device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.empty(0, dtype=torch.float32, device=device),
            torch.empty(0, dtype=torch.int32, device=device),
            torch.empty(0, dtype=torch.int32, device=device))


def _first_max(s3: torch.Tensor, lanes: torch.Tensor):
    """(max, lowest lane holding it) over the last axis."""
    best = s3.amax(2)
    lane = torch.where(s3 == best.unsqueeze(2), lanes, SEG_LANES).amin(2)
    return best, lane


def pool_writer_plain(
    q: torch.Tensor, refs: torch.Tensor, n_valid: int,
    scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
    q_sq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The winner pool: for every 128-column segment of q·refsᵀ (× scale
    per column for int8 codes; the L2 goodness with ``ref_sq`` and
    ``q_sq``), its best
    two entries (values best-first, then global column ids; ties to the
    lower column, columns ≥ n_valid at −inf). Returns ([M, N/128, 2] f32,
    [M, N/128, 2] int32). The id of a −inf slot is unspecified (here a
    column of its segment; the bf16 kernel writes 2³¹ − 1): only finite
    slots carry a column. Pad columns of refs past q's width are left
    out."""
    m, n = q.shape[0], refs.shape[0]
    n_seg = n // SEG_LANES
    vals = torch.empty((m, n_seg, SEG_KEEP), dtype=torch.float32, device=q.device)
    ids = torch.empty((m, n_seg, SEG_KEEP), dtype=torch.int32, device=q.device)
    lanes = torch.arange(SEG_LANES, dtype=torch.int16, device=q.device)
    seg_base = torch.arange(n_seg, dtype=torch.int32, device=q.device) * SEG_LANES
    refs = refs[:, : q.shape[1]].float()
    step = _row_chunk(n)
    for start in range(0, m, step):
        s = _plain_scores(q[start : start + step], refs, scale,
                          None if ref_sq is None else ref_sq[:n], _rows(q_sq, start, step))
        s[:, n_valid:] = float("-inf")
        s3 = s.view(s.shape[0], n_seg, SEG_LANES)
        m1, a1 = _first_max(s3, lanes)
        s3.scatter_(2, a1.long().unsqueeze(2), float("-inf"))
        m2, a2 = _first_max(s3, lanes)
        vals[start : start + step] = torch.stack([m1, m2], dim=2)
        ids[start : start + step] = torch.stack([a1, a2], dim=2).int() + seg_base[:, None]
    return vals, ids


def ordered_topk(
    vals: torch.Tensor, ids: torch.Tensor, kappa: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the κ best (value, id) entries of [M, W] candidates,
    ordered by value descending, then id ascending; rows with fewer than
    κ finite entries are padded with −inf and id 0. Two sorts: by id, then
    a stable sort by value."""
    m, w = vals.shape
    if w < kappa:
        vals = torch.cat([vals, vals.new_full((m, kappa - w), float("-inf"))], 1)
        ids = torch.cat([ids, ids.new_full((m, kappa - w), 2**31 - 1)], 1)
    ids, by_id = torch.sort(ids, dim=1)
    vals = torch.gather(vals, 1, by_id)
    vals, by_val = torch.sort(vals, dim=1, descending=True, stable=True)
    ids = torch.gather(ids, 1, by_val)
    vals, ids = vals[:, :kappa].contiguous(), ids[:, :kappa]
    return vals, torch.where(torch.isfinite(vals), ids, 0).int().contiguous()


def fused_topk_plain(
    q: torch.Tensor, refs: torch.Tensor, n_valid: int, kappa: int,
    scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
    q_sq: Optional[torch.Tensor] = None, blocks: Optional[torch.Tensor] = None,
    col_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-κ of the winner pool (``pool_writer_plain``'s: best 2
    per 128-column segment, columns ≥ n_valid at −inf), ordered by score
    descending, then column ascending: ([M, κ] f32, [M, κ] int32), padded
    with −inf and id 0. Any N (the pool zero-pads refs to whole segments).
    Pad columns of refs past q's width are left out; int8 codes take their
    ``scale``, L2 its ``ref_sq`` and ``q_sq``. With ``blocks`` (``col_block``
    a multiple of 128), the pool of the listed blocks' rows below n_valid
    (``block_rows``: whole segments but for the last), ids the corpus's."""
    if blocks is not None:
        rows = block_rows(blocks, col_block, n_valid)
        r, sc = _listed(refs, scale, rows)
        vals, ids = fused_topk_plain(q, r, rows.numel(), kappa, sc)
        if rows.numel() == 0:
            return vals, ids
        # The map is increasing: the (value, id) order holds.
        return vals, torch.where(torch.isfinite(vals), rows[ids.long()], 0).int()
    refs = refs[:, : q.shape[1]]
    n = refs.shape[0]
    n_seg = -(-n // SEG_LANES)
    if n_seg * SEG_LANES != n:
        pad = refs.new_zeros((n_seg * SEG_LANES - n, refs.shape[1]))
        refs = torch.cat([refs, pad])
        if scale is not None:
            scale = torch.cat([scale[:n], scale.new_zeros(n_seg * SEG_LANES - n)])
        if ref_sq is not None:
            ref_sq = torch.cat([ref_sq[:n], ref_sq.new_zeros(n_seg * SEG_LANES - n)])
    m = q.shape[0]
    vals, ids = pool_writer_plain(q, refs, n_valid, scale, ref_sq, q_sq)
    return ordered_topk(vals.view(m, -1), ids.view(m, -1), kappa)


def chamfer_fine_sims_plain(
    qf: torch.Tensor, rf: torch.Tensor, symmetric: bool = True
) -> torch.Tensor:
    """DnS chamfer [B, NQ, NR]: mean over query regions a of the max over
    ref regions c of ⟨qf[b, i, a], rf[b, j, c]⟩, averaged with mean_c
    max_a when ``symmetric``; no rescale. qf [B, NQ, R, D], rf
    [B, NR, R, D], f32 or bf16 (widened to f32: each product is the f32
    sum of the exact bf16 products). The XLA formulation of the JAX
    ``_chamfer_fuse``: one batched product [B, NQ·R, D] × [B, D, R·NR]
    (ref rows region-major), reshaped to [B, NQ, a, c, NR] and reduced,
    chunked over B."""
    b, nq, r, d = qf.shape
    nr = rf.shape[1]
    out = torch.empty((b, nq, nr), dtype=torch.float32, device=qf.device)
    # The mean is a sum divided by R, as in the kernel and XLA. R is a
    # tensor on the device: on the GPU, torch's mean and its division by
    # a Python scalar multiply by 1/R instead, one rounding apart.
    regions = torch.tensor(float(r), device=qf.device)
    step = max(1, PLAIN_CHUNK_ELEMENTS // max(nq * r * r * nr, 1))
    for s in range(0, b, step):
        q = qf[s : s + step].float().reshape(-1, nq * r, d)
        rr = rf[s : s + step].float().transpose(1, 2).reshape(-1, r * nr, d)
        p = torch.bmm(q, rr.transpose(1, 2)).view(-1, nq, r, r, nr)
        fg = p.amax(dim=3).sum(dim=2) / regions
        if symmetric:
            fg = (fg + p.amax(dim=2).sum(dim=2) / regions) / 2.0
        out[s : s + step] = fg
    return out


# ---- wrappers --------------------------------------------------------------


_OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def padded_width(d: int, align: int = ROW_ALIGN) -> int:
    """Columns of a row of ``d`` values padded to a multiple of ``align``."""
    return -(-d // align) * align


def pad_columns(x: torch.Tensor, align: int = ROW_ALIGN) -> torch.Tensor:
    """[N, D] rows as a contiguous, 16-byte-aligned [N, padded_width(D,
    align)] tensor whose columns past D are zero (zeros add nothing to a
    product); ``x`` itself when it is one already."""
    n, d = x.shape
    width = padded_width(d, align)
    if width == d and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((n, width))  # the allocator aligns to 512 bytes
    out[:, :d] = x
    return out


def _check(q: torch.Tensor, refs: torch.Tensor, n_valid: int,
           pad_ok: bool = False, scale: Optional[torch.Tensor] = None) -> None:
    """``pad_ok``: refs may also have padded_width(D) columns (int8 codes
    always may: padded_width(D, I8_ROW_ALIGN)). int8 codes take f32
    queries and their f32 ``scale`` [N]; every other pairing raises."""
    if q.device != refs.device:
        raise ValueError(f"q on {q.device}, refs on {refs.device}")
    int8 = refs.dtype == torch.int8
    if int8:
        if q.dtype != torch.float32:
            raise TypeError(f"int8 codes take f32 queries: got {q.dtype}")
        if scale is None:
            raise TypeError("int8 codes need their scale")
        if (scale.dtype != torch.float32 or scale.dim() != 1
                or scale.shape[0] != refs.shape[0] or scale.device != refs.device):
            raise ValueError(f"scale {tuple(scale.shape)} {scale.dtype} on "
                             f"{scale.device} for codes {tuple(refs.shape)}")
    else:
        if scale is not None:
            raise TypeError(f"scale goes with int8 codes only, not {refs.dtype}")
        if q.dtype not in _OPERAND_DTYPES or refs.dtype not in _OPERAND_DTYPES:
            raise TypeError(f"f32, bf16 or int8 codes only: got {q.dtype} and {refs.dtype}")
        if q.dtype != refs.dtype:
            raise TypeError(f"q and refs must share a dtype: got {q.dtype} and {refs.dtype}")
    align = I8_ROW_ALIGN if int8 else ROW_ALIGN
    if q.dim() != 2 or refs.dim() != 2 or (
        refs.shape[1] != q.shape[1]
        and not ((pad_ok or int8) and refs.shape[1] == padded_width(q.shape[1], align))
    ):
        raise ValueError(f"shapes {tuple(q.shape)} and {tuple(refs.shape)}")
    if not 0 <= n_valid <= refs.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [0, {refs.shape[0]}]")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        if not (q.is_contiguous() and refs.is_contiguous()):
            raise ValueError("the kernels take contiguous row-major tensors")
        if int8 and not scale.is_contiguous():
            raise ValueError("the kernels take a contiguous scale")
        if max(q.shape[0], refs.shape[0], q.shape[1]) >= 2**31:
            raise ValueError("dimensions must fit in int32")


def _check_l2(q: torch.Tensor, refs: torch.Tensor, ref_sq: Optional[torch.Tensor],
              q_sq: Optional[torch.Tensor]) -> bool:
    """Whether a call is L2: ``ref_sq`` [N] and ``q_sq`` [M] f32 on q's
    device, both given or neither; int8 codes take neither."""
    if ref_sq is None and q_sq is None:
        return False
    if ref_sq is None or q_sq is None:
        raise TypeError("L2 takes both ref_sq and q_sq")
    if refs.dtype == torch.int8:
        raise TypeError("int8 codes take no L2: inner product only")
    for name, t, n in (("ref_sq", ref_sq, refs.shape[0]), ("q_sq", q_sq, q.shape[0])):
        if t.dtype != torch.float32 or t.shape != (n,) or t.device != q.device:
            raise ValueError(f"{name} must be [{n}] f32 on {q.device}: got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if q.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"the kernels take a contiguous {name}")
    if q.device.type == "cuda" and ref_sq.data_ptr() % 8:
        raise ValueError("the kernels take an 8-byte aligned ref_sq (two columns a load)")
    return True


def _check_blocks(q: torch.Tensor, refs: torch.Tensor, blocks: torch.Tensor,
                  col_block: Optional[int], l2: bool) -> int:
    """Validate a block list (int32 [B] on q's device, ascending, distinct,
    each block holding a row of refs) and its ``col_block`` (a multiple of
    SEG_LANES; of WGMMA_COLS for the tensor-core kernels on the card, whose
    tile is that wide); returns col_block. Under L2 it raises: the block
    subsets take the inner product only, as the IVF tier does."""
    if l2:
        raise ValueError("block subsets take metric IP only (the IVF tier's)")
    if col_block is None:
        raise TypeError("blocks need their col_block")
    col_block = int(col_block)
    tensor_cores = q.device.type == "cuda" and (
        q.dtype == torch.bfloat16 or refs.dtype == torch.int8)
    align = WGMMA_COLS if tensor_cores else SEG_LANES
    if col_block <= 0 or col_block % align:
        raise ValueError(f"col_block {col_block} is not a positive multiple of {align}")
    if blocks.dtype != torch.int32 or blocks.dim() != 1 or blocks.device != q.device:
        raise ValueError(f"blocks must be [B] int32 on {q.device}: got "
                         f"{tuple(blocks.shape)} {blocks.dtype} on {blocks.device}")
    if blocks.numel():
        n_blocks = -(-refs.shape[0] // col_block)
        bad = (blocks[0] < 0) | (blocks[-1] >= n_blocks) | (blocks[1:] <= blocks[:-1]).any()
        if bool(bad):  # one sync
            raise ValueError(f"blocks must be ascending, distinct ids in [0, {n_blocks})")
    return col_block


def _l2_args(l2: bool, ref_sq: Optional[torch.Tensor], q_sq: Optional[torch.Tensor]):
    """(C name suffix, launch key suffix, the norms' pointers as the L2
    kernels take them after refs) of a call."""
    if not l2:
        return "", "", ()
    return "_l2", L2, (q_sq.data_ptr(), ref_sq.data_ptr())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")


# ---- the persistent schedule of row_max, count_above and fused_topk -------


def reduce_tiles(m: int, n_valid: int) -> Tuple[int, int]:
    """(row tiles, column tiles) of an [m, n_valid] call of a kernel of
    reduce_gemm.cuh; its work items are their product."""
    return -(-m // REDUCE_TILE), -(-n_valid // REDUCE_TILE)


def reduce_grid(m: int, n_valid: int, slots: int) -> int:
    """Blocks of one launch: one wave of the ``slots`` blocks the card
    holds at once, never more than the work items."""
    row_tiles, col_tiles = reduce_tiles(m, n_valid)
    return min(slots, row_tiles * col_tiles)


def block_ranges(items: int, grid: int) -> List[Tuple[int, int]]:
    """The contiguous ranges [b·W // grid, (b+1)·W // grid) of W work items
    that the blocks of a persistent ``grid``-block launch walk (both tile
    products): they tile the items in order and differ in length by at
    most one."""
    return [(b * items // grid, (b + 1) * items // grid) for b in range(grid)]


def reduce_schedule(m: int, n_valid: int, grid: int) -> List[Tuple[int, int]]:
    """The work items [begin, end) that each block of a ``grid``-block
    launch walks, as reduce_gemm.cuh computes them: items are numbered row
    tile major (row_tile · col_tiles + col_tile) and block b takes
    [b·W // grid, (b+1)·W // grid) of the W items, so the ranges tile the
    items in order and differ in length by at most one."""
    row_tiles, col_tiles = reduce_tiles(m, n_valid)
    return block_ranges(row_tiles * col_tiles, grid)


def topk_first_block(item: int, items: int, grid: int) -> int:
    """The block of a ``grid``-block launch over ``items`` work items whose
    range holds ``item``: the b with b·W // grid ≤ item < (b+1)·W // grid."""
    return ((item + 1) * grid - 1) // items


def topk_pieces(m: int, n_valid: int, grid: int) -> int:
    """S of a fused_topk launch: the most blocks whose ranges touch one row
    tile (1 when there is no work item). Block b writes its κ-sets of row
    tile rt into slot b − (the first block of rt) of [M, S, κ]."""
    row_tiles, col_tiles = reduce_tiles(m, n_valid)
    items = row_tiles * col_tiles
    if grid == 0 or items == 0:
        return 1
    return max(
        topk_first_block((rt + 1) * col_tiles - 1, items, grid)
        - topk_first_block(rt * col_tiles, items, grid) + 1
        for rt in range(row_tiles)
    )


def topk_grid(m: int, n_valid: int, kappa: int, grid: int) -> Tuple[int, int]:
    """(grid, S) of a fused_topk launch: the one-wave ``grid``, shrunk
    while its [M, S, κ] output would exceed TOPK_SCRATCH_BYTES."""
    pieces = topk_pieces(m, n_valid, grid)
    while grid > 1 and 8 * m * pieces * kappa > TOPK_SCRATCH_BYTES:
        grid -= 1
        pieces = topk_pieces(m, n_valid, grid)
    return grid, pieces


# ---- the work plan of the tensor-core product (wgmma_gemm.cuh) -----------


def wgmma_tiles(m: int, n_valid: int) -> Tuple[int, int]:
    """(query tiles, corpus tiles) of an [m, n_valid] call: 128 query rows
    by 256 corpus rows; its work items are their product."""
    return -(-m // WGMMA_ROWS), -(-n_valid // WGMMA_COLS)


def wgmma_item(i, m: int, n_valid: int, group_size: int = WGMMA_GROUP):
    """(group, query tile, corpus tile) of work item ``i`` (an int or an
    integer array), as wgmma_gemm.cuh ``item_at`` numbers them: groups of
    ``group_size`` query tiles (the last may hold fewer), then corpus
    tiles, then the group's query tiles."""
    q_tiles, c_tiles = wgmma_tiles(m, n_valid)
    per_group = c_tiles * group_size
    group = i // per_group
    local = i - group * per_group
    tiles = np.minimum(group_size, q_tiles - group * group_size)
    c_tile = local // tiles
    return group, group * group_size + (local - c_tile * tiles), c_tile


def wgmma_grid(m: int, n_valid: int, slots: int) -> int:
    """Blocks of one launch: one wave of ``slots``, at most the items."""
    q_tiles, c_tiles = wgmma_tiles(m, n_valid)
    return min(slots, q_tiles * c_tiles)


def pool_segments(n: int, n_valid: int) -> int:
    """Segments [0, s) of an [M, n/128, 2] pool that pool_writer.bf16's
    kernel writes: the two of each corpus tile its plan covers (the tiles
    of ``wgmma_tiles``, up to n_valid), at most n/128 (with n/128 odd the
    last tile's second segment lies past the pool). The wrapper fills the
    rest, [s, n/128), at −inf: they hold no valid column."""
    return min(2 * wgmma_tiles(1, n_valid)[1], n // SEG_LANES)


def wgmma_corpus_passes(m: int, n_valid: int, grid: int,
                        group_size: int = WGMMA_GROUP) -> float:
    """Corpus tiles the blocks of a ``grid``-block launch fetch, over the
    corpus tiles: a block fetches a tile when its item's corpus tile
    differs from its previous item's (consecutive items find it in L2).
    The row-tile-major order of reduce_gemm.cuh fetches the corpus once
    per query tile."""
    q_tiles, c_tiles = wgmma_tiles(m, n_valid)
    fetched = 0
    for begin, end in block_ranges(q_tiles * c_tiles, grid):
        _, _, c = wgmma_item(np.arange(begin, end), m, n_valid, group_size)
        fetched += int(np.count_nonzero(np.diff(c))) + int(end > begin)
    return fetched / c_tiles if c_tiles else 0.0


def wgmma_pieces(m: int, n_valid: int, grid: int,
                 group_size: int = WGMMA_GROUP) -> int:
    """S of a fused_topk.bf16 launch: the most blocks whose ranges touch
    one group (1 when there is no work item). Block b writes its κ-sets of
    a group's rows into slot b − (the block holding the group's first
    item) of [M, S, κ]. A group's items are contiguous, so each block
    touches it in one stretch."""
    q_tiles, c_tiles = wgmma_tiles(m, n_valid)
    items = q_tiles * c_tiles
    if grid == 0 or items == 0:
        return 1
    per_group = c_tiles * group_size
    return max(
        topk_first_block(min(g + per_group, items) - 1, items, grid)
        - topk_first_block(g, items, grid) + 1
        for g in range(0, items, per_group)
    )


def wgmma_topk_grid(m: int, n_valid: int, kappa: int, grid: int,
                    group_size: int = WGMMA_GROUP) -> Tuple[int, int]:
    """(grid, S) of a fused_topk.bf16 launch: the one-wave ``grid``,
    shrunk while its [M, S, κ] output would exceed TOPK_SCRATCH_BYTES."""
    pieces = wgmma_pieces(m, n_valid, grid, group_size)
    while grid > 1 and 8 * m * pieces * kappa > TOPK_SCRATCH_BYTES:
        grid -= 1
        pieces = wgmma_pieces(m, n_valid, grid, group_size)
    return grid, pieces


# Resident blocks per SM of each (kernel, device, occupancy arguments),
# from the CUDA occupancy calculator.
_resident: Dict[tuple, int] = {}


def _occupancy_slots(t: torch.Tensor, name: str, *args: int) -> int:
    """Blocks of kernel ``name`` (its C name) the card holds at once: SMs
    × ``vsc_<name>_occupancy(device, *args, &blocks)``."""
    key = (name, t.device.index, *args)
    if key not in _resident:
        blocks = ctypes.c_int(0)
        rc = getattr(_build.library(), f"vsc_{name}_occupancy")(
            t.device.index, *args, ctypes.addressof(blocks)
        )
        _raise_on(rc, name)
        if blocks.value < 1:
            raise RuntimeError(f"CUDA kernel {name} does not fit on an SM")
        _resident[key] = blocks.value
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return sms * _resident[key]


def _reduce_slots(t: torch.Tensor, name: str, vec: int) -> int:
    """Slots of a reduce_gemm.cuh kernel (e.g. ``count_above``) with
    16-byte copies if ``vec``."""
    return _occupancy_slots(t, name, vec)


def _wgmma_slots(t: torch.Tensor, name: str = "row_max_bf16", *args: int) -> int:
    """Slots of a kernel of the tensor-core product (wgmma_gemm.cuh), by
    its C name (``row_max_bf16``, ``count_above_bf16``,
    ``pool_writer_bf16``, ``scores_bf16``, ``fused_topk_bf16`` with its
    placement and κ)."""
    return _occupancy_slots(t, name, *args)


def _reduce_plan(name: str, q: torch.Tensor, refs: torch.Tensor,
                 n_valid: int) -> Tuple[int, int]:
    """(vec, grid) of a reduce_gemm.cuh launch of kernel ``name`` (its C
    name): 16-byte copies when a row is a whole number of 16-byte pieces
    (D % 4 == 0) and both bases are 16-byte aligned, 4-byte copies
    otherwise. One wave of blocks (0 when there is no work item)."""
    m, d = q.shape
    if d == 0:
        raise ValueError(f"{name}: the kernel takes D >= 1")
    vec = int(d % 4 == 0 and q.data_ptr() % 16 == 0 and refs.data_ptr() % 16 == 0)
    if n_valid == 0:
        return vec, 0
    return vec, reduce_grid(m, n_valid, _reduce_slots(q, name, vec))


def split_bf16x3(q: torch.Tensor) -> torch.Tensor:
    """f32 rows [M, D] as three bf16 rows each, [3, M, D] (hi, mid, lo),
    with hi + mid + lo == q exactly: hi = bf16(q), mid = bf16(q − hi),
    lo = bf16(q − hi − mid), each rounded to nearest even.

    Why exact: hi keeps the 8 leading significant bits of q, rounded, so
    |q − hi| ≤ 2⁻⁸·2ᵉ (2ᵉ ≤ |q| < 2ᵉ⁺¹) and q − hi is a multiple of
    2ᵉ⁻²³: an integer of at most 16 bits times 2ᵉ⁻²³, exact in f32
    (Sterbenz). mid rounds it to 8 bits the same way, leaving r − mid, an
    integer of at most 8 bits times 2ᵉ⁻²³, exact in f32 and in bf16, so
    lo loses nothing. This holds wherever bf16 has those exponents: every
    nonzero |q| in [2⁻¹¹⁰, 2¹²⁷) (below, the last bits would fall under
    bf16's smallest subnormal; above, hi could round to ±inf). The int8
    kernels' queries are embedding rows, far inside. Zero rows split into
    zeros; a bf16-exact q splits into (q, 0, 0), so its int8 scores are
    the bf16 product's. Elementwise torch: the product's preprocessing,
    once per call."""
    hi = q.to(torch.bfloat16)
    rest = q - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def _int8_operands(q: torch.Tensor, codes: torch.Tensor):
    """(split query terms [3, M, padded_width(D, I8_ROW_ALIGN)] bf16, int8
    codes of as many columns) as the int8 kernels take them (no copy of
    codes the searcher staged padded)."""
    if q.shape[1] == 0:
        raise ValueError("the int8 kernels take D >= 1")
    return split_bf16x3(pad_columns(q, I8_ROW_ALIGN)), pad_columns(codes, I8_ROW_ALIGN)


def _int8_grid(name: str, q: torch.Tensor, n_valid: int, *args: int) -> int:
    """One wave of blocks of the int8 kernel ``name`` (its C name, on the
    tensor-core product) over an [M, n_valid] call, 0 when there is no
    work item."""
    if n_valid == 0:
        return 0
    return wgmma_grid(q.shape[0], n_valid, _wgmma_slots(q, name, *args))


def row_max(q: torch.Tensor, refs: torch.Tensor, n_valid: int,
            scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
            q_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused q·refsᵀ row max over the first ``n_valid`` columns, [M] f32.
    A bf16 ``refs`` may carry ``pad_columns``' zero pad columns
    (padded_width(D) columns for q's D), as the searchers stage it; int8
    codes take their ``scale`` (scores q·codes[j] × scale[j]); ``ref_sq``
    and ``q_sq`` make it the max of the L2 goodness."""
    n_valid = int(n_valid)
    bf16 = q.dtype == torch.bfloat16
    _check(q, refs, n_valid, pad_ok=bf16, scale=scale)
    l2 = _check_l2(q, refs, ref_sq, q_sq)
    if q.device.type == "cpu":
        return row_max_plain(q, refs, n_valid, scale, ref_sq, q_sq)
    m, d = q.shape
    out = torch.empty((m,), dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    keys = torch.empty((m,), dtype=torch.int32, device=q.device)
    lib = _build.library()
    if refs.dtype == torch.int8:
        terms, refs = _int8_operands(q, refs)
        rc = lib.vsc_row_max_int8(
            q.device.index, terms.data_ptr(), refs.data_ptr(), scale.data_ptr(), m,
            refs.shape[0], refs.shape[1], n_valid, _int8_grid("row_max_int8", q, n_valid),
            keys.data_ptr(), out.data_ptr(), _stream(q),
        )
        _raise_on(rc, "row_max_int8")
        launches["row_max" + INT8] += 1
        return out
    sfx, key, norms = _l2_args(l2, ref_sq, q_sq)
    if bf16:
        if d == 0:
            raise ValueError("row_max_bf16: the kernel takes D >= 1")
        # Queries are padded per call (no copy when they are padded
        # already), refs only when the caller did not stage them padded.
        q, refs = pad_columns(q), pad_columns(refs)
        slots = _wgmma_slots(q, "row_max_bf16_l2") if l2 else _wgmma_slots(q)
        rc = getattr(lib, "vsc_row_max_bf16" + sfx)(
            q.device.index, q.data_ptr(), refs.data_ptr(), *norms, m, refs.shape[0],
            q.shape[1], n_valid, wgmma_grid(m, n_valid, slots), keys.data_ptr(),
            out.data_ptr(), _stream(q),
        )
        _raise_on(rc, "row_max_bf16" + sfx)
        launches["row_max" + BF16 + key] += 1
        return out
    vec, grid = _reduce_plan("row_max" + sfx, q, refs, n_valid)
    rc = getattr(lib, "vsc_row_max" + sfx)(
        q.device.index, q.data_ptr(), refs.data_ptr(), *norms, m, refs.shape[0], d,
        n_valid, vec, grid, keys.data_ptr(), out.data_ptr(), _stream(q),
    )
    _raise_on(rc, "row_max" + sfx)
    launches["row_max" + key] += 1
    return out


def count_above(
    q: torch.Tensor, refs: torch.Tensor, tau: float, n_valid: int,
    scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
    q_sq: Optional[torch.Tensor] = None, blocks: Optional[torch.Tensor] = None,
    col_block: Optional[int] = None,
) -> torch.Tensor:
    """Exact per-row count of q·refsᵀ ≥ τ over the first ``n_valid``
    columns, [M] int32. A bf16 ``refs`` may carry ``pad_columns``' zero
    pad columns; int8 codes take their ``scale``; ``ref_sq`` and ``q_sq``
    make it the count of the L2 goodness ≥ τ. ``blocks`` (with
    ``col_block``, IP only): the count over the listed blocks' columns
    (``count_above[.bf16|.int8].blocks``); an empty list counts 0 and
    launches nothing."""
    n_valid = int(n_valid)
    bf16 = q.dtype == torch.bfloat16
    _check(q, refs, n_valid, pad_ok=bf16, scale=scale)
    l2 = _check_l2(q, refs, ref_sq, q_sq)
    if blocks is not None:
        col_block = _check_blocks(q, refs, blocks, col_block, l2)
    if q.device.type == "cpu":
        return count_above_plain(q, refs, float(tau), n_valid, scale, ref_sq, q_sq,
                                 blocks, col_block)
    m, d = q.shape
    out = torch.empty((m,), dtype=torch.int32, device=q.device)
    if m == 0:
        return out
    lib = _build.library()
    if blocks is not None and blocks.numel() == 0:
        return out.zero_()
    sub, sub_key, n_sched = _schedule(blocks, col_block, n_valid)
    cfx = "_blocks" if sub else ""
    if refs.dtype == torch.int8:
        terms, refs = _int8_operands(q, refs)
        cname = "count_above_int8" + cfx
        rc = getattr(lib, f"vsc_{cname}")(
            q.device.index, terms.data_ptr(), refs.data_ptr(), scale.data_ptr(), m,
            refs.shape[0], refs.shape[1], float(tau), n_valid, *sub,
            _int8_grid(cname, q, n_sched), out.data_ptr(), _stream(q),
        )
        _raise_on(rc, cname)
        launches["count_above" + INT8 + sub_key] += 1
        return out
    sfx, key, norms = _l2_args(l2, ref_sq, q_sq)
    if bf16:
        if d == 0:
            raise ValueError("count_above_bf16: the kernel takes D >= 1")
        q, refs = pad_columns(q), pad_columns(refs)
        cname = "count_above_bf16" + sfx + cfx
        grid = wgmma_grid(m, n_sched, _wgmma_slots(q, cname))
        rc = getattr(lib, f"vsc_{cname}")(
            q.device.index, q.data_ptr(), refs.data_ptr(), *norms, m, refs.shape[0],
            q.shape[1], float(tau), n_valid, *sub, grid, out.data_ptr(), _stream(q),
        )
        _raise_on(rc, cname)
        launches["count_above" + BF16 + key + sub_key] += 1
        return out
    cname = "count_above" + sfx + cfx
    vec, grid = _reduce_plan(cname, q, refs, n_sched)
    rc = getattr(lib, f"vsc_{cname}")(
        q.device.index, q.data_ptr(), refs.data_ptr(), *norms, m, refs.shape[0], d,
        float(tau), n_valid, *sub, vec, grid, out.data_ptr(), _stream(q),
    )
    _raise_on(rc, cname)
    launches["count_above" + key + sub_key] += 1
    return out


def pool_writer(
    q: torch.Tensor, refs: torch.Tensor, n_valid: int,
    scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
    q_sq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused q·refsᵀ winner pool: best 2 per 128-column segment,
    ([M, N/128, 2] f32, [M, N/128, 2] int32). N must be a multiple of 128.
    A bf16 ``refs`` may carry ``pad_columns``' zero pad columns; int8
    codes take their ``scale``; ``ref_sq`` and ``q_sq`` make it the pool of
    the L2 goodness. The ids of −inf slots are unspecified and differ
    between the kernels; a finite slot's id is its column, ties to the
    lower one."""
    n_valid = int(n_valid)
    bf16 = q.dtype == torch.bfloat16
    _check(q, refs, n_valid, pad_ok=bf16, scale=scale)
    l2 = _check_l2(q, refs, ref_sq, q_sq)
    n = refs.shape[0]
    if n % SEG_LANES:
        raise ValueError(f"refs rows ({n}) must be a multiple of {SEG_LANES}")
    if q.device.type == "cpu":
        return pool_writer_plain(q, refs, n_valid, scale, ref_sq, q_sq)
    m, d = q.shape
    shape = (m, n // SEG_LANES, SEG_KEEP)
    vals = torch.empty(shape, dtype=torch.float32, device=q.device)
    ids = torch.empty(shape, dtype=torch.int32, device=q.device)
    if vals.numel() == 0:
        return vals, ids
    lib = _build.library()
    if refs.dtype == torch.int8 or bf16:
        # The tensor-core kernels write the segments their plan covers.
        written = pool_segments(n, n_valid)
        vals[:, written:] = float("-inf")
        ids[:, written:] = 2**31 - 1
    if refs.dtype == torch.int8:
        terms, refs = _int8_operands(q, refs)
        rc = lib.vsc_pool_writer_int8(
            q.device.index, terms.data_ptr(), refs.data_ptr(), scale.data_ptr(), m, n,
            refs.shape[1], n_valid, _int8_grid("pool_writer_int8", q, n_valid),
            vals.data_ptr(), ids.data_ptr(), _stream(q),
        )
        _raise_on(rc, "pool_writer_int8")
        launches["pool_writer" + INT8] += 1
        return vals, ids
    sfx, key, norms = _l2_args(l2, ref_sq, q_sq)
    if bf16:
        if d == 0:
            raise ValueError("pool_writer_bf16: the kernel takes D >= 1")
        q, refs = pad_columns(q), pad_columns(refs)
        cname = "pool_writer_bf16" + sfx
        grid = wgmma_grid(m, n_valid, _wgmma_slots(q, cname))
        rc = getattr(lib, f"vsc_{cname}")(
            q.device.index, q.data_ptr(), refs.data_ptr(), *norms, m, n, q.shape[1],
            n_valid, grid, vals.data_ptr(), ids.data_ptr(), _stream(q),
        )
        _raise_on(rc, cname)
        launches["pool_writer" + BF16 + key] += 1
        return vals, ids
    rc = getattr(lib, "vsc_pool_writer" + sfx)(
        q.device.index, q.data_ptr(), refs.data_ptr(), *norms, m, n, d, n_valid,
        vals.data_ptr(), ids.data_ptr(), _stream(q),
    )
    _raise_on(rc, "pool_writer" + sfx)
    launches["pool_writer" + key] += 1
    return vals, ids


def scores(q: torch.Tensor, refs: torch.Tensor, n_valid: int,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q·refs[j]ᵀ (× scale[j] for int8 codes) for j < n_valid, [M,
    n_valid] f32, on the product of the other kernels of its dtype (bf16
    tensors or int8 codes: the tensor cores), whose scores are those
    ``row_max``, ``count_above``, ``pool_writer`` and ``fused_topk`` see,
    bit for bit. The searchers re-search with ``scores_above``; this stays
    as its dense reference. A bf16 ``refs`` may carry ``pad_columns``' zero
    pad columns. f32 CUDA tensors raise: there the searchers score with
    ``torch.matmul``."""
    n_valid = int(n_valid)
    bf16 = q.dtype == torch.bfloat16
    _check(q, refs, n_valid, pad_ok=bf16, scale=scale)
    if q.device.type == "cpu":
        return scores_plain(q, refs, n_valid, scale)
    int8 = refs.dtype == torch.int8
    if not (bf16 or int8):
        raise TypeError("scores: the kernel takes bf16 operands or int8 codes")
    m, d = q.shape
    out = torch.empty((m, n_valid), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    if int8:
        terms, refs = _int8_operands(q, refs)
        rc = _build.library().vsc_scores_int8(
            q.device.index, terms.data_ptr(), refs.data_ptr(), scale.data_ptr(), m,
            refs.shape[0], refs.shape[1], n_valid, _int8_grid("scores_int8", q, n_valid),
            out.data_ptr(), _stream(q),
        )
        _raise_on(rc, "scores_int8")
        launches[SCORES_INT8] += 1
        return out
    if d == 0:
        raise ValueError("scores_bf16: the kernel takes D >= 1")
    q, refs = pad_columns(q), pad_columns(refs)
    grid = wgmma_grid(m, n_valid, _wgmma_slots(q, "scores_bf16"))
    rc = _build.library().vsc_scores_bf16(
        q.device.index, q.data_ptr(), refs.data_ptr(), m, refs.shape[0],
        q.shape[1], n_valid, grid, out.data_ptr(), _stream(q),
    )
    _raise_on(rc, "scores_bf16")
    launches[SCORES] += 1
    return out


def scores_above(
    q: torch.Tensor, refs: torch.Tensor, n_valid: int, floor: torch.Tensor,
    capacity: Optional[int] = None, scale: Optional[torch.Tensor] = None,
    ref_sq: Optional[torch.Tensor] = None, q_sq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every (i, j < n_valid) whose score q·refs[j]ᵀ (× scale[j] for int8
    codes) is ≥ floor[i], each once and in no order: (scores [E] f32, rows
    [E] int32, cols [E] int32). ``floor``: [M] f32 on q's device. For bf16
    CUDA tensors and int8 codes the tensor-core kernel of the operands'
    dtype: each score is the one ``scores`` writes at (i, j), bit for bit,
    and the set is nonzero(scores(q, refs, n_valid) >= floor[:, None]); no
    dense [M, n_valid] matrix is made. ``capacity``: the entries the caller
    expects (default SCORES_ABOVE_ROW_CAPACITY a row). The kernel counts
    every entry; when they are more, the wrapper launches it again with
    exactly that capacity (each launch counted). A bf16 ``refs`` may carry
    ``pad_columns``' zero pad columns; int8 codes take their ``scale``;
    ``ref_sq`` and ``q_sq`` (bf16 only) make the scores the L2 goodness
    (2·s − ref_sq[j]) − q_sq[i]. f32 CUDA tensors raise: the searchers
    re-search an f32 corpus with ``torch.matmul``."""
    n_valid = int(n_valid)
    bf16 = q.dtype == torch.bfloat16
    _check(q, refs, n_valid, pad_ok=bf16, scale=scale)
    l2 = _check_l2(q, refs, ref_sq, q_sq)
    if (floor.dtype != torch.float32 or floor.shape != (q.shape[0],)
            or floor.device != q.device):
        raise ValueError(f"floor must be [{q.shape[0]}] f32 on {q.device}: got "
                         f"{tuple(floor.shape)} {floor.dtype} on {floor.device}")
    if capacity is not None and int(capacity) < 0:
        raise ValueError(f"capacity {capacity} < 0")
    if q.device.type == "cpu":
        return scores_above_plain(q, refs, n_valid, floor, scale, ref_sq, q_sq)
    int8 = refs.dtype == torch.int8
    if not (bf16 or int8):
        raise TypeError(
            f"scores_above: the kernel takes bf16 operands or int8 codes, not {q.dtype}")
    m, d = q.shape
    sfx, l2_key, _ = _l2_args(l2, ref_sq, q_sq)
    cname, key = ("scores_above_int8", SCORES_ABOVE_INT8) if int8 else (
        "scores_above_bf16" + sfx, SCORES_ABOVE + l2_key)
    if d == 0:
        raise ValueError(f"{cname}: the kernel takes D >= 1")
    if m == 0 or n_valid == 0:
        return _no_entries(q.device)
    floor = floor.contiguous()
    if int8:
        terms, refs = _int8_operands(q, refs)
        operands, depth = (terms, refs, scale, floor), refs.shape[1]
    else:
        q, refs = pad_columns(q), pad_columns(refs)
        operands = (q, refs) + ((q_sq, ref_sq) if l2 else ()) + (floor,)
        depth = q.shape[1]
    cap = min(m * n_valid, m * SCORES_ABOVE_ROW_CAPACITY if capacity is None
              else int(capacity))
    grid = wgmma_grid(m, n_valid, _wgmma_slots(q, cname))
    count = torch.empty(1, dtype=torch.int64, device=q.device)
    while True:
        out_s = torch.empty(cap, dtype=torch.float32, device=q.device)
        out_r = torch.empty(cap, dtype=torch.int32, device=q.device)
        out_c = torch.empty(cap, dtype=torch.int32, device=q.device)
        rc = getattr(_build.library(), f"vsc_{cname}")(
            q.device.index, *(t.data_ptr() for t in operands), m, refs.shape[0],
            depth, n_valid, grid, cap, out_s.data_ptr(), out_r.data_ptr(),
            out_c.data_ptr(), count.data_ptr(), _stream(q),
        )
        _raise_on(rc, cname)
        launches[key] += 1
        total = int(count)  # the call's one sync
        if total <= cap:
            return out_s[:total], out_r[:total], out_c[:total]
        cap = total


def fused_topk(
    q: torch.Tensor, refs: torch.Tensor, n_valid: int, kappa: int,
    scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
    q_sq: Optional[torch.Tensor] = None, blocks: Optional[torch.Tensor] = None,
    col_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused q·refsᵀ per-row top-κ of the winner pool (best 2 per
    128-column segment), ordered by score descending, then column
    ascending: ([M, κ] f32, [M, κ] int32), padded with −inf and id 0. Any
    N and any κ ≥ 1. The kernel collects one κ-set per row and block
    (S pieces per row: ``topk_grid``, or ``wgmma_topk_grid`` in bf16 and
    int8); ``ordered_topk`` merges them. A bf16 ``refs`` may carry
    ``pad_columns``' zero pad columns; int8 codes take their ``scale``;
    ``ref_sq`` and ``q_sq`` make it the top-κ of the L2 goodness.
    ``blocks`` (with ``col_block``, IP only): the top-κ of the listed
    blocks' segment winners (``fused_topk[.bf16|.int8].blocks``); an empty
    list gives −inf sets and launches nothing."""
    n_valid, kappa = int(n_valid), int(kappa)
    bf16 = q.dtype == torch.bfloat16
    _check(q, refs, n_valid, pad_ok=bf16, scale=scale)
    l2 = _check_l2(q, refs, ref_sq, q_sq)
    if kappa < 1:
        raise ValueError(f"kappa must be >= 1, got {kappa}")
    if blocks is not None:
        col_block = _check_blocks(q, refs, blocks, col_block, l2)
    if q.device.type == "cpu":
        return fused_topk_plain(q, refs, n_valid, kappa, scale, ref_sq, q_sq,
                                blocks, col_block)
    m = q.shape[0]
    if m == 0:
        return (torch.empty((0, kappa), dtype=torch.float32, device=q.device),
                torch.empty((0, kappa), dtype=torch.int32, device=q.device))
    if blocks is not None and blocks.numel() == 0:
        return (torch.full((m, kappa), float("-inf"), device=q.device),
                torch.zeros((m, kappa), dtype=torch.int32, device=q.device))
    if bf16 or refs.dtype == torch.int8:
        return _fused_topk_tc(q, refs, n_valid, kappa,
                              kappa <= WGMMA_SMEM_SETS_KAPPA_MAX, scale, ref_sq, q_sq,
                              blocks, col_block)
    sfx, key, _ = _l2_args(l2, ref_sq, q_sq)
    sub, sub_key, n_sched = _schedule(blocks, col_block, n_valid)
    cname = "fused_topk" + sfx + ("_blocks" if sub else "")
    vec, grid = _reduce_plan(cname, q, refs, n_sched)
    grid, pieces = topk_grid(m, n_sched, kappa, grid)
    operands = (q, refs, q_sq, ref_sq) if l2 else (q, refs)
    return _launch_topk(cname, "fused_topk" + key + sub_key, operands, n_valid,
                        kappa, pieces, sub + (kappa, vec, grid, pieces), m)


def _schedule(blocks: Optional[torch.Tensor], col_block: Optional[int], n_valid: int):
    """(the block list's C arguments after n_valid, its launch key suffix,
    the columns the launch schedules) of a call: the listed blocks' columns,
    or the first n_valid."""
    if blocks is None:
        return (), "", n_valid
    return (blocks.data_ptr(), blocks.numel(), col_block), BLOCKS, blocks.numel() * col_block


def _fused_topk_tc(
    q: torch.Tensor, refs: torch.Tensor, n_valid: int, kappa: int, smem_sets: bool,
    scale: Optional[torch.Tensor] = None, ref_sq: Optional[torch.Tensor] = None,
    q_sq: Optional[torch.Tensor] = None, blocks: Optional[torch.Tensor] = None,
    col_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fused_topk.bf16 (fused_topk.int8 for codes with their ``scale``;
    fused_topk.bf16.l2 with ``ref_sq`` and ``q_sq``; ``.blocks`` over a
    non-empty checked block list) on the card (M ≥ 1) with its κ-sets in
    shared memory (``smem_sets``, κ ≤ WGMMA_SMEM_SETS_KAPPA_MAX) or in its
    [M, S, κ] output. ``fused_topk`` takes shared memory wherever κ fits;
    the card tests and ``tools/bench_reduce.py`` force either placement."""
    int8 = refs.dtype == torch.int8
    l2 = _check_l2(q, refs, ref_sq, q_sq)
    sfx, l2_key, _ = _l2_args(l2, ref_sq, q_sq)
    sub, sub_key, n_sched = _schedule(blocks, col_block, n_valid)
    cname = ("fused_topk_int8" if int8 else "fused_topk_bf16" + sfx) + (
        "_blocks" if sub else "")
    if q.shape[1] == 0:
        raise ValueError(f"{cname}: the kernel takes D >= 1")
    if smem_sets and kappa > WGMMA_SMEM_SETS_KAPPA_MAX:
        raise ValueError(f"kappa {kappa} > {WGMMA_SMEM_SETS_KAPPA_MAX}: the sets "
                         "do not fit in shared memory")
    m, smem_sets = q.shape[0], int(smem_sets)
    group = WGMMA_SMEM_SETS_GROUP if smem_sets else WGMMA_GROUP
    slots = _wgmma_slots(q, cname, smem_sets, kappa if smem_sets else 0)
    grid, pieces = wgmma_topk_grid(m, n_sched, kappa,
                                   wgmma_grid(m, n_sched, slots), group)
    if int8:
        terms, refs = _int8_operands(q, refs)
        operands = (terms, refs, scale)
    else:
        operands = (pad_columns(q), pad_columns(refs)) + ((q_sq, ref_sq) if l2 else ())
    key = "fused_topk" + (INT8 if int8 else BF16 + l2_key) + sub_key
    return _launch_topk(cname, key, operands, n_valid, kappa, pieces,
                        sub + (kappa, smem_sets, grid, pieces), m)


def _launch_topk(
    cname: str, key: str, operands: Tuple[torch.Tensor, ...], n_valid: int,
    kappa: int, pieces: int, args: Tuple[int, ...], m: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches ``vsc_<cname>`` on ``operands`` (q or the split query
    terms, refs[, scale][, q_sq, ref_sq]) for ``m`` query rows into S =
    ``pieces`` κ-sets per row, counts it under ``key`` and merges the
    sets."""
    q, refs = operands[0], operands[1]
    out_v = torch.empty((m, pieces * kappa), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, pieces * kappa), dtype=torch.int32, device=q.device)
    rc = getattr(_build.library(), f"vsc_{cname}")(
        q.device.index, *(t.data_ptr() for t in operands), m, refs.shape[0],
        refs.shape[1], n_valid, *args, out_v.data_ptr(), out_i.data_ptr(),
        _stream(q),
    )
    _raise_on(rc, cname)
    launches[key] += 1
    return ordered_topk(out_v, out_i, kappa)


CHAMFER_REGIONS = 9  # the kernels keep the 9 x 9 region products of a frame pair

# chamfer.bf16's work item (ops/csrc/chamfer_bf16.cu): one pair,
# CHAMFER_QT query frames (two consumers of 64) by CHAMFER_RT ref frames,
# whose 9 · CHAMFER_RT region rows are the wgmma B operand. Depth goes in
# k-slices of CHAMFER_BK values through a ring of CHAMFER_STAGES query
# slices (16 KB) beside up to CHAMFER_MAX_SLOTS ref slices (9 · CHAMFER_RT
# rows x CHAMFER_BK, 18 KB): the ref tile stays resident while its
# k-slices fit, else it streams through the slots once a pass.
CHAMFER_QT = 128
CHAMFER_RT = 16
CHAMFER_BK = 64
CHAMFER_STAGES = 4
CHAMFER_SMEM_LIMIT = 232_448  # dynamic shared memory of an H100 block
_CHAMFER_ALIGN = 1024  # slack to align the swizzled tiles
_CHAMFER_SLICE = CHAMFER_REGIONS * CHAMFER_RT * CHAMFER_BK * 2
_CHAMFER_Q_STAGE = CHAMFER_QT * CHAMFER_BK * 2


def chamfer_bf16_smem_bytes(slots: int) -> int:
    """Dynamic shared memory of a chamfer.bf16 launch with ``slots`` ref
    slices: alignment slack, the query ring, the slices, and a full and an
    empty mbarrier (8 bytes) for each stage and slot."""
    return (_CHAMFER_ALIGN + CHAMFER_STAGES * _CHAMFER_Q_STAGE + slots * _CHAMFER_SLICE
            + 8 * (2 * CHAMFER_STAGES + 2 * slots))


CHAMFER_MAX_SLOTS = (CHAMFER_SMEM_LIMIT - chamfer_bf16_smem_bytes(0)) // (_CHAMFER_SLICE + 16)


class ChamferPlan(NamedTuple):
    """A chamfer.bf16 launch: ``rt`` ref frames an item, ``q_tiles`` x
    ``r_tiles`` items a pair, ``items`` in all, ``kt_n`` k-slices, the ref
    tile ``resident`` (in ``slots`` == kt_n slices) or streamed through
    ``slots`` slices once a pass, ``smem_bytes`` of shared memory, and a
    persistent ``grid`` of one block per SM (at most the items)."""

    rt: int
    q_tiles: int
    r_tiles: int
    items: int
    kt_n: int
    resident: bool
    slots: int
    smem_bytes: int
    grid: int


def chamfer_bf16_plan(b: int, nq: int, nr: int, d: int, sms: int = 132) -> ChamferPlan:
    """The plan of a chamfer.bf16 call on ``sms`` SMs (one block each)."""
    kt_n = -(-d // CHAMFER_BK)
    resident = kt_n <= CHAMFER_MAX_SLOTS
    slots = kt_n if resident else CHAMFER_MAX_SLOTS
    q_tiles, r_tiles = -(-nq // CHAMFER_QT), -(-nr // CHAMFER_RT)
    items = b * q_tiles * r_tiles
    return ChamferPlan(
        rt=CHAMFER_RT, q_tiles=q_tiles, r_tiles=r_tiles, items=items, kt_n=kt_n,
        resident=resident, slots=slots, smem_bytes=chamfer_bf16_smem_bytes(slots),
        grid=min(items, sms),
    )


def chamfer_bf16_item(i, nq: int, nr: int):
    """(pair, first query frame, first ref frame) of work item ``i`` (an
    int or an integer array), as chamfer_bf16.cu numbers them: pair major,
    then query tile, then ref tile. Block k of a ``grid``-block launch
    takes items k, k + grid, k + 2·grid, ..."""
    q_tiles, r_tiles = -(-nq // CHAMFER_QT), -(-nr // CHAMFER_RT)
    per_pair = q_tiles * r_tiles
    b, local = i // per_pair, i % per_pair
    return b, local // r_tiles * CHAMFER_QT, local % r_tiles * CHAMFER_RT


def chamfer_fine_sims(
    qf: torch.Tensor, rf: torch.Tensor, symmetric: bool = True
) -> torch.Tensor:
    """Fused DnS chamfer [B, NQ, NR] f32 of fine region features qf
    [B, NQ, 9, D] and rf [B, NR, 9, D] (before the [0, 1] rescale); any
    NQ and NR. Zero-pad frames give 0. f32 operands (precision "highest")
    launch ``chamfer`` (f32 FMA on the CUDA cores, D % 4 == 0); bf16
    operands (precision "default") launch ``chamfer.bf16`` (the tensor
    cores: exact bf16 products, f32 sums; D % 8 == 0)."""
    if qf.device != rf.device:
        raise ValueError(f"qf on {qf.device}, rf on {rf.device}")
    if qf.dtype not in _OPERAND_DTYPES or rf.dtype != qf.dtype:
        raise TypeError(
            f"qf and rf must share a dtype, f32 or bf16: got {qf.dtype} and {rf.dtype}"
        )
    if (
        qf.dim() != 4 or rf.dim() != 4 or qf.shape[0] != rf.shape[0]
        or qf.shape[2:] != rf.shape[2:]
    ):
        raise ValueError(f"shapes {tuple(qf.shape)} and {tuple(rf.shape)}")
    if qf.device.type == "cpu":
        return chamfer_fine_sims_plain(qf, rf, symmetric)
    if qf.device.type != "cuda":
        raise ValueError(f"unsupported device {qf.device}")
    b, nq, r, d = qf.shape
    nr = rf.shape[1]
    bf16 = qf.dtype == torch.bfloat16
    align = ROW_ALIGN if bf16 else 4  # 16-byte copies of a row
    if r != CHAMFER_REGIONS or d % align:
        raise ValueError(
            f"the kernel takes {CHAMFER_REGIONS} regions and D % {align} == 0; "
            f"got R={r}, D={d}"
        )
    if not (qf.is_contiguous() and rf.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors")
    if qf.data_ptr() % 16 or rf.data_ptr() % 16:
        raise ValueError("the kernel takes 16-byte aligned tensors")
    if max(b, nq, nr, d) >= 2**31:
        raise ValueError("dimensions must fit in int32")
    out = torch.empty((b, nq, nr), dtype=torch.float32, device=qf.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    if bf16:
        sms = torch.cuda.get_device_properties(qf.device).multi_processor_count
        plan = chamfer_bf16_plan(b, nq, nr, d, sms)
        rc = lib.vsc_chamfer_bf16(
            qf.device.index, qf.data_ptr(), rf.data_ptr(), b, nq, nr, r, d,
            int(bool(symmetric)), plan.grid, plan.slots, out.data_ptr(), _stream(qf),
        )
        _raise_on(rc, "chamfer_bf16")
        launches[CHAMFER_BF16] += 1
        return out
    rc = lib.vsc_chamfer(
        qf.device.index, qf.data_ptr(), rf.data_ptr(), b, nq, nr, r, d,
        int(bool(symmetric)), out.data_ptr(), _stream(qf),
    )
    _raise_on(rc, "chamfer")
    launches["chamfer"] += 1
    return out
