#!/usr/bin/env python3
"""DnS matching baseline on the PyTorch/CUDA port: retrieval on coarse
descriptors, localization on the fine chamfer similarity fused with the
coarse similarity.

Counterpart of ``vsc2022_tpu/baseline/dns_baseline.py`` (reference:
vsc/baseline/dns_baseline.py), with the same flags: ``--accelerator cpu``
runs on the CPU, ``--accelerator tpu`` (or ``cuda``) on the card, and
``--device {cuda,cpu}`` says the same. Search runs on the 1024-d coarse
(score normalized) descriptors; each localized pair's similarity is the
fine chamfer (the ``chamfer`` kernel, symmetrized, rescaled to [0, 1])
geometric-mean fused with the coarse similarity, √(clip(fg)·clip(cg)),
then TN-aligned with the SSCD path's parameters.

    python -m vsc2022_torch.baseline.dns_baseline \\
        --query_coarse_features idx/queries_cg_student_sn.npz \\
        --ref_coarse_features idx/refs_cg_student_sn.npz \\
        --query_fine_features idx/queries_fg_att_student.npz \\
        --ref_fine_features idx/refs_fg_att_student.npz \\
        --ground_truth gt.csv --output_path out/

Runs on ``cuda`` unless ``--device cpu`` or ``--accelerator cpu`` is
given; ``--profile_dir`` writes a ``torch.profiler`` trace.
"""

import argparse
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vsc2022_torch.baseline import pipeline
from vsc2022_torch.device import DeviceLike, add_device_flags, resolve_device
from vsc2022_torch.localization import TNLocalizationMaxSim
from vsc2022_torch.localization.localize import gather_rows
from vsc2022_torch.metrics import CandidatePair, Dataset, Match
from vsc2022_torch.models.dns import NUM_REGIONS
from vsc2022_torch.ops import kernels
from vsc2022_torch.storage import load_features
from vsc2022_torch.types import VideoFeature
from vsc2022_torch.utils.profiling import maybe_profile

logger = logging.getLogger("vsc2022_torch.dns_baseline")

parser = argparse.ArgumentParser()
parser.add_argument(
    "--query_coarse_features", type=str, required=True,
    help="Path to query coarse descriptors",
)
parser.add_argument(
    "--ref_coarse_features", type=str, required=True,
    help="Path to reference coarse descriptors",
)
parser.add_argument(
    "--query_fine_features", type=str, required=True,
    help="Path to query fine descriptors",
)
parser.add_argument(
    "--ref_fine_features", type=str, required=True,
    help="Path to reference fine descriptors",
)
parser.add_argument(
    "--fg_type", choices=["att", "bin"], default="att",
    help="Fine-grained feature variant (bin features are rescaled to ±1).",
)
parser.add_argument(
    "--output_path", type=str, required=True,
    help="The path to write match predictions.",
)
parser.add_argument(
    "--ground_truth", type=str, help="Path to the ground truth (labels) CSV file."
)
parser.add_argument(
    "--overwrite", help="Overwrite prediction files, if found.", action="store_true"
)
parser.add_argument(
    "--vcsl_faithful_tn", action="store_true",
    help="Align with the published VCSL TN configuration (absolute "
    "min_sim gate, top-K=5, path-cell masking, max_iou dedup) instead "
    "of the tuned adaptive gate.",
)
parser.add_argument(
    "--torchscript_path", type=str, default=None,
    help="A fine-grained student's TorchScript, as the reference takes it: "
    "its student_type is checked and its fg_type used (the fine "
    "similarity itself is the chamfer of the indexed fine features).",
)
parser.add_argument(
    "--profile_dir", type=str, default=None,
    help="Write a torch.profiler (chrome trace) of the matching run.",
)
add_device_flags(parser)


# The JAX precisions of the fine similarity: "highest" is full f32 (the
# f32 chamfer); "default" one bf16 pass with f32 accumulation (the bf16
# chamfer, the counterpart of the Pallas kernel's bf16 branch).
PRECISIONS = ("highest", "default")


def _chamfer_fuse(
    qf: torch.Tensor,  # [B, NQ, R, D] fine
    rf: torch.Tensor,  # [B, NR, R, D]
    qc: torch.Tensor,  # [B, NQ, DC] coarse
    rc: torch.Tensor,  # [B, NR, DC]
    bias: float,
    symmetric: bool = True,
    precision: str = "highest",
) -> torch.Tensor:
    """Chamfer (symmetrized), rescaled to [0, 1], geometric-mean fused
    with the biased coarse similarity: [B, NQ, NR]. At "default" the
    operands round to bf16 (nearest even), as JAX's DEFAULT precision
    takes them: the fine ones go to the bf16 chamfer, and the coarse
    product is the f32 product of the rounded values (exact bf16 products,
    f32 sums)."""
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r} is not ported: the DnS similarity takes "
            f"{' or '.join(map(repr, PRECISIONS))}"
        )
    if precision == "default":
        qf, rf = qf.to(torch.bfloat16), rf.to(torch.bfloat16)
        qc, rc = (x.to(torch.bfloat16).float() for x in (qc, rc))
    fg = kernels.chamfer_fine_sims(qf, rf, symmetric) / 2.0 + 0.5
    cg = torch.bmm(qc, rc.transpose(1, 2)) + bias
    return torch.sqrt(torch.clamp(fg, min=1e-7) * torch.clamp(cg, min=1e-7))


def _fused_fine_coarse_sims(
    qf: torch.Tensor, rf: torch.Tensor, qc: torch.Tensor, rc: torch.Tensor,
    bias: float, symmetric: bool = True, precision: str = "highest",
) -> torch.Tensor:
    """Chamfer+coarse fusion over explicit feature batches."""
    return _chamfer_fuse(qf, rf, qc, rc, bias, symmetric, precision)


def _gathered_dns_sims(
    qc_table: torch.Tensor,  # [1+Tq, DC] coarse (row 0 = zero pad)
    rc_table: torch.Tensor,  # [1+Tr, DC]
    qf_table: torch.Tensor,  # [1+Tq, R*D] fine (row 0 = zero pad)
    rf_table: torch.Tensor,  # [1+Tr, R*D]
    qc_idx, rc_idx, qf_idx, rf_idx,  # [B, N*] rows
    bias: float,
    symmetric: bool = True,
    precision: str = "highest",
    regions: int = NUM_REGIONS,
    device=None,
) -> torch.Tensor:
    """Chamfer+coarse fusion from device-resident feature tables (tensors,
    or ``RowShardedTable``s whose shards hand over the rows they own): the
    per-batch inputs are index matrices into the query and ref tables, and
    the rows are gathered onto ``device`` (default the query tables'),
    where the fusion runs (``_dns_rows_sims``)."""
    device = qc_table.device if device is None else device
    return _dns_rows_sims(
        gather_rows(qc_table, qc_idx, device), gather_rows(rc_table, rc_idx, device),
        gather_rows(qf_table, qf_idx, device), gather_rows(rf_table, rf_idx, device),
        bias, symmetric, precision, regions)


def _dns_rows_sims(
    qc: torch.Tensor, rc: torch.Tensor,  # [B, N*, DC] coarse rows
    qf: torch.Tensor, rf: torch.Tensor,  # [B, N*, R*D] fine rows
    bias: float,
    symmetric: bool = True,
    precision: str = "highest",
    regions: int = NUM_REGIONS,
) -> torch.Tensor:
    """Chamfer+coarse fusion of gathered rows in their stored dtype, on
    their device. Rows stored bf16 are widened; at "default" the fine rows
    go to the bf16 chamfer as bf16 (the same values)."""
    fine = torch.bfloat16 if precision == "default" else torch.float32
    qc, rc, qf, rf = qc.float(), rc.float(), qf.to(fine), rf.to(fine)
    return _chamfer_fuse(
        qf.view(*qf.shape[:2], regions, -1), rf.view(*rf.shape[:2], regions, -1),
        qc, rc, bias, symmetric, precision,
    )


class DnSLocalization(TNLocalizationMaxSim):
    """Fine+coarse fused similarity feeding the TN aligner (the
    reference's VCSLLocalizationDnS). Pairs bucket by their coarse frame
    counts; the fine rows come from their own pair of device tables. With
    ``table_dtype="bfloat16"`` both reference tables (coarse and fine)
    store bf16 rows, widened to f32 as they are gathered: the chamfer
    kernel stays the f32 one. With ``mesh`` and ``shard_ref_table`` both
    reference tables are row-sharded; each pair tile gathers its true rows
    from their owner shards onto its device, where the fused chamfer runs
    (the port's chamfer kernel; JAX's sharded body runs XLA there). Over a
    pod each rank holds its shards of both tables and runs its own tiles
    (``TNLocalization._align``)."""

    # The gathered fine rows are B·(NQ + NR)·9·512 floats per chunk
    # (2.4 GB at 1024 pairs of 64 × 64 frames), hence a smaller budget.
    sim_element_budget = 4 * 1024 * 1024

    def __init__(
        self,
        queries_fine: Dict[str, VideoFeature],
        refs_fine: Dict[str, VideoFeature],
        queries_coarse: List[VideoFeature],
        refs_coarse: List[VideoFeature],
        model_type: str = "TN",
        fg_type: str = "att",
        symmetric: bool = True,
        **kwargs,
    ):
        super().__init__(queries_coarse, refs_coarse, model_type, **kwargs)
        self.queries_fine = queries_fine
        self.refs_fine = refs_fine
        self.fg_type = fg_type
        self.symmetric = symmetric

    # -- serving lifecycle (JAX dns_baseline.py:305-395) ----------------------

    def set_queries(self, queries, queries_fine=None) -> None:
        """Replace the query set, fine features included; both reference
        tables (coarse and fine) stay on the device."""
        if queries_fine is None:
            raise ValueError("DnS localization needs fine features: pass queries_fine")
        super().set_queries(queries)
        self.queries_fine = dict(queries_fine)
        self._tables.pop("query_fine", None)

    def add_refs(self, refs_coarse, refs_fine=None) -> None:
        """Extend both reference sides; both staged ref tables grow on the
        device. The fine dict grows first, so a failed coarse grow still
        leaves both dicts holding the new videos; the staged fine table
        then lacks them too, and is dropped with the coarse one."""
        if refs_fine is None:
            raise ValueError("DnS localization needs fine features: pass refs_fine")
        self.refs_fine.update(refs_fine)
        with self._or_drop("ref_fine"):
            super().add_refs(refs_coarse)
            self._grow_table("ref_fine", self.refs_fine, list(refs_fine),
                             row_fn=self._fine_rows)

    def remove_refs(self, video_ids) -> None:
        """Drop reference videos on both sides; both staged ref tables
        compact on the device."""
        super().remove_refs(video_ids)
        for v in video_ids:
            self.refs_fine.pop(v, None)
        with self._or_drop("ref_fine"):
            self._compact_table("ref_fine", self.refs_fine)

    def _fine(self, vf: VideoFeature) -> np.ndarray:
        f = np.asarray(vf.feature, dtype=np.float32)
        if "bin" in self.fg_type:
            f = 2.0 * f - 1.0  # {0,1} → {-1,+1} (dns_baseline.py:133-136)
        return f.reshape(f.shape[0], NUM_REGIONS, -1)

    def _fine_rows(self, vf: VideoFeature) -> np.ndarray:
        feat = self._fine(vf)
        return feat.reshape(feat.shape[0], -1)

    def _pair_tables(self, candidates: Sequence[CandidatePair]):
        """The coarse query and ref tables, with the fine twins staged
        beside them (flattened region rows under their own names)."""
        self._stage("query_fine", self.queries_fine,
                    [c.query_id for c in candidates], row_fn=self._fine_rows)
        self._stage("ref_fine", self.refs_fine,
                    [c.ref_id for c in candidates], row_fn=self._fine_rows)
        return super()._pair_tables(candidates)

    def _tile_index(self, candidates: Sequence[CandidatePair], nq: int, nr: int):
        """The coarse and fine rows a tile of pairs reads (the tables'
        names: "query", "ref", "query_fine", "ref_fine"), and its lengths.
        A pair contributes min(fine, coarse) frames (they should match; be
        robust to ragged inputs): frames beyond that read the zero pad row
        on BOTH tables, so their fine similarity is exactly 0."""
        _, qc_offs, _, rc_offs = self._pair_tables(candidates)
        qf_offs, rf_offs = self._tables["query_fine"][1], self._tables["ref_fine"][1]
        q_ids = [c.query_id for c in candidates]
        r_ids = [c.ref_id for c in candidates]
        qc_idx, q_len_c = self._indices_from(qc_offs, q_ids, nq)
        rc_idx, r_len_c = self._indices_from(rc_offs, r_ids, nr)
        qf_idx, q_len_f = self._indices_from(qf_offs, q_ids, nq)
        rf_idx, r_len_f = self._indices_from(rf_offs, r_ids, nr)
        q_len = np.minimum(q_len_c, q_len_f)
        r_len = np.minimum(r_len_c, r_len_f)
        q_mask = np.arange(nq)[None, :] < q_len[:, None]
        r_mask = np.arange(nr)[None, :] < r_len[:, None]
        idx = {"query": np.where(q_mask, qc_idx, 0), "ref": np.where(r_mask, rc_idx, 0),
               "query_fine": np.where(q_mask, qf_idx, 0),
               "ref_fine": np.where(r_mask, rf_idx, 0)}
        return idx, q_len, r_len

    def _batch_sims(
        self, candidates: Sequence[CandidatePair], nq: int, nr: int,
        device: torch.device = None, rows: Optional[Dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        device = self.device if device is None else device
        idx, q_len, r_len = self._tile_index(candidates, nq, nr)
        names = ("query", "ref", "query_fine", "ref_fine")
        bias = float(self.similarity_bias)
        if rows is None:
            sims = _gathered_dns_sims(*(self._tables[n][0] for n in names),
                                      *(idx[n] for n in names), bias,
                                      symmetric=self.symmetric, device=device)
        else:
            sims = _dns_rows_sims(*(rows[n] for n in names), bias, self.symmetric)
        return (
            sims,
            torch.from_numpy(q_len).to(device),
            torch.from_numpy(r_len).to(device),
        )


def search(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    retrieve_per_query: float = pipeline.RETRIEVE_PER_QUERY,
    candidates_per_query: float = pipeline.CANDIDATES_PER_QUERY,
    device: DeviceLike = "cuda",
) -> List[CandidatePair]:
    return pipeline.retrieve_candidates(
        queries, refs, retrieve_per_query, candidates_per_query, device=device
    )


def localize_and_verify(
    queries_fine: Dict[str, VideoFeature],
    refs_fine: Dict[str, VideoFeature],
    queries_coarse: List[VideoFeature],
    refs_coarse: List[VideoFeature],
    candidates: List[CandidatePair],
    localize_per_query: float = pipeline.LOCALIZE_PER_QUERY,
    fg_type: str = "att",
    vcsl_faithful: bool = False,
    device: DeviceLike = "cuda",
) -> List[Match]:
    candidates = candidates[: int(len(queries_fine) * localize_per_query)]
    alignment = DnSLocalization(
        queries_fine, refs_fine, queries_coarse, refs_coarse,
        model_type="TN", fg_type=fg_type, tn_max_step=5, min_length=4,
        similarity_bias=0.5, vcsl_faithful=vcsl_faithful, device=device,
    )
    return pipeline.align_candidates(alignment, candidates)


def match(
    queries_fine: Dict[str, VideoFeature],
    refs_fine: Dict[str, VideoFeature],
    queries_coarse: List[VideoFeature],
    refs_coarse: List[VideoFeature],
    output_path: str,
    fg_type: str = "att",
    vcsl_faithful: bool = False,
    device: DeviceLike = "cuda",
    stages: Dict[str, float] = None,
) -> Tuple[str, str]:
    stages = {} if stages is None else stages
    device = resolve_device(device)
    with pipeline.timed(stages, "retrieve", device):
        candidates = search(queries_coarse, refs_coarse, device=device)
        candidate_file, _ = pipeline.write_stage_artifacts(
            output_path, candidates
        )
    with pipeline.timed(stages, "localize", device):
        matches = localize_and_verify(
            queries_fine, refs_fine, queries_coarse, refs_coarse, candidates,
            fg_type=fg_type, vcsl_faithful=vcsl_faithful, device=device,
        )
        _, match_file = pipeline.write_stage_artifacts(
            output_path, candidates, matches
        )
    return candidate_file, match_file


def _by_id(videos: List[VideoFeature]) -> Dict[str, VideoFeature]:
    return {vf.video_id: vf for vf in videos}


def main(args) -> Dict[str, object]:
    """Run the DnS matching pipeline; returns the per-stage seconds and,
    with ``--ground_truth``, both APs."""
    if os.path.exists(args.output_path) and not args.overwrite:
        raise Exception(
            f"Output path already exists: {args.output_path}. "
            "Do you want to --overwrite?"
        )
    device = resolve_device(args.device)
    fg_type = args.fg_type
    if args.torchscript_path:
        module = torch.jit.load(args.torchscript_path, map_location="cpu")
        if getattr(module, "student_type", "fg") != "fg":
            raise Exception(
                "Only fine-grained students are accepted for similarity "
                "calculation."
            )
        fg_type = getattr(module, "fg_type", fg_type)

    stages: Dict[str, float] = {}
    with pipeline.timed(stages, "load", device):
        queries_fine = _by_id(load_features(args.query_fine_features, Dataset.QUERIES))
        refs_fine = _by_id(load_features(args.ref_fine_features, Dataset.REFS))
        queries_coarse = load_features(args.query_coarse_features, Dataset.QUERIES)
        refs_coarse = load_features(args.ref_coarse_features, Dataset.REFS)

    with maybe_profile(args.profile_dir, device):
        candidate_file, match_file = match(
            queries_fine, refs_fine, queries_coarse, refs_coarse,
            args.output_path, fg_type=fg_type,
            vcsl_faithful=args.vcsl_faithful_tn, device=device, stages=stages,
        )
    result: Dict[str, object] = {"stages": stages}
    if args.ground_truth:
        with pipeline.timed(stages, "metrics", device):
            result.update(
                pipeline.report_metrics(
                    args.ground_truth, candidate_file, match_file, logger,
                    output_path=args.output_path,
                )
            )
    return result


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    main(parser.parse_args())
