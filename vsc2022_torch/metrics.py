"""Evaluation layer: descriptor-track micro-AP and matching-track segment AP.

The port's own copy of ``vsc2022_tpu/metrics.py``, the frozen metric
definitions (reference: vsc/metrics.py). Public names, CSV schemas, the
``Q%06d``/``R%06d`` id convention and the numeric definitions are kept
identical. Differences from the JAX package's module:

  * CSV files are written and read with the standard ``csv`` module
    instead of pandas; the bytes written are those pandas writes
    (shortest round-trip float repr, ``\n`` line ends, minimal quoting).
    ``CandidatePair.to_dataframe`` imports pandas when it is called, and
    ``PrecisionRecallCurve.plot`` matplotlib: neither is needed anywhere
    else.
  * ``match_metric`` runs its Python implementation only (no C++ core).

Kept from the JAX package's module:

  * The binary average-precision core is a self-contained numpy
    implementation equivalent to ``sklearn.metrics.average_precision_score``
    (reference: vsc/metrics.py:477-481 delegates to sklearn) so the eval
    layer has no sklearn dependency.
  * Interval union/merge is vectorized with numpy instead of a Python
    sweep (reference: vsc/metrics.py:154-169).
  * Segment-AP bookkeeping carries (query-axis, ref-axis) quantities as
    length-2 vectors rather than per-axis dict plumbing, and the
    DrivenData AP realizes the GT left-merge as a set-membership lookup.

Matching-track metric semantics (reference: vsc/metrics.py:238-378):
segment AP over predictions sorted by score, tie-groups updated together,
per-axis precision/recall combined by geometric mean, and GT boxes only
count toward the intersection once they overlap at least one prediction
(the VCSL figure-4f correction).
"""

from __future__ import annotations

import dataclasses
import enum
from math import sqrt
from typing import (
    Collection,
    Dict,
    Iterable,
    List,
    NamedTuple,
    Optional,
    Sequence,
    TextIO,
    Tuple,
    Union,
)

import csv
import math
import re

import numpy as np


class Dataset(enum.Enum):
    QUERIES = "Q"
    REFS = "R"


def format_video_id(video_id: Union[str, int], dataset: Optional[Dataset]) -> str:
    """Normalize a video id to the ``Q%06d`` / ``R%06d`` convention.

    Integer ids are rendered with the dataset's prefix; string ids pass
    through after a prefix sanity check. (reference: vsc/metrics.py:26-40)
    """
    prefix = None if dataset is None else dataset.value
    if isinstance(video_id, str):
        # np.str_ is a str subclass, so ids loaded from npz land here too.
        if prefix is not None and not video_id.startswith(prefix):
            raise AssertionError(
                f"video id {video_id!r} lacks the {prefix!r} prefix "
                f"expected for {dataset}"
            )
        return video_id
    if isinstance(video_id, (int, np.integer)):
        if prefix is None:
            raise ValueError(
                "Unable to convert integer video_id without a Dataset enum"
            )
        return f"{prefix}{int(video_id):06d}"
    raise AssertionError(
        f"video id must be str or int; got {type(video_id).__name__}"
    )


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not (
        isinstance(v, (bool, np.bool_))
    )


def _format_column(values: Sequence) -> List[str]:
    """Render one column as pandas' ``to_csv`` does: an all-integer
    column as integers, a numeric column holding any float as float64
    in its shortest round-trip repr (NaN as an empty field), anything
    else as ``str``."""
    if values and all(_is_number(v) for v in values):
        if any(isinstance(v, (float, np.floating)) for v in values):
            return [
                "" if math.isnan(float(v)) else repr(float(v)) for v in values
            ]
        return [str(int(v)) for v in values]
    return ["" if v is None else str(v) for v in values]


def _write_table(
    file: Union[str, TextIO], columns: Sequence[str], rows: Sequence[Sequence]
) -> None:
    """Write a header plus rows with pandas' CSV dialect (minimal
    quoting, ``\n`` line ends). No columns at all writes one empty
    line, as ``pd.DataFrame([]).to_csv`` does."""
    cols = list(zip(*rows)) if rows else [() for _ in columns]
    rendered = [_format_column(list(c)) for c in cols]
    out_rows = list(zip(*rendered)) if rows else []

    def emit(f):
        w = csv.writer(f, lineterminator="\n")
        if not columns:
            f.write("\n")
            return
        w.writerow(columns)
        w.writerows(out_rows)

    if isinstance(file, str):
        with open(file, "w", newline="") as f:
            emit(f)
    else:
        emit(file)


_FLOAT_RE = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*")
_POW10 = [float(f"1e{i}") for i in range(309)]


def _parse_float(text: str) -> float:
    """A float as pandas' default C parser reads it (its
    ``precise_xstrtod``): at most 17 digits, leading zeros included, are
    accumulated and the rest dropped, then one scaling by an exact power
    of ten. This is not always the correctly rounded value, and the port
    reads what the JAX package reads."""
    m = _FLOAT_RE.fullmatch(text)
    if m is None or not (m.group(2) or m.group(3)):
        word = text.strip().lower().lstrip("+")
        if word in ("inf", "-inf", "infinity", "-infinity", "nan", "-nan"):
            return float(word)
        raise ValueError(f"not a number: {text!r}")
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    decimals = 0
    for ch in frac or "":
        if digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        decimals += 1
    exponent -= decimals
    if sign == "-":
        number = -number
    exponent += int(exp) if exp else 0
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_column(fields: Sequence[str]) -> List:
    """Type one CSV column as pandas' reader infers it: all integers →
    int, all numbers (empty fields → NaN) → float, else strings (empty
    fields → None)."""
    try:
        return [int(v) for v in fields]
    except ValueError:
        pass
    try:
        return [_parse_float(v) if v != "" else float("nan") for v in fields]
    except ValueError:
        return [v if v != "" else None for v in fields]


def _read_table(file: Union[str, TextIO]) -> Dict[str, List]:
    """Read a CSV with a header row into typed columns."""

    def parse(f):
        rows = list(csv.reader(f))
        if not rows or not any(rows[0]):
            raise ValueError("No columns to parse from file")
        header, body = rows[0], [r for r in rows[1:] if r]
        for r in body:
            if len(r) != len(header):
                raise ValueError(
                    f"Expected {len(header)} fields in line, saw {len(r)}"
                )
        columns = list(zip(*body)) if body else [() for _ in header]
        return {
            name: _parse_column(list(col))
            for name, col in zip(header, columns)
        }

    if isinstance(file, str):
        with open(file, newline="") as f:
            return parse(f)
    return parse(file)


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


@dataclasses.dataclass
class CandidatePair:
    """A (query video, ref video) candidate with a retrieval score.

    CSV schema: ``query_id,ref_id,score`` (reference: vsc/metrics.py:43-93).
    """

    query_id: str
    ref_id: str
    score: float

    @classmethod
    def to_dataframe(cls, candidates: Collection["CandidatePair"]):
        """The candidates as a pandas DataFrame (columns query_id, ref_id,
        score, ids formatted), as the JAX package and the reference give
        it. pandas is imported here: nothing else in the port needs it."""
        import pandas as pd

        if not candidates:
            return pd.DataFrame([])
        return pd.DataFrame(
            {
                "query_id": [
                    format_video_id(c.query_id, Dataset.QUERIES)
                    for c in candidates
                ],
                "ref_id": [
                    format_video_id(c.ref_id, Dataset.REFS) for c in candidates
                ],
                "score": [c.score for c in candidates],
            }
        )

    @classmethod
    def write_csv(
        cls, candidates: Collection["CandidatePair"], file: Union[str, TextIO]
    ):
        if not candidates:
            _write_table(file, [], [])
            return
        rows = [
            (
                format_video_id(c.query_id, Dataset.QUERIES),
                format_video_id(c.ref_id, Dataset.REFS),
                c.score,
            )
            for c in candidates
        ]
        _write_table(file, ["query_id", "ref_id", "score"], rows)

    @classmethod
    def read_csv(cls, file: Union[str, TextIO]) -> List["CandidatePair"]:
        cols = _read_table(file)
        return [
            CandidatePair(
                query_id=format_video_id(q, Dataset.QUERIES),
                ref_id=format_video_id(r, Dataset.REFS),
                score=score,
            )
            for q, r, score in zip(
                cols["query_id"], cols["ref_id"], cols["score"]
            )
        ]

    @classmethod
    def from_matches(cls, matches: Collection["Match"]) -> List["CandidatePair"]:
        """Per-pair max-score reduction over segment matches; scores are
        floored at 0.0 as in the reference (vsc/metrics.py:85-93, whose
        defaultdict(float) starts every pair at zero)."""
        best: Dict[Tuple[str, str], float] = {}
        for m in matches:
            k = (m.query_id, m.ref_id)
            best[k] = max(best.get(k, 0.0), m.score)
        return [
            CandidatePair(query_id=q, ref_id=r, score=s)
            for (q, r), s in best.items()
        ]


@dataclasses.dataclass
class PrecisionRecallCurve:
    precisions: np.ndarray
    recalls: np.ndarray
    scores: np.ndarray

    def plot(self, ax=None, **kwargs):
        """Precision against recall on ``ax`` (a new labelled axes when
        None); matplotlib is imported here, only when plotting."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
            ax.set_xlabel("recall")
            ax.set_ylabel("precision")
            ax.set_xlim(0, 1.05)
            ax.set_ylim(0, 1.05)
        ax.plot(self.recalls, self.precisions, **kwargs)
        return ax


@dataclasses.dataclass
class AveragePrecision:
    ap: float
    pr_curve: PrecisionRecallCurve
    simple_ap: Optional[float] = None


def _merge_intervals(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union-merge into sorted, non-overlapping intervals (vectorized).

    Touching intervals (start == previous end) merge, matching the
    reference sweep (reference: vsc/metrics.py:154-169).
    """
    if len(intervals) <= 1:
        return sorted(intervals)
    arr = np.asarray(sorted(intervals), dtype=np.float64)
    starts, ends = arr[:, 0], arr[:, 1]
    running_end = np.maximum.accumulate(ends)
    # A new group starts where this interval begins after every prior end.
    new_group = np.empty(len(arr), dtype=bool)
    new_group[0] = True
    new_group[1:] = starts[1:] > running_end[:-1]
    group = np.cumsum(new_group) - 1
    group_starts = starts[new_group]
    n_groups = group[-1] + 1
    group_ends = np.full(n_groups, -np.inf)
    np.maximum.at(group_ends, group, ends)
    return list(zip(group_starts.tolist(), group_ends.tolist()))


class Intervals:
    """A set of non-overlapping, ordered intervals with union/intersection
    length algebra: |A ∩ B| = |A| + |B| − |A ∪ B|.

    (reference: vsc/metrics.py:120-174)
    """

    intervals: List[Tuple[float, float]]

    def __init__(self, intervals: Optional[List[Tuple[float, float]]] = None):
        self.intervals = _merge_intervals(list(intervals or []))

    def add(self, interval: Tuple[float, float]):
        self.intervals = _merge_intervals(self.intervals + [interval])

    def union(self, other: "Intervals") -> "Intervals":
        return Intervals(self.intervals + other.intervals)

    def total_length(self) -> float:
        return float(sum(end - start for start, end in self.intervals))

    def intersect_length(self, other: "Intervals") -> float:
        union = self.union(other)
        return self.total_length() + other.total_length() - union.total_length()

    def __str__(self):
        return str(self.intervals)

    __repr__ = __str__


class Axis(enum.Enum):
    QUERY = enum.auto()
    REF = enum.auto()


class Match(NamedTuple):
    """A ground-truth or predicted segment match; also a 2-D box in
    (query-time × ref-time) space.

    CSV schema (7 columns, any order): query_id, ref_id, score,
    query_start, query_end, ref_start, ref_end
    (reference: vsc/metrics.py:182-235).
    """

    query_id: str
    ref_id: str
    score: float
    query_start: float
    query_end: float
    ref_start: float
    ref_end: float

    def pair_id(self) -> Tuple[str, str]:
        return (self.query_id, self.ref_id)

    def interval(self, axis: Axis) -> Tuple[float, float]:
        if axis == Axis.QUERY:
            return (self.query_start, self.query_end)
        return (self.ref_start, self.ref_end)

    def spans(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        """(query span, ref span) — index 0/1 = the two time axes."""
        return (
            (self.query_start, self.query_end),
            (self.ref_start, self.ref_end),
        )

    def intersection_area(self, other: "Match") -> float:
        dq = min(self.query_end, other.query_end) - max(
            self.query_start, other.query_start
        )
        dr = min(self.ref_end, other.ref_end) - max(self.ref_start, other.ref_start)
        return max(dq, 0.0) * max(dr, 0.0)

    def overlaps(self, other: "Match") -> bool:
        return self.intersection_area(other) > 0.0

    @classmethod
    def write_csv(cls, matches: Collection["Match"], file: Union[str, TextIO]):
        _write_table(file, list(cls._fields), [tuple(m) for m in matches])

    @classmethod
    def read_csv(
        cls, file: Union[str, TextIO], is_gt: bool = False, check: bool = True
    ) -> List["Match"]:
        cols = _read_table(file)
        n = len(next(iter(cols.values())))
        cols["query_id"] = [
            format_video_id(v, Dataset.QUERIES) for v in cols["query_id"]
        ]
        cols["ref_id"] = [format_video_id(v, Dataset.REFS) for v in cols["ref_id"]]
        if is_gt:
            # GT scores are not meaningful; force 1.0
            # (reference: vsc/metrics.py:230-231).
            cols["score"] = [1.0] * n
        if check:
            na_cols = [
                f for f in cls._fields if any(_is_missing(v) for v in cols[f])
            ]
            assert not na_cols, f"NaN values in column(s): {na_cols}"
            # Negative-length segments would poison the interval algebra
            # downstream (division by a cancelled total); fail loudly here
            # instead. (The reference crashes with ZeroDivisionError.)
            bad = [
                i for i in range(n)
                if cols["query_end"][i] < cols["query_start"][i]
                or cols["ref_end"][i] < cols["ref_start"][i]
            ]
            if bad:
                raise ValueError(
                    f"Negative-length segments in rows {bad}: "
                    "segment end must be >= start"
                )
        return [
            Match(**{f: cols[f][i] for f in cls._fields}) for i in range(n)
        ]


class VideoPair:
    """Incremental per-(query, ref) matching state for segment AP.

    Carries per-axis quantities as length-2 vectors (index 0 = query
    time axis, 1 = ref time axis): ``covered`` is the length of GT that
    predictions intersect, ``claimed`` the total length predictions
    span. A GT box participates in ``covered`` only once at least one
    prediction touches it — the VCSL figure-4f correction
    (reference semantics: vsc/metrics.py:238-301).
    """

    __slots__ = ("gts", "preds", "covered", "claimed")

    def __init__(self):
        self.gts: List[Match] = []
        self.preds: List[Match] = []
        self.covered = np.zeros(2)
        self.claimed = np.zeros(2)

    def add_gt(self, bbox: Match):
        self.gts.append(bbox)

    def total_gt_length(self) -> np.ndarray:
        """GT union length per axis, as a (2,) vector."""
        per_axis = zip(*(gt.spans() for gt in self.gts)) if self.gts else ((), ())
        return np.array(
            [Intervals(list(spans)).total_length() for spans in per_axis]
        )

    def add_prediction(self, bbox: Match) -> Tuple[np.ndarray, np.ndarray]:
        """Fold one prediction in; return the (2,) deltas of
        (GT-intersection length, prediction-total length) per axis."""
        self.preds.append(bbox)
        # Only GT boxes touched by some prediction count (fig. 4f).
        active = [
            gt
            for gt in self.gts
            if any(gt.overlaps(p) for p in self.preds)
        ]

        state = np.empty((2, 2))  # rows: covered, claimed; cols: axis
        for ax in range(2):
            pred_union = Intervals([p.spans()[ax] for p in self.preds])
            gt_union = Intervals([g.spans()[ax] for g in active])
            state[0, ax] = pred_union.intersect_length(gt_union)
            state[1, ax] = pred_union.total_length()

        covered_delta = state[0] - self.covered
        claimed_delta = state[1] - self.claimed
        self.covered, self.claimed = state[0], state[1]
        return covered_delta, claimed_delta


def match_metric(
    gts: Collection[Match],
    predictions: Collection[Match],
) -> AveragePrecision:
    """Matching-track segment AP.

    AP = Σ P(i) ΔR(i) with P = √(P_q·P_r), R = √(R_q·R_r); predictions
    visited in descending score order, score ties applied as one group
    (reference semantics: vsc/metrics.py:304-378).
    """
    ledgers: Dict[Tuple[str, str], VideoPair] = {}
    for gt in gts:
        ledgers.setdefault(gt.pair_id(), VideoPair()).add_gt(gt)

    # Denominator: total GT length per axis across all pairs, (2,).
    gt_span = sum(
        (pair.total_gt_length() for pair in ledgers.values()),
        start=np.zeros(2),
    )

    ranked = sorted(predictions, key=lambda m: m.score, reverse=True)
    covered = np.zeros(2)
    claimed = np.zeros(2)
    ap = 0.0
    last_recall = 0.0
    curve_rows: List[Tuple[float, float, float]] = []  # (P, R, score)

    # Walk tie groups: all predictions sharing a score land together.
    i = 0
    while i < len(ranked):
        j = i + 1
        while j < len(ranked) and ranked[j].score == ranked[i].score:
            j += 1
        for pred in ranked[i:j]:
            ledger = ledgers.setdefault(pred.pair_id(), VideoPair())
            covered_delta, claimed_delta = ledger.add_prediction(pred)
            covered += covered_delta
            claimed += claimed_delta

        # Plain-float division so an empty axis raises ZeroDivisionError,
        # as the reference does.
        recall_qr = [float(covered[ax]) / float(gt_span[ax]) for ax in range(2)]
        precision_qr = [float(covered[ax]) / float(claimed[ax]) for ax in range(2)]
        recall = sqrt(recall_qr[0] * recall_qr[1])
        precision = sqrt(precision_qr[0] * precision_qr[1])

        ap += precision * (recall - last_recall)
        if recall > last_recall:
            curve_rows.append((precision, recall, ranked[i].score))
        last_recall = recall
        i = j

    columns = list(zip(*curve_rows)) if curve_rows else ([], [], [])
    curve = PrecisionRecallCurve(*(np.array(col) for col in columns))
    return AveragePrecision(ap, curve)


@dataclasses.dataclass
class MatchingTrackMetrics:
    segment_ap: AveragePrecision
    pairwise_micro_ap: AveragePrecision


def evaluate_matching_track(
    ground_truth_filename: str, predictions_filename: str
) -> MatchingTrackMetrics:
    """Matching-track evaluation from CSV files.

    (reference: vsc/metrics.py:389-415)
    """
    gt = Match.read_csv(ground_truth_filename, is_gt=True)
    predictions = Match.read_csv(predictions_filename)
    metric = match_metric(gt, predictions)
    gt_pairs = CandidatePair.from_matches(gt)
    pairs = CandidatePair.from_matches(predictions)
    pair_ap = average_precision(gt_pairs, pairs)
    return MatchingTrackMetrics(segment_ap=metric, pairwise_micro_ap=pair_ap)


def binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary average precision, numerically identical to
    ``sklearn.metrics.average_precision_score`` for unweighted binary
    labels (the only form the reference uses; vsc/metrics.py:478).

    Step-wise AP over the PR curve: AP = Σ_n (R_n − R_{n−1}) P_n with
    score ties collapsed to one threshold.
    """
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    assert y_true.shape == y_score.shape

    # Stable sort by descending score (ties keep input order).
    order = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[order]
    y_score = y_score[order]

    # Threshold boundaries: last index of each tie group.
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    if tps[-1] == 0:
        return 0.0
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # AP = sum over ascending-recall steps; prepend the (R=0, P=1) point.
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def average_precision(
    ground_truth: Collection[CandidatePair], predictions: Collection[CandidatePair]
) -> AveragePrecision:
    """Descriptor-track micro-AP over candidate pairs.

    Includes the canonical DrivenData AP (rescaled by the fraction of GT
    positives that are present in the prediction set) plus a simple
    cumulative AP and the PR curve sampled at correct hits
    (reference semantics: vsc/metrics.py:418-450).
    """
    positives = {(c.query_id, c.ref_id) for c in ground_truth}
    assert len(positives) == len(ground_truth), (
        "Duplicates detected in ground truth"
    )
    distinct_preds = {(c.query_id, c.ref_id) for c in predictions}
    assert len(distinct_preds) == len(predictions), (
        "Duplicates detected in predictions"
    )

    canonical_ap = drivendata_average_precision(
        predicted=predictions, ground_truth=ground_truth
    )

    ranked = sorted(predictions, key=lambda c: c.score, reverse=True)
    hits = np.fromiter(
        ((c.query_id, c.ref_id) in positives for c in ranked),
        dtype=bool,
        count=len(ranked),
    )
    hits_so_far = np.cumsum(hits)
    precision_at = hits_so_far / np.arange(1, hits.size + 1)
    # numpy division: empty GT yields nan (+RuntimeWarning), matching
    # the reference rather than raising ZeroDivisionError
    # (vsc/metrics.py:441-446).
    with np.errstate(invalid="ignore", divide="ignore"):
        simple_ap = float(
            np.float64(precision_at[hits].sum()) / len(positives)
        )
        recall_at_hits = hits_so_far[hits] / max(len(positives), 1)

    scores = np.array([c.score for c in ranked])
    curve = PrecisionRecallCurve(precision_at[hits], recall_at_hits, scores[hits])
    return AveragePrecision(ap=canonical_ap, pr_curve=curve, simple_ap=simple_ap)


def drivendata_average_precision(
    predicted: Iterable[CandidatePair],
    ground_truth: Iterable[CandidatePair],
) -> float:
    """Canonical challenge AP: unadjusted binary AP over predictions
    labeled against GT, rescaled by predicted_n_pos / actual_n_pos to
    penalize non-exhaustive prediction sets.

    The reference realizes the labeling as a pandas left-merge
    (vsc/metrics.py:453-489); a set-membership lookup over the records
    is equivalent because the caller guarantees GT pairs are unique.
    """
    predicted = [
        (format_video_id(c.query_id, Dataset.QUERIES),
         format_video_id(c.ref_id, Dataset.REFS), c.score)
        for c in predicted
    ]
    if not predicted:
        # The reference's frame of an empty prediction list has no
        # columns, so its score lookup raises; so does this.
        raise KeyError("score")
    ground_truth = list(ground_truth)
    scores = np.array([p[2] for p in predicted], dtype=np.float64)
    if not np.isfinite(scores).all():
        raise ValueError("Scores must be finite.")

    positives = {
        (format_video_id(c.query_id, Dataset.QUERIES),
         format_video_id(c.ref_id, Dataset.REFS))
        for c in ground_truth
    }
    labels = np.fromiter(
        ((q, r) in positives for q, r, _ in predicted),
        dtype=np.float64,
        count=len(predicted),
    )

    matched_n_pos = int(labels.sum())
    if matched_n_pos == 0:
        return 0.0
    raw_ap = binary_average_precision(labels, scores)
    # Rows with a blank ref_id exist only to validate query ids upstream;
    # they are not scorable positives.
    actual_n_pos = sum(not _is_missing(c.ref_id) for c in ground_truth)
    return raw_ap * (matched_n_pos / actual_n_pos)
