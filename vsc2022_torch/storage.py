"""NPZ feature storage — the frozen external contract (the port's own
copy of ``vsc2022_tpu/storage.py``).

Format (reference: vsc/storage.py:13-25): arrays ``video_ids`` (one
string per frame), ``features`` [ΣN, D], ``timestamps`` [ΣN] or [ΣN, 2].
A video's rows must be contiguous; ``load_features`` splits on
contiguous same-id ranges (reference semantics: vsc/storage.py:28-68).
Only the on-disk format is contract; this implementation is vectorized
run-splitting rather than a per-element Python walk.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from vsc2022_torch.metrics import Dataset, format_video_id
from vsc2022_torch.types import VideoFeature


def store_features(
    f, features: List[VideoFeature], dataset: Optional[Dataset] = None
) -> None:
    """Write a list of per-video features as one flat npz archive."""
    ids_per_frame = [
        np.full(len(vf), format_video_id(vf.video_id, dataset))
        for vf in features
    ]
    arrays = {
        "video_ids": np.concatenate(ids_per_frame),
        "features": np.concatenate([vf.feature for vf in features]),
        "timestamps": np.concatenate([vf.timestamps for vf in features]),
    }
    np.savez(f, **arrays)


def _run_boundaries(ids: np.ndarray) -> np.ndarray:
    """Split points between contiguous runs of equal ids, vectorized.

    Returns the sorted index array suitable for ``np.split`` (excludes
    0 and len). The reference walks frame-by-frame in Python
    (vsc/storage.py:28-39) — measurable on million-frame corpora.
    """
    if ids.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    return np.flatnonzero(ids[1:] != ids[:-1]) + 1


def _check_archive(feats: np.ndarray, timestamps: np.ndarray) -> None:
    n_feat, n_ts = feats.shape[0], timestamps.shape[0]
    if n_ts != n_feat:
        raise ValueError(
            f"Row-count mismatch in npz archive: {n_feat} feature rows "
            f"vs {n_ts} timestamp rows"
        )
    if timestamps.ndim not in (1, 2) or (
        timestamps.ndim == 2 and timestamps.shape[1] != 2
    ):
        raise ValueError(
            f"Timestamps must be [N] points or [N, 2] intervals; "
            f"archive has shape {timestamps.shape}"
        )


def load_features(f, dataset: Optional[Dataset] = None) -> List[VideoFeature]:
    """Read an npz archive back into per-video features.

    Rows belonging to one video must be contiguous (the npz contract);
    splitting is on run boundaries of the ``video_ids`` column.
    """
    with np.load(f, allow_pickle=False) as data:
        video_ids = data["video_ids"]
        feats = data["features"]
        timestamps = data["timestamps"]
    _check_archive(feats, timestamps)

    cuts = _run_boundaries(video_ids)
    starts = np.concatenate([[0], cuts]) if video_ids.shape[0] else cuts
    return [
        VideoFeature(
            video_id=format_video_id(video_ids[start], dataset),
            timestamps=ts_chunk,
            feature=feat_chunk,
        )
        for start, feat_chunk, ts_chunk in zip(
            starts.tolist(), np.split(feats, cuts), np.split(timestamps, cuts)
        )
    ]


def convert_to_dict(features: List[VideoFeature]) -> Dict[str, VideoFeature]:
    """Per-video features keyed by video id."""
    return {vf.video_id: vf for vf in features}
