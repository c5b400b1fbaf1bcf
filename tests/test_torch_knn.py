"""Per-query KNN search (``global_k < 0``) on the port's indexes against
the JAX package's.

``VideoIndex.search(queries, global_k=-k)`` regroups each query frame's k
best reference frames (the searcher's ``row_topk``) per (query video, ref
video) pair, as the reference's vanilla KNN mode does (against the VSC
rules; provided for comparison). On integer-valued descriptors every
score is exact on both sides (int8: one rounding of an exact sum by the
same scale), and on the dyadic rows of the score-normalized index (±1 on
four dimensions, β = 1.25) every normalized score is a multiple of 1/16:
the pairs, their matches and their order compare for identity
(tolerance 0).
"""

import logging

import numpy as np
import pytest

from vsc2022_torch.retrieval.index import ScoreNormalizedVideoIndex, VideoIndex
from vsc2022_torch.types import VideoFeature as TVF
from vsc2022_tpu.retrieval.index import ScoreNormalizedVideoIndex as JaxSNIndex
from vsc2022_tpu.retrieval.index import VideoIndex as JaxVideoIndex
from vsc2022_tpu.types import VideoFeature as JVF


def _videos(vf, feats, prefix, lengths, offset=0):
    out, at = [], 0
    for i, n in enumerate(lengths):
        out.append(vf(video_id=f"{prefix}{offset + i:06d}",
                      timestamps=np.arange(n, dtype=np.float64) / 2,
                      feature=feats[at : at + n]))
        at += n
    return out


def _ints(shape, seed):
    return np.random.RandomState(seed).randint(-3, 4, size=shape).astype(np.float32)


def _dyadic(rng, n, d=16):
    """[n, d]: dimension 0 at zero, ±1 on four of the others."""
    x = np.zeros((n, d), np.float32)
    cols = 1 + np.argsort(rng.rand(n, d - 1), axis=1)[:, :4]
    np.put_along_axis(x, cols, rng.choice([-1.0, 1.0], size=(n, 4)), axis=1)
    return x


def _matches(pair_matches):
    return [
        (m.query_id, m.ref_id,
         [(tuple(np.atleast_1d(x.query_timestamps)), tuple(np.atleast_1d(x.ref_timestamps)),
           x.score) for x in m.matches])
        for m in pair_matches
    ]


@pytest.mark.parametrize("metric,dtype", [
    ("IP", "float32"), ("IP", "bfloat16"), ("IP", "int8"),
    ("L2", "float32"), ("L2", "bfloat16"),
])
@pytest.mark.parametrize("k", [1, 7])
def test_video_index_knn_identical_to_jax(metric, dtype, k):
    r, q = _ints((600, 12), 1), _ints((45, 12), 2)
    r[[3, 9, 300]] = r[5]  # ties across videos: the lower row first
    q[0] = r[5]
    lengths = [150, 250, 200]
    ji = JaxVideoIndex(12, metric=metric, dtype=dtype)
    ti = VideoIndex(12, metric=metric, dtype=dtype, device="cpu")
    ji.add(_videos(JVF, r, "R", lengths))
    ti.add(_videos(TVF, r, "R", lengths))
    want = ji.search(_videos(JVF, q, "Q", [20, 25]), global_k=-k)
    got = ti.search(_videos(TVF, q, "Q", [20, 25]), global_k=-k)
    assert _matches(got) == _matches(want)
    assert sum(len(m.matches) for m in got) == 45 * k


def test_knn_takes_at_most_the_corpus_and_warns(caplog):
    r, q = _ints((30, 8), 3), _ints((4, 8), 4)
    ji, ti = JaxVideoIndex(8), VideoIndex(8, device="cpu")
    ji.add(_videos(JVF, r, "R", [30]))
    ti.add(_videos(TVF, r, "R", [30]))
    with caplog.at_level(logging.WARNING, logger="vsc2022_torch.retrieval.index"):
        got = ti.search(_videos(TVF, q, "Q", [4]), global_k=-50)
    assert "violates the VSC rules" in caplog.text
    assert _matches(got) == _matches(ji.search(_videos(JVF, q, "Q", [4]), global_k=-50))
    assert sum(len(m.matches) for m in got) == 4 * 30
    assert ti.search([], global_k=-3) == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_score_normalized_index_knn_identical_to_jax(dtype):
    rng = np.random.RandomState(5)
    r, q, noise = _dyadic(rng, 400), _dyadic(rng, 40), _dyadic(rng, 100)
    q[:5] = r[10:15]
    kw = dict(beta=1.25, dtype=dtype)
    ji = JaxSNIndex(16, _videos(JVF, noise, "R", [100], offset=500), **kw)
    ti = ScoreNormalizedVideoIndex(16, _videos(TVF, noise, "R", [100], offset=500),
                                   device="cpu", **kw)
    ji.add(_videos(JVF, r, "R", [180, 220]))
    ti.add(_videos(TVF, r, "R", [180, 220]))
    want = ji.search(_videos(JVF, q, "Q", [15, 25]), global_k=-4)
    got = ti.search(_videos(TVF, q, "Q", [15, 25]), global_k=-4)
    assert _matches(got) == _matches(want)
    # The KNN rows stage in the corpus's query dtype: the same normalized
    # queries the global search takes.
    assert ti._get_searcher().searcher.dtype == dtype
