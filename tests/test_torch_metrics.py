"""The port's csv-module metrics against the JAX package's pandas ones:
byte-identical CSV files, identical parsed records (GT read included)
and identical metric values."""

import io

import numpy as np
import pytest

from vsc2022_torch import metrics as tm
from vsc2022_tpu import metrics as jm

FLOATS = [0.1, 1e-05, 1e16, 1e15, 1.2345678901234568e17, -0.0, 1.0,
          3.4028234663852886e38, 0.30000000000000004, 2.5e-07, 1234567.0,
          float(np.float32(0.7)), -17.25]


def _candidates(mod, n=40, seed=0, int_scores=False):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        score = int(rng.randint(0, 9)) if int_scores else (
            FLOATS[i] if i < len(FLOATS) else float(rng.randn()))
        out.append(mod.CandidatePair(
            query_id=f"Q{rng.randint(0, 50):06d}" if i % 3 else i,
            ref_id=f"R{rng.randint(0, 50):06d}" if i % 4 else i + 7,
            score=score,
        ))
    return out


def _matches(mod, n=30, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        qs = float(rng.randint(0, 50))
        rs = np.float64(rng.randint(0, 50)) + 0.5
        out.append(mod.Match(
            query_id=f"Q{rng.randint(0, 5):06d}",
            ref_id=f"R{rng.randint(0, 5):06d}",
            score=FLOATS[i % len(FLOATS)] if i % 2 else float(np.float32(rng.rand())),
            query_start=qs, query_end=qs + rng.randint(1, 9),
            ref_start=rs, ref_end=rs + rng.randint(1, 9),
        ))
    return out


def _write(fn, rows):
    buf = io.StringIO()
    fn(rows, buf)
    return buf.getvalue()


@pytest.mark.parametrize("int_scores", [False, True])
def test_candidate_csv_bytes_identical(int_scores):
    rows = _candidates(jm, int_scores=int_scores)
    want = _write(jm.CandidatePair.write_csv, rows)
    got = _write(tm.CandidatePair.write_csv, rows)
    assert got == want


def test_empty_csvs_identical():
    assert _write(tm.CandidatePair.write_csv, []) == _write(
        jm.CandidatePair.write_csv, []
    )
    assert _write(tm.Match.write_csv, []) == _write(jm.Match.write_csv, [])


def test_match_csv_bytes_identical():
    rows = _matches(jm)
    assert _write(tm.Match.write_csv, rows) == _write(jm.Match.write_csv, rows)


def test_candidate_csv_read_identical(tmp_path):
    path = str(tmp_path / "c.csv")
    jm.CandidatePair.write_csv(_candidates(jm), path)
    want = jm.CandidatePair.read_csv(path)
    got = tm.CandidatePair.read_csv(path)
    assert [tuple(vars(c).values()) for c in got] == [
        tuple(vars(c).values()) for c in want
    ]
    # Numeric ids parse as integers and take the Q/R prefix, as in pandas.
    numeric = io.StringIO("query_id,ref_id,score\n3,12,0.5\n")
    assert tm.CandidatePair.read_csv(numeric)[0].query_id == "Q000003"


@pytest.mark.parametrize("is_gt", [False, True])
def test_match_csv_read_identical(tmp_path, is_gt):
    path = str(tmp_path / "m.csv")
    jm.Match.write_csv(_matches(jm), path)
    want = jm.Match.read_csv(path, is_gt=is_gt)
    got = tm.Match.read_csv(path, is_gt=is_gt)
    assert [tuple(m) for m in got] == [tuple(m) for m in want]
    assert [[type(v) for v in m] for m in got] == [[type(v) for v in m] for m in want]


def test_integer_gt_columns_parse_as_pandas_does():
    text = ("query_id,ref_id,query_start,query_end,ref_start,ref_end\n"
            "Q000001,R000002,15,27,8,20\nQ000003,R000004,1,2.5,3,4\n")
    want = jm.Match.read_csv(io.StringIO(text), is_gt=True)
    got = tm.Match.read_csv(io.StringIO(text), is_gt=True)
    assert [tuple(m) for m in got] == [tuple(m) for m in want]
    assert [[type(v) for v in m] for m in got] == [[type(v) for v in m] for m in want]


def test_read_checks_match_pandas_version():
    bad = ("query_id,ref_id,score,query_start,query_end,ref_start,ref_end\n"
           "Q000001,R000002,1.0,5,3,0,1\n")
    for mod in (jm, tm):
        with pytest.raises(ValueError, match="Negative-length"):
            mod.Match.read_csv(io.StringIO(bad))
    nan = ("query_id,ref_id,score,query_start,query_end,ref_start,ref_end\n"
           "Q000001,R000002,,0,3,0,1\n")
    for mod in (jm, tm):
        with pytest.raises(AssertionError, match="NaN"):
            mod.Match.read_csv(io.StringIO(nan))


def test_metric_values_identical(tmp_path):
    gt = _matches(jm, n=12, seed=4)
    preds = _matches(jm, n=40, seed=5)
    gt_path, pred_path = str(tmp_path / "gt.csv"), str(tmp_path / "p.csv")
    jm.Match.write_csv(gt, gt_path)
    jm.Match.write_csv(preds, pred_path)
    want = jm.evaluate_matching_track(gt_path, pred_path)
    got = tm.evaluate_matching_track(gt_path, pred_path)
    assert got.segment_ap.ap == want.segment_ap.ap
    assert got.pairwise_micro_ap.ap == want.pairwise_micro_ap.ap
    np.testing.assert_array_equal(
        got.segment_ap.pr_curve.recalls, want.segment_ap.pr_curve.recalls
    )
    cands = _candidates(jm, n=60, seed=6)
    dedup = list({(c.query_id, c.ref_id): c for c in cands}.values())
    gt_pairs = jm.CandidatePair.from_matches(gt)
    w = jm.average_precision(gt_pairs, dedup)
    g = tm.average_precision(gt_pairs, dedup)
    assert (g.ap, g.simple_ap) == (w.ap, w.simple_ap)


def test_empty_predictions_score_zero_where_jax_raises():
    # Empty predictions raise in both packages: the JAX package builds an
    # empty DataFrame and fails on its missing "score" column, and the
    # port raises the same KeyError (it used to score 0.0).
    gt = [jm.CandidatePair("Q000001", "R000001", 1.0)]
    with pytest.raises(KeyError) as want:
        jm.average_precision(gt, [])
    with pytest.raises(KeyError) as got:
        tm.average_precision(gt, [])
    assert got.value.args == want.value.args == ("score",)


def _pair_matches(types, seed=7):
    """PairMatches of one package's types with float frame scores."""
    rng = np.random.RandomState(seed)
    out = []
    for p in range(12):
        n = int(rng.randint(1, 9))
        out.append(types.PairMatches(
            f"Q{p % 4:06d}", f"R{p:06d}",
            [types.PairMatch(float(i), float(i + 1), float(rng.randn()))
             for i in range(n)]))
    return out


@pytest.mark.parametrize("agg", [("MaxScoreAggregation", ()),
                                 ("SumScoreAggregation", ()),
                                 ("TopKMeanScoreAggregation", ()),
                                 ("TopKMeanScoreAggregation", (1,)),
                                 ("TopKMeanScoreAggregation", (3,))])
def test_aggregations_identical_to_jax(agg):
    # The same float64 reductions over each pair's frame scores: the
    # ranked candidates are equal, scores included (tolerance 0).
    from vsc2022_torch import types as tt
    from vsc2022_torch.retrieval import candidates as tc
    from vsc2022_tpu import types as jt
    from vsc2022_tpu.retrieval import candidates as jc

    name, args = agg
    want = jc.rank_candidates(_pair_matches(jt), getattr(jc, name)(*args))
    got = tc.rank_candidates(_pair_matches(tt), getattr(tc, name)(*args))
    assert [(c.query_id, c.ref_id, c.score) for c in got] == \
        [(c.query_id, c.ref_id, c.score) for c in want]


def test_candidate_to_dataframe_identical_to_jax():
    import pandas as pd

    for n in (0, 40):
        want = jm.CandidatePair.to_dataframe(_candidates(jm, n=n, seed=8))
        got = tm.CandidatePair.to_dataframe(_candidates(tm, n=n, seed=8))
        pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("given_ax", [False, True])
def test_pr_curve_plot_draws_what_jax_draws(given_ax):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(9)
    arrays = (np.sort(rng.rand(20)), np.sort(rng.rand(20)), rng.rand(20))
    axes = []
    for mod in (jm, tm):
        ax = plt.subplots()[1] if given_ax else None
        axes.append(mod.PrecisionRecallCurve(*arrays).plot(ax, linewidth=1))
    want, got = axes
    assert got.get_xlabel() == want.get_xlabel() and got.get_xlim() == want.get_xlim()
    (lw,), (lg,) = want.get_lines(), got.get_lines()
    np.testing.assert_array_equal(lg.get_xydata(), lw.get_xydata())
    assert lg.get_linewidth() == lw.get_linewidth() == 1
    plt.close("all")
