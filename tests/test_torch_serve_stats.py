"""Unit tests for ``repro_torch.serve.stats`` (LatencyStats / Histogram):
the counterpart of every test in ``tests/test_serve_stats.py``.

Exact nearest-rank percentiles and the decimating reservoir, on the
port's accumulators; where a test feeds a sequence, the reference's
``repro.serve.stats`` is fed the same one and must end in the same state
(reservoir, stride, count, total and every percentile asked).
"""
import math
import random

import pytest

from repro.serve import stats as ref_stats
from repro_torch.serve.stats import Histogram, LatencyStats


def _same_as_reference(s: LatencyStats, values, cap=100_000, qs=(0.5, 0.99)):
    r = ref_stats.LatencyStats(cap=cap)
    for v in values:
        r.record(v)
    assert (s._sorted, s._stride, s._skip, s.count, s.total) == (
        r._sorted, r._stride, r._skip, r.count, r.total)
    assert [s.percentile(q) for q in qs] == [r.percentile(q) for q in qs]
    assert s.summary() == r.summary()


# ---------------------------------------------------------------- percentiles


def test_percentile_empty_returns_zero():
    s = LatencyStats()
    assert s.percentile(0.50) == 0.0
    assert s.percentile(0.99) == 0.0
    assert s.mean == 0.0
    assert s.summary() == {"count": 0, "mean_s": 0.0, "p50_s": 0.0, "p99_s": 0.0}


def test_percentile_single_sample_is_that_sample():
    s = LatencyStats()
    s.record(3.5)
    for q in (0.01, 0.50, 0.99, 1.0):
        assert s.percentile(q) == 3.5


def test_percentile_two_samples_nearest_rank():
    # nearest-rank: p50 of {1, 9} is the ceil(0.5*2)=1st sample — the LOWER
    # one.  The old round-half-up rule returned 9 here.
    s = LatencyStats()
    s.record(9.0)
    s.record(1.0)
    assert s.percentile(0.50) == 1.0
    assert s.percentile(0.99) == 9.0


def test_percentile_three_samples_nearest_rank():
    s = LatencyStats()
    for v in (30.0, 10.0, 20.0):
        s.record(v)
    assert s.percentile(0.50) == 20.0  # ceil(0.5*3)=2nd sample
    assert s.percentile(0.99) == 30.0
    assert s.percentile(1.0 / 3.0) == 10.0


def test_percentile_matches_nearest_rank_definition_exhaustively():
    # cross-check against the textbook definition for every N up to 40
    rng = random.Random(7)
    for n in range(1, 41):
        s = LatencyStats()
        vals = [rng.uniform(0.0, 100.0) for _ in range(n)]
        for v in vals:
            s.record(v)
        ordered = sorted(vals)
        for q in (0.01, 0.25, 0.50, 0.75, 0.90, 0.99):
            rank = max(1, math.ceil(q * n))  # 1-based nearest rank
            assert s.percentile(q) == ordered[rank - 1], (n, q)
        _same_as_reference(s, vals, qs=(0.01, 0.25, 0.50, 0.75, 0.90, 0.99))


def test_percentile_q_edges_clamp_in_range():
    s = LatencyStats()
    for v in (1.0, 2.0, 3.0, 4.0):
        s.record(v)
    assert s.percentile(0.0) == 1.0  # ceil(0)=0 clamps to the first sample
    assert s.percentile(1.0) == 4.0


# ---------------------------------------------------------- decimation / cap


def test_decimation_crossing_cap_halves_reservoir_and_doubles_stride():
    s = LatencyStats(cap=8)
    for i in range(8):
        s.record(float(i))
    assert s._stride == 1 and len(s._sorted) == 8
    # the 9th sample crosses the cap: reservoir halves, stride doubles,
    # and the new sample still lands in the (now coarser) reservoir
    s.record(100.0)
    assert s._stride == 2
    assert len(s._sorted) == 5  # 8 -> every other (4) + the new sample
    assert 100.0 in s._sorted
    assert s._sorted == sorted(s._sorted)
    _same_as_reference(s, [float(i) for i in range(8)] + [100.0], cap=8)


def test_decimation_keeps_exact_count_and_mean():
    # count/mean/total are exact regardless of reservoir decimation
    s = LatencyStats(cap=4)
    vals = [float(i) for i in range(1, 101)]
    for v in vals:
        s.record(v)
    assert s.count == 100
    assert s.total == pytest.approx(sum(vals))
    assert s.mean == pytest.approx(sum(vals) / 100)
    assert len(s._sorted) <= s.cap
    assert s._stride > 1


def test_decimation_reservoir_stays_sorted_and_spans_eras():
    # after several cap crossings the retained samples still cover both the
    # oldest and the newest eras (decimation, not tail-dropping)
    s = LatencyStats(cap=16)
    for i in range(1000):
        s.record(float(i))
    assert s._sorted == sorted(s._sorted)
    assert len(s._sorted) <= s.cap
    assert min(s._sorted) < 250.0 and max(s._sorted) > 750.0
    # percentiles remain monotone in q on the decimated reservoir
    ps = [s.percentile(q) for q in (0.1, 0.25, 0.5, 0.75, 0.9, 0.99)]
    assert ps == sorted(ps)
    _same_as_reference(s, [float(i) for i in range(1000)], cap=16,
                       qs=(0.1, 0.25, 0.5, 0.75, 0.9, 0.99))


def test_stride_skips_between_retained_samples():
    s = LatencyStats(cap=2)
    for i in range(12):
        s.record(float(i))
    # stride grew past 1, so the reservoir holds far fewer than count
    assert s._stride >= 2
    assert len(s._sorted) < s.count
    _same_as_reference(s, [float(i) for i in range(12)], cap=2)


# ------------------------------------------------------------------ histogram


def test_histogram_counts_mean_and_summary():
    h = Histogram()
    assert h.total == 0 and h.mean == 0.0
    for v in (3, 1, 3, 2, 3):
        h.record(v)
    assert h.total == 5
    assert h.counts == {1: 1, 2: 1, 3: 3}
    assert h.mean == pytest.approx((1 + 2 + 3 * 3) / 5)
    summ = h.summary()
    assert summ["counts"] == {"1": 1, "2": 1, "3": 3}
    assert list(summ["counts"]) == ["1", "2", "3"]  # sorted keys
    r = ref_stats.Histogram()
    for v in (3, 1, 3, 2, 3):
        r.record(v)
    assert summ == r.summary()


def test_histogram_coerces_to_int():
    h = Histogram()
    h.record(2.0)
    h.record(2)
    assert h.counts == {2: 2}
