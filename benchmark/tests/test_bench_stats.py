"""The metric arithmetic: a rate over the whole window, and busy time and
idle share from a device timeline."""

import pytest

from benchmark.harness import stats, trace


def test_rate_over_the_whole_window():
    assert stats.rate(256 * 30, 20.48) == pytest.approx(375.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_and_gaps_of_intervals():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert stats.union_length(iv) == 12 + 10 + 1
    assert stats.gaps(iv, 0, 41) == [(12, 20), (30, 40)]
    assert stats.gaps(iv, -5, 50) == [(-5, 0), (12, 20), (30, 40), (41, 50)]


def test_idle_share_from_a_synthetic_trace():
    # Two calls, each 30 us of kernels (two overlapping) in a 50 us call.
    dev = [("k1", 0, 20), ("k2", 10, 30), ("copy", 60, 70), ("k1", 80, 100)]
    host = [("step", 0, 45), ("fetch", 45, 50), ("step", 50, 100)]
    t = trace.summarize(dev, host, calls=2, window_s=100e-6)
    assert t.busy_s == pytest.approx(60e-6)
    assert t.busy_per_call_ms() == pytest.approx(0.03)
    assert t.activities_per_call() == 2
    t.wall_per_call_s = 50e-6
    assert t.idle_share_pct() == pytest.approx(40.0)
    # The idle gaps, labelled by the innermost span open where they start.
    assert t.idle_gaps == [("step", pytest.approx(30e-6)),
                           ("step", pytest.approx(10e-6))]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(40e-6)]
    assert len(b["idle_gaps"]) == 2


def test_roofline_share_reads_nothing_without_the_kernel():
    t = trace.summarize([("fast_candidates_kernel", 0, 10)], [], calls=1, window_s=1e-5)
    t.bounds["fast_cand"] = 5e-6
    assert t.roofline_pct("fast_cand", "fast_candidates_kernel") == pytest.approx(50.0)
    assert t.roofline_pct("klt_level", "track_level_kernel") is None
