"""The percentile, rate, bound and busy-interval arithmetic on hand-made
numbers."""

import pytest

import peaks
import stats


def test_percentile_nearest_rank():
    xs = list(range(1, 101))                 # 1..100
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    # 200 samples: 10 lie beyond the 95th percentile
    ys = list(range(200))
    p = stats.percentile(ys, 95)
    assert sum(y > p for y in ys) == 10
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    with pytest.raises(ValueError):
        stats.percentile([1.0], 0)


def test_rate():
    assert stats.rate(64 * 300, 10.0) == pytest.approx(1920.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_merged_length_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.merged_length(iv) == pytest.approx(4.0)
    assert stats.merged_length([]) == 0.0
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert stats.gaps([], 1, 2) == [(1, 2)]


def test_bounds_from_shapes():
    ms, by = peaks.bound_ms(3.35e9, 0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = peaks.bound_ms(0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    b, o = peaks.waterfall_work(64)
    # chip_smoke's 30.5 MB for the 64-channel waterfall
    assert b / 1e6 == pytest.approx(30.5, abs=0.1)
    assert o == 5 * 1024 * 10 * 184 * 64
    b, o = peaks.sync_work(64)
    assert o == 64 * 2 * 2 * 36 * 249 * 84
    b, o = peaks.bp_work(10, 0)
    assert o == 0 and b == 10 * 174 * 5 + 40
    assert peaks.llr_work(0) == (0, 0)
    assert peaks.snr_work(0) == (0, 0)


def test_roofline_pct_by_kernel_name():
    tr = {"profile": {"device": [("void bp_kernel<1>", 0.0, 2000.0),
                                 ("other", 0.0, 5.0)]},
          "work": [{"bp": [(3.35e9, 0)]}]}
    # bound 1 ms over 2 ms of device time
    assert peaks.roofline_pct(tr, "bp") == pytest.approx(50.0)
    assert peaks.roofline_pct(tr, "sync") is None
    assert peaks.roofline_pct({"profile": None}, "bp") is None
