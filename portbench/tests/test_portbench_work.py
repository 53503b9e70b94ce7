"""The frozen work arithmetic against counts made by hand."""

from __future__ import annotations

import pytest

from portbench.work.cpqr import cpqr_batched_bound, cpqr_bound, cpqr_work
from portbench.work.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def test_a_act_transpose_of_cr1000():
    # 1000 x 998, 998 steps, float64.  Flops: 2 r c for the first norms,
    # then 6 (r - k)(c - k - 1) a step; with j = 997 - k that is
    # 6 sum_{j=0}^{997} (j + 3) j = 6 (sum j^2 + 3 sum j).
    s2 = 997 * 998 * 1995 // 6
    s1 = 997 * 998 // 2
    flops = 2 * 1000 * 998 + 6 * (s2 + 3 * s1)
    least = 2 * 1000 * 998 * 8 + 998 * 8 + 998 * 4
    got = cpqr_work(1000, 998, 998, 8)
    assert got[0] == least == 15_979_976
    assert got[1] == flops == 1_995_988_024
    ms, by, _ = cpqr_bound(1000, 998, 998, 8)
    assert by == "operations"
    assert ms == pytest.approx(flops / 33.5e12 * 1e3)


def test_j2_of_cr1000():
    # 1998 x 1000, 2 steps, float64
    flops = 2 * 1998 * 1000 + 6 * (1998 * 999 + 1997 * 998)
    least = 2 * 1998 * 1000 * 8 + 1000 * 8 + 1000 * 4
    streamed = 1998 * 1000 * 8 + 3 * 8 * (1998 * 999 + 1997 * 998)
    got = cpqr_work(1998, 1000, 2, 8)
    assert got == (least, flops, streamed)
    assert (least, flops) == (31_980_000, 27_930_048)
    ms, by, _ = cpqr_bound(1998, 1000, 2, 8)
    assert by == "bytes"
    assert ms == pytest.approx(least / 3.35e12 * 1e3)


def test_batched_bound_of_hs65():
    # 4096 lanes of 3 x 2, both steps, float64: bytes bound
    nbytes = 2 * 4096 * 3 * 2 * 8 + 4096 * (2 * 8 + 4 * 2)
    flops = 6 * 4096 * (3 * 2 + 2 * 1)
    ms, by = cpqr_batched_bound(4096, 3, 2, 8)
    assert by == "bytes"
    assert ms == pytest.approx(max(nbytes / HBM_BYTES_PER_S,
                                   flops / PEAK_FLOPS[8]) * 1e3)


def test_peaks_are_the_published_ones():
    assert HBM_BYTES_PER_S == 3.35e12
    assert PEAK_FLOPS == {4: 67e12, 8: 33.5e12}
