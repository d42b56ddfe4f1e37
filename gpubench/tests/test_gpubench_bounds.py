"""The frozen bound arithmetic reproduces PERF.md's bounds."""

import pytest

from gpubench import bounds

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("n,k,touched,ms", [
    (900_000, 31, 100_001, 0.0678),        # phase 7's fixed effect
    (900_000, 32, 100_001, 0.0700),        # phase 6's ELL arrays
    (148_520, 264, 900_000, 0.0949),       # phase 6's transposed ELL
    (106_496, 30, 100_001, 0.0079),        # phase 7's scoring chunk
])
def test_bounds_match_the_recorded_ones(n, k, touched, ms):
    peak = bounds.CARD_PEAK_BYTES_PER_S[H100]
    got = bounds.gather_rowsum_bound_s(n, k, touched, peak)
    assert round(got * 1e3, 4) == ms


def test_a_bound_is_bytes_bound_at_these_widths():
    t = bounds.gather_rowsum_bound_s(900_000, 31, 100_001,
                                     bounds.CARD_PEAK_BYTES_PER_S[H100])
    assert t == (900_000 * 31 * 8 + 100_001 * 4 + 900_000 * 4) / 3.35e12


@pytest.mark.parametrize("nnz,dim,touched,ms", [
    (10_000_000 * 12, 54_686_453, 10_000_000, 0.4944),   # glm-fit
    (900_000 * 31, 100_001, 900_000, 0.0681),            # phase 7's
])
def test_sorted_colsum_bounds_match_the_recorded_ones(nnz, dim, touched, ms):
    peak = bounds.CARD_PEAK_BYTES_PER_S[H100]
    got = bounds.sorted_colsum_bound_s(nnz, dim, touched, peak)
    assert round(got * 1e3, 4) == ms
