"""The copied roofline arithmetic gives chip_smoke.py's recorded bounds
(PERF.md's kernel table)."""

import pytest
import torch

from benchmark import roofline


def test_k1_bound_at_the_main_path():
    assert roofline.k1_bound(2048, 11, 14) == pytest.approx(0.0108, abs=5e-5)


def test_k2_bound_at_the_main_path():
    assert roofline.k2_bound(206_848, 7, 16) == pytest.approx(0.0966, abs=5e-5)


def test_k3_bound_counts_distinct_rows():
    pts = torch.tensor([[0.01, 0.01, 0.01], [0.011, 0.012, 0.013], [0.5, 0.5, 0.5],
                        [-9.0, -9.0, -9.0]], dtype=torch.float64)
    rows = roofline.distinct_rows(pts, [0.0, 0.0, 0.0], 0.1, [10, 10, 10])
    # the first two share a cell, and the last is clamped into it too
    assert rows == 2
    N = 4
    nbytes = N * 3 * 4 + rows * 32 + N * 17
    assert roofline.k3_bound(N, 3, rows) == pytest.approx(
        max(nbytes / roofline.HBM_BYTES_PER_S, N * 120 / roofline.F32_FLOPS) * 1e3)
