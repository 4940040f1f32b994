"""The bytes B1 and B5 must move, counted from a call's shapes."""

import pytest
import torch

from benchmark.harness import roofline


def test_b1_bytes_count_rays_tables_and_winners_once():
    n = 1 << 17
    o, d = torch.zeros(n, 3), torch.zeros(n, 3)
    groups = (torch.zeros(512, 4), torch.zeros(512, dtype=torch.int32),
              torch.zeros(16, 8), torch.zeros(8, 16, dtype=torch.int32), 3)
    tables = 512 * 16 + 512 * 4 + 16 * 32 + 8 * 16 * 4
    assert roofline.b1_bytes(None, None, o, d, 1e-3, float("inf"),
                             groups=groups) == n * 32 + tables
    lo = torch.zeros(n)  # per-ray bounds move their bytes too
    assert roofline.b1_bytes(None, None, o, d, lo, lo,
                             groups=groups) == n * 40 + tables


def test_b5_bytes_count_the_packed_nodes_orders_and_spheres():
    n, m, s = 1000, 1023, 10_000
    o, d = torch.zeros(n, 3), torch.zeros(n, 3)
    card = (torch.zeros(m, 8), torch.zeros(8, m, 2, dtype=torch.int32))
    got = roofline.b5_bytes(torch.zeros(m, 8), torch.zeros(m, 4), torch.zeros(
        s, 4), o, d, 1e-3, float("inf"), card=card)
    assert got == n * 32 + m * (32 + 64) + s * 16


def test_share_against_the_cards_bandwidth():
    assert roofline.share(3.35e9, 1e-3, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(100.0)
    assert roofline.share(1.0, 1.0, "some other card") is None
    assert roofline.share(1.0, 0.0, "NVIDIA H100 80GB HBM3") is None
