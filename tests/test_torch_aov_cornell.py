"""Port parity: the AOV pre-pass on cornell (the TLAS route), against
op-by-op and compiled JAX; the rules are tests/test_torch_aov.py's."""

import pytest

from test_torch_aov import check_aov_frame


@pytest.mark.parametrize("batch", [None, 256])
def test_aov_frame_matches_reference(batch, monkeypatch):
    check_aov_frame("cornell", batch, monkeypatch)
