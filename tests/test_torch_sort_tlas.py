"""Port parity for whole persistent passes with the lane sorter on a
TLAS scene: cornell, as tests/test_torch_sort_passes.py holds the
five-sphere scene, with the same shape, cadences and rules (see its
docstring); on cornell no pixel flips between the packages, so the
films agree in every bounce count.
"""

import pytest
import torch

from torch_sort_cases import check_sorted_pass, make_case

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    return make_case("cornell")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sorted_pass_matches_reference(case, k, monkeypatch):
    check_sorted_pass(case, k, monkeypatch)
