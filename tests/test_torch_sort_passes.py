"""Port parity for whole persistent passes with the lane sorter
(``render_samples_persistent(sort_rays=k)``) against the JAX package's
``render_samples_chunked(sort_rays=k)``, at the shape of
tests/test_persistent.py's sorted tests: 24x24, spp 4, depth 8, pool 512,
cadences 1, 2 and 4, on that file's five-sphere scene
(tests/test_torch_sort_tlas.py: cornell, a TLAS).  The passes are in
tests/torch_sort_cases.py.

Tolerances and why:
  - A sort moves whole lanes and every draw is keyed on (ray_id,
    bounce), so the set of work items in flight after each step does not
    depend on the lane order: a sorted pass runs the same steps as an
    unsorted one (the cadences divide FLUSH_STEPS), with one sort every
    k steps, and its film has the same bounce counts; radiance differs
    only by the order of the film's float additions (rtol/atol 2e-4, the
    reference test's).  The reference's sorted and unsorted films hold
    the same rule among themselves.
  - Against compiled JAX the port holds C2's rule (ROADMAP C2: XLA
    contracts multiply-adds into FMAs and flips a few paths).  The
    pixels whose bounce count differs between the sorted films of the two
    packages are exactly those that differ between their unsorted films:
    sorting adds no difference of its own.  Every other pixel is within
    2e-4.
"""

import pytest
import torch

from torch_sort_cases import check_sorted_pass, make_case

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    return make_case("spheres")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sorted_pass_matches_reference(case, k, monkeypatch):
    check_sorted_pass(case, k, monkeypatch)
