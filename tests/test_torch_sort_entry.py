"""The lane sorter through the port's entry points on the CPU, and with
the pend film mode against the JAX package.

  - ``render(persistent=True, sort_rays=k)`` for k in True, 1, 2, 4,
    ``driver.run`` with ``RenderConfig(sort_rays=True)`` and
    ``python -m mrt_torch --sort-rays``: the lanes are sorted, and the
    film has the bounce counts of the unsorted one (``sort_rays=False``,
    ``--no-sort-rays``) and its sums within 2e-4 (the order of the film's
    float additions differs).  A batched render with ``sort_rays=True``
    sorts nothing and gives the unsorted film bit for bit.
  - The auto rule (``sort_rays=None``) resolves in
    ``render_pass_persistent``: no sort on the CPU, the scene's cadence
    where the gate is on.
  - cornell in the pend film mode with ``sort_rays=2``, as
    tests/test_deposit.py holds the reference (the sorter must permute
    the pending accumulator): against the port's unsorted B2 film,
    bounce counts exact and sums within 1e-5 (that test's tolerance);
    against JAX's sorted pend pass (``pend="interpret"``), cornell flips
    no path (C2), bounce counts exact and sums within 2e-4.
"""

import numpy as np
import pytest
import torch

from mrt.integrator.persistent import render_samples_chunked
from mrt.scenes import get as jget
from mrt_torch.__main__ import main
from mrt_torch.geometry import scene as tscene
from mrt_torch.integrator import persistent as TP
from mrt_torch.ops import sort as S
from mrt_torch.runtime import driver as drv
from mrt_torch.runtime import render as R
from mrt_torch.runtime.config import RenderConfig
from mrt_torch.runtime.film import Film
from mrt_torch.scenes import get as tget

torch.set_num_threads(2)

W, H, SPP, DEPTH = 16, 12, 2, 5


@pytest.fixture
def sorts(monkeypatch):
    """Counts the lanes' sort-key computations, one a sort."""
    count = [0]
    keys = S.sort_keys

    def counted(*a):
        count[0] += 1
        return keys(*a)

    monkeypatch.setattr(TP, "sort_keys", counted)
    return count


def _same(a, b):
    np.testing.assert_array_equal(a.depth_sum.numpy(), b.depth_sum.numpy())
    np.testing.assert_allclose(a.sum.numpy(), b.sum.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert a.samples == b.samples


@pytest.mark.parametrize("k", [True, 1, 2, 4], ids=["True", "1", "2", "4"])
def test_render_sorts_and_matches_unsorted(sorts, k):
    scene, camera = tget("rtiow")(aspect_ratio=W / H, grid=3).generate(
        device="cpu")
    run = lambda s: R.render(scene, camera, W, H, spp=SPP, max_depth=DEPTH,
                             persistent=True, sort_rays=s)
    unsorted = run(False)
    assert sorts[0] == 0
    _same(run(k), unsorted)
    assert sorts[0] > 0


def test_batched_render_does_not_sort(sorts):
    scene, camera = tget("rtiow")(aspect_ratio=W / H, grid=3).generate(
        device="cpu")
    run = lambda s: R.render(scene, camera, W, H, spp=SPP, max_depth=DEPTH,
                             sort_rays=s)
    a, b = run(True), run(False)
    assert sorts[0] == 0
    assert a.sum.numpy().tobytes() == b.sum.numpy().tobytes()
    np.testing.assert_array_equal(a.depth_sum.numpy(), b.depth_sum.numpy())


def test_driver_and_cli_sort(sorts, tmp_path):
    config = lambda s, name: RenderConfig(
        scene="cornell", width=W, height=H, spp=SPP, samples_per_pass=1,
        max_depth=DEPTH, sort_rays=s, output=str(tmp_path / name))
    quiet = lambda *a: None
    unsorted = drv.run(config(False, "a.png"), log=quiet, device="cpu")
    assert sorts[0] == 0
    _same(drv.run(config(True, "b.png"), log=quiet, device="cpu"), unsorted)
    after_run = sorts[0]
    assert after_run > 0
    argv = lambda flag, name: [
        "--scene", "cornell", "--width", str(W), "--height", str(H),
        "--spp", str(SPP), "--samples-per-pass", "1", "--max-depth",
        str(DEPTH), flag, "--device", "cpu", "-o", str(tmp_path / name)]
    cli_unsorted = main(argv("--no-sort-rays", "c.png"))
    assert sorts[0] == after_run
    _same(cli_unsorted, unsorted)
    _same(main(argv("--sort-rays", "d.png")), unsorted)
    assert sorts[0] > after_run
    assert (tmp_path / "d.png").exists()


def test_auto_rule_resolves_in_the_pass(monkeypatch):
    seen = []
    real = R.render_samples_persistent

    def spy(*a, sort_rays, **kw):
        seen.append(sort_rays)
        return real(*a, sort_rays=sort_rays, **kw)

    monkeypatch.setattr(R, "render_samples_persistent", spy)
    scene, camera = tget("sphere_grid")(aspect_ratio=W / H, dim=32).generate(
        device="cpu")
    assert scene.spheres.count >= scene.SORT_MIN_SPHERES
    run = lambda **kw: R.render_pass_persistent(
        scene, camera, Film.create(W, H, device="cpu"), 1, 0, width=W,
        height=H, max_depth=3, samples=1, pool=W * H, **kw)
    run()
    monkeypatch.setattr(tscene, "sorts_on_device", lambda s: True)
    run()
    run(sort_rays=True)
    run(sort_rays=2)
    assert seen == [0, scene.sort_cadence(), 1, 2] == [0, 4, 1, 2]


def test_pend_sorted_matches_scatter_and_reference(sorts):
    ts, tc = tget("cornell")().generate(device="cpu")
    w, h, pool = 64, 32, 2048
    run = lambda pend, k: TP.render_samples_persistent(
        ts, tc, w, h, 1, 0, 2, max_depth=8, pool=pool, pend=pend,
        sort_rays=k)
    got_sum, got_depth = run(True, 2)
    assert sorts[0] > 0
    ref_sum, ref_depth = run(False, 0)
    np.testing.assert_array_equal(got_depth.numpy(), ref_depth.numpy())
    np.testing.assert_allclose(got_sum.numpy(), ref_sum.numpy(), rtol=1e-5,
                               atol=1e-5)
    js, jc = jget("cornell")().generate()
    jsum, jdepth = render_samples_chunked(
        js, jc, w, h, seed=1, sample_start=0, samples=2, max_depth=8,
        pool=pool, pend="interpret", sort_rays=2)
    np.testing.assert_array_equal(got_depth.numpy(), np.asarray(jdepth))
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(jsum), rtol=2e-4,
                               atol=2e-4)
