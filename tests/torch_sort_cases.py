"""Whole persistent passes with the lane sorter in both packages, for
tests/test_torch_sort_passes.py (a sphere scene) and
tests/test_torch_sort_tlas.py (cornell): their shape, the port's pass
with its steps and sorts counted, the reference's, and the checks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrt.integrator.persistent import render_samples_chunked
from mrt.scenes import get as jget
from mrt_torch import convert
from mrt_torch.core.camera import Camera
from mrt_torch.integrator import persistent as TP
from mrt_torch.materials.table import MaterialTable
from mrt_torch.scenes import get as tget
from test_persistent import _camera as jspheres_camera
from test_persistent import _scene as jspheres_scene

W = H = 24
SPP, DEPTH, POOL, SEED = 4, 8, 512, 9


def _spheres():
    js, jc = jspheres_scene(), jspheres_camera()
    ts = convert.scene_from_numpy(
        {k: np.asarray(getattr(js.spheres, k))
         for k in ("center", "radius", "material")},
        {k: np.asarray(getattr(js.materials, k))
         for k in MaterialTable.FIELDS},
        has_mix=js.has_mix, mix_depth=js.materials.mix_depth)
    tc = convert.camera_from_numpy(*(np.asarray(getattr(jc, k))
                                     for k in Camera.FIELDS))
    return (js, jc), (ts, tc)


def _cornell():
    return jget("cornell")().generate(), tget("cornell")().generate(
        device="cpu")


def _port(scene, camera, k, monkeypatch):
    """The port's pass at cadence k: (film sum, depth sum, steps,
    sorts)."""
    counts = dict(steps=0, sorts=0)
    step, make = TP.LanePool.step, TP.make_sorter

    def counted_step(self, *a):
        counts["steps"] += 1
        return step(self, *a)

    def counted_sorter(*a):
        sorter = make(*a)

        def run(st):
            counts["sorts"] += 1
            return sorter(st)
        return run

    monkeypatch.setattr(TP.LanePool, "step", counted_step)
    monkeypatch.setattr(TP, "make_sorter", counted_sorter)
    fs, ds = TP.render_samples_persistent(scene, camera, W, H, SEED, 0, SPP,
                                          max_depth=DEPTH, pool=POOL,
                                          sort_rays=k)
    monkeypatch.undo()
    return fs.numpy(), ds.numpy(), counts["steps"], counts["sorts"]


def _jax(scene, camera, k):
    fs, ds = render_samples_chunked(scene, camera, W, H, SEED, 0,
                                    jnp.uint32(SPP), max_depth=DEPTH,
                                    pool=POOL, sort_rays=k)
    return np.asarray(fs), np.asarray(ds)


def make_case(name):
    """(name, jax scene and camera, port scene and camera, the unsorted
    films of both packages) for "spheres" or "cornell"."""
    (js, jc), (ts, tc) = {"spheres": _spheres, "cornell": _cornell}[name]()
    unsorted = _port(ts, tc, 0, pytest.MonkeyPatch())
    assert unsorted[3] == 0
    return name, (js, jc), (ts, tc), unsorted, _jax(js, jc, 0)


def check_sorted_pass(case, k, monkeypatch):
    """The port's pass at cadence k against its unsorted pass and the
    reference's passes (the rules of the test files' docstrings)."""
    name, (js, jc), (ts, tc), (u_sum, u_depth, u_steps, _), j_unsorted = case
    g_sum, g_depth, steps, sorts = _port(ts, tc, k, monkeypatch)
    # Against the port's unsorted pass: the same steps, a sort every k,
    # the same bounce counts.
    assert steps == u_steps and sorts == steps // k
    np.testing.assert_array_equal(g_depth, u_depth)
    np.testing.assert_allclose(g_sum, u_sum, rtol=2e-4, atol=2e-4)
    # The reference's sorted pass against its unsorted one, the same way.
    j_sum, j_depth = _jax(js, jc, k)
    np.testing.assert_array_equal(j_depth, j_unsorted[1])
    np.testing.assert_allclose(j_sum, j_unsorted[0], rtol=2e-4, atol=2e-4)
    # Across the packages: C2's flips, and only the unsorted films' ones.
    flipped = g_depth != j_depth
    np.testing.assert_array_equal(flipped, u_depth != j_unsorted[1])
    assert flipped.mean() <= 0.01
    if name == "cornell":
        assert not flipped.any()
    np.testing.assert_allclose(g_sum[~flipped], j_sum[~flipped], rtol=2e-4,
                               atol=2e-4)
