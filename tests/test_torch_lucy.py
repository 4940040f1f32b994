"""Port parity for the lucy scene (121 stand-in statues under a SAH
BVH, a ground cube, a sun sphere) on its two routes: the two-level TLAS
and, with MRT_TLAS_KERNEL=flat, its 16 flat parts (mrt_torch vs mrt).

Tolerances as in tests/test_torch_mesh_scenes.py:
  - scene arrays byte-equal, the flat parts' tables included;
  - the flat-parts winners against the compiled JAX flat-parts route:
    equal hits and (instance, triangle), t rtol 1e-5, points 1e-4; u
    and v 1e-4 and normals 2e-5: on world-space triangles far from their
    vertex a XLA's FMAs move the barycentrics (by up to 4e-5 on the
    ground cube's 2,000-unit triangles, 6 of 1,024 rays), and a smooth
    normal is interpolated with them (1.2e-5 on one statue ray); the
    port's dispatch equals the direct call;
  - renders at the golden settings against the compiled JAX render of
    the same route: at most 1% of pixels with another bounce count,
    every other pixel within 5e-4.  The flat-parts route renders through
    the persistent integrator only (the main path): its wavefront render
    takes ~20 s on the CPU and runs the same intersection.
The JAX side (two subprocesses, ~40 and ~55 s: the compiled flat-parts
route builds 16 traversal loops) starts with this module.
"""

import numpy as np
import pytest
import torch

from mrt.scenes import get as jget
from mrt_torch.geometry import instance as TI
from mrt_torch.scenes import get as tget
from mrt_torch import convert
from test_torch_mesh_scenes import (JaxSide, close_to, port_render,
                                    same_hits, same_winners,
                                    scene_arrays_equal, scene_numpy)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    side = JaxSide("lucy", [("two_level", "hits"), ("flat",)],
                   tmp_path_factory)
    yield side.results
    side.close()


@pytest.fixture(autouse=True)
def _start(jax_side, monkeypatch):
    for name in ("MRT_TLAS_KERNEL", "MRT_FLAT_SPLIT"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("kind", ["", "flat"])
def test_lucy_scene_arrays_equal(monkeypatch, kind):
    if kind:
        monkeypatch.setenv("MRT_TLAS_KERNEL", kind)
    js, _ = jget("lucy")(aspect_ratio=1.0).generate()
    ts, _ = tget("lucy")(aspect_ratio=1.0).generate(device="cpu")
    assert ts.tlas.n_instances == 122 and ts.spheres.count == 1
    assert int(ts.tlas.tri_count.sum()) == 81_324
    assert (ts.tlas.flat_parts is None) == (not kind)
    scene_arrays_equal(js, ts)
    # convert carries the JAX scene, its flat parts included.
    scene_arrays_equal(js, convert.scene_from_numpy(**scene_numpy(js)))


def test_lucy_flat_parts_hits_match(jax_side, monkeypatch):
    r = jax_side()
    monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
    ts, _ = tget("lucy")(aspect_ratio=1.0).generate(device="cpu")
    o, d = torch.from_numpy(r["o"]), torch.from_numpy(r["d"])
    got = {}
    expand = TI.expand_winner

    def spy(tlas, o, d, *winners):
        got["w"] = [x.numpy() for x in winners]
        return expand(tlas, o, d, *winners)

    monkeypatch.setattr(TI, "expand_winner", spy)
    direct = TI.intersect_tlas_flat_parts(ts.tlas, o, d, 1e-3, float("inf"))
    t, inst, tri, u, v = got["w"]
    hit = same_winners(r, t, tri, u, v, inst=inst, uv_atol=1e-4)
    assert hit.mean() > 0.9 and len(np.unique(inst[hit])) > 10
    hits = ts.intersect(o, d)  # the dispatch takes the flat parts
    np.testing.assert_array_equal(hits.t.numpy(), direct.t.numpy())
    same_hits(r, hits, hit, normal_atol=2e-5)
    monkeypatch.delenv("MRT_TLAS_KERNEL")
    two = ts.intersect(o, d)
    assert not np.array_equal(two.t.numpy(), hits.t.numpy())


@pytest.mark.parametrize("route,integrator", [
    ("two_level", "wavefront"), ("two_level", "persistent"),
    ("flat", "persistent")])
def test_lucy_render_matches_compiled_jax(jax_side, monkeypatch, route,
                                          integrator):
    if route == "flat":
        monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
    film = port_render("lucy", integrator)
    r = jax_side()
    flipped = close_to(film, r[f"{route}_sum"], r[f"{route}_depth"])
    print(f"lucy {route} {integrator}: {flipped} of 576 flip")
