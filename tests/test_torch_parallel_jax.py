"""The port's sharded films against the reference's
(``mrt.parallel.render``) on the same mesh shape, scene and seed: the
port's over a gloo group of 4 CPU processes, the reference's over 4 of
the conftest's virtual CPU devices.

The reference's program is compiled, so C2's rule holds (ROADMAP C2):
at most 1% of pixels with another bounce count, every other pixel within
5e-4; menger's voxels hold C10's cap instead (ROADMAP C10: coplanar
sponge faces flip paths on FMA contraction; 30 of 576 pixels outside
the C2 rule in tests/test_torch_voxels.py, here that share of 256).
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from mrt.core.camera import Camera
from mrt.geometry.scene import Scene
from mrt.geometry.spheres import Spheres
from mrt.materials.background import SkyBackground
from mrt.materials.table import MaterialBuilder
from mrt.parallel.mesh import make_mesh
from mrt.parallel.render import (render_pass_sharded_persistent,
                                 render_sharded, shard_film)
from mrt.runtime.film import Film
from test_parallel import _hard_case
from test_torch_parallel import spawn

torch.set_num_threads(2)


def _jax_spheres():
    b = MaterialBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    metal = b.metal(0.1, (0.8, 0.7, 0.6))
    glass = b.dielectric(1.5)
    scene = Scene(materials=b.build(), background=SkyBackground.create(),
                  spheres=Spheres(
                      center=jax.numpy.asarray([[0, -100.5, -1],
                                                [-0.6, 0, -1.5],
                                                [0.6, 0, -1.5]],
                                               jax.numpy.float32),
                      radius=jax.numpy.asarray([100.0, 0.5, 0.5]),
                      material=jax.numpy.asarray([ground, metal, glass],
                                                 jax.numpy.int32)))
    camera = Camera.create(60.0, (0, 0.3, 1), (0, 0, -1.5), (0, 1, 0),
                           aspect_ratio=1.0)
    return scene, camera


def _jax_film(case):
    scene, camera = (_jax_spheres() if case["scene"] == "spheres"
                     else _hard_case(case["scene"]))
    mesh = make_mesh(tile=case["tile"], spp=case["spp"],
                     devices=jax.devices()[:4])
    if case["integrator"] == "wavefront":
        return render_sharded(scene, camera, W.SIZE, W.SIZE, mesh,
                              spp=case["samples"], max_depth=case["depth"],
                              seed=case["seed"])
    film = shard_film(Film.create(W.SIZE, W.SIZE), mesh)
    fn = jax.jit(lambda s, c, f: render_pass_sharded_persistent(
        s, c, f, case["seed"], 0, width=W.SIZE, height=W.SIZE,
        samples=case["samples"], max_depth=case["depth"], mesh=mesh,
        pool=512))
    return fn(scene, camera, film)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(4, tmp_path_factory.mktemp("world4"), 4)[0]


NAMES = ["spheres-wavefront-2x2", "spheres-persistent-2x2",
         "tlas-wavefront-4x1", "alpha-wavefront-1x4", "voxel-persistent-2x2"]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_film_matches_reference(port, name):
    case = next(c for c in W.CASES[4] if c["name"] == name)
    want = _jax_film(case)
    want_sum, want_depth = np.asarray(want.sum), np.asarray(want.depth_sum)
    got_sum, got_depth = port[name + "/sum"], port[name + "/depth"]
    flipped = got_depth != want_depth
    if case["scene"] == "voxel":
        off = ~np.isclose(got_sum, want_sum, rtol=5e-4, atol=5e-4).all(-1)
        assert (flipped | off).sum() <= 30 * flipped.size // 576
    else:
        assert flipped.mean() <= 0.01, flipped.sum()
        np.testing.assert_allclose(got_sum[~flipped], want_sum[~flipped],
                                   rtol=5e-4, atol=5e-4)
    assert int(want.samples) == case["samples"] and want_depth.sum() > 0
