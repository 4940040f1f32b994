"""Gradients through next-event estimation and Russian roulette, port
against JAX: ``materials/lights.py``'s light sampling and MIS weights,
and the roulette's survival draw, under the differentiable wavefront.

Both scenes have spheres only (the brute-force route).  The light table
is collected once, from constant geometry, and the parameter (the
ground's albedo) enters through ``replace``, as an inverse render of it
would.  Tolerance: rtol 1e-4 on the loss and the gradient against JAX's
jitted ``value_and_grad`` with MRT_NO_ROWMM=1 (C17).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

CENTER = [[0.0, -100.5, -2.0], [0.0, 1.0, -2.0], [0.6, 0.0, -2.2]]
RADIUS = [100.0, 0.8, 0.4]
START = np.array([0.5, 0.4, 0.3], np.float32)


def _jax_scene():
    from mrt.geometry.scene import Scene, attach_lights
    from mrt.geometry.spheres import Spheres
    from mrt.materials.background import SolidBackground
    from mrt.materials.table import MaterialBuilder

    b = MaterialBuilder()
    rows = [b.lambertian((0.5, 0.5, 0.5)), b.diffuse_light((4.0, 4.0, 4.0)),
            b.lambertian((0.2, 0.6, 0.3))]
    return attach_lights(Scene(
        materials=b.build(), background=SolidBackground.create((0.1, 0.1,
                                                                0.1)),
        spheres=Spheres(center=jnp.asarray(CENTER),
                        radius=jnp.asarray(RADIUS),
                        material=jnp.asarray(rows, jnp.int32))))


def _torch_scene():
    from mrt_torch.geometry.scene import Scene, attach_lights
    from mrt_torch.geometry.spheres import Spheres
    from mrt_torch.materials.background import SolidBackground
    from mrt_torch.materials.table import MaterialBuilder

    b = MaterialBuilder()
    rows = [b.lambertian((0.5, 0.5, 0.5)), b.diffuse_light((4.0, 4.0, 4.0)),
            b.lambertian((0.2, 0.6, 0.3))]
    return attach_lights(Scene(
        materials=b.build(), background=SolidBackground.create((0.1, 0.1,
                                                                0.1)),
        spheres=Spheres(np.asarray(CENTER, np.float32),
                        np.asarray(RADIUS, np.float32),
                        np.asarray(rows, np.int32))))


def _rays(n=256, seed=3):
    rs = np.random.default_rng(seed)
    s, t, du, dv = rs.random((4, n)).astype(np.float32)
    return s, t, du, dv


@pytest.mark.parametrize("rr_depth", [None, 1])
def test_nee_gradient_matches_jax(rr_depth, monkeypatch):
    import torch_grad_scenes as S
    from mrt.integrator import wavefront as jw
    from mrt_torch.integrator import wavefront as tw

    rays = _rays()
    kw = dict(max_depth=4, rr_depth=rr_depth, differentiable=True)

    scene = _torch_scene()
    assert scene.lights is not None
    o, d = S.torch_camera().rays(*(torch.from_numpy(x) for x in rays))
    ids = torch.arange(o.shape[0])
    p = torch.tensor(START, requires_grad=True)
    albedo = scene.materials.albedo.clone()
    albedo[0, :3] = p
    radiance, _ = tw.trace_wavefront(
        scene.replace(materials=scene.materials.replace(albedo=albedo)), o,
        d, ids, 7, **kw)
    loss = torch.mean(radiance)
    loss.backward()

    jscene = _jax_scene()
    jo, jd = S.jax_camera().rays(*(jnp.asarray(x) for x in rays))
    monkeypatch.setenv("MRT_NO_ROWMM", "1")

    def jloss(q):
        m = jscene.materials
        sc = jscene.replace(materials=m.replace(
            albedo=m.albedo.at[0, :3].set(q)))
        r, _ = jw.trace_wavefront(sc, jo, jd, jnp.arange(o.shape[0],
                                                        dtype=jnp.uint32),
                                  7, **kw)
        return jnp.mean(r)

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(START))
    g = p.grad.numpy()
    assert np.isfinite(g).all() and (g != 0).all()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-4)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-4)
