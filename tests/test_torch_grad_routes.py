"""The gradient path's closest-hit routes: those the reference walks in
a ``lax.while_loop`` (sphere and triangle BVHs, the TLAS and its flat
parts, the voxel DDA, mesh volumes) raise ValueError naming the route
when their rays or geometry require grad, where JAX refuses to
reverse-differentiate the loop; with constant rays and geometry a
shading gradient flows through them as in JAX.

Tolerance: sphere_grid's background colour against JAX's jitted
``value_and_grad`` with MRT_NO_ROWMM=1 (C17), rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_golden_scenes as G
from mrt_torch import inverse
from mrt_torch.geometry import bvh as TB
from mrt_torch.geometry import instance as TI
from mrt_torch.geometry import volumes as TV
from mrt_torch.geometry import voxels as TX
from mrt_torch.scenes import get

torch.set_num_threads(2)


def _grid(device="cpu"):
    return get("sphere_grid")(aspect_ratio=1.0, dim=4).generate(
        device=device)


def test_sphere_bvh_background_gradient_matches_jax(monkeypatch):
    # Constant geometry and rays: B5's route (and the ground's TLAS) stay
    # off the gradient, which flows through shading as in JAX.
    from mrt import inverse as jinv
    from mrt.materials.background import SolidBackground as JSolid
    from mrt.scenes import get as jget
    from mrt_torch.materials.background import SolidBackground

    kw = dict(spp=1, seed=4, max_depth=3)
    start = np.array([0.3, 0.4, 0.5], np.float32)
    scene, camera = _grid()
    color = torch.tensor(start, requires_grad=True)
    loss = torch.mean(inverse.render_image(
        scene.replace(background=SolidBackground(color)), camera, 8, 8, **kw))
    loss.backward()
    jscene, jcam = jget("sphere_grid")(aspect_ratio=1.0, dim=4).generate()
    monkeypatch.setenv("MRT_NO_ROWMM", "1")
    jv, jg = jax.jit(jax.value_and_grad(lambda c: jnp.mean(
        jinv.render_image(jscene.replace(background=JSolid(color=c)), jcam,
                          8, 8, **kw))))(jnp.asarray(start))
    jg = np.asarray(jg)
    assert (np.abs(color.grad.numpy()) > 0).all()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-4)
    np.testing.assert_allclose(color.grad.numpy(), jg, rtol=1e-4)


def test_sphere_bvh_refuses_material_rows_as_jax_does(monkeypatch):
    # A material-table parameter reaches the scattered direction through
    # the packed row (its fuzz column), so the next bounce's rays carry
    # a derivative into B5's walk: the port raises, and JAX refuses to
    # reverse-differentiate the walk's while_loop.
    from mrt import inverse as jinv
    from mrt.scenes import get as jget

    kw = dict(spp=1, seed=4, max_depth=3)
    scene, camera = _grid()
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    with pytest.raises(ValueError, match=r"sphere BVH \(B5\)"):
        inverse.render_image(scene.replace(
            materials=scene.materials.replace(albedo=albedo)), camera, 8, 8,
            **kw)
    jscene, jcam = jget("sphere_grid")(aspect_ratio=1.0, dim=4).generate()
    monkeypatch.setenv("MRT_NO_ROWMM", "1")
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jax.grad(lambda a: jnp.mean(jinv.render_image(jscene.replace(
            materials=jscene.materials.replace(albedo=a)), jcam, 8, 8,
            **kw)))(jscene.materials.albedo)


def _routes(monkeypatch):
    """(route name, call(o, d)) for every closest-hit route without a
    reverse-differentiable counterpart in the reference."""
    grid, _ = _grid()
    cornell, _ = get("cornell")(aspect_ratio=1.0).generate(device="cpu")
    monkeypatch.setenv("MRT_FLAT_SPLIT", "24")  # two cubes a part
    parts, _ = get("cornell")(aspect_ratio=1.0).generate(device="cpu")
    monkeypatch.delenv("MRT_FLAT_SPLIT")
    menger, _ = get("menger")(aspect_ratio=1.0, level=1).generate(
        device="cpu")
    vol, _ = G.volume("cpu")
    tl = cornell.tlas
    return {
        "sphere BVH (B5)": lambda o, d: TB.intersect_bvh_spheres(
            grid.spheres, grid.sphere_bvh, o, d, 1e-3, float("inf")),
        "triangle BVH (B6)": lambda o, d: TB.intersect_bvh(
            tl.flat_tris, tl.flat_bvh, o, d, 1e-3, float("inf")),
        "TLAS (B7)": lambda o, d: TI.intersect_tlas(tl, o, d, 1e-3,
                                                    float("inf")),
        "TLAS flat parts (B6)": lambda o, d: TI.intersect_tlas_flat_parts(
            parts.tlas, o, d, 1e-3, float("inf")),
        "voxel DDA": lambda o, d: TX.intersect(menger.voxels[0], o, d, 1e-3,
                                               float("inf")),
        "mesh volume (B7)": lambda o, d: TV.intersect_mesh(
            vol.mesh_volumes[0], o, d, 1e-3, float("inf"),
            torch.full((o.shape[0],), 0.5)),
    }


ROUTES = ["sphere BVH (B5)", "triangle BVH (B6)", "TLAS (B7)",
          "TLAS flat parts (B6)", "voxel DDA", "mesh volume (B7)"]


@pytest.mark.parametrize("which", ["o", "d"])
def test_routes_refuse_rays_that_require_grad(which, monkeypatch):
    rs = np.random.default_rng(2)
    o = torch.from_numpy(rs.normal(0, 1, (32, 3)).astype(np.float32))
    d = torch.from_numpy(rs.normal(0, 1, (32, 3)).astype(np.float32))
    routes = _routes(monkeypatch)
    assert sorted(routes) == sorted(ROUTES)
    for name, call in routes.items():
        oo = o.clone().requires_grad_(which == "o")
        dd = d.clone().requires_grad_(which == "d")
        with pytest.raises(ValueError, match=name.replace("(", r"\(")
                           .replace(")", r"\)")):
            call(oo, dd)
        with torch.no_grad():
            call(oo, dd)  # no graph to record: the route runs
        call(o, d)  # constant rays and geometry: the route runs


def test_routes_refuse_geometry_that_requires_grad():
    scene, camera = _grid()
    center = scene.spheres.center.clone().requires_grad_(True)
    moved = scene.replace(spheres=scene.spheres.replace(center=center))
    with pytest.raises(ValueError, match=r"sphere BVH \(B5\)"):
        inverse.render_image(moved, camera, 4, 4, spp=1, max_depth=2)
    # A fuzz parameter bends the scattered rays: the next bounce's rays
    # require grad and the walk refuses them, as JAX's while_loop does.
    fuzz = scene.materials.fuzz.clone().requires_grad_(True)
    fuzzy = scene.replace(materials=scene.materials.replace(fuzz=fuzz))
    with pytest.raises(ValueError, match=r"sphere BVH \(B5\)"):
        inverse.render_image(fuzzy, camera, 8, 8, spp=1, max_depth=3)
