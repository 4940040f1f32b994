"""The gradient cases of tests/test_grad.py, built in both packages from
the same numbers, for the port's gradient tests (test_torch_grad*.py).

Each case is a loss of one parameter array: the mean of an 8x8 image
rendered by ``inverse.render_image`` of a small scene under the
test_grad camera.  ``CASES[name]`` holds the render settings and the
parameter's start value; ``jax_loss(name)`` and ``torch_loss(name)``
build the two losses.  ``tri_vertex`` adds one case test_grad lacks: a
brute-force triangle (no BVH) whose first vertex is the parameter, its
flat normal rebuilt from it in the graph.

JAX's gradients w.r.t. material and sphere rows pass through
``mrt.ops.rowlookup``'s bf16 split, which rounds the cotangent to bf16
(ROADMAP C17); ``jax_value_and_grad`` takes them with MRT_NO_ROWMM=1,
the reference's exact gather route.
"""

import dataclasses
import os

import numpy as np
import torch

GROUND_C = [0.0, -100.5, -2.0]
SIZE = 8


def _settings(spp, seed, depth, init):
    return dict(spp=spp, seed=seed, max_depth=depth,
                init=np.asarray(init, np.float32))


CASES = {
    "albedo": _settings(4, 3, 4, [0.6, 0.4, 0.2]),
    "emission": _settings(2, 1, 3, [2.0, 2.0, 2.0]),
    "texel": _settings(4, 7, 4, np.random.default_rng(0).uniform(
        0.2, 0.8, (4, 4, 4)).astype(np.float32)),
    "fuzz": _settings(4, 5, 4, 0.3),
    "center": _settings(2, 2, 3, -2.0),
    "tri_vertex": _settings(2, 9, 3, [-0.6, -0.4, -1.6]),
    # The texel case on a triangle with UVs (spheres have none), with
    # the alpha test on: texels of alpha 0 in the texture's left half cut
    # the triangle out, and the re-cast rounds find what is behind it.
    "texel_alpha": _settings(1, 7, 3, np.concatenate(
        [np.random.default_rng(1).uniform(0.2, 0.8, (4, 4, 3)),
         np.repeat([[[0.0], [0.0], [1.0], [1.0]]], 4, axis=0)],
        axis=-1).astype(np.float32)),
}

# The triangle of tri_vertex: vertex a (the parameter), b, c.
TRI_BC = np.array([[0.7, -0.3, -1.8], [0.0, 0.6, -2.2]], np.float32)
# texel_alpha's triangle and its UVs at a, b, c.
ALPHA_TRI = np.array([[-1.2, -0.5, -1.9], [1.0, -0.5, -1.9],
                      [-1.2, 1.2, -1.9]], np.float32)
ALPHA_UV = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)


def _alpha_tri(Triangles, material):
    return Triangles.from_soup(*(ALPHA_TRI[None, k] for k in range(3)),
                               uvs=tuple(ALPHA_UV[None, k] for k in range(3)),
                               material=material)


def jax_scene(name, p):
    """Case `name`'s scene in the JAX package, parameter p.  The scene
    around the parameter is built eagerly (``with_atlas`` reads its
    tables on the host), also inside a trace."""
    import jax

    with jax.ensure_compile_time_eval():
        return _jax_scene(name, p)


def _jax_scene(name, p):
    import jax.numpy as jnp

    from mrt.geometry.scene import Scene, with_atlas
    from mrt.geometry.spheres import Spheres
    from mrt.geometry.triangles import Triangles
    from mrt.materials.background import SkyBackground, SolidBackground
    from mrt.materials.table import MaterialBuilder
    from mrt.textures.atlas import AtlasBuilder

    b = MaterialBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    center = [GROUND_C, [0.0, 0.0, -2.0]]
    radius = [100.0, 0.5]
    background = SkyBackground.create()
    if name in ("albedo", "tri_vertex"):
        other = b.lambertian((1.0, 1.0, 1.0))
        table = b.build()
        table = table.replace(
            albedo=table.albedo.at[other, :3].set(p if name == "albedo"
                                                  else 0.7))
    elif name == "emission":
        other = b.diffuse_light((1.0, 1.0, 1.0))
        table = b.build()
        table = table.replace(emit=table.emit.at[other].set(p))
        center, radius = [GROUND_C, [0.0, 1.0, -2.0]], [100.0, 0.8]
        background = SolidBackground.create((0.0, 0.0, 0.0))
    elif name == "fuzz":
        other = b.metal(fuzz=0.0, albedo=(0.9, 0.9, 0.9))
        table = b.build()
        table = table.replace(fuzz=table.fuzz.at[other].set(p))
    elif name == "center":
        other = b.lambertian((0.8, 0.1, 0.1))
        table = b.build()
        center = jnp.stack([jnp.asarray(GROUND_C),
                            jnp.stack([0.0 * p, 0.0 * p, p])])
    else:  # texel, texel_alpha
        ab = AtlasBuilder()
        tid = ab.add_raw(np.ones((4, 4, 4), np.float32))
        other = b.lambertian((1.0, 1.0, 1.0), tex=tid)
        table = b.build()
    spheres = Spheres(center=jnp.asarray(center), radius=jnp.asarray(radius),
                      material=jnp.asarray([ground, other], jnp.int32))
    if name in ("tri_vertex", "texel_alpha"):
        spheres = Spheres(center=spheres.center[:1],
                          radius=spheres.radius[:1],
                          material=spheres.material[:1])
    scene = Scene(materials=table, background=background, spheres=spheres,
                  needs_alpha=name == "texel_alpha")
    if name == "texel_alpha":
        scene = scene.replace(triangles=_alpha_tri(Triangles, other))
    if name == "tri_vertex":
        tris = Triangles.from_soup(np.zeros((1, 3), np.float32),
                                   TRI_BC[None, 0], TRI_BC[None, 1],
                                   material=other)
        va = jnp.asarray(p)[None]
        ab_, ac_ = jnp.asarray(TRI_BC[None, 0]) - va, jnp.asarray(
            TRI_BC[None, 1]) - va
        flat = jnp.cross(ab_, ac_)
        flat = flat / jnp.sqrt(jnp.sum(flat * flat, axis=-1, keepdims=True))
        tris = tris.replace(va=va, e_ab=ab_, e_ac=ac_, na=flat, nb=flat,
                            nc=flat)
        scene = scene.replace(triangles=tris)
    if name.startswith("texel"):
        scene = with_atlas(scene, ab.build())
        nxt = np.minimum(np.arange(4) + 1, 3)
        img = jnp.asarray(p)
        q = jnp.concatenate([img, img[:, nxt], img[nxt], img[nxt][:, nxt]],
                            axis=-1).reshape(-1, 16)
        scene = scene.replace(atlas=scene.atlas.replace(
            data=img.reshape(-1, 4), qdata=q))
    return scene


def torch_scene(name, p):
    """Case `name`'s scene in the port (on p's device), parameter p."""
    from mrt_torch.geometry.scene import Scene, with_atlas
    from mrt_torch.geometry.spheres import Spheres
    from mrt_torch.geometry.triangles import TriangleTable, Triangles
    from mrt_torch.materials.background import SkyBackground, SolidBackground
    from mrt_torch.materials.table import MaterialBuilder
    from mrt_torch.math import vec
    from mrt_torch.textures.atlas import AtlasBuilder

    dev = p.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    b = MaterialBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    center = f32([GROUND_C, [0.0, 0.0, -2.0]])
    radius = f32([100.0, 0.5])
    background = SkyBackground.create()
    if name in ("albedo", "tri_vertex"):
        other = b.lambertian((1.0, 1.0, 1.0))
        table = b.build().to(dev)
        albedo = table.albedo.clone()
        albedo[other, :3] = p if name == "albedo" else 0.7
        table = table.replace(albedo=albedo)
    elif name == "emission":
        other = b.diffuse_light((1.0, 1.0, 1.0))
        table = b.build().to(dev)
        emit = table.emit.clone()
        emit[other] = p
        table = table.replace(emit=emit)
        center, radius = f32([GROUND_C, [0.0, 1.0, -2.0]]), f32([100.0, 0.8])
        background = SolidBackground.create((0.0, 0.0, 0.0))
    elif name == "fuzz":
        other = b.metal(fuzz=0.0, albedo=(0.9, 0.9, 0.9))
        table = b.build().to(dev)
        fuzz = table.fuzz.clone()
        fuzz[other] = p
        table = table.replace(fuzz=fuzz)
    elif name == "center":
        other = b.lambertian((0.8, 0.1, 0.1))
        table = b.build().to(dev)
        center = torch.stack([f32(GROUND_C),
                              torch.stack([0.0 * p, 0.0 * p, p])])
    else:  # texel, texel_alpha
        ab = AtlasBuilder()
        tid = ab.add_raw(np.ones((4, 4, 4), np.float32))
        other = b.lambertian((1.0, 1.0, 1.0), tex=tid)
        table = b.build().to(dev)
    material = torch.tensor([ground, other], dtype=torch.int32, device=dev)
    if name in ("tri_vertex", "texel_alpha"):
        center, radius, material = center[:1], radius[:1], material[:1]
    scene = Scene(materials=table, background=background.to(dev),
                  spheres=Spheres(center, radius, material),
                  needs_alpha=name == "texel_alpha")
    if name == "texel_alpha":
        scene = scene.replace(triangles=TriangleTable(
            _alpha_tri(Triangles, other).to_torch(dev)))
    if name == "tri_vertex":
        tris = Triangles.from_soup(np.zeros((1, 3), np.float32),
                                   TRI_BC[None, 0], TRI_BC[None, 1],
                                   material=other).to_torch(dev)
        va = p[None]
        ab_, ac_ = f32(TRI_BC[None, 0]) - va, f32(TRI_BC[None, 1]) - va
        flat = vec.unit(vec.cross(ab_, ac_))
        tris = dataclasses.replace(tris, va=va, e_ab=ab_, e_ac=ac_, na=flat,
                                   nb=flat, nc=flat)
        scene = scene.replace(triangles=TriangleTable(tris))
    if name.startswith("texel"):
        scene = with_atlas(scene, ab.build())
        scene = scene.replace(atlas=scene.atlas.replace(
            data=p.reshape(-1, 4)))
    return scene


def jax_camera():
    from mrt.core.camera import Camera

    return Camera.create(60.0, (0, 0, 0), (0, 0, -1), (0, 1, 0),
                         aspect_ratio=1.0)


def torch_camera(device="cpu"):
    from mrt_torch.core.camera import Camera

    return Camera.create(60.0, (0, 0, 0), (0, 0, -1), (0, 1, 0),
                         aspect_ratio=1.0).to(device)


def jax_loss(name):
    """p -> mean of case `name`'s image, in the JAX package."""
    import jax.numpy as jnp

    from mrt import inverse

    c, cam = CASES[name], jax_camera()
    return lambda p: jnp.mean(inverse.render_image(
        jax_scene(name, p), cam, SIZE, SIZE, spp=c["spp"], seed=c["seed"],
        max_depth=c["max_depth"]))


def torch_loss(name, device="cpu"):
    """p -> mean of case `name`'s image, in the port."""
    from mrt_torch import inverse

    c, cam = CASES[name], torch_camera(device)
    return lambda p: torch.mean(inverse.render_image(
        torch_scene(name, p), cam, SIZE, SIZE, spp=c["spp"], seed=c["seed"],
        max_depth=c["max_depth"]))


def jax_value_and_grad(name, p=None, exact_rows=True):
    """(loss, gradient) of case `name` at p (None: its start value)
    through jax.jit(jax.value_and_grad(...)), as numpy; exact_rows runs
    it with MRT_NO_ROWMM=1 (the gather route, C17)."""
    import jax
    import jax.numpy as jnp

    p = CASES[name]["init"] if p is None else p
    old = os.environ.get("MRT_NO_ROWMM")
    if exact_rows:
        os.environ["MRT_NO_ROWMM"] = "1"
    try:
        v, g = jax.jit(jax.value_and_grad(jax_loss(name)))(jnp.asarray(p))
        return float(v), np.asarray(g)
    finally:
        os.environ.pop("MRT_NO_ROWMM", None)
        if old is not None:
            os.environ["MRT_NO_ROWMM"] = old


def torch_value_and_grad(name, p=None, device="cpu"):
    """(loss, gradient) of case `name` at p through the port, as numpy."""
    p = CASES[name]["init"] if p is None else p
    x = torch.tensor(np.asarray(p, np.float32), device=device,
                     requires_grad=True)
    v = torch_loss(name, device)(x)
    v.backward()
    return float(v.detach()), x.grad.cpu().numpy()


def torch_recovery(steps, optimizer=None):
    """tests/test_grad.py's albedo recovery through the port's
    ``inverse.optimize``: (params, losses) after `steps` steps at 12x12,
    spp 4, depth 4 from (0.3, 0.5, 0.5) towards (0.7, 0.2, 0.4)."""
    from mrt_torch import inverse

    cam = torch_camera()
    target = inverse.render_image(
        torch_scene("albedo", torch.tensor([0.7, 0.2, 0.4])), cam, 12, 12,
        spp=8, seed=11, max_depth=4)
    return inverse.optimize(lambda p: torch_scene("albedo", p),
                            torch.tensor([0.3, 0.5, 0.5]), cam, 12, 12,
                            target, steps=steps, learning_rate=0.05, spp=4,
                            max_depth=4, seed=100, optimizer=optimizer)
