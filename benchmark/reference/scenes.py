"""Plain scene tables rebuilt from a configuration's recipe.

A recipe is a file of its own, ``reference/recipes/<scene>.py``, found
by the configuration's ``scene``: its ``scene(aspect, **scene_args)``
returns the tables below, and it may give its own ``film_at`` or
``guides_at`` where the scene needs more than ``tracer`` and ``aov``
cover.  This module holds what recipes
share: frozen copies of the port's material rows, the cube of
``geometry/shapes.py``, the TRS transforms of ``math/m4.py`` and the
camera of ``core/camera.py``, kept here so that the reference does not
change when the program does.  Everything is built from the recipe's
numbers with NumPy and plain PyTorch; nothing of the program is read.

A scene is a dict of tensors:
  spheres: center (S, 3), radius (S,), material (S,) int64
  ground (optional): a cube instance, tris va, e_ab, e_ac, normal (12, 3),
    inv (3, 3), inv_t (3,), fwd (3, 3), material (an int)
  materials: mtype (M,) int64, albedo (M, 3), fuzz (M,), ior (M,),
    emit (M, 3)
  background: ("sky", None) or ("solid", color (3,))
  camera: origin, lower_left, horizontal, vertical, u, v (3,) each,
    lens_radius (0-dim)
  root: "expanded" (a brute-force scene: the port's B1 and its plain
    scan) or "offset" (a sphere BVH: B5 and its leaf test); the two
    root expressions round differently, and each scene's reference
    follows the one its walk uses
"""

from __future__ import annotations

import math

import numpy as np
import torch

LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT = 0, 1, 2, 3
# The port builds a sphere BVH from this many spheres on (SceneBuilder).
SPHERE_BVH_THRESHOLD = 64


class Materials:
    """Rows in the order a scene adds them, as the port's
    MaterialBuilder numbers them."""

    def __init__(self):
        self.rows = []

    def _add(self, mtype, albedo=(0.0, 0.0, 0.0), fuzz=0.0, ior=1.0,
             emit=(0.0, 0.0, 0.0)):
        self.rows.append((mtype, tuple(albedo)[:3], fuzz, ior, tuple(emit)))
        return len(self.rows) - 1

    def lambertian(self, albedo):
        return self._add(LAMBERTIAN, albedo=albedo)

    def metal(self, fuzz, albedo):
        return self._add(METAL, albedo=albedo, fuzz=min(fuzz, 1.0))

    def dielectric(self, ior):
        return self._add(DIELECTRIC, ior=ior)

    def diffuse_light(self, emit):
        return self._add(DIFFUSE_LIGHT, emit=emit)

    def tables(self):
        col = lambda k, dt: torch.tensor(
            np.array([r[k] for r in self.rows], dt))
        return dict(mtype=col(0, np.int64), albedo=col(1, np.float32),
                    fuzz=col(2, np.float32), ior=col(3, np.float32),
                    emit=col(4, np.float32))


def camera(vfov_deg, look_from, look_at, view_up, aspect, aperture,
           focus):
    """The thin-lens camera's vectors, float32 on the host (the port's
    ``Camera.create`` arithmetic)."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    look_from, look_at, view_up = f32(look_from), f32(look_at), f32(view_up)
    theta = f32(vfov_deg) * (math.pi / 180.0)
    vh = 2.0 * torch.tan(theta / 2.0)
    vw = aspect * vh

    def unit(a):
        n = torch.sqrt(((a[0] * a[0] + a[1] * a[1]) + a[2] * a[2])
                       .to(torch.float64)).to(torch.float32)
        return a / n

    def cross(a, b):
        return torch.stack([a[1] * b[2] - a[2] * b[1],
                            a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])

    w = unit(look_from - look_at)
    u = unit(cross(view_up, w))
    v = cross(w, u)
    horizontal = u * (vw * focus)
    vertical = v * (vh * focus)
    lower_left = look_from - horizontal / 2.0 - vertical / 2.0 - w * focus
    return dict(origin=look_from, lower_left=lower_left,
                horizontal=horizontal, vertical=vertical, u=u, v=v,
                lens_radius=f32(aperture) / 2.0)


def recipe(name, folders=None):
    """The recipe module ``reference/recipes/<name>.py``, from the first
    of the benchmark `folders` that has it (default: this one)."""
    from benchmark.harness.spec import HERE, load

    return load(folders or [HERE], "reference/recipes", name)


def build(config, device, dtype=torch.float32, folders=None):
    """The scene of a configuration file's recipe, its float tables in
    `dtype` on `device`."""
    scene = recipe(config["scene"], folders).scene(
        config["width"] / config["height"], **config.get("scene_args", {}))
    return to(scene, device, dtype)


def own(config, name, default, folders=None):
    """The recipe's own function `name` of the reference (``film_at``,
    ``guides_at``) where it gives one, for a scene that needs more than
    the plain tracer's spheres and cube; else `default`."""
    return getattr(recipe(config["scene"], folders), name, default)


def to(obj, device, dtype):
    if isinstance(obj, dict):
        return {k: to(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(to(v, device, dtype) for v in obj)
    if torch.is_tensor(obj):
        obj = obj.to(device)
        return obj.to(dtype) if obj.is_floating_point() else obj
    return obj


def spheres(centers, radii, mats):
    return dict(center=torch.tensor(np.array(centers, np.float32)),
                radius=torch.tensor(np.array(radii, np.float32)),
                material=torch.tensor(np.array(mats, np.int64)))


def _cube_tris(size):
    """The port's 12-triangle cube (outward flat normals), in its
    order: va, e_ab, e_ac and the flat normal, float32."""
    h = np.broadcast_to(np.float32(size), (3,)) / 2.0
    c = np.zeros(3, np.float32)
    va, vb, vc = [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            fc = c + n * h
            p00, p10 = fc - u * h - v * h, fc + u * h - v * h
            p11, p01 = fc + u * h + v * h, fc - u * h + v * h
            for a, b, e in ((p00, p10, p11), (p00, p11, p01)):
                if np.dot(np.cross(b - a, e - a), n) < 0:
                    b, e = e, b
                va.append(a), vb.append(b), vc.append(e)
    va, vb, vc = (np.stack(x).astype(np.float32) for x in (va, vb, vc))
    ab, ac = vb - va, vc - va
    flat = np.cross(ab, ac)
    flat = flat / np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True),
                             1e-20)
    return va, ab, ac, flat.astype(np.float32)


def cube_instance(translation, scale, size, material):
    """A cube placed by translation and uniform scale: its triangles in
    object space and the instance's forward and inverse transforms, as
    the port composes them (no rotation)."""
    va, ab, ac, normal = _cube_tris(size)
    t = np.asarray(translation, np.float32)
    s = np.broadcast_to(np.float32(scale), (3,)).astype(np.float32)
    fwd = np.eye(3, dtype=np.float32) * s[None, :]
    inv = np.eye(3, dtype=np.float32) / s[:, None]
    inv_t = -(inv @ t)
    as_t = lambda x: torch.tensor(np.ascontiguousarray(x, np.float32))
    return dict(va=as_t(va), e_ab=as_t(ab), e_ac=as_t(ac),
                normal=as_t(normal), fwd=as_t(fwd), inv=as_t(inv),
                inv_t=as_t(inv_t), material=int(material))
