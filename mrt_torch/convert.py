"""Build the port's scene and camera from numpy parameters.

The arrays are those of the JAX package's ``Scene`` and ``Camera``
(``np.asarray`` of each leaf), so both packages can compute the same
render from the same parameters.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.device import resolve
from .geometry.bvh import FlatBVH
from .geometry.instance import TLAS
from .geometry.scene import Scene
from .geometry.spheres import Spheres
from .geometry.triangles import FIELDS as TRI_FIELDS
from .geometry.triangles import TriangleTable, Triangles
from .geometry.volumes import MeshVolume, VolumeSpheres
from .geometry.voxels import VoxelGrid
from .materials.background import (CubeMap, SkyBackground, SkySphere,
                                   SolidBackground)
from .materials.lights import LightTable
from .materials.table import MaterialTable
from .textures.atlas import TextureAtlas


def _background(spec):
    if spec is None:
        return SkyBackground.create()
    if not hasattr(spec, "keys"):
        return SolidBackground.create(np.asarray(spec, np.float32))
    if "faces" in spec:
        return CubeMap(np.asarray(spec["faces"]),
                       np.asarray(spec["transform"]),
                       faces_raw=spec.get("faces_raw", False))
    return SkySphere(np.asarray(spec["tex"]))


def scene_from_numpy(spheres, materials, *, has_mix, background=None,
                     mix_depth=None, sphere_bvh=None, tlas=None,
                     triangles=None, bvh=None, atlas=None, volumes=None,
                     mesh_volumes=None, needs_alpha=False, mat_tex_raw=False,
                     voxels=None, lights=None):
    """spheres: mapping with "center" (S,3), "radius" (S,), "material"
    (S,); materials: mapping with the MaterialTable.FIELDS arrays;
    background: None for the sky gradient, an RGB color for a solid
    background, or a mapping: "faces" (6,), "transform" (4,4) and
    "faces_raw" for a CubeMap, "tex" () for a SkySphere; mix_depth: the
    table's Mix nesting depth (None:
    MAX_MIX_DEPTH); sphere_bvh: None, or a mapping with the FlatBVH
    arrays "bmin", "bmax", "first", "count", "escape" over the spheres
    as given; tlas: None, or a mapping of the TLAS's leaves, its
    world-flattened tables included (``TLAS.from_numpy``); triangles:
    None, or a mapping with the Triangles fields; bvh: None (a
    brute-force scan), or a mapping with the FlatBVH arrays over those
    triangles as given; atlas: None, or a mapping with the
    TextureAtlas.FIELDS arrays; volumes: None, or a mapping with
    "center", "radius", "neg_inv_density", "material"; mesh_volumes:
    None, or mappings with "tlas" (as ``tlas``), "neg_inv_density" and
    "material"; needs_alpha, mat_tex_raw: the Scene's flags; voxels:
    None, or mappings with "origin", "cell", "material", "levels",
    "rule" and, for rule "dense", "mips" (the reference's pyramid);
    lights: None, or a mapping with the LightTable.FIELDS arrays.

    The scene is built on the CPU; ``.to(device)`` moves it."""
    table_kw = {k: np.asarray(materials[k]) for k in MaterialTable.FIELDS}
    if mix_depth is not None:
        table_kw["mix_depth"] = mix_depth
    sph = None
    if spheres is not None:
        sph = Spheres(*(np.asarray(spheres[k])
                        for k in ("center", "radius", "material")))
    flat_bvh = lambda m: None if m is None else FlatBVH.create(
        *(np.asarray(m[k]) for k in FlatBVH.FIELDS))
    tris = None
    if triangles is not None:
        tris = TriangleTable(Triangles(**{k: np.asarray(triangles[k])
                                          for k in TRI_FIELDS}))
    arrays = lambda m, keys: [np.asarray(m[k]) for k in keys]
    vols = None
    if volumes is not None:
        vols = VolumeSpheres(*arrays(volumes, ("center", "radius",
                                               "neg_inv_density",
                                               "material")))
    mesh_vols = [MeshVolume(TLAS.from_numpy(v["tlas"]),
                            *arrays(v, ("neg_inv_density", "material")))
                 for v in mesh_volumes or ()]
    grids = [VoxelGrid(np.asarray(g["origin"]), np.asarray(g["cell"]),
                       int(g["levels"]), np.asarray(g["material"]),
                       rule=g["rule"], mips=g.get("mips"))
             for g in voxels or ()]
    return Scene(materials=MaterialTable(**table_kw),
                 background=_background(background), spheres=sph,
                 has_mix=has_mix, sphere_bvh=flat_bvh(sphere_bvh),
                 triangles=tris, bvh=flat_bvh(bvh),
                 tlas=None if tlas is None else TLAS.from_numpy(tlas),
                 volumes=vols, mesh_volumes=mesh_vols,
                 atlas=None if atlas is None else TextureAtlas(**{
                     k: np.asarray(atlas[k]) for k in TextureAtlas.FIELDS}),
                 needs_alpha=needs_alpha, mat_tex_raw=mat_tex_raw,
                 voxels=grids,
                 lights=None if lights is None else LightTable(**{
                     k: np.asarray(lights[k]) for k in LightTable.FIELDS}))


def params_from_numpy(tree, device=None):
    """A JAX parameter pytree with numpy leaves (``np.asarray`` of each)
    as leaf tensors that require grad, in the same structure (dicts,
    lists, tuples): both packages start an inverse render from the same
    parameters.  Floating leaves become float32; device None is the
    CUDA card (``core.device.resolve``)."""
    device = resolve(device)

    def leaf(x):
        t = torch.as_tensor(np.asarray(x), device=device)
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.detach().clone().requires_grad_(t.is_floating_point())

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return leaf(x)

    return walk(tree)


def camera_from_numpy(origin, lower_left, horizontal, vertical, u, v,
                      lens_radius):
    """Camera from its seven parameter arrays (each (3,), lens_radius
    a scalar)."""
    return Camera(*(np.asarray(x, np.float32)
                    for x in (origin, lower_left, horizontal, vertical, u,
                              v, lens_radius)))
