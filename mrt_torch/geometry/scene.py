"""The compiled scene (mirrors ``mrt.geometry.scene``): primitive sets
plus a closest-hit dispatcher, and ``SceneBuilder``, the host-side
accumulator that builds one.

Primitive sets, in the order their hits fold (on equal t the earlier
set keeps the hit):
  - spheres: brute force through kernel B1, or a sphere BVH through
    kernel B5 from SPHERE_BVH_THRESHOLD spheres on;
  - triangles: a mesh under its own single-level BVH (kernel B6), or a
    small set scanned by brute force (``SceneBuilder.add_triangles``);
  - instanced meshes: a TLAS, through kernel B7, or through kernel B6 on
    its world-flattened routes where ``MRT_TLAS_KERNEL`` opts in
    (``instance.wants_flat`` / ``wants_flat_parts``).
Volumes, voxels, textures and lights join the port with their slices.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.device import resolve
from . import bvh as bvh_mod
from . import instance as inst_mod
from . import spheres as sphere_mod
from . import triangles as tri_mod
from .hit import Hits

T_MIN = 1e-3  # intersect(ray, 0.001, inf), as in the reference


class Scene(nn.Module):
    """materials: MaterialTable; background: a background module;
    spheres: Spheres or None; sphere_bvh: FlatBVH over the spheres (in
    BVH order) or None; triangles: a TriangleTable or None; bvh: FlatBVH
    over the triangles (in BVH order) or None for a brute-force scan;
    tlas: TLAS or None.  ``has_mix`` is False when no material row is a
    MIX (shading then skips the row resolution)."""

    def __init__(self, materials, background, spheres=None, has_mix=True,
                 sphere_bvh=None, tlas=None, triangles=None, bvh=None):
        super().__init__()
        self.materials = materials
        self.background = background
        self.spheres = spheres
        self.sphere_bvh = sphere_bvh
        self.triangles = triangles
        self.bvh = bvh
        self.tlas = tlas
        self.has_mix = bool(has_mix)

    def world_bounds(self):
        """(bmin, bmax) of all geometry: the root boxes of the BVHs, or
        the spheres' own bounds when they have no BVH."""
        mins, maxs = [], []
        if self.tlas is not None:
            mins.append(self.tlas.t_bmin[0])
            maxs.append(self.tlas.t_bmax[0])
        if self.bvh is not None:
            mins.append(self.bvh.bmin[0])
            maxs.append(self.bvh.bmax[0])
        if self.sphere_bvh is not None:
            mins.append(self.sphere_bvh.bmin[0])
            maxs.append(self.sphere_bvh.bmax[0])
        elif self.spheres is not None:
            r = self.spheres.radius[:, None]
            mins.append(torch.amin(self.spheres.center - r, dim=0))
            maxs.append(torch.amax(self.spheres.center + r, dim=0))
        if not mins:
            device = self.materials.mtype.device
            return (torch.zeros(3, device=device),
                    torch.ones(3, device=device))
        return (torch.amin(torch.stack(mins), dim=0),
                torch.amax(torch.stack(maxs), dim=0))

    def intersect(self, o, d, t_min=T_MIN, t_max=float("inf")) -> Hits:
        """Closest hit of each ray (o, d: (N, 3)) against every primitive
        set; on equal t the earlier set keeps the hit."""
        hits = Hits.none(o.shape[0], device=o.device)
        if self.spheres is not None:
            if self.sphere_bvh is not None:
                hits = hits.closer_of(bvh_mod.intersect_bvh_spheres(
                    self.spheres, self.sphere_bvh, o, d, t_min, t_max))
            else:
                hits = hits.closer_of(
                    sphere_mod.intersect(self.spheres, o, d, t_min, t_max))
        if self.triangles is not None:
            if self.bvh is not None:
                hits = hits.closer_of(bvh_mod.intersect_bvh(
                    self.triangles, self.bvh, o, d, t_min, t_max))
            else:
                hits = hits.closer_of(tri_mod.intersect_brute(
                    self.triangles, o, d, t_min, t_max))
        if self.tlas is not None:
            # The reference's TPU dispatch passes auto=True, its XLA one
            # False; the card takes the first, the CPU the second.
            auto = o.device.type == "cuda"
            if inst_mod.wants_flat(self.tlas, auto):
                hits = hits.closer_of(bvh_mod.intersect_bvh(
                    self.tlas.flat_tris, self.tlas.flat_bvh, o, d, t_min,
                    t_max))
            elif inst_mod.wants_flat_parts(self.tlas, auto):
                hits = hits.closer_of(inst_mod.intersect_tlas_flat_parts(
                    self.tlas, o, d, t_min, t_max))
            else:
                hits = hits.closer_of(inst_mod.intersect_tlas(
                    self.tlas, o, d, t_min, t_max))
        return hits

    def background_eval(self, d):
        return self.background.eval(d)

    def background_eval_masked(self, d, mask):
        """where(mask, background_eval(d), 0)."""
        return torch.where(mask[:, None], self.background_eval(d), 0.0)


class SceneBuilder:
    """Host-side accumulator of spheres, meshes, instances and brute-force
    triangle sets (the reference's World + Model pattern).  Volumes,
    voxels, textures and lights join with their slices."""

    # Sphere sets at or above this size get a BVH.
    SPHERE_BVH_THRESHOLD = 64

    def __init__(self, materials, background):
        """materials: a MaterialBuilder; background: a background
        module."""
        self._materials = materials
        self._background = background
        self._sphere_rows = []
        self._registry = None
        self._tri_groups = []

    def _ensure_registry(self):
        if self._registry is None:
            self._registry = inst_mod.MeshRegistry()
        return self._registry

    def add_sphere(self, center, radius, material):
        self._sphere_rows.append((tuple(center), float(radius),
                                  int(material)))

    def add_mesh(self, tris, split=None):
        """Register a mesh (host Triangles) for instancing, under a BVH
        split "median" (None) or "sah"; returns its id."""
        return self._ensure_registry().add_mesh(tris, split=split)

    def add_instance(self, mesh_id, translation=(0, 0, 0),
                     rotation=(0, 0, 0), scale=(1, 1, 1), material=None):
        """Place an instance; rotation in turns."""
        return self._ensure_registry().add_instance(
            mesh_id, translation, rotation, scale, material)

    def add_model(self, tris, material=None):
        """A mesh placed once, untransformed: an identity instance."""
        return self.add_instance(self.add_mesh(tris), material=material)

    def add_triangles(self, tris):
        """A small host Triangles set, intersected by brute force."""
        self._tri_groups.append(tris)

    def build(self, device=None) -> Scene:
        """The Scene, on `device` (None: the CUDA card)."""
        device = resolve(device)
        spheres = sphere_bvh = None
        if self._sphere_rows:
            rows = self._sphere_rows
            spheres = sphere_mod.Spheres(
                center=np.array([r[0] for r in rows], np.float32),
                radius=np.array([r[1] for r in rows], np.float32),
                material=np.array([r[2] for r in rows], np.int32))
            if spheres.count >= self.SPHERE_BVH_THRESHOLD:
                sphere_bvh, spheres = bvh_mod.build_over_spheres(spheres)
        triangles = None
        if self._tri_groups:
            triangles = tri_mod.TriangleTable(
                tri_mod.concatenate(self._tri_groups))
        tlas = None
        if self._registry is not None and self._registry._instances:
            tlas = self._registry.build()
        scene = Scene(materials=self._materials.build(),
                      background=self._background, spheres=spheres,
                      has_mix=self._materials.has_mix(),
                      sphere_bvh=sphere_bvh, tlas=tlas, triangles=triangles)
        return scene.to(device)
