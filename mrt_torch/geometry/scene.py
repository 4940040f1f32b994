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
    (``instance.wants_flat`` / ``wants_flat_parts``);
  - voxel grids, walked by a hierarchical DDA in PyTorch
    (``geometry/voxels.py``);
  - volumes bounded by spheres (one uniform each), then volumes bounded
    by meshes (kernel B7), drawing from the caller's sampler.
With a texture atlas, EVE hits then get their normal maps (unless the
caller asks only for occlusion, as shadow rays do), and a scene whose
materials can fail the alpha test re-casts the rays whose winner did
(``ALPHA_ROUNDS`` times).  A scene with a light table (``lights``) is
rendered with next-event estimation (``materials/lights.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..core.autodiff import Replace, needs_grad
from ..core.device import resolve
from ..materials import shade
from ..materials.background import CubeMap, SkySphere
from ..ops import budget, compact
from ..ops import hits as hit_kernel
from ..textures.atlas import RAW
from ..utils import profiling
from . import bvh as bvh_mod
from . import instance as inst_mod
from . import spheres as sphere_mod
from . import triangles as tri_mod
from . import volumes as vol_mod
from . import voxels as vox_mod
from .hit import Hits

T_MIN = 1e-3  # intersect(ray, 0.001, inf), as in the reference


class Scene(Replace, nn.Module):
    """materials: MaterialTable; background: a background module;
    spheres: Spheres or None; sphere_bvh: FlatBVH over the spheres (in
    BVH order) or None; triangles: a TriangleTable or None; bvh: FlatBVH
    over the triangles (in BVH order) or None for a brute-force scan;
    tlas: TLAS or None; voxels: a sequence of VoxelGrid or None; volumes:
    VolumeSpheres or None; mesh_volumes: a sequence of MeshVolume or
    None; atlas: TextureAtlas or None; lights: a LightTable (next-event
    estimation) or None.  The sphere set gets the table of the kernel
    that walks it here (``Spheres.build_kernel_table``).
    ``has_mix`` is False when no material row is a MIX (shading then
    skips the row resolution); ``needs_alpha`` is True when a material
    row can fail the alpha test (the re-cast rounds run);
    ``mat_tex_raw`` is True when every texture a material row refers to
    is a RAW atlas row (one texel lookup a sample).
    ``replace(materials=..., spheres=...)`` is the counterpart of the
    reference's ``.replace``; a sphere set given without its kernel
    table gets one, as here."""

    # Re-cast rounds for alpha-tested winners: each sees through one more
    # cutout per ray; stacked cutouts beyond it render opaque.
    ALPHA_ROUNDS = 3

    def __init__(self, materials, background, spheres=None, has_mix=True,
                 sphere_bvh=None, tlas=None, triangles=None, bvh=None,
                 volumes=None, mesh_volumes=None, atlas=None,
                 needs_alpha=False, mat_tex_raw=False, voxels=None,
                 lights=None):
        super().__init__()
        self.materials = materials
        self.background = background
        self.spheres = spheres
        self.sphere_bvh = sphere_bvh
        if spheres is not None:
            spheres.build_kernel_table(in_bvh=sphere_bvh is not None)
        self.triangles = triangles
        self.bvh = bvh
        self.tlas = tlas
        self.voxels = nn.ModuleList(voxels) if voxels else None
        self.volumes = volumes
        self.mesh_volumes = (nn.ModuleList(mesh_volumes) if mesh_volumes
                             else None)
        self.atlas = atlas
        self.lights = lights
        self.has_mix = bool(has_mix)
        self.needs_alpha = bool(needs_alpha)
        self.mat_tex_raw = bool(mat_tex_raw)

    def replace(self, **fields):
        new = super().replace(**fields)
        sph = new.spheres
        if "spheres" in fields and sph is not None and (
                sph.krows is None and sph.g_rows is None):
            sph.build_kernel_table(in_bvh=new.sphere_bvh is not None)
        return new

    def to(self, *args, **kwargs):
        """nn.Module.to, timed as the ``table upload`` part of a scene
        build (``utils.profiling``)."""
        with profiling.part("table upload"):
            return super().to(*args, **kwargs)

    def world_bounds(self):
        """(bmin, bmax) of all geometry: the root boxes of the BVHs, the
        spheres' own bounds when they have no BVH, and the voxel grids'
        boxes."""
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
        for grid in self.voxels or ():
            lo, hi = grid.world_bounds()
            mins.append(lo)
            maxs.append(hi)
        if not mins:
            device = self.materials.mtype.device
            return (torch.zeros(3, device=device),
                    torch.ones(3, device=device))
        return (torch.amin(torch.stack(mins), dim=0),
                torch.amax(torch.stack(maxs), dim=0))

    # The reference's auto rule for the persistent pass's lane sorter
    # (``mrt.geometry.scene``): a TLAS past the table budget or of
    # SORT_MIN_INSTANCES instances, or SORT_MIN_SPHERES spheres under a
    # BVH, sorts; every SORT_CADENCE_HEAVY_INSTANCES-instance or
    # over-budget TLAS every step, any other scene every 4 steps.  Its
    # thresholds are the reference's, so both packages sort the same
    # scenes; the card's own cost of sorting is in PERF.md.
    SORT_MIN_INSTANCES = 32
    SORT_MIN_SPHERES = 4096
    SORT_CADENCE_HEAVY_INSTANCES = 64

    def prefers_sorted_rays(self):
        """True where the auto rule sorts this scene's lanes: only on the
        card (``sorts_on_device``), as the reference's rule only runs
        with its TPU kernels."""
        if not sorts_on_device(self):
            return False
        if self.tlas is not None:
            if not budget.fits(budget.tlas_tables_bytes(self.tlas)):
                return True
            if self.tlas.transform.shape[0] >= self.SORT_MIN_INSTANCES:
                return True
        return (self.sphere_bvh is not None and self.spheres is not None
                and self.spheres.count >= self.SORT_MIN_SPHERES)

    def sort_cadence(self):
        """Steps between lane sorts when sorting is on (1 = every)."""
        if self.tlas is not None:
            if not budget.fits(budget.tlas_tables_bytes(self.tlas)):
                return 1
            if (self.tlas.transform.shape[0]
                    >= self.SORT_CADENCE_HEAVY_INSTANCES):
                return 1
        return 4

    def intersect(self, o, d, t_min=T_MIN, t_max=float("inf"),
                  sampler=None, shading_aux=True) -> Hits:
        """Closest hit of each ray (o, d: (N, 3)) against every primitive
        set; on equal t the earlier set keeps the hit.  `sampler` feeds
        the volumes' free flights and the alpha test's Mix draws (scenes
        with either need it).  shading_aux=False skips what only shading
        needs (normal maps), for occlusion queries.

        Alpha test: the winner is tested, and rays whose winner fails are
        cast again from just past it.  Every round runs and merges by
        where(redo, ...), so the host never waits for the device; a round
        with nothing to redo changes nothing, and the sampler's draws
        advance the same either way."""
        hits = self._intersect_once(o, d, t_min, t_max, sampler, shading_aux)
        if self.needs_alpha and self.atlas is not None:
            for _ in range(self.ALPHA_ROUNDS):
                keep = shade.alpha_test(self, hits.material, hits.uv, sampler)
                redo = hits.hit & ~keep
                again = self._intersect_once(
                    o, d, torch.where(redo, hits.t + 1e-4, t_min), t_max,
                    sampler, shading_aux)
                hits = hits.select(redo, again)
        return hits

    def _intersect_once(self, o, d, t_min, t_max, sampler, shading_aux):
        if records_on_card(self, o, d, shading_aux):
            sph, inst = self.winners(o, d, t_min, t_max)
            return hit_kernel.hit_record(o, d, self.spheres, sph, self.tlas,
                                         inst)
        hits = Hits.none(o.shape[0], device=o.device)
        if self.spheres is not None:
            hits = hits.closer_of(sphere_mod.make_hits(
                self.spheres, o, d, *self._sphere_winners(o, d, t_min, t_max),
                t_min))
        if self.triangles is not None:
            if self.bvh is not None:
                hits = hits.closer_of(bvh_mod.intersect_bvh(
                    self.triangles, self.bvh, o, d, t_min, t_max))
            else:
                hits = hits.closer_of(tri_mod.intersect_brute(
                    self.triangles, o, d, t_min, t_max))
        if self.tlas is not None:
            if inst_mod.wants_flat(self.tlas, o.device.type == "cuda"):
                hits = hits.closer_of(bvh_mod.intersect_bvh(
                    self.tlas.flat_tris, self.tlas.flat_bvh, o, d, t_min,
                    t_max))
            else:
                hits = hits.closer_of(inst_mod.expand_winner(
                    self.tlas, o, d,
                    *self._instance_winners(o, d, t_min, t_max)))
        for grid in self.voxels or ():
            hits = hits.closer_of(vox_mod.intersect(grid, o, d, t_min, t_max))
        if (self.volumes is not None or self.mesh_volumes) and sampler is None:
            raise ValueError("scene has volumes: intersect needs a sampler "
                             "for the free flights")
        if self.volumes is not None:
            u = torch.stack([sampler.next1()
                             for _ in range(self.volumes.count)], dim=-1)
            hits = hits.closer_of(vol_mod.intersect(self.volumes, o, d, t_min,
                                                    t_max, u))
        for vol in self.mesh_volumes or ():
            hits = hits.closer_of(vol_mod.intersect_mesh(
                vol, o, d, t_min, t_max, sampler.next1()))
        if self.atlas is not None and shading_aux:
            hits = shade.apply_normal_maps(self, hits, d)
        return hits

    def winners(self, o, d, t_min, t_max):
        """The searches of a scene of spheres and instances
        (``records_on_card``): (the spheres' (t, index) or None, the
        instances' (t, instance, triangle, u, v) or None), as kernel H1's
        wrapper takes them."""
        return (None if self.spheres is None
                else self._sphere_winners(o, d, t_min, t_max),
                None if self.tlas is None
                else self._instance_winners(o, d, t_min, t_max))

    def _sphere_winners(self, o, d, t_min, t_max):
        """(t, index): B5 through the sphere BVH, else B1."""
        if self.sphere_bvh is not None:
            return bvh_mod.sphere_bvh_winners(self.spheres, self.sphere_bvh,
                                              o, d, t_min, t_max)
        return sphere_mod.nearest_t(self.spheres, o, d, t_min, t_max)

    def _instance_winners(self, o, d, t_min, t_max):
        """(t, instance, triangle, u, v): the flat parts (B6) where the
        dispatch takes them, else B7.  The reference's TPU dispatch passes
        auto=True, its XLA one False; the card takes the first, the CPU
        the second."""
        if inst_mod.wants_flat_parts(self.tlas, o.device.type == "cuda"):
            return inst_mod.flat_parts_winners(self.tlas, o, d, t_min, t_max)
        return inst_mod.tlas_winners(self.tlas, o, d, t_min, t_max)

    def background_eval(self, d):
        return self.background.eval(d, atlas=self.atlas)

    def background_eval_masked(self, d, mask):
        """where(mask, background_eval(d), 0).  For a texel-backed
        background with ``MRT_BG_COMPACT=1`` (off by default, as in the
        reference), the masked (miss) lanes are packed first and only
        they are evaluated (``ops.compact``)."""
        use = (isinstance(self.background, (CubeMap, SkySphere))
               and os.environ.get("MRT_BG_COMPACT") == "1")
        k = compact.rows_for(d.shape[0])
        if not use or k >= d.shape[0]:
            return torch.where(mask[:, None], self.background_eval(d), 0.0)
        return compact.compact_apply(
            lambda dc: self.background.eval(dc, atlas=self.atlas), mask, d,
            k, pad_row=(1.0, 0.0, 0.0))


def records_on_card(scene: Scene, o, d, shading_aux) -> bool:
    """Whether ``Scene.intersect`` writes its record through kernel H1's
    wrapper (``ops.hits``), on any device: the scene's sets are only
    spheres (B1 or B5) and instances whose winners come as (t, instance,
    triangle, u, v) (B7 or the flat parts), no normal maps are asked for
    (no atlas while `shading_aux`), and autograd does not record through
    the rays or the spheres (the spheres' ``winner_t`` needs the graph).
    Everywhere else the eager chain runs."""
    if (scene.triangles is not None or scene.voxels or scene.volumes
            is not None or scene.mesh_volumes or (
                scene.atlas is not None and shading_aux)):
        return False
    if scene.tlas is not None and inst_mod.wants_flat(
            scene.tlas, o.device.type == "cuda"):
        return False
    sph = scene.spheres
    return not needs_grad(o, d, *((sph.center, sph.radius) if sph is not None
                                  else ()))


def sorts_on_device(scene: Scene) -> bool:
    """The auto rule's gate: True where the scene's tensors are on CUDA,
    where the port's kernels run (the reference gates its rule on its
    TPU kernels, ``spheres._use_pallas``).  Tests patch it."""
    return scene.materials.mtype.is_cuda


def attach_lights(scene: Scene) -> Scene:
    """Opt in to next-event estimation: collect the scene's emissive
    geometry into its light table (nothing changes when it has none).
    Returns the scene."""
    from ..materials.lights import collect_lights

    table = collect_lights(scene)
    if table is not None:
        scene.lights = table
    return scene


def all_raw(texture_ids, atlas):
    """True when every one of the atlas ids is a RAW row."""
    kinds = atlas.kind.cpu().numpy()
    return all(int(kinds[i]) == RAW for i in texture_ids)


def with_atlas(scene: Scene, atlas) -> Scene:
    """Attach a texture atlas to a built scene, with the ``mat_tex_raw``
    it implies; returns the scene."""
    m = scene.materials
    ids = {int(i) for col in (m.tex, m.tex_no, m.tex_pmdg)
           for i in col.cpu().tolist() if i >= 0}
    scene.mat_tex_raw = all_raw(ids, atlas)
    scene.atlas = atlas.to(m.mtype.device)
    return scene


class SceneBuilder:
    """Host-side accumulator of spheres, meshes, instances, brute-force
    triangle sets, voxel grids and volumes (the reference's World + Model
    pattern)."""

    # Sphere sets at or above this size get a BVH.
    SPHERE_BVH_THRESHOLD = 64

    def __init__(self, materials, background, atlas=None):
        """materials: a MaterialBuilder (still open: volumes add rows);
        background: a background module; atlas: a built TextureAtlas or
        None."""
        self._materials = materials
        self._background = background
        self._atlas = atlas
        self._sphere_rows = []
        self._registry = None
        self._tri_groups = []
        self._volumes = []
        self._mesh_volumes = []
        self._voxels = []

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

    def add_volume_sphere(self, center, radius, density, albedo):
        """A fog volume bounded by a sphere."""
        mat = self._materials.isotropic(tuple(albedo))
        self._volumes.append((tuple(center), float(radius),
                              -1.0 / float(density), mat))

    def add_volume_mesh(self, tris, density, albedo, translation=(0, 0, 0),
                        rotation=(0, 0, 0), scale=(1, 1, 1)):
        """A fog volume bounded by an instanced mesh; rotation in turns."""
        mat = self._materials.isotropic(tuple(albedo))
        reg = inst_mod.MeshRegistry()
        reg.add_instance(reg.add_mesh(tris), translation, rotation, scale)
        self._mesh_volumes.append((reg, -1.0 / float(density), mat))

    def add_voxel_grid(self, origin, cell, levels, material, rule="menger",
                       occupancy=None):
        """An axis-aligned grid of solid cells (``voxels.VoxelGrid``)."""
        self._voxels.append(vox_mod.VoxelGrid.create(
            origin, cell, levels, material, rule=rule, occupancy=occupancy))

    def build(self, device=None, nee=False) -> Scene:
        """The Scene, on `device` (None: the CUDA card); nee=True attaches
        its light table (next-event estimation)."""
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
        volumes = None
        if self._volumes:
            volumes = vol_mod.VolumeSpheres(*(
                np.array([v[k] for v in self._volumes],
                         np.int32 if k == 3 else np.float32)
                for k in range(4)))
        mesh_volumes = [vol_mod.MeshVolume(reg.build(), np.float32(nid), mat)
                        for reg, nid, mat in self._mesh_volumes]
        mats, atlas = self._materials, self._atlas
        scene = Scene(materials=mats.build(), background=self._background,
                      spheres=spheres, has_mix=mats.has_mix(),
                      sphere_bvh=sphere_bvh, tlas=tlas, triangles=triangles,
                      volumes=volumes, mesh_volumes=mesh_volumes,
                      voxels=self._voxels, atlas=atlas,
                      needs_alpha=atlas is not None and mats.may_alpha_test(),
                      mat_tex_raw=(atlas is not None
                                   and all_raw(mats.texture_ids(), atlas)))
        scene = scene.to(device)
        return attach_lights(scene) if nee else scene
