"""Instanced meshes: a two-level BVH, TLAS over BLAS (mirrors
``mrt.geometry.instance``).

Every mesh's BVH nodes and triangles are concatenated ("mega-BLAS"); a
top-level BVH is built over the instances' world-space boxes with one
instance per leaf.  A ray walks both levels in one stackless loop
(kernel B7, ``ops.bvh.tlas_hit``): entering a TLAS leaf warps it by the
instance's inverse transform and jumps to the mesh's BLAS root;
finishing the BLAS resumes the TLAS at the leaf's escape index.  Hit t
is affine-invariant, so the best t shrinks across instances.

Winners go back to world space as in the reference: the point along
the world ray, the normal by the forward linear part and renormalised
(not the inverse transpose).

The world-flattened alternates of the JAX package (flat, flat-parts and
the brute instanced scan) are opt-in there and lost their A/Bs; they
are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..math import m4
from ..math.vec import dot, sqrt
from ..ops import bvh as kernel
from . import bvh as bvh_mod
from . import triangles as tri_mod
from .bvh import LEAF_SIZE
from .hit import INF, Hits, set_face_normal

# The reference TLAS's fields this port keeps (numpy names; ``tris`` is
# a Triangles set).  The world-flattened and brute-scan fields are not
# kept.
FIELDS = ("t_bmin", "t_bmax", "t_inst", "t_escape", "transform",
          "inv_transform", "override", "blas_root", "blas_end", "bmin",
          "bmax", "first", "count", "escape")


class TLAS(nn.Module):
    """Two-level acceleration structure, as device tables.

    Kernel tables (layouts in ``ops.bvh``): tnodes, tmeta, inst (the
    inverse transforms), imeta, bnodes, bmeta, tris.  Expansion tables:
    transform (I, 4, 4) object to world, override (I,) material row or
    -1, shading (T, 29) the triangles' ``shading_table``."""

    def __init__(self, t_bmin, t_bmax, t_inst, t_escape, transform,
                 inv_transform, override, blas_root, blas_end, bmin, bmax,
                 first, count, escape, tris):
        super().__init__()
        tmeta = np.zeros((len(t_inst), 4), np.int32)
        tmeta[:, 0] = t_inst
        tmeta[:, 1] = t_escape
        bottom = bvh_mod.FlatBVH.create(bmin, bmax, first, count, escape)
        inv = np.asarray(inv_transform, np.float32)
        tris = tris.to_torch()
        buffers = dict(
            tnodes=bvh_mod.node_rows(t_bmin, t_bmax), tmeta=tmeta,
            inst=np.concatenate([inv[:, :3, :3].reshape(-1, 9),
                                 inv[:, :3, 3]], axis=1),
            imeta=np.stack([blas_root, blas_end], axis=1).astype(np.int32),
            bnodes=bottom.nodes, bmeta=bottom.meta,
            tris=torch.cat([tris.va, tris.e_ab, tris.e_ac], dim=1),
            transform=np.asarray(transform, np.float32),
            override=np.asarray(override, np.int32),
            shading=tri_mod.shading_table(tris))
        for name, value in buffers.items():
            self.register_buffer(name,
                                 torch.as_tensor(value).contiguous())

    @classmethod
    def from_numpy(cls, arrays):
        """From a mapping of the reference TLAS's leaves: FIELDS and
        ``tris`` (a mapping of Triangles fields)."""
        tris = arrays["tris"]
        tris = tri_mod.Triangles(**{k: np.asarray(tris[k])
                                    for k in tri_mod.FIELDS})
        return cls(*(np.asarray(arrays[k]) for k in FIELDS), tris=tris)

    @property
    def n_tlas_nodes(self):
        return self.tnodes.shape[0]

    @property
    def n_instances(self):
        return self.inst.shape[0]

    t_bmin = property(lambda self: self.tnodes[:, 0:3])
    t_bmax = property(lambda self: self.tnodes[:, 4:7])
    t_inst = property(lambda self: self.tmeta[:, 0])
    t_escape = property(lambda self: self.tmeta[:, 1])
    blas_root = property(lambda self: self.imeta[:, 0])
    blas_end = property(lambda self: self.imeta[:, 1])
    bmin = property(lambda self: self.bnodes[:, 0:3])
    bmax = property(lambda self: self.bnodes[:, 4:7])
    first = property(lambda self: self.bmeta[:, 0])
    count = property(lambda self: self.bmeta[:, 1])
    escape = property(lambda self: self.bmeta[:, 2])


class MeshRegistry:
    """Host-side accumulator: register meshes once, instance them many
    times (the reference's shared ``Arc<BvhNode>``)."""

    def __init__(self):
        self._meshes = []     # [(FlatBVH, Triangles in BVH order)]
        self._instances = []  # [dict]

    def add_mesh(self, tris, leaf_size=LEAF_SIZE) -> int:
        self._meshes.append(bvh_mod.build_over_triangles(tris, leaf_size))
        return len(self._meshes) - 1

    def add_instance(self, mesh_id, translation=(0, 0, 0),
                     rotation=(0, 0, 0), scale=(1, 1, 1), material=None):
        """rotation in turns, like the reference."""
        self._instances.append(dict(
            mesh=mesh_id,
            translation=np.asarray(translation, np.float32),
            rotation=np.asarray(np.broadcast_to(rotation, (3,)), np.float32),
            scale=np.asarray(np.broadcast_to(scale, (3,)), np.float32),
            material=-1 if material is None else int(material)))
        return len(self._instances) - 1

    def build(self) -> TLAS:
        if not self._instances:
            raise ValueError("no instances registered")
        node_off = []
        bmins, bmaxs, firsts, counts, escapes = [], [], [], [], []
        n_nodes = n_tris = 0
        for bvh, tris in self._meshes:
            node_off.append(n_nodes)
            bmins.append(bvh.bmin.numpy())
            bmaxs.append(bvh.bmax.numpy())
            firsts.append(bvh.first.numpy() + n_tris)
            counts.append(bvh.count.numpy())
            escapes.append(bvh.escape.numpy() + n_nodes)
            n_nodes += bvh.n_nodes
            n_tris += tris.count
        tris = tri_mod.concatenate([t for _, t in self._meshes])

        n_inst = len(self._instances)
        tr = np.stack([i["translation"] for i in self._instances])
        ro = np.stack([i["rotation"] for i in self._instances])
        sc = np.stack([i["scale"] for i in self._instances])
        mesh_ids = np.array([i["mesh"] for i in self._instances], np.int32)
        override = np.array([i["material"] for i in self._instances],
                            np.int32)
        fwd = m4.trs_batch_np(tr, ro, sc)
        inv = m4.trs_inverse_batch_np(tr, ro, sc)

        nodes_per = np.array([b.n_nodes for b, _ in self._meshes], np.int32)
        roots = np.array(node_off, np.int32)[mesh_ids]
        ends = roots + nodes_per[mesh_ids]

        # World boxes from the 8 transformed corners of each mesh's root
        # box.
        root_min = np.stack([b.bmin[0].numpy()
                             for b, _ in self._meshes])[mesh_ids]
        root_max = np.stack([b.bmax[0].numpy()
                             for b, _ in self._meshes])[mesh_ids]
        combos = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                           for z in (0, 1)], np.float32)
        corners = (root_min[:, None, :] * (1.0 - combos[None])
                   + root_max[:, None, :] * combos[None])
        wc = (np.einsum("iab,icb->ica", fwd[:, :3, :3], corners)
              + fwd[:, None, :3, 3])
        w_min = wc.min(axis=1)
        w_max = wc.max(axis=1)

        # TLAS over the instance boxes, one instance per leaf; leaves
        # name the instance (-1 for inner nodes).
        (t_bmin, t_bmax, t_first, t_count, t_escape), order = bvh_mod.build(
            (w_min + w_max) / 2.0, w_min, w_max, leaf_size=1)
        t_inst = np.where(t_count > 0, order[np.minimum(t_first, n_inst - 1)],
                          -1).astype(np.int32)
        return TLAS(t_bmin, t_bmax, t_inst, t_escape, fwd, inv, override,
                    roots, ends, np.concatenate(bmins), np.concatenate(bmaxs),
                    np.concatenate(firsts), np.concatenate(counts),
                    np.concatenate(escapes), tris)


def intersect_tlas(tlas: TLAS, o, d, t_min, t_max) -> Hits:
    """Closest hit over all instances (kernel B7), as Hits."""
    t, inst, tri, u, v = kernel.tlas_hit(tlas, o, d, t_min, t_max)
    return expand_winner(tlas, o, d, t, inst, tri, u, v)


def expand_winner(tlas: TLAS, o, d, best_t, best_inst, best_tri, best_u,
                  best_v) -> Hits:
    """Per-ray winners (t, instance, triangle, u, v) -> world-space
    Hits.  Tables are indexed directly."""
    hit = torch.isfinite(best_t)
    inst = torch.clamp(best_inst, min=0).to(torch.int64)
    w = (1.0 - best_u - best_v)[:, None]
    uu, vv = best_u[:, None], best_v[:, None]
    s = tri_mod.unpack_shading(tlas.shading[best_tri.to(torch.int64)])
    normal_l = s["na"] * w + s["nb"] * uu + s["nc"] * vv

    # World normal: forward linear part, then unit length.
    lin = tlas.transform[inst, :3, :3]
    normal_w = dot(lin, normal_l[:, None, :])
    norm = sqrt(dot(normal_w, normal_w))[:, None]
    normal_w = normal_w / torch.clamp(norm, min=1e-20)

    t_safe = torch.where(hit, best_t, 0.0)
    point = o + d * t_safe[:, None]  # t is affine-invariant
    ov = tlas.override[inst]
    material = torch.where(ov >= 0, ov, s["material"])
    normal_w, front_face = set_face_normal(d, normal_w)
    return Hits(t=torch.where(hit, best_t, INF), point=point,
                normal=normal_w, front_face=front_face, material=material,
                hit=hit)
