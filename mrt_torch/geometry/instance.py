"""Instanced meshes: a two-level BVH, TLAS over BLAS (mirrors
``mrt.geometry.instance``).

Every mesh's BVH nodes and triangles are concatenated ("mega-BLAS"); a
top-level BVH is built over the instances' world-space boxes with one
instance per leaf.  A ray walks both levels in one stackless loop
(kernel B7, ``ops.bvh.tlas_hit``): entering a TLAS leaf warps it by the
instance's inverse transform and jumps to the mesh's BLAS root;
finishing the BLAS resumes the TLAS after the leaf.  Hit t is
affine-invariant, so the best t shrinks across instances.  The card
walks both levels front to back in the octant threading of
``bvh.thread_octants`` (each BLAS threaded alone, with its ``blas_end``
as sentinel; a tree under ``bvh.OCTANT_MIN_NODES`` nodes in the escape
order, ``bvh.card_order``), from packed tables kept beside the
reference's.

Winners go back to world space as in the reference: the point along
the world ray, the normal by the forward linear part and renormalised
(not the inverse transpose).

The world-flattened routes are the reference's, opt-in through
``MRT_TLAS_KERNEL`` (``flat`` or ``auto``; any other value disables)
exactly as there, so one environment routes both packages alike:
  - flat: a small scene's instances pre-transformed to world space under
    one single-level BVH (``flat_tris``/``flat_bvh``, built whenever the
    tables fit, below FLAT_MAX_TRIS world triangles);
  - flat parts: a mid-size scene split into spatial instance clusters,
    each world-flattened under its own BVH (``flat_parts``, built only
    when the opt-in asks for it); per-ray winners fold across the parts
    and expand through ``expand_winner``.  On the card one B6 launch
    walks all parts as one forest (``FlatParts``).
Both walk their BVHs with kernel B6.  The brute instanced scan
(``MRT_TLAS_KERNEL=brute``, a TPU oracle for B7's function) is not
ported: that value takes the two-level route here.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..core.autodiff import refuse_grad
from ..math import m4
from ..math.vec import clamp, cross, dot, length, sqrt
from ..ops import budget
from ..ops import bvh as kernel
from . import bvh as bvh_mod
from . import triangles as tri_mod
from .bvh import LEAF_SIZE
from .hit import INF, Hits, set_face_normal

# The reference TLAS's array fields (numpy names); ``tris`` (a Triangles
# set) and the world-flattened fields come apart.
FIELDS = ("t_bmin", "t_bmax", "t_inst", "t_escape", "transform",
          "inv_transform", "override", "blas_root", "blas_end", "bmin",
          "bmax", "first", "count", "escape", "tri_first", "tri_count",
          "w_min", "w_max")


class FlatPart(nn.Module):
    """One spatial cluster of world-flattened instances: ``bvh`` (a
    FlatBVH), ``rows`` (Tp, 9) its world triangles in BVH order (kernel
    layout) and ``packed`` (Tp,) int32 ids (instance << 20) | the
    triangle's index in the TLAS's ``tris``."""

    def __init__(self, bvh, rows, packed):
        super().__init__()
        self.bvh = bvh
        self.register_buffer("rows", torch.as_tensor(
            rows, dtype=torch.float32).contiguous())
        self.register_buffer("packed", torch.as_tensor(
            packed, dtype=torch.int32).contiguous())


class FlatParts(nn.Module):
    """The flat parts of a TLAS (a sequence of FlatPart) and the forest
    that kernel B6 walks over all of them in one launch: ``forest``, a
    FlatBVH whose top nodes split the parts' root boxes and whose
    subtrees are the parts' BVHs (``bvh.graft``), its leaves indexing
    the parts' rows in part order, and ``krows``, those rows packed
    (``ops.bvh.card_tris``)."""

    def __init__(self, parts):
        super().__init__()
        self.parts = nn.ModuleList(parts)
        offsets = np.cumsum([0] + [p.rows.shape[0] for p in parts])[:-1]
        self.forest = bvh_mod.FlatBVH.create(*bvh_mod.graft(
            [p.bvh for p in parts], offsets))
        self.register_buffer("krows", kernel.card_tris(
            torch.cat([p.rows for p in parts])))

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]


class TLAS(nn.Module):
    """Two-level acceleration structure, as device tables.

    Kernel tables (layouts in ``ops.bvh``): tnodes, tmeta, inst (the
    inverse transforms), imeta, bnodes, bmeta, tris; B7's packed ones
    beside them: k_tnodes (instance in the pad), t_order (the TLAS's
    octant threading), k_bnodes (first, count in the pads), b_order
    (each BLAS's threading), k_tris.  Expansion tables:
    transform (I, 4, 4) object to world, override (I,) material row or
    -1, shading (T, 29) the triangles' ``shading_table``.  Per instance:
    tri_first, tri_count (its mesh's range in ``tris``) and w_min, w_max
    (its world box, as built into the TLAS leaves).

    World-flattened routes, each None where not built: ``flat_tris`` (a
    TriangleTable, unit normals) under ``flat_bvh``; ``flat_parts`` (a
    FlatParts) with ``flat_packed``, their packed ids concatenated in
    part order."""

    def __init__(self, t_bmin, t_bmax, t_inst, t_escape, transform,
                 inv_transform, override, blas_root, blas_end, bmin, bmax,
                 first, count, escape, tri_first, tri_count, w_min, w_max,
                 tris, flat_tris=None, flat_bvh=None, flat_parts=None):
        """Arrays as the reference's fields; tris, flat_tris: host
        Triangles; flat_bvh: a FlatBVH; flat_parts: FlatParts."""
        super().__init__()
        tmeta = np.zeros((len(t_inst), 4), np.int32)
        tmeta[:, 0] = t_inst
        tmeta[:, 1] = t_escape
        bmeta = np.zeros((len(first), 4), np.int32)
        bmeta[:, 0] = first
        bmeta[:, 1] = count
        bmeta[:, 2] = escape
        tnodes = bvh_mod.node_rows(t_bmin, t_bmax)
        bnodes = bvh_mod.node_rows(bmin, bmax)
        inv = np.asarray(inv_transform, np.float32)
        tris = tris.to_torch()
        rows = torch.cat([tris.va, tris.e_ab, tris.e_ac], dim=1)
        buffers = dict(
            tnodes=tnodes, tmeta=tmeta,
            inst=np.concatenate([inv[:, :3, :3].reshape(-1, 9),
                                 inv[:, :3, 3]], axis=1),
            imeta=np.stack([blas_root, blas_end], axis=1).astype(np.int32),
            bnodes=bnodes, bmeta=bmeta, tris=rows,
            k_tnodes=kernel.card_nodes(tnodes, tmeta[:, 0], tmeta[:, 3]),
            t_order=bvh_mod.card_order(
                (tmeta[:, 0] >= 0).astype(np.int32), t_escape, t_bmin,
                t_bmax),
            k_bnodes=kernel.card_nodes(bnodes, first, count),
            b_order=bvh_mod.thread_segments(count, escape, bmin, bmax,
                                            blas_root, blas_end),
            k_tris=kernel.card_tris(rows),
            transform=np.asarray(transform, np.float32),
            override=np.asarray(override, np.int32),
            shading=tri_mod.shading_table(tris),
            tri_first=np.asarray(tri_first, np.int32),
            tri_count=np.asarray(tri_count, np.int32),
            w_min=np.asarray(w_min, np.float32),
            w_max=np.asarray(w_max, np.float32))
        for name, value in buffers.items():
            self.register_buffer(name,
                                 torch.as_tensor(value).contiguous())
        self.flat_tris = (None if flat_tris is None
                          else tri_mod.TriangleTable(flat_tris))
        self.flat_bvh = flat_bvh
        self.flat_parts = None
        if flat_parts is not None:
            self.flat_parts = FlatParts(flat_parts)
            self.register_buffer("flat_packed", torch.cat(
                [p.packed for p in flat_parts]))

    @classmethod
    def from_numpy(cls, arrays):
        """From a mapping of the reference TLAS's leaves: FIELDS, ``tris``
        (a mapping of Triangles fields) and, where the reference built
        them, ``flat_tris`` (such a mapping), ``flat_bvh`` (a mapping of
        the FlatBVH arrays) and ``flat_parts`` (a sequence of mappings
        with "tris" {va, e_ab, e_ac}, "bvh" and "packed")."""
        tris = lambda m, **kw: tri_mod.Triangles(
            **{k: np.asarray(m[k]) for k in tri_mod.FIELDS}, **kw)
        bvh = lambda m: bvh_mod.FlatBVH.create(
            *(np.asarray(m[k]) for k in bvh_mod.FlatBVH.FIELDS))
        flat_tris = flat_bvh = flat_parts = None
        if arrays.get("flat_tris") is not None:
            flat_tris = tris(arrays["flat_tris"], unit_normal=True)
            flat_bvh = bvh(arrays["flat_bvh"])
        if arrays.get("flat_parts") is not None:
            flat_parts = [FlatPart(bvh(p["bvh"]), np.concatenate(
                [np.asarray(p["tris"][k]) for k in ("va", "e_ab", "e_ac")],
                axis=1), np.asarray(p["packed"]))
                for p in arrays["flat_parts"]]
        return cls(*(np.asarray(arrays[k]) for k in FIELDS),
                   tris=tris(arrays["tris"]), flat_tris=flat_tris,
                   flat_bvh=flat_bvh, flat_parts=flat_parts)

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

    # World-flattening limits, the reference's: the single flat set up
    # to FLAT_MAX_TRIS world triangles; flat parts up to
    # FLAT_PARTS_MAX_TRIS in all and FLAT_PART_TRIS a part (both sized
    # to the TPU kernel's table budget, ``ops.budget``), and within the
    # packed (instance << 20 | triangle) int32 encoding.
    FLAT_MAX_TRIS = 12288
    FLAT_PARTS_MAX_TRIS = 1 << 17
    FLAT_PART_TRIS = 9216

    def add_mesh(self, tris, leaf_size=LEAF_SIZE, split=None) -> int:
        """Register a host Triangles set under its own BVH, split
        "median" (None) or "sah"; returns its id."""
        self._meshes.append(bvh_mod.build_over_triangles(tris, leaf_size,
                                                         split=split))
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
        node_off, tri_off = [], []
        bmins, bmaxs, firsts, counts, escapes = [], [], [], [], []
        n_nodes = n_tris = 0
        for bvh, tris in self._meshes:
            node_off.append(n_nodes)
            tri_off.append(n_tris)
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
        tris_per = np.array([t.count for _, t in self._meshes], np.int32)
        inst_tri_first = np.array(tri_off, np.int32)[mesh_ids]
        inst_tri_count = tris_per[mesh_ids]

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

        # The world-flattened routes' tables, built as the reference
        # builds them (MRT_FLAT_SPLIT forces parts of that many
        # triangles).
        split_env = os.environ.get("MRT_FLAT_SPLIT", "")
        flat_tris = flat_bvh = flat_parts = None
        if not split_env:
            flat_tris, flat_bvh = self._build_flat(
                mesh_ids, fwd, override, int(inst_tri_count.sum()))
        if flat_tris is None and (
                split_env
                or os.environ.get("MRT_TLAS_KERNEL") in ("flat", "auto")):
            flat_parts = self._build_flat_parts(
                mesh_ids, fwd, w_min, w_max, inst_tri_first, inst_tri_count,
                part_tris=int(split_env) if split_env else None)
        return TLAS(t_bmin, t_bmax, t_inst, t_escape, fwd, inv, override,
                    roots, ends, np.concatenate(bmins), np.concatenate(bmaxs),
                    np.concatenate(firsts), np.concatenate(counts),
                    np.concatenate(escapes), inst_tri_first, inst_tri_count,
                    w_min, w_max, tris, flat_tris=flat_tris,
                    flat_bvh=flat_bvh, flat_parts=flat_parts)

    def _build_flat(self, mesh_ids, fwd, override, world_tris):
        """Every instance's triangles in world space as one host
        Triangles set under a single-level BVH; (None, None) past
        FLAT_MAX_TRIS or the table budget.

        The instanced hit semantics carry over: vertices and edges by
        the forward affine transform; vertex normals and the tangent
        frame by the forward linear part (not the inverse transpose),
        normalised at hit time (``unit_normal``: the transform is
        linear, so interpolating transformed normals equals transforming
        the interpolated normal); material overrides baked per
        triangle.  Meshes go in ascending id order."""
        if world_tris > self.FLAT_MAX_TRIS:
            return None, None
        by_mesh = {}
        for i, m in enumerate(mesh_ids):
            by_mesh.setdefault(int(m), []).append(i)
        chunks = []
        for m, idx in sorted(by_mesh.items()):
            tris = self._meshes[m][1]
            a = fwd[idx][:, :3, :3]                        # (K, 3, 3)
            b = fwd[idx][:, :3, 3]                         # (K, 3)
            ov = override[idx]                             # (K,)
            k = len(idx)
            pt = lambda x: (np.einsum("kab,tb->kta", a, np.asarray(x))
                            + b[:, None, :]).reshape(-1, 3)
            ln = lambda x: np.einsum(
                "kab,tb->kta", a, np.asarray(x)).reshape(-1, 3)
            tile = lambda x: np.broadcast_to(
                np.asarray(x)[None], (k,) + np.asarray(x).shape
            ).reshape((-1,) + np.asarray(x).shape[1:])
            mat = np.where(ov[:, None] >= 0, ov[:, None],
                           np.asarray(tris.material)[None, :])
            chunks.append(tri_mod.Triangles(
                va=pt(tris.va), e_ab=ln(tris.e_ab), e_ac=ln(tris.e_ac),
                na=ln(tris.na), nb=ln(tris.nb), nc=ln(tris.nc),
                uva=tile(tris.uva), uvb=tile(tris.uvb), uvc=tile(tris.uvc),
                tangent=ln(tris.tangent), bitangent=ln(tris.bitangent),
                material=mat.reshape(-1).astype(np.int32),
                has_uv=tile(tris.has_uv), unit_normal=True))
        flat = tri_mod.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        flat_bvh, flat = bvh_mod.build_over_triangles(flat)
        if not budget.fits(budget.tri_tables_bytes(flat_bvh.n_nodes,
                                                   flat.count)):
            return None, None
        return flat, flat_bvh

    def _build_flat_parts(self, mesh_ids, fwd, w_min, w_max, tri_first,
                          tri_count, part_tris=None):
        """Instances split into spatial clusters, each world-flattened
        (geometry only) under its own single-level BVH; a list of
        FlatPart, or None where the scene is too small (the single flat
        set serves it) or too large, or the encoding or the table budget
        does not fit.  Clusters split at the triangle-count median along
        the widest axis of the instance box centres."""
        n_inst = len(mesh_ids)
        total = int(tri_count.sum())
        ceil = part_tris or self.FLAT_PART_TRIS
        if ((part_tris is None and total <= self.FLAT_MAX_TRIS)
                or total > self.FLAT_PARTS_MAX_TRIS
                or n_inst >= 2048
                or int(tri_first.max() + tri_count.max()) >= 1 << 20):
            return None
        if int(tri_count.max()) > ceil:
            return None  # one instance alone overflows a part

        cent = ((w_min + w_max) * 0.5).astype(np.float64)
        counts = np.asarray(tri_count, np.int64)

        def split(idx):
            if counts[idx].sum() <= ceil or len(idx) == 1:
                return [idx]
            ext = cent[idx].max(axis=0) - cent[idx].min(axis=0)
            ax = int(np.argmax(ext))
            order = idx[np.argsort(cent[idx, ax], kind="stable")]
            cum = np.cumsum(counts[order])
            half = int(np.searchsorted(cum, cum[-1] / 2.0))
            half = min(max(half, 1), len(order) - 1)
            return split(order[:half]) + split(order[half:])

        parts = []
        for idx in split(np.arange(n_inst)):
            vas, eabs, eacs, packs = [], [], [], []
            for i in idx:
                tris = self._meshes[mesh_ids[i]][1]
                a, b = fwd[i, :3, :3], fwd[i, :3, 3]
                vas.append(np.asarray(tris.va) @ a.T + b)
                eabs.append(np.asarray(tris.e_ab) @ a.T)
                eacs.append(np.asarray(tris.e_ac) @ a.T)
                g = np.arange(tris.count, dtype=np.int64)
                packs.append((np.int64(i) << 20)
                             | (np.int64(tri_first[i]) + g))
            va = np.concatenate(vas).astype(np.float32)
            eab = np.concatenate(eabs).astype(np.float32)
            eac = np.concatenate(eacs).astype(np.float32)
            packed = np.concatenate(packs)
            vb, vc = va + eab, va + eac
            bmin = np.minimum(np.minimum(va, vb), vc)
            bmax = np.maximum(np.maximum(va, vb), vc)
            arrays, order = bvh_mod.build((va + vb + vc) / 3.0, bmin, bmax,
                                          LEAF_SIZE)
            if not budget.fits(budget.tri_tables_bytes(len(arrays[0]),
                                                       va.shape[0])):
                return None
            parts.append(FlatPart(
                bvh_mod.FlatBVH.create(*arrays),
                np.concatenate([va[order], eab[order], eac[order]], axis=1),
                packed[order].astype(np.int32)))
        return parts


# The reference's measured verdicts (on its TPU) left both world-
# flattened routes opt-in: no automatic rule switches them on.
FLAT_AUTO_ON = False
FLAT_MAX_INSTANCES = 32
PARTS_AUTO_ON = False


def wants_flat(tlas: TLAS, auto=True) -> bool:
    """Route this TLAS through its world-flattened single-level BVH?
    ``MRT_TLAS_KERNEL=flat`` forces it, ``auto`` takes the build gate
    alone, any other value disables; unset, the instance-count rule
    applies when ``auto`` (the card's dispatch; the CPU's passes False,
    as the reference's XLA dispatch does)."""
    if tlas is None or tlas.flat_tris is None:
        return False
    kind = os.environ.get("MRT_TLAS_KERNEL", "")
    if kind in ("flat", "auto"):
        return True
    if kind:
        return False
    return auto and FLAT_AUTO_ON and tlas.n_instances < FLAT_MAX_INSTANCES


def wants_flat_parts(tlas: TLAS, auto=True) -> bool:
    """Route this TLAS through its flat parts?  As ``wants_flat``."""
    if tlas is None or tlas.flat_parts is None:
        return False
    kind = os.environ.get("MRT_TLAS_KERNEL", "")
    if kind in ("flat", "auto"):
        return True
    return not kind and auto and PARTS_AUTO_ON


def flat_parts_winners(tlas: TLAS, o, d, t_min, t_max):
    """Closest hit over the flat parts (kernel B6, one launch for all
    parts): (t (N,), +inf on a miss; instance, triangle (N,) int32; u;
    v), as the two-level route gives them.

    Winners fold across the parts: a strictly smaller t wins, so on
    equal t the earlier part keeps the hit (within a part the lower
    triangle).  The winner's packed id gives (instance, triangle).
    Raises ValueError where o, d or the TLAS require grad."""
    refuse_grad("TLAS flat parts (B6)", o, d, tlas)
    t, row, u, v = kernel.tri_bvh_parts_hit(tlas.flat_parts, o, d, t_min,
                                            t_max)
    packed = tlas.flat_packed[row.to(torch.int64)]
    return t, packed >> 20, packed & ((1 << 20) - 1), u, v


def intersect_tlas_flat_parts(tlas: TLAS, o, d, t_min, t_max) -> Hits:
    """Closest hit over the flat parts, as Hits: ``flat_parts_winners``
    turned into the two-level route's Hits by ``expand_winner``."""
    return expand_winner(tlas, o, d,
                         *flat_parts_winners(tlas, o, d, t_min, t_max))


def tlas_winners(tlas: TLAS, o, d, t_min, t_max):
    """Closest hit over all instances (kernel B7): (t (N,), +inf on a
    miss; instance, triangle (N,) int32; u; v).  Raises ValueError where
    o, d or the TLAS require grad."""
    refuse_grad("TLAS (B7)", o, d, tlas)
    return kernel.tlas_hit(tlas, o, d, t_min, t_max)


def intersect_tlas(tlas: TLAS, o, d, t_min, t_max) -> Hits:
    """Closest hit over all instances (kernel B7), as Hits."""
    return expand_winner(tlas, o, d, *tlas_winners(tlas, o, d, t_min,
                                                   t_max))


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
    uv = s["uva"] * w + s["uvb"] * uu + s["uvc"] * vv
    uv = torch.where(s["has_uv"][:, None], uv, 0.0)

    # World normal: forward linear part, then unit length.
    lin = tlas.transform[inst, :3, :3]
    normal_w = dot(lin, normal_l[:, None, :])
    norm = sqrt(dot(normal_w, normal_w))[:, None]
    normal_w = normal_w / clamp(norm, 1e-20)

    t_safe = torch.where(hit, best_t, 0.0)
    point = o + d * t_safe[:, None]  # t is affine-invariant
    ov = tlas.override[inst]
    material = torch.where(ov >= 0, ov, s["material"])
    # The tangent frame takes the same forward linear part, unnormalised.
    tangent = dot(lin, s["tangent"][:, None, :])
    bitangent = dot(lin, s["bitangent"][:, None, :])
    normal_w, front_face = set_face_normal(d, normal_w)
    # World triangle area for the MIS light pdf: the edges through the
    # instance's forward linear part.
    area = 0.5 * length(cross(dot(lin, s["e_ab"][:, None, :]),
                              dot(lin, s["e_ac"][:, None, :])))
    return Hits(t=torch.where(hit, best_t, INF), point=point,
                normal=normal_w, front_face=front_face, uv=uv,
                material=material, hit=hit, tangent=tangent,
                bitangent=bitangent, prim_area=torch.where(hit, area, 0.0))
