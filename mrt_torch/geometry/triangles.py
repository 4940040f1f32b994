"""Triangle sets and Möller–Trumbore (mirrors ``mrt.geometry.triangles``).

Triangles are built on the host as NumPy SoA arrays (``build``,
``from_soup``); a ``TriangleTable`` (or the TLAS) moves them to the
device once.  Semantics of the reference:
  - det epsilon 1e-6 rejects parallel rays;
  - barycentric smooth normal, NOT renormalised, except on sets marked
    ``unit_normal`` (world-flattened instances, whose normals carry the
    instance's linear part: the instanced path normalises after it);
  - tangent/bitangent from UV deltas at build, r clamped to [-1, 1];
  - flat normal fallback = unit(ab x ac).

``nearest_hit`` is the brute-force scan (``SceneBuilder.add_triangles``);
BVHs go through kernel B6 (``geometry.bvh.intersect_bvh``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..math.vec import clamp, cross, dot, length, sqrt
from ..ops.bvh import card_tris
from .hit import INF, Hits, set_face_normal

DET_EPS = 1e-6
# Triangles a step of the brute scan: the (N, CHUNK) temporaries bound
# its memory.
CHUNK = 64

FIELDS = ("va", "e_ab", "e_ac", "na", "nb", "nc", "uva", "uvb", "uvc",
          "tangent", "bitangent", "material", "has_uv")


@dataclasses.dataclass
class Triangles:
    va: object         # (T,3) vertex a
    e_ab: object       # (T,3) vertex_b - vertex_a
    e_ac: object       # (T,3) vertex_c - vertex_a
    na: object         # (T,3) vertex normals (flat normal if none)
    nb: object
    nc: object
    uva: object        # (T,2)
    uvb: object
    uvc: object
    tangent: object    # (T,3)
    bitangent: object  # (T,3)
    material: object   # (T,) int32
    has_uv: object     # (T,) bool
    # Normalise the interpolated smooth normal at hit time.
    unit_normal: bool = False

    @property
    def count(self):
        return self.va.shape[0]

    def map(self, fn):
        """A copy with fn applied to every array field."""
        return dataclasses.replace(
            self, **{k: fn(getattr(self, k)) for k in FIELDS})

    def to_torch(self, device=None):
        """Tensors of every field; a field that is a tensor already is
        kept as it is (with its autograd graph)."""
        return self.map(lambda x: x if torch.is_tensor(x) else
                        torch.as_tensor(np.asarray(x), device=device))

    @classmethod
    def build(cls, vertices, faces, normals=None, uvs=None, material=0):
        """From indexed mesh data: vertices (V,3), faces (T,3) vertex
        indices, optional per-vertex normals (V,3) and uvs (V,2),
        material a scalar or (T,) rows."""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        corners = lambda x: tuple(np.asarray(x, np.float32)[faces[:, k]]
                                  for k in range(3))
        return cls.from_soup(
            *corners(vertices),
            normals=None if normals is None else corners(normals),
            uvs=None if uvs is None else corners(uvs),
            material=material)

    @classmethod
    def from_soup(cls, va, vb, vc, normals=None, uvs=None, material=0):
        """From a triangle soup; normals/uvs: optional (na, nb, nc) /
        (uva, uvb, uvc) tuples of per-corner arrays."""
        va = np.asarray(va, np.float32)
        vb = np.asarray(vb, np.float32)
        vc = np.asarray(vc, np.float32)
        t = va.shape[0]
        ab = vb - va
        ac = vc - va

        flat = np.cross(ab, ac)
        norm = np.linalg.norm(flat, axis=-1, keepdims=True)
        flat = flat / np.maximum(norm, 1e-20)

        if normals is None:
            na = nb = nc = flat
        else:
            na, nb, nc = (np.asarray(x, np.float32) for x in normals)

        if uvs is None:
            uva = uvb = uvc = np.zeros((t, 2), np.float32)
            has_uv = np.zeros((t,), bool)
            tangent = np.zeros((t, 3), np.float32)
            bitangent = np.zeros((t, 3), np.float32)
        else:
            uva, uvb, uvc = (np.asarray(x, np.float32) for x in uvs)
            has_uv = np.ones((t,), bool)
            uv_ab = uvb - uva
            uv_ac = uvc - uva
            denom = (uv_ab[:, 0] * uv_ac[:, 1]
                     - uv_ab[:, 1] * uv_ac[:, 0])
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.clip(1.0 / denom, -1.0, 1.0)
            r = np.nan_to_num(r, nan=1.0, posinf=1.0, neginf=-1.0)
            tangent = (ab * uv_ac[:, 1:2] - ac * uv_ab[:, 1:2]) * r[:, None]
            bitangent = (ac * uv_ab[:, 0:1] - ab * uv_ac[:, 0:1]) * r[:, None]

        material = np.ascontiguousarray(
            np.broadcast_to(np.asarray(material, np.int32), (t,)))
        return cls(va=va, e_ab=ab, e_ac=ac, na=na, nb=nb, nc=nc,
                   uva=uva, uvb=uvb, uvc=uvc, tangent=tangent,
                   bitangent=bitangent, material=material, has_uv=has_uv)


def concatenate(tris_list):
    """Host concatenation of NumPy Triangles sets."""
    return dataclasses.replace(tris_list[0], **{
        k: np.concatenate([np.asarray(getattr(t, k)) for t in tris_list])
        for k in FIELDS})


class TriangleTable(nn.Module):
    """A triangle set as device tables: ``rows`` (T, 9) float32 va,
    e_ab, e_ac, ``krows`` (T, 12) the same packed for kernel B6
    (``ops.bvh.card_tris``, detached) and ``shading`` (T, 29) its
    ``shading_table``; ``unit_normal`` as on Triangles.  Built from a
    Triangles of tensors that require grad, ``rows`` and ``shading``
    carry their graph, so the brute-force scan is differentiable."""

    def __init__(self, tris: Triangles):
        super().__init__()
        t = tris.to_torch()
        self.register_buffer(
            "rows", torch.cat([t.va, t.e_ab, t.e_ac], dim=1).contiguous())
        self.register_buffer("krows", card_tris(self.rows.detach()))
        self.register_buffer("shading", shading_table(t).contiguous())
        self.unit_normal = bool(tris.unit_normal)

    @property
    def count(self):
        return self.rows.shape[0]


def moller_trumbore(va, ab, ac, o, d):
    """Möller–Trumbore in the reference traversal's operation order.

    All arguments broadcast over (..., 3).  Returns (det_ok, u, v, t);
    u, v, t are finite garbage where det_ok is False."""
    p = cross(d, ac)
    det = dot(ab, p)
    det_ok = torch.abs(det) >= DET_EPS
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tv = o - va
    u = dot(tv, p) * inv_det
    q = cross(tv, ab)
    v = dot(d, q) * inv_det
    t = dot(ac, q) * inv_det
    return det_ok, u, v, t


def shading_table(tris: Triangles):
    """Per-triangle shading data as one (T, 29) float32 table: na nb nc
    (9), uva uvb uvc (6), has_uv (1), material (1), tangent bitangent
    (6), e_ab e_ac (6).  A winner's row is one direct index."""
    return torch.cat(
        [tris.na, tris.nb, tris.nc, tris.uva, tris.uvb, tris.uvc,
         tris.has_uv.to(torch.float32)[:, None],
         tris.material.to(torch.float32)[:, None],
         tris.tangent, tris.bitangent, tris.e_ab, tris.e_ac], dim=-1)


def unpack_shading(row):
    """Split (N, 29) shading_table rows into named parts."""
    return dict(
        na=row[:, 0:3], nb=row[:, 3:6], nc=row[:, 6:9],
        uva=row[:, 9:11], uvb=row[:, 11:13], uvc=row[:, 13:15],
        has_uv=row[:, 15] > 0.5,
        material=torch.round(row[:, 16]).to(torch.int32),
        tangent=row[:, 17:20], bitangent=row[:, 20:23],
        e_ab=row[:, 23:26], e_ac=row[:, 26:29])


def nearest_hit(tris: TriangleTable, o, d, t_min, t_max):
    """Closest valid triangle per ray by brute force: the reference's
    chunked scan, a strictly closer chunk winning, the lowest index
    within a chunk.

    t_min, t_max: scalars or (N,).  Returns (t (N,), +inf on a miss;
    index (N,) int32; u; v)."""
    rows = tris.rows
    n, count, dev = o.shape[0], rows.shape[0], o.device
    lane = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                     device=dev).expand(n)[:, None]
    t_min, t_max = lane(t_min), lane(t_max)
    best_t = torch.full((n,), INF, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    chunk = min(CHUNK, max(8, count))
    for b0 in range(0, count, chunk):
        c = rows[None, b0:b0 + chunk]                       # (1, C, 9)
        det_ok, u, v, t = moller_trumbore(c[..., 0:3], c[..., 3:6],
                                          c[..., 6:9], o[:, None, :],
                                          d[:, None, :])
        lim = torch.minimum(best_t[:, None], t_max)
        ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t >= t_min) & (t <= lim))
        ct, sel = torch.min(torch.where(ok, t, INF), dim=1)
        pick = lambda x: torch.gather(x, 1, sel[:, None])[:, 0]
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, sel + b0, best_i)
        best_u = torch.where(better, pick(u), best_u)
        best_v = torch.where(better, pick(v), best_v)
    return best_t, best_i.to(torch.int32), best_u, best_v


def intersect_brute(tris: TriangleTable, o, d, t_min, t_max) -> Hits:
    """Closest hit over a TriangleTable by brute force, as Hits."""
    return make_hits(tris, o, d, *nearest_hit(tris, o, d, t_min, t_max))


def make_hits(tris: TriangleTable, o, d, t, index, u, v) -> Hits:
    """Expand winners (t, index, u, v) of a TriangleTable into Hits.

    Smooth normal and UV with barycentric weights (1-u-v, u, v), the
    normal normalised only on ``unit_normal`` sets; UV zero on triangles
    without UVs; the tangent frame as stored."""
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 0.0)
    point = o + d * t_safe[:, None]
    w = (1.0 - u - v)[:, None]
    uu, vv = u[:, None], v[:, None]
    # index_select: its backward adds with index_add_ (indexing's sorts).
    s = unpack_shading(tris.shading.index_select(0, index.to(torch.int64)))
    normal = s["na"] * w + s["nb"] * uu + s["nc"] * vv
    uv = s["uva"] * w + s["uvb"] * uu + s["uvc"] * vv
    uv = torch.where(s["has_uv"][:, None], uv, 0.0)
    if tris.unit_normal:
        # The instanced path's normalisation (instance.expand_winner):
        # the linear part is baked into the vertex normals, so
        # normalise(interpolated) here equals normalise(lin @ interpolated).
        norm = sqrt(dot(normal, normal))[:, None]
        normal = normal / clamp(norm, 1e-20)
    normal, front_face = set_face_normal(d, normal)
    area = 0.5 * length(cross(s["e_ab"], s["e_ac"]))
    return Hits(t=torch.where(hit, t, INF), point=point, normal=normal,
                front_face=front_face, uv=uv, material=s["material"],
                hit=hit, tangent=s["tangent"], bitangent=s["bitangent"],
                prim_area=torch.where(hit, area, 0.0))
