"""Batched ray-sphere intersection (mirrors ``mrt.geometry.spheres``).

The nearest-hit search is kernel B1 (``mrt_torch.ops.spheres``); this
module expands its (t, index) into a full hit record.  A sphere set
carries the table of the one kernel that walks it, built once with its
scene (``Spheres.build_kernel_table``): B1's groups
(``ops.spheres.group_table``), or B5's rows (center, radius) where a
sphere BVH holds the set.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import spheres as kernel
from .hit import INF, Hits, set_face_normal


class Spheres(nn.Module):
    """center (S, 3) float32, radius (S,) float32, material (S,) int32;
    the walking kernel's table, None until ``build_kernel_table``: B1's
    groups ``g_rows``, ``g_index``, ``g_boxes``, ``g_order`` and
    ``n_big`` (``groups``), or B5's rows ``krows`` (S, 4) center xyz,
    radius."""

    GROUP_TABLE = ("g_rows", "g_index", "g_boxes", "g_order")

    def __init__(self, center, radius, material):
        super().__init__()
        self.register_buffer("center",
                             torch.as_tensor(center, dtype=torch.float32))
        self.register_buffer("radius",
                             torch.as_tensor(radius, dtype=torch.float32))
        self.register_buffer("material",
                             torch.as_tensor(material, dtype=torch.int32))
        for name in (*self.GROUP_TABLE, "krows"):
            self.register_buffer(name, None)
        self.n_big = 0

    def build_kernel_table(self, in_bvh):
        """Build the table of the kernel that walks this set: B5's rows
        where a sphere BVH holds it (`in_bvh`, the set in BVH order), else
        B1's groups.  Returns self."""
        if in_bvh:
            self.krows = torch.cat([self.center, self.radius[:, None]],
                                   dim=1).contiguous()
        else:
            *table, self.n_big = kernel.group_table(self.center, self.radius)
            for name, x in zip(self.GROUP_TABLE, table):
                setattr(self, name, x)
        return self

    @property
    def count(self):
        return self.center.shape[0]

    @property
    def groups(self):
        """B1's tables, as ``ops.spheres.nearest_t`` takes them, or None
        before ``build_kernel_table``."""
        if self.g_rows is None:
            return None
        return (self.g_rows, self.g_index, self.g_boxes, self.g_order,
                self.n_big)


def nearest_t(spheres: Spheres, o, d, t_min, t_max):
    """Nearest valid sphere hit per ray: (t (N,), +inf on a miss;
    index (N,) int32).  t_min, t_max: scalars or (N,)."""
    return kernel.nearest_t(spheres.center, spheres.radius, o, d, t_min,
                            t_max, groups=spheres.groups)


def make_hits(spheres: Spheres, o, d, t, index) -> Hits:
    """Expand (t, index) from nearest_t into a full Hits record."""
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 0.0)
    index = torch.clamp(index.to(torch.int64), 0, spheres.count - 1)
    c = spheres.center[index]
    r = spheres.radius[index]
    point = o + d * t_safe[:, None]
    outward = (point - c) / r[:, None]
    normal, front_face = set_face_normal(d, outward)
    zeros = torch.zeros_like(point)
    return Hits(
        t=torch.where(hit, t, INF),
        point=point,
        normal=normal,
        front_face=front_face,
        uv=zeros[:, :2],
        material=spheres.material[index],
        hit=hit,
        tangent=zeros,
        bitangent=zeros,
        prim_area=torch.where(hit, -r, 0.0),  # < 0: a sphere (MIS pdf)
    )


def intersect(spheres: Spheres, o, d, t_min, t_max) -> Hits:
    t, index = nearest_t(spheres, o, d, t_min, t_max)
    return make_hits(spheres, o, d, t, index)
