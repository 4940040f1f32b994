"""Batched ray-sphere intersection (mirrors ``mrt.geometry.spheres``).

The nearest-hit search is kernel B1 (``mrt_torch.ops.spheres``); this
module expands its (t, index) into a full hit record.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import spheres as kernel
from .hit import INF, Hits, set_face_normal


class Spheres(nn.Module):
    """center (S, 3) float32, radius (S,) float32, material (S,) int32."""

    def __init__(self, center, radius, material):
        super().__init__()
        self.register_buffer("center",
                             torch.as_tensor(center, dtype=torch.float32))
        self.register_buffer("radius",
                             torch.as_tensor(radius, dtype=torch.float32))
        self.register_buffer("material",
                             torch.as_tensor(material, dtype=torch.int32))

    @property
    def count(self):
        return self.center.shape[0]


def nearest_t(spheres: Spheres, o, d, t_min, t_max):
    """Nearest valid sphere hit per ray: (t (N,), +inf on a miss;
    index (N,) int32).  t_min, t_max: scalars or (N,)."""
    return kernel.nearest_t(spheres.center, spheres.radius, o, d, t_min,
                            t_max)


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
