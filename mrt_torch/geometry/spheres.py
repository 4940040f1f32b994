"""Batched ray-sphere intersection (mirrors ``mrt.geometry.spheres``).

The nearest-hit search is kernel B1 (``mrt_torch.ops.spheres``); this
module expands its (t, index) into a full hit record.  A sphere set
carries the table of the one kernel that walks it, built once with its
scene (``Spheres.build_kernel_table``): B1's groups
(``ops.spheres.group_table``), or B5's rows (center, radius) where a
sphere BVH holds the set.  The tables hold detached values.

Gradients: the search runs without an autograd graph (B1 on the card,
its plain version on the CPU), so ``make_hits`` recomputes the winning
root under autograd from the winner's centre and radius and the ray
(``winner_t``): the value stays the search's t, the derivative is the
reference scan's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.autodiff import Replace, needs_grad
from ..math.vec import dot, sqrt
from ..ops import spheres as kernel
from .hit import INF, Hits, set_face_normal


class Spheres(Replace, nn.Module):
    """center (S, 3) float32, radius (S,) float32, material (S,) int32;
    the walking kernel's table, None until ``build_kernel_table``: B1's
    groups ``g_rows``, ``g_index``, ``g_boxes``, ``g_order`` and
    ``n_big`` (``groups``), or B5's rows ``krows`` (S, 4) center xyz,
    radius.  ``replace(center=...)`` rebuilds the table the set had
    (on the host, for B1's groups)."""

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
                                   dim=1).detach().contiguous()
        else:
            *table, self.n_big = kernel.group_table(self.center, self.radius)
            for name, x in zip(self.GROUP_TABLE, table):
                setattr(self, name, x)
        return self

    def replace(self, **fields):
        new = super().replace(**fields)
        if {"center", "radius"} & fields.keys():
            in_bvh = self.krows is not None
            built = in_bvh or self.g_rows is not None
            for name in (*self.GROUP_TABLE, "krows"):
                setattr(new, name, None)
            new.n_big = 0
            if built:
                new.build_kernel_table(in_bvh)
        return new

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


def winner_root(c, r, o, d, hit, t_min):
    """The winning root recomputed under autograd from the winners'
    centres c (N, 3) and radii r (N,), o and d (N, 3), in the reference
    scan's expression, op for op (``mrt.geometry.spheres``: the
    where-before-sqrt guard, root0 where it is at or past t_min, else
    root1); 0 where `hit` is False.  On hit lanes it equals the search's
    t bit for bit.

    The guard also takes disc == 0 (a tangent) out of the sqrt, whose
    derivative is infinite there: the reference's 0 * inf (a NaN that
    reaches the centre's gradient from any such lane, live or dead)
    becomes no derivative through sqrt(disc) (ROADMAP C18)."""
    od, oo, a = dot(o, d), dot(o, o), dot(d, d)
    cc_rr = dot(c, c) - r * r
    half_b = od - dot(c, d)
    c_term = (oo - 2.0 * dot(c, o)) + cc_rr
    disc = half_b * half_b - a * c_term
    # Miss lanes (they test sphere 0) and tangents: guarded.
    ok = hit & (disc > 0.0) & (r != 0.0)
    sq = torch.where(ok, sqrt(torch.where(ok, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    root0 = (-half_b - sq) * inv_a
    root1 = (-half_b + sq) * inv_a
    return torch.where(hit, torch.where(root0 >= t_min, root0, root1), 0.0)


def winner_t(c, r, o, d, t, t_min):
    """The winners' t (N,) with a derivative: its value is `t`, the
    search's, its derivative that of ``winner_root``.  Misses keep +inf
    and get no derivative.  Without a graph to record (nothing requires
    grad) returns `t` itself."""
    if not needs_grad(o, d, c, r):
        return t
    t_r = winner_root(c, r, o, d, torch.isfinite(t), t_min)
    return t + (t_r - t_r.detach())


def make_hits(spheres: Spheres, o, d, t, index, t_min) -> Hits:
    """Expand (t, index) from a nearest-hit search with lower bound
    `t_min` (a scalar or (N,)) into a full Hits record."""
    hit = torch.isfinite(t)
    index = torch.clamp(index.to(torch.int64), 0, spheres.count - 1)
    # index_select: its backward adds with index_add_ (indexing's sorts).
    c = spheres.center.index_select(0, index)
    r = spheres.radius.index_select(0, index)
    t = winner_t(c, r, o, d, t, t_min)
    t_safe = torch.where(hit, t, 0.0)
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
    return make_hits(spheres, o, d, t, index, t_min)
