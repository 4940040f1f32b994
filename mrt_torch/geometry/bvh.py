"""Bounding volume hierarchies: host build and stackless traversal
(mirrors ``mrt.geometry.bvh``).

The build runs on the host in NumPy: a deterministic widest-axis median
split down to LEAF_SIZE primitives a leaf, flattened depth-first with
**escape indices** (node i's subtree is skipped by jumping to
escape[i]), so a traversal needs no stack.  Its trees are those of the
reference's median build, array for array.  (The reference switches to
its C++ builder above 1,024 primitives; that builder reproduces this
Python body bit for bit.  The SAH split comes with the scenes that use
it.)

Traversal: sphere BVHs go through kernel B5 (``ops.bvh``); triangle
BVHs through the plain ``intersect_bvh_tris`` (their kernel, B6, is not
ported yet: no scene of this slice has a single-level mesh BVH).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch import nn

from ..ops import bvh as kernel
from ..ops.bvh import LEAF_SIZE, slab_hit, tri_leaf
from . import spheres as sphere_mod
from .hit import INF


class FlatBVH(nn.Module):
    """A flattened BVH in the kernel's layout: ``nodes`` (M, 8) float32
    rows (bmin xyz, 0, bmax xyz, 0) and ``meta`` (M, 4) int32 rows
    (first, count, escape, 0); count 0 marks an inner node."""

    def __init__(self, nodes, meta):
        super().__init__()
        self.register_buffer("nodes", torch.as_tensor(nodes,
                                                      dtype=torch.float32))
        self.register_buffer("meta", torch.as_tensor(meta,
                                                     dtype=torch.int32))

    @classmethod
    def create(cls, bmin, bmax, first, count, escape):
        """From the reference's five (M, ...) arrays."""
        meta = np.zeros((len(first), 4), np.int32)
        meta[:, 0] = first
        meta[:, 1] = count
        meta[:, 2] = escape
        return cls(node_rows(bmin, bmax), meta)

    @property
    def n_nodes(self):
        return self.nodes.shape[0]

    bmin = property(lambda self: self.nodes[:, 0:3])
    bmax = property(lambda self: self.nodes[:, 4:7])
    first = property(lambda self: self.meta[:, 0])
    count = property(lambda self: self.meta[:, 1])
    escape = property(lambda self: self.meta[:, 2])


def node_rows(bmin, bmax):
    """(M, 8) float32 node rows (bmin xyz, 0, bmax xyz, 0)."""
    nodes = np.zeros((len(bmin), 8), np.float32)
    nodes[:, 0:3] = np.asarray(bmin, np.float32)
    nodes[:, 4:7] = np.asarray(bmax, np.float32)
    return nodes


def build(centroids, bounds_min, bounds_max, leaf_size=LEAF_SIZE):
    """Median-split BVH over primitives, on the host.

    centroids, bounds_min, bounds_max: (T, 3).  Returns ((bmin, bmax,
    first, count, escape) as NumPy, order), where ``order`` permutes the
    primitive arrays so that every leaf's primitives are contiguous."""
    t = centroids.shape[0]
    centroids = np.asarray(centroids, np.float64)
    bounds_min = np.asarray(bounds_min, np.float64)
    bounds_max = np.asarray(bounds_max, np.float64)
    order = np.arange(t)
    nodes = []  # [bmin, bmax, first, count, escape]

    # Depth-first: a node's left subtree follows it directly, so its
    # escape index is the index after its subtree.
    def build_range(start, end):
        idx = len(nodes)
        prim = order[start:end]
        bmin = bounds_min[prim].min(axis=0)
        bmax = bounds_max[prim].max(axis=0)
        n = end - start
        if n <= leaf_size:
            nodes.append([bmin, bmax, start, n, -1])
            return
        axis = int(np.argmax(bmax - bmin))
        key = np.argsort(centroids[prim][:, axis], kind="stable")
        order[start:end] = prim[key]
        mid = start + n // 2
        nodes.append([bmin, bmax, 0, 0, -1])
        build_range(start, mid)
        build_range(mid, end)
        nodes[idx][4] = len(nodes)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit,
                              4 * int(np.log2(max(t, 2)) + 2) * 64))
    try:
        build_range(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    bmin = np.stack([n[0] for n in nodes]).astype(np.float32)
    bmax = np.stack([n[1] for n in nodes]).astype(np.float32)
    first = np.array([n[2] for n in nodes], np.int32)
    count = np.array([n[3] for n in nodes], np.int32)
    # A leaf escapes to the next node in depth-first order; the last
    # node escapes to M, the end of the walk.
    escape = np.array([n[4] if n[4] >= 0 else i + 1
                       for i, n in enumerate(nodes)], np.int32)
    return (bmin, bmax, first, count, escape), order


def build_over_triangles(tris, leaf_size=LEAF_SIZE):
    """BVH over a host (NumPy) Triangles set; returns (FlatBVH,
    reordered Triangles)."""
    va = np.asarray(tris.va)
    vb = va + np.asarray(tris.e_ab)
    vc = va + np.asarray(tris.e_ac)
    bmin = np.minimum(np.minimum(va, vb), vc)
    bmax = np.maximum(np.maximum(va, vb), vc)
    cent = (va + vb + vc) / 3.0
    arrays, order = build(cent, bmin, bmax, leaf_size)
    return FlatBVH.create(*arrays), tris.map(lambda x: np.asarray(x)[order])


def build_over_spheres(spheres, leaf_size=LEAF_SIZE):
    """BVH over a Spheres set; returns (FlatBVH, reordered Spheres)."""
    c = spheres.center.cpu().numpy()
    r = spheres.radius.cpu().numpy()[:, None]
    arrays, order = build(c, c - r, c + r, leaf_size)
    perm = torch.as_tensor(order, device=spheres.center.device)
    reordered = sphere_mod.Spheres(spheres.center[perm],
                                   spheres.radius[perm],
                                   spheres.material[perm])
    return FlatBVH.create(*arrays).to(spheres.center.device), reordered


def intersect_bvh_spheres(spheres, bvh: FlatBVH, o, d, t_min, t_max):
    """Closest sphere hit through the sphere BVH (kernel B5); returns
    Hits."""
    t, index = kernel.sphere_bvh_hit(
        bvh.nodes, bvh.meta, kernel_spheres(spheres), o, d, t_min, t_max)
    return sphere_mod.make_hits(spheres, o, d, t, index)


def kernel_spheres(spheres):
    """(S, 4) float32 rows (center xyz, radius) for kernel B5."""
    return torch.cat([spheres.center, spheres.radius[:, None]],
                     dim=1).contiguous()


def intersect_bvh_tris(tris, bvh: FlatBVH, o, d, t_min, t_max):
    """Closest triangle hit through a single-level triangle BVH: the
    plain stackless traversal (B6's kernel is not ported yet).

    tris: torch Triangles in BVH order.  t_min, t_max: scalars or (N,).
    Returns (t (N,), +inf on a miss; index (N,) int32; u; v)."""
    n = o.shape[0]
    dev = o.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32,
                            device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=dev).expand(n)
    table = torch.cat([tris.va, tris.e_ab, tris.e_ac], dim=1)
    m = bvh.n_nodes
    inv_d = 1.0 / d
    best_t = torch.full((n,), INF, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    meta = bvh.meta.to(torch.int64)
    while True:
        lane = (node < m).nonzero()[:, 0]
        if not lane.numel():
            break
        ni = node[lane]
        box = bvh.nodes[ni]
        hit = slab_hit(box[:, 0:3], box[:, 4:7], o[lane], inv_d[lane],
                       t_min[lane], torch.minimum(best_t[lane], t_max[lane]))
        row = meta[ni]
        leaf = row[:, 1] > 0
        test = hit & leaf
        k = lane[test]
        if k.numel():
            ct, ci, cu, cv = tri_leaf(table, row[test, 0], row[test, 1],
                                      o[k], d[k], t_min[k], t_max[k])
            bt, bi = best_t[k], best_i[k]
            better = (ct < bt) | ((ct == bt) & (ci < bi))
            best_t[k] = torch.where(better, ct, bt)
            best_i[k] = torch.where(better, ci, bi)
            best_u[k] = torch.where(better, cu, best_u[k])
            best_v[k] = torch.where(better, cv, best_v[k])
        node[lane] = torch.where(hit & ~leaf, ni + 1, row[:, 2])
    return best_t, best_i.to(torch.int32), best_u, best_v
