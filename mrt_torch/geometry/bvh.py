"""Bounding volume hierarchies: host build and stackless traversal
(mirrors ``mrt.geometry.bvh``).

The build runs on the host in NumPy: a deterministic split down to
LEAF_SIZE primitives a leaf, either at the median along the widest axis
or, with ``split="sah"``, by the binned surface-area heuristic (falling
back to the median where the SAH finds no split).  It is flattened
depth-first with **escape indices** (node i's subtree is skipped by
jumping to escape[i]), so a traversal needs no stack.  Its trees are the
reference's, array for array, for both splits.  (The reference switches
to its C++ builder above 1,024 primitives; that builder reproduces this
Python body bit for bit, and the port builds in Python at every size.)

The card walks a tree in front-to-back order: ``thread_octants`` (the
reference's) threads it once for each of the eight ray-direction
octants, so a walk stays stackless but descends into the nearer child
first.  A tree of fewer than OCTANT_MIN_NODES nodes keeps the escape
order in every octant (``card_order``).  Each FlatBVH keeps that
threading and its nodes in the kernels' packed layout beside the
reference tables (``ops.bvh``).

Traversal: sphere BVHs go through kernel B5 and triangle BVHs through
kernel B6 (``ops.bvh``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch import nn

from ..core.autodiff import refuse_grad
from ..ops import bvh as kernel
from ..ops.bvh import LEAF_SIZE
from ..utils import profiling
from . import spheres as sphere_mod
from . import triangles as tri_mod
from .hit import Hits


class FlatBVH(nn.Module):
    """A flattened BVH: ``nodes`` (M, 8) float32 rows (bmin xyz, 0, bmax
    xyz, 0) and ``meta`` (M, 4) int32 rows (first, count, escape, 0);
    count 0 marks an inner node.  The kernels' tables beside them:
    ``knodes`` (M, 8), the nodes with first and count in the pad slots
    (``ops.bvh.card_nodes``), and ``order`` (8, M, 2) int32, the
    octants' (hit, miss) threading (``card_order``)."""

    # The reference's arrays, in ``create``'s order.
    FIELDS = ("bmin", "bmax", "first", "count", "escape")

    def __init__(self, nodes, meta):
        super().__init__()
        nodes = torch.as_tensor(nodes, dtype=torch.float32)
        meta = torch.as_tensor(meta, dtype=torch.int32)
        self.register_buffer("nodes", nodes)
        self.register_buffer("meta", meta)
        self.register_buffer("order", torch.from_numpy(card_order(
            meta[:, 1].cpu().numpy(), meta[:, 2].cpu().numpy(),
            nodes[:, 0:3].cpu().numpy(), nodes[:, 4:7].cpu().numpy())))
        self.register_buffer("knodes", kernel.card_nodes(
            nodes, meta[:, 0], meta[:, 1]))

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


def thread_octants(count, escape, bmin, bmax):
    """(hitp, missp) (8, M) int32 traversal orders, one per direction
    octant (bit a of o set <=> d[a] < 0); ``mrt.geometry.bvh``'s.

    Children at inner node n are (n+1) and escape[n+1], ordered by
    ascending centroid along the node's longest axis (the build's split
    rule); the near child for an octant is the first one when the
    direction is positive along that axis, else the second.  The DFS
    sentinel after the root is M (matches the escape convention)."""
    count = np.asarray(count)
    escape = np.asarray(escape)
    m = len(count)
    ext = np.asarray(bmax, np.float64) - np.asarray(bmin, np.float64)
    axis = np.argmax(ext, axis=1).astype(np.int32)
    inner = count == 0
    c1 = np.arange(m, dtype=np.int32) + 1
    c2 = np.where(inner, escape[np.minimum(c1, m - 1)], 0).astype(
        np.int32)

    hitp = np.zeros((8, m), np.int32)
    missp = np.zeros((8, m), np.int32)
    for o in range(8):
        neg = np.array([(o >> a) & 1 for a in range(3)], bool)
        swap = neg[axis]                      # (M,)
        first_c = np.where(swap, c2, c1)
        second_c = np.where(swap, c1, c2)
        # Iterative DFS threading: after(n) = next subtree in THIS
        # octant's order.
        stack = [(0, m)]
        while stack:
            n, after = stack.pop()
            if inner[n]:
                hitp[o, n] = first_c[n]
                missp[o, n] = after
                stack.append((int(first_c[n]), int(second_c[n])))
                stack.append((int(second_c[n]), after))
            else:
                hitp[o, n] = after
                missp[o, n] = after
    return hitp, missp


def escape_threads(count, escape):
    """(hitp, missp) (8, M) int32 of the build's escape order, the same
    in every octant: a hit inner node goes on at node + 1, anything else
    at its escape."""
    count, escape = np.asarray(count), np.asarray(escape)
    m = len(count)
    nxt = np.where(count == 0, np.arange(m) + 1, escape)
    return (np.broadcast_to(nxt, (8, m)).astype(np.int32),
            np.broadcast_to(escape, (8, m)).astype(np.int32))


def order_table(hitp, missp):
    """(8, M, 2) int32: each octant's (hit, miss) successor of a node,
    side by side so that one 8-byte load fetches both."""
    return np.ascontiguousarray(np.stack([hitp, missp], axis=-1),
                                dtype=np.int32)


# Trees below this many nodes keep the escape order on the card: the
# octant order culls little in them (playground's 7-node BLAS tests as
# many triangles either way), and lanes of a warp that walk different
# orders reach their leaves apart, so the leaf loops serialise
# (chip_smoke.py's phase 8 counts both orders' work a ray).
OCTANT_MIN_NODES = 32


def card_order(count, escape, bmin, bmax):
    """The (8, M, 2) threading the kernels walk: ``thread_octants`` for
    a tree of OCTANT_MIN_NODES nodes or more, else the escape order."""
    if len(count) < OCTANT_MIN_NODES:
        return order_table(*escape_threads(count, escape))
    return order_table(*thread_octants(count, escape, bmin, bmax))


def thread_segments(count, escape, bmin, bmax, roots, ends):
    """``card_order`` of a table that holds several trees (the TLAS's
    concatenated BLAS): each tree [root, end) threaded alone, its
    indices global and its sentinel ``end``.  Nodes of no listed tree,
    and trees below OCTANT_MIN_NODES, keep the escape order."""
    count, escape = np.asarray(count), np.asarray(escape)
    hitp, missp = escape_threads(count, escape)
    for root, end in sorted(set(zip(np.asarray(roots).tolist(),
                                    np.asarray(ends).tolist()))):
        if end - root < OCTANT_MIN_NODES:
            continue
        h, s = thread_octants(count[root:end], escape[root:end] - root,
                              bmin[root:end], bmax[root:end])
        hitp[:, root:end] = h + root
        missp[:, root:end] = s + root
    return order_table(hitp, missp)


def graft(trees, tri_offsets):
    """One tree over several BVHs: a top tree over their root boxes
    (``build``'s median split, one tree a leaf), each top leaf replaced
    by that tree's nodes, their triangle indices shifted by the tree's
    offset in ``tri_offsets``.  Depth-first like any build, so escapes
    and ``thread_octants`` apply unchanged.  Returns the five arrays of
    ``FlatBVH.create``."""
    arrays = [[np.asarray(getattr(t, k).cpu()) for k in ("bmin", "bmax",
                                                         "first", "count",
                                                         "escape")]
              for t in trees]
    rmin = np.stack([a[0][0] for a in arrays])
    rmax = np.stack([a[1][0] for a in arrays])
    (tmin, tmax, tfirst, tcount, tescape), order = build(
        (rmin.astype(np.float64) + rmax) / 2.0, rmin, rmax, leaf_size=1)
    # New index of each top node, and where its subtree ends.
    start, pos = [], 0
    for i in range(len(tcount)):
        start.append(pos)
        pos += 1 if tcount[i] == 0 else len(arrays[order[tfirst[i]]][3])
    start.append(pos)
    out = [[] for _ in range(5)]
    for i in range(len(tcount)):
        if tcount[i] == 0:
            row = (tmin[i:i + 1], tmax[i:i + 1], [0], [0],
                   [start[tescape[i]]])
        else:
            k = order[tfirst[i]]
            bmin, bmax, first, count, escape = arrays[k]
            row = (bmin, bmax,
                   np.where(count > 0, first + tri_offsets[k], 0), count,
                   escape + start[i])
        for dst, src in zip(out, row):
            dst.append(np.asarray(src))
    return (np.concatenate(out[0]).astype(np.float32),
            np.concatenate(out[1]).astype(np.float32),
            *(np.concatenate(x).astype(np.int32) for x in out[2:]))


def node_rows(bmin, bmax):
    """(M, 8) float32 node rows (bmin xyz, 0, bmax xyz, 0)."""
    nodes = np.zeros((len(bmin), 8), np.float32)
    nodes[:, 0:3] = np.asarray(bmin, np.float32)
    nodes[:, 4:7] = np.asarray(bmax, np.float32)
    return nodes


# Binned-SAH split: bins per axis for the surface-area heuristic (the
# expected traversal cost, sum of child area x child count).
SAH_BINS = 16


def _area(lo, hi):
    """Surface area of AABBs (..., 3); 0 for empty (inf/-inf) boxes."""
    d = hi - lo
    ok = np.all(np.isfinite(d), axis=-1) & np.all(d >= 0.0, axis=-1)
    d = np.where(ok[..., None], d, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def _sah_partition(prim, centroids, bounds_min, bounds_max):
    """Best binned-SAH split of `prim`: a bool left mask, or None where
    the centroids coincide or no split separates anything.  Costs in
    float64; of equal costs the first split (lowest axis, then bin)
    wins."""
    c = centroids[prim]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    best_cost = np.inf
    best = None
    for axis in range(3):
        ext = cmax[axis] - cmin[axis]
        if ext <= 0.0:
            continue
        scale = SAH_BINS * (1.0 - 1e-12) / ext
        b = ((c[:, axis] - cmin[axis]) * scale).astype(np.int64)
        cnt = np.bincount(b, minlength=SAH_BINS).astype(np.float64)
        bin_min = np.full((SAH_BINS, 3), np.inf)
        bin_max = np.full((SAH_BINS, 3), -np.inf)
        np.minimum.at(bin_min, b, bounds_min[prim])
        np.maximum.at(bin_max, b, bounds_max[prim])
        # Prefix (left) and suffix (right) boxes and counts over bins.
        lmin = np.minimum.accumulate(bin_min, axis=0)
        lmax = np.maximum.accumulate(bin_max, axis=0)
        rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
        lcnt = np.cumsum(cnt)
        rcnt = cnt.sum() - lcnt
        # Split k: left bins [0, k], right bins [k + 1, SAH_BINS).
        la = _area(lmin[:-1], lmax[:-1])
        ra = _area(rmin[1:], rmax[1:])
        cost = (np.where(lcnt[:-1] > 0, lcnt[:-1] * la, 0.0)
                + np.where(rcnt[:-1] > 0, rcnt[:-1] * ra, 0.0))
        valid = (lcnt[:-1] > 0) & (rcnt[:-1] > 0)
        if not valid.any():
            continue
        cost = np.where(valid, cost, np.inf)
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost = cost[k]
            best = b <= k
    return best


@profiling.part("BVH build")
def build(centroids, bounds_min, bounds_max, leaf_size=LEAF_SIZE,
          split=None):
    """BVH over primitives, on the host.

    centroids, bounds_min, bounds_max: (T, 3).  split: "median" (None)
    or "sah".  Returns ((bmin, bmax, first, count, escape) as NumPy,
    order), where ``order`` permutes the primitive arrays so that every
    leaf's primitives are contiguous."""
    sah = split == "sah"
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
        mid = None
        if sah:
            mask = _sah_partition(prim, centroids, bounds_min, bounds_max)
            if mask is not None:
                # A stable two-sided partition.
                order[start:end] = np.concatenate([prim[mask], prim[~mask]])
                mid = start + int(mask.sum())
        if mid is None:  # the median split, also where the SAH found none
            axis = int(np.argmax(bmax - bmin))
            key = np.argsort(centroids[prim][:, axis], kind="stable")
            order[start:end] = prim[key]
            mid = start + n // 2
        nodes.append([bmin, bmax, 0, 0, -1])
        build_range(start, mid)
        build_range(mid, end)
        nodes[idx][4] = len(nodes)

    # SAH trees are not count-balanced and may run deep.
    old_limit = sys.getrecursionlimit()
    depth_guess = (20000 if sah
                   else 4 * int(np.log2(max(t, 2)) + 2) * 64)
    sys.setrecursionlimit(max(old_limit, depth_guess))
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


def build_over_triangles(tris, leaf_size=LEAF_SIZE, split=None):
    """BVH over a host (NumPy) Triangles set, split "median" (None) or
    "sah"; returns (FlatBVH, reordered Triangles)."""
    va = np.asarray(tris.va)
    vb = va + np.asarray(tris.e_ab)
    vc = va + np.asarray(tris.e_ac)
    bmin = np.minimum(np.minimum(va, vb), vc)
    bmax = np.maximum(np.maximum(va, vb), vc)
    cent = (va + vb + vc) / 3.0
    arrays, order = build(cent, bmin, bmax, leaf_size, split=split)
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


def sphere_bvh_winners(spheres, bvh: FlatBVH, o, d, t_min, t_max):
    """Closest sphere hit through the sphere BVH (kernel B5): (t (N,),
    +inf on a miss; index (N,) int32).  Raises ValueError where o, d or
    the spheres require grad."""
    refuse_grad("sphere BVH (B5)", o, d, spheres, bvh)
    return kernel.sphere_bvh_hit(
        bvh.nodes, bvh.meta, spheres.krows, o, d, t_min, t_max,
        card=(bvh.knodes, bvh.order))


def intersect_bvh_spheres(spheres, bvh: FlatBVH, o, d, t_min, t_max):
    """Closest sphere hit through the sphere BVH (kernel B5); returns
    Hits.  Raises ValueError where o, d or the spheres require grad."""
    t, index = sphere_bvh_winners(spheres, bvh, o, d, t_min, t_max)
    return sphere_mod.make_hits(spheres, o, d, t, index, t_min)


def intersect_bvh_tris(tris, bvh: FlatBVH, o, d, t_min, t_max):
    """Closest triangle hit through a single-level triangle BVH (kernel
    B6).

    tris: a TriangleTable in BVH order.  t_min, t_max: scalars or (N,).
    Returns (t (N,), +inf on a miss; index (N,) int32; u; v)."""
    return kernel.tri_bvh_hit(bvh.nodes, bvh.meta, tris.rows, o, d, t_min,
                              t_max, card=(bvh.knodes, bvh.order, tris.krows))


def intersect_bvh(tris, bvh: FlatBVH, o, d, t_min, t_max) -> Hits:
    """Closest triangle hit through a single-level BVH (kernel B6), as
    Hits.  Raises ValueError where o, d or the triangles require grad."""
    refuse_grad("triangle BVH (B6)", o, d, tris, bvh)
    t, i, u, v = intersect_bvh_tris(tris, bvh, o, d, t_min, t_max)
    return tri_mod.make_hits(tris, o, d, t, i, u, v)
