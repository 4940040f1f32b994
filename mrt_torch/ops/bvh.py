"""Kernels B5 (sphere-BVH closest hit), B6 (triangle-BVH closest hit)
and B7 (two-level TLAS closest hit), with their plain PyTorch versions.

``sphere_bvh_hit``, ``tri_bvh_hit``, ``tri_bvh_parts_hit`` and
``tlas_hit`` are the wrappers: on CPU tensors they run the plain
versions ``sphere_bvh_plain`` / ``tri_bvh_plain`` /
``tri_bvh_parts_plain`` / ``tlas_plain``; on CUDA tensors they launch
``csrc/bvh.cu`` or raise.  ``tri_bvh_parts_hit`` launches B6 too.

B5 replaces ``mrt/ops/pallas_bvh.py::_kernel`` (wrapper
``intersect_bvh_spheres``).  B6 replaces ``pallas_bvh.py::_tri_kernel``
(wrapper ``traverse_bvh_tris``), which carries the world-flattened TLAS
routes and ``Scene.bvh``; ``tri_bvh_parts_hit`` walks all flat parts of
a TLAS in one launch, where the reference folds one traversal a part.
B7 replaces ``pallas_bvh.py::_tlas_kernel`` and ``_tlas_kernel_ordered``
(wrapper ``intersect_tlas``) and also
``mrt/ops/pallas_stream.py::_build_kernel``, which computes B7's
function for tables past the TPU's 448 KB of SMEM by paging them from
HBM: B7 copies its tables into shared memory where they fit the card's
opt-in limit a block and reads them from global memory past it.

Semantics, shared by kernel and plain version (those of the reference
traversals ``mrt.geometry.bvh.intersect_bvh_spheres`` and
``mrt.geometry.instance.intersect_tlas``, run per ray):
  - stackless walk.  The plain versions by default: a hit inner node
    continues at node + 1, anything else at its escape index.  The
    kernels (and the plain versions given ``order`` / ``ordered``): the
    threading of one direction octant (bit a set <=> d[a] < 0), near
    child first: a hit continues at ``order[oct, node, 0]``, anything
    else at ``order[oct, node, 1]``.  B5 and B6 take the ray's octant;
    B7 its warp's in the TLAS (``warp_octant``) and the ray's in
    instance space inside an instance.  The walk ends at the tree's
    sentinel;
  - the slab test propagates NaN (``torch.minimum``/``maximum``): a ray
    that starts on a slab plane with a zero direction component gets
    0 * inf = NaN there and culls the box, as in the reference; its far
    limit is min(best, t_max) and a box passes on near <= far;
  - spheres: near root before far root in [t_min, min(best, t_max)];
    equal t -> the lower sphere index; a leaf is tested whole at the
    limit of its entry (``sphere_leaf``), which keeps the reference's
    sequential leaf's winner;
  - triangles: Möller–Trumbore with DET_EPS = 1e-6, t in [t_min,
    t_max]; equal t -> the lower triangle index (B6; over flat parts
    the lower global row, which is the reference's fold: strictly
    smaller t wins, equal t keeps the earlier part), the
    lexicographically lower (instance, triangle) (B7).  So the visit
    order does not change the winner, up to the slab test's rounding
    (ROADMAP C15);
  - a zero-length direction is traversed as given, like the reference's
    XLA traversal (the Pallas wrappers substitute (1, 1, 1)).

Table layouts (rows, one per node / primitive; all contiguous):
  nodes (M, 8) f32: bmin xyz, 0, bmax xyz, 0
  meta  (M, 4) i32: first, count (0 = inner), escape, 0
  sph   (S, 4) f32: center xyz, radius
  tnodes (Mt, 8) f32 as nodes; tmeta (Mt, 4) i32: instance (-1 =
  inner), escape, 0, 0; inst (I, 12) f32: inverse transform rows
  R00 R01 R02 R10 R11 R12 R20 R21 R22 t0 t1 t2; imeta (I, 2) i32:
  blas_root, blas_end; bnodes/bmeta as nodes/meta; tris (T, 9) f32:
  va, e_ab, e_ac.
The kernels' packed tables (B5, B6, B7; ``card_nodes``, ``card_tris``):
  knodes (M, 8) f32: bmin xyz, a, bmax xyz, b, with the int32 a, b
  bit-cast: (first, count) in a BVH, (instance or -1, 0) in a TLAS:
  a visit is two independent 16-byte loads;
  order (8, M, 2) i32: each octant's (hit, miss) successor, one 8-byte
  load;
  krows (T, 12) f32: va, 0, e_ab, 0, e_ac, 0: three 16-byte loads.
"""

from __future__ import annotations

import numbers

import torch

from ..math.vec import dot, sqrt
from . import _build

INF = float("inf")
LEAF_SIZE = 32  # primitives per BVH leaf (geometry.bvh.LEAF_SIZE)


def card_nodes(nodes, a, b):
    """(M, 8) float32 kernel node rows: the boxes of ``nodes`` with the
    int32 columns a and b bit-cast into the pad slots 3 and 7."""
    out = torch.as_tensor(nodes, dtype=torch.float32).clone()
    for col, x in ((3, a), (7, b)):
        out[:, col] = torch.as_tensor(x, dtype=torch.int32).contiguous().view(
            torch.float32)
    return out.contiguous()


def card_tris(rows):
    """(T, 12) float32 kernel triangle rows va, 0, e_ab, 0, e_ac, 0 of
    (T, 9) rows va, e_ab, e_ac."""
    rows = torch.as_tensor(rows, dtype=torch.float32)
    out = rows.new_zeros((rows.shape[0], 3, 4))
    out[:, :, :3] = rows.reshape(-1, 3, 3)
    return out.reshape(-1, 12)


def octant(d):
    """(N,) int64 direction octants: bit a set where d[:, a] < 0."""
    neg = (d < 0.0).to(torch.int64)
    return neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)


def warp_octant(d):
    """(N,) int64: the octant of each ray's warp, as kernel B7 walks its
    TLAS: rays group into warps of 32 consecutive indices, and on each
    axis the warp takes the sign of most of its rays (a tie: positive)."""
    n = d.shape[0]
    group = torch.arange(n, device=d.device) // 32
    groups = (n + 31) // 32
    neg = torch.zeros((groups, 3), dtype=torch.int64, device=d.device)
    neg.index_add_(0, group, (d < 0.0).to(torch.int64))
    size = torch.bincount(group, minlength=groups)
    most = (2 * neg > size[:, None]).to(torch.int64)
    return (most[:, 0] | (most[:, 1] << 1) | (most[:, 2] << 2))[group]


def _successors(node, leaf, escape, order, oct_):
    """(after a hit, after a miss) of each lane's node: the escape order
    (``order`` None) or the octants' threading.  A leaf's two are
    equal."""
    if order is None:
        return torch.where(leaf, escape, node + 1), escape
    nxt = order[oct_, node].to(torch.int64)
    return nxt[:, 0], nxt[:, 1]


def slab_hit(bmin, bmax, o, inv_d, t_min, t_max):
    """Batched AABB slab test, (L, 3) boxes and rays, (L,) bounds ->
    (L,) bool.  NaN-propagating, as the reference's."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    near = torch.maximum(
        torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2]), t_min)
    far = torch.minimum(
        torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2]), t_max)
    return near <= far


def _leaf_slots(first, count, n_prims):
    """(L, LEAF_SIZE) primitive indices of leaves and their validity."""
    j = torch.arange(LEAF_SIZE, device=first.device)
    idx = torch.clamp(first[:, None] + j, max=n_prims - 1)
    return idx, j < count[:, None]


def _tally(counts, key, value):
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(value)


def sphere_leaf(sph, first, count, o, d, a, inv_a, t_min, lim):
    """Spheres of one leaf per lane: the lexicographically lowest valid
    (root, index).  Returns (t (L,), +inf if none; index (L,) int64).
    The reference's sequential loop shrinks its limit as it goes; that
    keeps the same lowest pair."""
    si, valid = _leaf_slots(first, count, sph.shape[0])
    c = sph[si]                                          # (L, J, 4)
    oc = o[:, None, :] - c[..., :3]
    half_b = dot(oc, d[:, None, :])
    r = c[..., 3]
    cterm = dot(oc, oc) - r * r
    disc = half_b * half_b - a[:, None] * cterm
    sq = sqrt(torch.where(disc >= 0.0, torch.clamp(disc, min=0.0), 1.0))
    root0 = (-half_b - sq) * inv_a[:, None]
    root1 = (-half_b + sq) * inv_a[:, None]
    ok = valid & (disc >= 0.0)
    lo, hi = t_min[:, None], lim[:, None]
    ok0 = ok & (root0 >= lo) & (root0 <= hi)
    ok1 = ok & (root1 >= lo) & (root1 <= hi)
    root = torch.where(ok0, root0, torch.where(ok1, root1, INF))
    t, j = torch.min(root, dim=1)  # the first of equal minima
    return t, torch.gather(si, 1, j[:, None])[:, 0]


def tri_leaf(tris, first, count, o, d, t_min, t_max):
    """Triangles of one leaf per lane: the lowest valid (t, index) and
    its (u, v).  tris: (T, 9) rows va, e_ab, e_ac.  Returns (t (L,),
    +inf if none; index (L,) int64; u; v)."""
    from ..geometry.triangles import moller_trumbore

    ti, valid = _leaf_slots(first, count, tris.shape[0])
    rows = tris[ti]                                      # (L, J, 9)
    det_ok, u, v, t = moller_trumbore(rows[..., 0:3], rows[..., 3:6],
                                      rows[..., 6:9], o[:, None, :],
                                      d[:, None, :])
    ok = (valid & det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= t_min[:, None]) & (t <= t_max[:, None]))
    t = torch.where(ok, t, INF)
    ct, j = torch.min(t, dim=1)
    pick = lambda x: torch.gather(x, 1, j[:, None])[:, 0]
    return ct, pick(ti), pick(u), pick(v)


def _warp_tally(counts, lane, at_leaf, count, per_warp):
    """One wavefront step's warp counts (warps of 32 consecutive rays):
    "warp_iters" (warps with a live lane), "leaf_lanes" (lanes at a hit
    leaf: the warp leaf step's passes), "leaf_steps" (each warp's longest
    hit leaf: the lane loop's steps)."""
    if counts is None:
        return
    w = lane // 32
    live = torch.bincount(w, minlength=per_warp.shape[0]) > 0
    per_warp += live
    ww = w[at_leaf]
    lanes = torch.bincount(ww, minlength=per_warp.shape[0])
    longest = torch.zeros_like(lanes).scatter_reduce_(
        0, ww, count[at_leaf].to(lanes.dtype), "amax")
    _tally(counts, "warp_iters", live.sum())
    _tally(counts, "leaf_lanes", lanes.sum())
    _tally(counts, "leaf_steps", longest.sum())


def sphere_bvh_plain(nodes, meta, sph, o, d, t_min, t_max, counts=None,
                     order=None):
    """Plain PyTorch version of B5: the reference's wavefront traversal
    with finished rays dropped from the wavefront after each step.

    nodes (M, 8), meta (M, 4), sph (S, 4); o, d (N, 3); t_min, t_max
    (N,).  Returns (t (N,) float32, +inf on a miss; index (N,) int32).
    ``order`` (8, M, 2): walk the octants' threading, as the kernel does,
    instead of the escape order.  ``counts``, if a dict, gains "nodes"
    (node visits), "prims" (leaf sphere tests), "warps" and, summed over
    the warps of 32 consecutive rays, "warp_iters", "leaf_lanes" and
    "leaf_steps" (``_warp_tally``), and "warp_iters_p99" (the 99th
    percentile of a warp's iterations)."""
    n, m = o.shape[0], nodes.shape[0]
    dev = o.device
    out_t = torch.full((n,), INF, device=dev)
    out_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    inv_d = 1.0 / d
    a = dot(d, d)
    inv_a = 1.0 / a
    oct_ = octant(d)
    lane = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_t, best_i = out_t.clone(), torch.zeros((n,), dtype=torch.int64,
                                                device=dev)
    per_warp = torch.zeros(((n + 31) // 32,), dtype=torch.int64, device=dev)
    while lane.numel():
        lim = torch.minimum(best_t, t_max[lane])
        box = nodes[node]
        hit = slab_hit(box[:, 0:3], box[:, 4:7], o[lane], inv_d[lane],
                       t_min[lane], lim)
        row = meta[node].to(torch.int64)
        leaf = row[:, 1] > 0
        test = (hit & leaf).nonzero()[:, 0]
        _tally(counts, "nodes", lane.numel())
        _warp_tally(counts, lane, hit & leaf, row[:, 1], per_warp)
        if test.numel():
            k = lane[test]
            _tally(counts, "prims", row[test, 1].sum())
            ct, ci = sphere_leaf(sph, row[test, 0], row[test, 1], o[k],
                                 d[k], a[k], inv_a[k], t_min[k], lim[test])
            bt, bi = best_t[test], best_i[test]
            better = (ct < bt) | ((ct == bt) & (ci < bi))
            best_t[test] = torch.where(better, ct, bt)
            best_i[test] = torch.where(better, ci, bi)
        on_hit, on_miss = _successors(node, leaf, row[:, 2], order,
                                      oct_[lane])
        node = torch.where(hit, on_hit, on_miss)
        done = node >= m
        if done.any():
            out_t[lane[done]] = best_t[done]
            out_i[lane[done]] = best_i[done].to(torch.int32)
            keep = ~done
            lane, node = lane[keep], node[keep]
            best_t, best_i = best_t[keep], best_i[keep]
    if counts is not None:
        counts["warps"] = per_warp.numel()
        counts["warp_iters_p99"] = (
            float(torch.quantile(per_warp.double(), 0.99))
            if per_warp.numel() else 0.0)
    return out_t, out_i


def tri_bvh_plain(nodes, meta, tris, o, d, t_min, t_max, counts=None,
                  order=None):
    """Plain PyTorch version of B6: the reference's single-level
    wavefront traversal with finished rays dropped from the wavefront
    after each step.

    nodes (M, 8), meta (M, 4), tris (T, 9); o, d (N, 3); t_min, t_max
    (N,).  Returns (t (N,) float32, +inf on a miss; triangle (N,) int32,
    0 on a miss; u, v (N,) float32).  ``counts``, if a dict, gains
    "nodes" (node visits) and "prims" (leaf triangle tests).  ``order``
    (8, M, 2): walk the octants' threading, as the kernel does, instead
    of the escape order."""
    n, m = o.shape[0], nodes.shape[0]
    dev = o.device
    out_t = torch.full((n,), INF, device=dev)
    out_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), device=dev)
    out_v = torch.zeros((n,), device=dev)
    inv_d = 1.0 / d
    oct_ = octant(d)
    lane = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    bt, bi = out_t.clone(), torch.zeros((n,), dtype=torch.int64, device=dev)
    bu, bv = out_u.clone(), out_v.clone()
    while lane.numel():
        box = nodes[node]
        hit = slab_hit(box[:, 0:3], box[:, 4:7], o[lane], inv_d[lane],
                       t_min[lane], torch.minimum(bt, t_max[lane]))
        row = meta[node].to(torch.int64)
        leaf = row[:, 1] > 0
        test = (hit & leaf).nonzero()[:, 0]
        _tally(counts, "nodes", lane.numel())
        if test.numel():
            k = lane[test]
            _tally(counts, "prims", row[test, 1].sum())
            ct, ci, cu, cv = tri_leaf(tris, row[test, 0], row[test, 1], o[k],
                                      d[k], t_min[k], t_max[k])
            better = (ct < bt[test]) | ((ct == bt[test]) & (ci < bi[test]))
            bt[test] = torch.where(better, ct, bt[test])
            bi[test] = torch.where(better, ci, bi[test])
            bu[test] = torch.where(better, cu, bu[test])
            bv[test] = torch.where(better, cv, bv[test])
        on_hit, on_miss = _successors(node, leaf, row[:, 2], order,
                                      oct_[lane])
        node = torch.where(hit, on_hit, on_miss)
        done = node >= m
        if done.any():
            g = lane[done]
            out_t[g], out_i[g] = bt[done], bi[done].to(torch.int32)
            out_u[g], out_v[g] = bu[done], bv[done]
            keep = ~done
            lane, node = lane[keep], node[keep]
            bt, bi, bu, bv = bt[keep], bi[keep], bu[keep], bv[keep]
    return out_t, out_i, out_u, out_v


def tri_bvh_parts_plain(parts, o, d, t_min, t_max, counts=None):
    """Plain PyTorch version of B6 over flat parts: the reference's
    fold (``mrt.geometry.instance.intersect_tlas_flat_parts``), one
    ``tri_bvh_plain`` a part.  A strictly smaller t wins, so on equal t
    the earlier part keeps the hit.

    parts: FlatParts (each with ``bvh`` and ``rows``).  Returns (t,
    global row (N,) int32 into the parts' rows in part order, u, v).
    ``counts`` as ``tri_bvh_plain``'s, summed over the parts."""
    n, dev = o.shape[0], o.device
    best_t = torch.full((n,), INF, device=dev)
    best_row = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    offset = 0
    for part in parts:
        t, i, u, v = tri_bvh_plain(part.bvh.nodes, part.bvh.meta, part.rows,
                                   o, d, t_min, t_max, counts=counts)
        ok = t < best_t
        best_row = torch.where(ok, i.to(torch.int64) + offset, best_row)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)
        best_t = torch.where(ok, t, best_t)
        offset += part.rows.shape[0]
    return best_t, best_row.to(torch.int32), best_u, best_v


def _warp(r, v, translate):
    """Rows r (L, 12) of inverse transforms applied to v (L, 3), in the
    kernel's order ((r0 x + r1 y) + r2 z) + t0."""
    out = [(r[:, 3 * k] * v[:, 0] + r[:, 3 * k + 1] * v[:, 1])
           + r[:, 3 * k + 2] * v[:, 2] for k in range(3)]
    if translate:
        out = [x + r[:, 9 + k] for k, x in enumerate(out)]
    return torch.stack(out, dim=1)


def tlas_plain(tl, o, d, t_min, t_max, counts=None, ordered=False):
    """Plain PyTorch version of B7: the reference's two-level wavefront
    traversal, each ray a state machine (TLAS node, instance, resume
    node, local ray), finished rays dropped after each step.

    tl: an object with the tables tnodes, tmeta, inst, imeta, bnodes,
    bmeta, tris (layouts in the module docstring).  o, d (N, 3); t_min,
    t_max (N,).  Returns (t (N,) f32, +inf on a miss; instance (N,) i32,
    -1 on a miss; triangle (N,) i32; u, v (N,) f32).  ``counts``, if a
    dict, gains "tlas_nodes", "blas_nodes", "enters" and "prims".
    ``ordered``: walk the octants' threading, as the kernel does,
    instead of the escape order: ``tl.t_order`` in the ray's warp's
    octant (``warp_octant``), ``tl.b_order`` in the octant of the ray in
    instance space."""
    n, mt = o.shape[0], tl.tnodes.shape[0]
    dev = o.device
    i64 = dict(dtype=torch.int64, device=dev)
    out_t = torch.full((n,), INF, device=dev)
    out_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), device=dev)
    out_v = torch.zeros((n,), device=dev)
    inv_d = 1.0 / d
    tmeta, imeta = tl.tmeta.to(torch.int64), tl.imeta.to(torch.int64)
    bmeta = tl.bmeta.to(torch.int64)
    t_order = tl.t_order if ordered else None
    b_order = tl.b_order if ordered else None
    w_oct = warp_octant(d)                   # the TLAS walk's octant

    lane = torch.arange(n, device=dev)
    node = torch.zeros((n,), **i64)     # TLAS node, or BLAS node in one
    inst = torch.full((n,), -1, **i64)  # current instance, -1 = in TLAS
    resume = torch.zeros((n,), **i64)   # TLAS node after the BLAS
    ol, dl, il = o.clone(), d.clone(), inv_d.clone()  # local ray
    l_oct = w_oct.clone()                    # the local ray's octant
    bt = out_t.clone()
    b_inst = torch.full((n,), -1, **i64)
    b_tri = torch.zeros((n,), **i64)
    bu, bv = out_u.clone(), out_v.clone()
    while lane.numel():
        lim = torch.minimum(bt, t_max[lane])
        lo, hi = t_min[lane], t_max[lane]
        in_blas = inst >= 0

        # TLAS lanes: slab test; a hit leaf enters its instance.
        tl_k = (~in_blas).nonzero()[:, 0]
        if tl_k.numel():
            tn = node[tl_k]
            box = tl.tnodes[tn]
            g = lane[tl_k]
            hit = slab_hit(box[:, 0:3], box[:, 4:7], o[g], inv_d[g],
                           lo[tl_k], lim[tl_k])
            leaf_inst = tmeta[tn, 0]
            enter = hit & (leaf_inst >= 0)
            # A leaf's successor is the same on a hit or a miss: the
            # walk resumes there after the instance.
            on_hit, after = _successors(tn, leaf_inst >= 0, tmeta[tn, 1],
                                        t_order, w_oct[g])
            node[tl_k] = torch.where(hit, on_hit, after)
            _tally(counts, "tlas_nodes", tl_k.numel())
            e = tl_k[enter]
            if e.numel():
                _tally(counts, "enters", e.numel())
                i = leaf_inst[enter]
                r = tl.inst[i]
                ol[e] = _warp(r, o[lane[e]], translate=True)
                dl[e] = _warp(r, d[lane[e]], translate=False)
                il[e] = 1.0 / dl[e]
                l_oct[e] = octant(dl[e])
                inst[e] = i
                resume[e] = after[enter]
                node[e] = imeta[i, 0]

        # BLAS lanes: slab test, leaf triangles, then next node or exit.
        bl_k = in_blas.nonzero()[:, 0]
        if bl_k.numel():
            bn = node[bl_k]
            box = tl.bnodes[bn]
            hit = slab_hit(box[:, 0:3], box[:, 4:7], ol[bl_k], il[bl_k],
                           lo[bl_k], lim[bl_k])
            row = bmeta[bn]
            leaf = row[:, 1] > 0
            _tally(counts, "blas_nodes", bl_k.numel())
            test = hit & leaf
            k = bl_k[test]
            if k.numel():
                _tally(counts, "prims", row[test, 1].sum())
                ct, ctri, cu, cv = tri_leaf(tl.tris, row[test, 0],
                                            row[test, 1], ol[k], dl[k],
                                            lo[k], hi[k])
                ci = inst[k]
                better = ((ct < bt[k])
                          | ((ct == bt[k])
                             & ((ci < b_inst[k])
                                | ((ci == b_inst[k]) & (ctri < b_tri[k])))))
                bt[k] = torch.where(better, ct, bt[k])
                b_inst[k] = torch.where(better, ci, b_inst[k])
                b_tri[k] = torch.where(better, ctri, b_tri[k])
                bu[k] = torch.where(better, cu, bu[k])
                bv[k] = torch.where(better, cv, bv[k])
            on_hit, on_miss = _successors(bn, leaf, row[:, 2], b_order,
                                          l_oct[bl_k])
            nxt = torch.where(hit, on_hit, on_miss)
            exiting = nxt >= imeta[inst[bl_k], 1]
            node[bl_k] = torch.where(exiting, resume[bl_k], nxt)
            inst[bl_k] = torch.where(exiting, -1, inst[bl_k])

        done = (inst < 0) & (node >= mt)
        if done.any():
            g = lane[done]
            out_t[g] = bt[done]
            out_inst[g] = b_inst[done].to(torch.int32)
            out_tri[g] = b_tri[done].to(torch.int32)
            out_u[g] = bu[done]
            out_v[g] = bv[done]
            keep = ~done
            lane, node, inst, resume = (lane[keep], node[keep], inst[keep],
                                        resume[keep])
            ol, dl, il, l_oct = ol[keep], dl[keep], il[keep], l_oct[keep]
            bt, b_inst, b_tri = bt[keep], b_inst[keep], b_tri[keep]
            bu, bv = bu[keep], bv[keep]
    return out_t, out_inst, out_tri, out_u, out_v


def _lanes(x, n, device):
    """Scalar or (N,) t bound -> contiguous (N,) float32; a Python number
    filled in on the device, with no copy from the host (which would
    synchronise)."""
    if isinstance(x, numbers.Real):
        return torch.full((n,), float(x), dtype=torch.float32, device=device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(n).contiguous() if x.dim() == 0 else x


def bound_arg(x):
    """A t bound as B1's and B5's kernels take it, with no device copy:
    (None, value) for a scalar, (x, 0.0) for an (N,) tensor."""
    if torch.is_tensor(x) and x.dim() == 0:
        x = float(x)
    return (x, 0.0) if torch.is_tensor(x) else (None, float(x))


def _check(fn, device, **tensors):
    """Each entry: name -> (tensor, dtype, shape with -1 for any)."""
    for name, (x, dtype, shape) in tensors.items():
        if x.dim() != len(shape) or any(
                s not in (-1, e) for s, e in zip(shape, x.shape)):
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {x.dtype}, not {dtype}")
        if x.device != device:
            raise ValueError(f"{fn}: {name} is on {x.device}, rays on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def _aligned(fn, **tables):
    """The kernel reads these tables as float4/int4 (int2 for imeta)."""
    for name, (x, align) in tables.items():
        if x.data_ptr() % align:
            raise ValueError(f"{fn}: {name} is not {align}-byte aligned")


def _rays(fn, o, d, t_min, t_max):
    n = o.shape[0]
    t_min, t_max = _lanes(t_min, n, o.device), _lanes(t_max, n, o.device)
    f32 = torch.float32
    _check(fn, o.device, o=(o, f32, (n, 3)), d=(d, f32, (n, 3)),
           t_min=(t_min, f32, (n,)), t_max=(t_max, f32, (n,)))
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {o.device}")
    return n, t_min, t_max


def sphere_bvh_hit(nodes, meta, sph, o, d, t_min, t_max, card=None):
    """Closest sphere hit through a sphere BVH (B5).

    nodes (M, 8), meta (M, 4), sph (S, 4) rows center xyz, radius in BVH
    order.  t_min, t_max: scalars or (N,) tensors.  card: the kernel's
    tables (knodes (M, 8), order (8, M, 2)), needed on the card.  Returns
    (t (N,) float32, +inf on a miss; index (N,) int32, into the
    BVH-ordered spheres).  The CPU walks the reference's escape order,
    the card the octants' threading."""
    n = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("sphere_bvh_hit", o.device, o=(o, f32, (n, 3)),
           d=(d, f32, (n, 3)), nodes=(nodes, f32, (-1, 8)),
           meta=(meta, i32, (nodes.shape[0], 4)), sph=(sph, f32, (-1, 4)),
           **{k: (x, f32, (n,)) for k, x in (("t_min", t_min),
                                             ("t_max", t_max))
              if torch.is_tensor(x) and x.dim() > 0})
    if o.device.type == "cpu":
        return sphere_bvh_plain(nodes, meta, sph, o, d,
                                _lanes(t_min, n, o.device),
                                _lanes(t_max, n, o.device))
    if o.device.type != "cuda":
        raise ValueError(f"sphere_bvh_hit: no kernel for device {o.device}")
    if card is None:
        raise ValueError("sphere_bvh_hit: no kernel tables (knodes, order): "
                         "the card walks the octants' threading")
    m = nodes.shape[0]
    knodes, order = card
    _check("sphere_bvh_hit", o.device, knodes=(knodes, f32, (m, 8)),
           order=(order, i32, (8, m, 2)))
    _aligned("sphere_bvh_hit", knodes=(knodes, 16), order=(order, 8),
             sph=(sph, 16))
    t = torch.empty((n,), dtype=f32, device=o.device)
    index = torch.empty((n,), dtype=i32, device=o.device)
    counter = torch.empty((1,), dtype=i32, device=o.device)
    _build.launch("mrt_sphere_bvh", o.device, knodes, order, m, sph,
                  sph.shape[0], o, d, *bound_arg(t_min), *bound_arg(t_max),
                  n, t, index, counter)
    return t, index


def _tri_card(fn, device, card, m):
    """B6's packed tables (knodes, order, krows), checked."""
    if card is None:
        raise ValueError(f"{fn}: no kernel tables (knodes, order, krows): "
                         "the card walks the octants' threading")
    knodes, order, krows = card
    _check(fn, device, knodes=(knodes, torch.float32, (m, 8)),
           order=(order, torch.int32, (8, m, 2)),
           krows=(krows, torch.float32, (-1, 12)))
    _aligned(fn, knodes=(knodes, 16), order=(order, 8), krows=(krows, 16))
    return knodes, order, krows


def _tri_launch(knodes, order, krows, o, d, t_min, t_max):
    n = o.shape[0]
    f32, dev = torch.float32, o.device
    t = torch.empty((n,), dtype=f32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=f32, device=dev)
    v = torch.empty((n,), dtype=f32, device=dev)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    _build.launch("mrt_tri_bvh", dev, knodes, order, knodes.shape[0], krows,
                  krows.shape[0], o, d, t_min, t_max, n, t, tri, u, v,
                  counter)
    return t, tri, u, v


def tri_bvh_hit(nodes, meta, tris, o, d, t_min, t_max, card=None):
    """Closest triangle hit through a single-level triangle BVH (B6).

    nodes (M, 8), meta (M, 4), tris (T, 9) rows va, e_ab, e_ac in BVH
    order.  t_min, t_max: scalars or (N,) tensors.  card: the kernel's
    tables (knodes (M, 8), order (8, M, 2), krows (T, 12)), needed on
    the card.  Returns (t, triangle, u, v) as ``tri_bvh_plain``."""
    n, t_min, t_max = _rays("tri_bvh_hit", o, d, t_min, t_max)
    f32, i32 = torch.float32, torch.int32
    _check("tri_bvh_hit", o.device, nodes=(nodes, f32, (-1, 8)),
           meta=(meta, i32, (nodes.shape[0], 4)), tris=(tris, f32, (-1, 9)))
    if o.device.type == "cpu":
        return tri_bvh_plain(nodes, meta, tris, o, d, t_min, t_max)
    knodes, order, krows = _tri_card("tri_bvh_hit", o.device, card,
                                     nodes.shape[0])
    if krows.shape[0] != tris.shape[0]:
        raise ValueError(f"tri_bvh_hit: krows has {krows.shape[0]} rows, "
                         f"tris {tris.shape[0]}")
    return _tri_launch(knodes, order, krows, o, d, t_min, t_max)


def tri_bvh_parts_hit(parts, o, d, t_min, t_max):
    """Closest hit over all flat parts of a TLAS in one B6 launch.

    parts: FlatParts, the parts (each with ``bvh`` and ``rows``) and the
    forest the kernel walks (``forest``, a FlatBVH whose leaves index
    the parts' rows in part order; ``krows`` those rows packed).  The
    kernel carries its best t from part to part, so a near hit culls the
    far parts.  Returns (t, global row (N,) int32, u, v) as
    ``tri_bvh_parts_plain``."""
    n, t_min, t_max = _rays("tri_bvh_parts_hit", o, d, t_min, t_max)
    if o.device.type == "cpu":
        return tri_bvh_parts_plain(parts, o, d, t_min, t_max)
    forest = parts.forest
    card = _tri_card("tri_bvh_parts_hit", o.device,
                     (forest.knodes, forest.order, parts.krows),
                     forest.n_nodes)
    return _tri_launch(*card, o, d, t_min, t_max)


# B7's tables, in the order the kernel copies them into shared memory:
# (attribute, dtype, row shape).
TLAS_CARD = (("k_tnodes", torch.float32, (8,)),
             ("t_order", torch.int32, None),
             ("inst", torch.float32, (12,)),
             ("imeta", torch.int32, (2,)),
             ("k_bnodes", torch.float32, (8,)),
             ("b_order", torch.int32, None),
             ("k_tris", torch.float32, (12,)))
_SMEM_OPTIN = {}
# Below this many bytes of tables B7 reads global memory: L1 holds them
# anyway, and a block's copy and the persistent grid cost more than they
# save (cornell's 2,320 B; chip_smoke.py's phase 8 times both regimes).
SHARED_MIN_BYTES = 8192


def tlas_table_bytes(tl):
    """Bytes of B7's tables in shared memory, each table from a 16-byte
    boundary (as the kernel lays them out)."""
    return sum((getattr(tl, k).numel() * 4 + 15) // 16 * 16
               for k, _, _ in TLAS_CARD)


def smem_optin(device):
    """The shared memory a block may opt in to on `device`, in bytes
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    key = torch.device(device).index or 0
    if key not in _SMEM_OPTIN:
        smem = torch.zeros((1,), dtype=torch.int32)
        khz = torch.zeros((1,), dtype=torch.int32)
        _build.launch("mrt_probe_attributes", torch.device("cuda", key),
                      smem, khz)
        _SMEM_OPTIN[key] = int(smem)
    return _SMEM_OPTIN[key]


def tlas_regime(tl):
    """Where B7 reads ``tl``'s tables on the card: "shared" (copied into
    each block's shared memory, persistent warps) from SHARED_MIN_BYTES
    up to the opt-in limit, else "global" (one thread a ray)."""
    size = tlas_table_bytes(tl)
    fits = SHARED_MIN_BYTES <= size <= smem_optin(tl.k_tnodes.device)
    return "shared" if fits else "global"


def tlas_hit(tl, o, d, t_min, t_max):
    """Closest hit over all instances of a TLAS (B7; also B8's
    function at any table size).

    tl: an object with the tables tnodes, tmeta, inst, imeta, bnodes,
    bmeta, tris and the kernel's (``TLAS_CARD``: k_tnodes, t_order,
    k_bnodes, b_order, k_tris).  t_min, t_max: scalars or (N,) tensors.
    The tables' size picks the regime (``tlas_regime``).  Returns (t,
    instance, triangle, u, v) as ``tlas_plain``."""
    n, t_min, t_max = _rays("tlas_hit", o, d, t_min, t_max)
    f32, i32 = torch.float32, torch.int32
    mt, ni, mb = tl.tnodes.shape[0], tl.inst.shape[0], tl.bnodes.shape[0]
    _check("tlas_hit", o.device, tnodes=(tl.tnodes, f32, (-1, 8)),
           tmeta=(tl.tmeta, i32, (mt, 4)), inst=(tl.inst, f32, (-1, 12)),
           imeta=(tl.imeta, i32, (ni, 2)), bnodes=(tl.bnodes, f32, (-1, 8)),
           bmeta=(tl.bmeta, i32, (mb, 4)), tris=(tl.tris, f32, (-1, 9)))
    if o.device.type == "cpu":
        return tlas_plain(tl, o, d, t_min, t_max)
    rows = dict(k_tnodes=mt, t_order=mt, inst=ni, imeta=ni, k_bnodes=mb,
                b_order=mb, k_tris=tl.tris.shape[0])
    tables = {}
    for name, dtype, row in TLAS_CARD:
        x = getattr(tl, name, None)
        if x is None:
            raise ValueError(f"tlas_hit: no kernel table {name}: the card "
                             "walks the octants' threading")
        shape = (8, rows[name], 2) if row is None else (rows[name], *row)
        _check("tlas_hit", o.device, **{name: (x, dtype, shape)})
        tables[name] = x
    # 16-byte loads, and 16-byte cp.async copies into shared memory.
    _aligned("tlas_hit", **{k: (x, 16) for k, x in tables.items()})
    shared = tlas_regime(tl) == "shared"
    t = torch.empty((n,), dtype=f32, device=o.device)
    inst = torch.empty((n,), dtype=i32, device=o.device)
    tri = torch.empty((n,), dtype=i32, device=o.device)
    u = torch.empty((n,), dtype=f32, device=o.device)
    v = torch.empty((n,), dtype=f32, device=o.device)
    counter = torch.empty((1,), dtype=i32, device=o.device)
    _build.launch("mrt_tlas", o.device, *tables.values(), mt, ni, mb,
                  tl.tris.shape[0], o, d, t_min, t_max, n, t, inst, tri, u,
                  v, counter, int(shared))
    return t, inst, tri, u, v
