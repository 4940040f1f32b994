"""Kernel B1: nearest ray-sphere hit over all spheres of a set.

``nearest_t`` is the wrapper: on CPU tensors it runs the plain PyTorch
version ``nearest_t_plain``; on CUDA tensors it launches the CUDA kernel
``csrc/spheres.cu`` (which replaces the TPU kernels of
``mrt/ops/pallas_spheres.py``) or raises.

Semantics, shared by every version (those of the reference scan
``mrt.geometry.spheres.nearest_t``): for each ray the smallest root in
[t_min, t_max] over all spheres, the near root before the far one;
+inf and index 0 on a miss; the lowest index on ties; radius-0 spheres
never hit; a zero direction misses.

The kernel walks its spheres in two levels (``group_table``, built once
with the scene): the spheres sorted into spatial groups of at most
``GROUP`` (a warp's width), each with a box, and the spheres too large
to group, which every ray tests.  A warp visits the groups front to back
in its majority octant and skips a group when no lane's segment
[t_min, min(best, t_max)] enters its box.  The box test is conservative
(``PAD``, ``SLACK``): it never skips a sphere whose computed root the
brute force would take, so the winners are the brute force's, bit for
bit.  ``nearest_t_grouped_plain`` is that walk in PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.vec import dot, sqrt
from ..utils import profiling
from . import _build
from .bvh import _lanes, _tally, bound_arg, warp_octant

INF = float("inf")
# Spheres per step of the plain version's scan: bounds its (CHUNK, N)
# temporaries.
CHUNK = 128
# Spheres a group: one warp's width.
GROUP = 32
# A sphere this many times the median radius or wider is not grouped:
# every ray tests it (RTIOW's radius-1000 ground).  A table of at most
# GROUP spheres is one group.
BIG = 16.0
# Group boxes grow by PAD * (|o| + reach) on every side, reach the
# largest |c| + r of the group.  The expanded root form rounds its
# discriminant by up to ~32 ulp of a (|o| + |c| + r)^2, which can put a
# computed root's point o + t d up to sqrt(32 * 2^-24) (|o| + |c| + r)
# = 1.4e-3 (|o| + |c| + r) outside its sphere (at grazing incidence);
# PAD is about three times that.
PAD = 4e-3
# The box test widens its entry and exit t by this relative amount
# against the slab arithmetic's own rounding.
SLACK = 1e-5
# Tables up to this many bytes (``table_bytes``) are copied into each
# block's shared memory (the most a block may take without opting in);
# larger ones are read from global memory.
SHARED_MAX_BYTES = 48 * 1024


def sphere_table(center, radius):
    """(S, 4) float32 rows (cx, cy, cz, |c|^2 - r^2) for the kernel;
    radius-0 rows get +inf in the last column, so they never hit."""
    ccrr = dot(center, center) - radius * radius
    ccrr = torch.where(radius != 0.0, ccrr, INF)
    return torch.cat([center, ccrr[:, None]], dim=1).contiguous()


def _spread(x):
    """Bits 0-9 of x moved to bits 0, 3, 6, ..., 27."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


@profiling.part("B1 group build")
def group_table(center, radius):
    """B1's kernel tables for spheres center (S, 3), radius (S,), built
    on the host, returned on center's device:

    rows  (S, 4) float32: ``sphere_table``'s rows, the ungrouped spheres
          first, then each group's, every run in ascending scene index;
    index (S,) int32: each row's scene index (the tie rule's);
    boxes (G, 8) float32: a group's bmin xyz, reach (the largest
          |c| + |r| of its spheres), bmax xyz, 0; group g holds rows
          [n_big + GROUP g, min(n_big + GROUP (g + 1), S));
    order (8, G) int32: the groups front to back in each direction
          octant (bit a set <=> d[a] < 0): by their box centres
          projected on the octant's diagonal;
    n_big: the ungrouped spheres' count.
    Groups are runs of GROUP spheres in the Morton order of their
    centres."""
    dev = center.device
    c32 = profiling.to_host(center.detach().float(), "B1 group build")
    r32 = profiling.to_host(radius.detach().float(), "B1 group build")
    table = sphere_table(c32, r32).numpy()
    c = c32.numpy().astype(np.float64)
    r = np.abs(r32.numpy().astype(np.float64))
    s = len(r)
    positive = r[r > 0.0]
    big = np.zeros(s, bool)
    if s > GROUP and positive.size:
        big = r >= BIG * np.median(positive)
    rest = np.nonzero(~big)[0]
    if rest.size:
        p = c[rest]
        lo = p.min(axis=0)
        ext = np.maximum(p.max(axis=0) - lo, 1e-30)
        q = np.clip((p - lo) / ext * 1023.0, 0, 1023).astype(np.int64)
        code = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (
            _spread(q[:, 2]) << 2)
        rest = rest[np.lexsort((rest, code))]
    groups = [np.sort(rest[i:i + GROUP]) for i in range(0, rest.size, GROUP)]
    perm = np.concatenate([np.nonzero(big)[0]] + groups).astype(np.int64)
    boxes = np.zeros((len(groups), 8), np.float32)
    for g, members in enumerate(groups):
        cg, rg = c[members], r[members][:, None]
        boxes[g, 0:3] = (cg - rg).min(axis=0)
        boxes[g, 4:7] = (cg + rg).max(axis=0)
        boxes[g, 3] = (np.sqrt((cg * cg).sum(axis=1)) + rg[:, 0]).max()
    mid = (boxes[:, 0:3].astype(np.float64) + boxes[:, 4:7]) / 2.0
    order = np.zeros((8, len(groups)), np.int32)
    for o in range(8):
        sign = np.array([-1.0 if (o >> a) & 1 else 1.0 for a in range(3)])
        order[o] = np.argsort(mid @ sign, kind="stable")

    def as_t(x):
        # On the card, from pinned memory without a wait: a copy from
        # pageable memory would synchronise the host with the card.
        x = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type != "cuda":
            return x
        return x.pin_memory().to(dev, non_blocking=True)

    return (as_t(table[perm]), as_t(perm.astype(np.int32)), as_t(boxes),
            as_t(order), int(big.sum()))


def nearest_t_plain(center, radius, o, d, t_min, t_max, chunk=CHUNK):
    """Plain PyTorch version: the reference's chunked scan, with its
    expanded-form arithmetic in the same operation order.

    center (S, 3), radius (S,), o and d (N, 3), t_min and t_max (N,).
    Returns (t (N,) float32, index (N,) int32).
    """
    n, s = o.shape[0], center.shape[0]
    chunk = min(chunk, max(8, s))
    s_pad = -(-s // chunk) * chunk
    centers = torch.zeros((s_pad, 3), dtype=torch.float32, device=o.device)
    centers[:s] = center
    radii = torch.zeros((s_pad,), dtype=torch.float32, device=o.device)
    radii[:s] = radius

    od = dot(o, d)
    oo = dot(o, o)
    a = dot(d, d)
    inv_a = 1.0 / a[None, :]
    best_t = torch.full((n,), INF, device=o.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for b0 in range(0, s_pad, chunk):
        c = centers[b0:b0 + chunk]
        r = radii[b0:b0 + chunk]
        cc_rr = dot(c, c) - r * r
        cd = (c[:, 0:1] * d[None, :, 0] + c[:, 1:2] * d[None, :, 1]
              + c[:, 2:3] * d[None, :, 2])
        co = (c[:, 0:1] * o[None, :, 0] + c[:, 1:2] * o[None, :, 1]
              + c[:, 2:3] * o[None, :, 2])
        half_b = od[None, :] - cd
        c_term = (oo[None, :] - 2.0 * co) + cc_rr[:, None]
        disc = half_b * half_b - a[None, :] * c_term
        ok = (disc >= 0.0) & (r != 0.0)[:, None]
        sq = sqrt(torch.where(ok, torch.clamp(disc, min=0.0), 1.0))
        root0 = (-half_b - sq) * inv_a
        root1 = (-half_b + sq) * inv_a
        lim = torch.minimum(best_t, t_max)[None, :]
        ok0 = ok & (root0 >= t_min[None, :]) & (root0 <= lim)
        ok1 = ok & (root1 >= t_min[None, :]) & (root1 <= lim)
        root = torch.where(ok0, root0, torch.where(ok1, root1, INF))
        ct, ci = torch.min(root, dim=0)  # first index among equal minima
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, ci + b0, best_i)
    return best_t, best_i.to(torch.int32)


def nearest_t_grouped_plain(groups, o, d, t_min, t_max, counts=None):
    """Plain PyTorch model of the kernel's two-level walk, with its
    arithmetic: the ungrouped rows, then each warp of 32 consecutive
    rays visits the groups in its octant's order (``warp_octant``) and
    tests a group's rows on all its lanes when any lane's segment enters
    the padded box.  Equal to ``nearest_t_plain`` on every ray.

    groups: ``group_table``'s (rows, index, boxes, order, n_big); o, d
    (N, 3); t_min, t_max (N,).  Returns (t (N,) float32, index (N,)
    int32).  ``counts``, if a dict, gains "pairs" (the sphere tests each
    ray needs: the ungrouped rows, and a group's rows where the ray's own
    segment enters its padded box), "warp_pairs" (the sphere tests the
    warps run: a group's rows on every lane of a warp that enters it),
    "boxes" (group box tests, a lane) and "entered" (groups a warp
    tested)."""
    rows, index, boxes, order, n_big = groups
    n, dev = o.shape[0], o.device
    n_rows = rows.shape[0]
    od, oo, a = dot(o, d), dot(o, o), dot(d, d)
    inv_a = 1.0 / a
    best_t = torch.full((n,), INF, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)

    def test(lane, first, count, own=None):
        """Rows [first, first + count) (count <= GROUP) on each lane;
        `own`: the lanes whose own segment enters the rows' box (None:
        all)."""
        j = torch.arange(GROUP, device=dev)
        k = torch.clamp(first[:, None] + j, max=n_rows - 1)
        valid = j < count[:, None]
        c = rows[k]                                     # (L, GROUP, 4)
        dl, ol = d[lane][:, None, :], o[lane][:, None, :]
        cd = (c[..., 0] * dl[..., 0] + c[..., 1] * dl[..., 1]
              + c[..., 2] * dl[..., 2])
        co = (c[..., 0] * ol[..., 0] + c[..., 1] * ol[..., 1]
              + c[..., 2] * ol[..., 2])
        half_b = od[lane][:, None] - cd
        c_term = (oo[lane][:, None] - 2.0 * co) + c[..., 3]
        disc = half_b * half_b - a[lane][:, None] * c_term
        ok = valid & (disc >= 0.0)
        sq = sqrt(torch.where(ok, disc, 1.0))
        root0 = (-half_b - sq) * inv_a[lane][:, None]
        root1 = (-half_b + sq) * inv_a[lane][:, None]
        lo, hi = t_min[lane][:, None], t_max[lane][:, None]
        ok0 = ok & (root0 >= lo) & (root0 <= hi)
        ok1 = ok & (root1 >= lo) & (root1 <= hi)
        root = torch.where(ok0, root0, torch.where(ok1, root1, INF))
        # A run's rows ascend in scene index: the first of equal minima
        # is the lowest index.
        ct, cj = torch.min(root, dim=1)
        ci = index[torch.gather(k, 1, cj[:, None])[:, 0]].to(torch.int64)
        bt, bi = best_t[lane], best_i[lane]
        better = (ct < bt) | ((ct == bt) & (ci < bi))
        best_t[lane] = torch.where(better, ct, bt)
        best_i[lane] = torch.where(better, ci, bi)
        _tally(counts, "warp_pairs", valid.sum())
        _tally(counts, "pairs", valid.sum() if own is None
               else valid[own].sum())

    everyone = torch.arange(n, device=dev)
    for b0 in range(0, n_big, GROUP):
        test(everyone, torch.full((n,), b0, device=dev),
             torch.full((n,), min(GROUP, n_big - b0), device=dev))
    n_groups = boxes.shape[0]
    if n_groups == 0 or n == 0:
        return best_t, best_i.to(torch.int32)
    warp = everyone // 32
    n_warps = (n + 31) // 32
    w_oct = warp_octant(d)[::32]
    inv_d = 1.0 / d
    reach = sqrt(oo)
    for step in range(n_groups):
        g = order[w_oct, step].to(torch.int64)[warp]         # (N,)
        box = boxes[g]
        pad = PAD * (reach + box[:, 3])
        t0 = (box[:, 0:3] - pad[:, None] - o) * inv_d
        t1 = (box[:, 4:7] + pad[:, None] - o) * inv_d
        lo3, hi3 = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = torch.maximum(torch.maximum(torch.maximum(
            lo3[:, 0], lo3[:, 1]), lo3[:, 2]), t_min)
        far = torch.minimum(torch.minimum(torch.minimum(
            hi3[:, 0], hi3[:, 1]), hi3[:, 2]), torch.minimum(best_t, t_max))
        near = near - near.abs() * SLACK
        far = far + far.abs() * SLACK
        inside = ~(near > far)  # NaN: tested
        enter = torch.zeros((n_warps,), dtype=torch.int64, device=dev)
        enter.index_add_(0, warp, inside.to(torch.int64))
        lane = (enter > 0)[warp].nonzero()[:, 0]
        _tally(counts, "boxes", n)
        _tally(counts, "entered", (enter > 0).sum())
        if lane.numel():
            first = n_big + GROUP * g[lane]
            test(lane, first, torch.clamp(n_rows - first, max=GROUP),
                 own=inside[lane])
    return best_t, best_i.to(torch.int32)


def _check(center, radius, o, d, t_min, t_max):
    n = o.shape[0] if o.dim() == 2 else -1
    s = center.shape[0] if center.dim() == 2 else -1
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,)),
                           ("center", center, (s, 3)),
                           ("radius", radius, (s,))):
        if not torch.is_tensor(x) or x.dim() == 0:
            continue  # a scalar bound
        if tuple(x.shape) != shape or shape[0] < 0:
            raise ValueError(f"nearest_t: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32:
            raise TypeError(f"nearest_t: {name} is {x.dtype}, not float32")
        if x.device != o.device:
            raise ValueError(f"nearest_t: {name} is on {x.device}, "
                             f"o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"nearest_t: {name} is not contiguous")


def _check_groups(groups, s, device):
    if groups is None:
        raise ValueError("nearest_t: no kernel tables (group_table's): the "
                         "card walks the spheres in groups")
    rows, index, boxes, order, n_big = groups
    g = boxes.shape[0]
    for name, x, dtype, shape in (
            ("rows", rows, torch.float32, (s, 4)),
            ("index", index, torch.int32, (s,)),
            ("boxes", boxes, torch.float32, (g, 8)),
            ("order", order, torch.int32, (8, g))):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"nearest_t: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} {shape}")
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"nearest_t: {name} is not a contiguous "
                             f"tensor on {device}")
        if x.data_ptr() % 16:
            raise ValueError(f"nearest_t: {name} is not 16-byte aligned")
    if not 0 <= n_big <= s or n_big + GROUP * g < s:
        raise ValueError(f"nearest_t: {n_big} ungrouped and {g} groups do "
                         f"not cover {s} spheres")


def table_bytes(groups):
    """Bytes of B1's tables in shared memory, each from a 16-byte
    boundary (as the kernel lays them out)."""
    return sum((x.numel() * 4 + 15) // 16 * 16 for x in groups[:4])


def nearest_t(center, radius, o, d, t_min, t_max, groups=None):
    """Nearest valid sphere hit per ray.

    t_min, t_max: scalars or (N,) tensors.  groups: ``group_table``'s
    tables for these spheres, needed on the card.  Returns (t (N,)
    float32, +inf on a miss; index (N,) int32), with no autograd graph
    on either device (``geometry.spheres.winner_t`` gives t its
    derivative)."""
    n = o.shape[0]
    _check(center, radius, o, d, t_min, t_max)
    if o.device.type == "cpu":
        with torch.no_grad():
            return nearest_t_plain(center, radius, o, d,
                                   _lanes(t_min, n, "cpu"),
                                   _lanes(t_max, n, "cpu"))
    if o.device.type != "cuda":
        raise ValueError(f"nearest_t: no kernel for device {o.device}")
    _check_groups(groups, center.shape[0], o.device)
    rows, index, boxes, order, n_big = groups
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    i = torch.empty((n,), dtype=torch.int32, device=o.device)
    shared = table_bytes(groups) <= SHARED_MAX_BYTES
    _build.launch("mrt_nearest_t", o.device, rows, index, boxes, order,
                  rows.shape[0], boxes.shape[0], n_big, o, d,
                  *bound_arg(t_min), *bound_arg(t_max), n, t, i, int(shared))
    return t, i
