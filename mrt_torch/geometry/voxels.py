"""Voxel grids walked by a hierarchical DDA (mirrors
``mrt.geometry.voxels``).

A ``VoxelGrid`` is an axis-aligned grid of n^3 solid unit cells, n =
3^levels, with occupancy either
  rule="menger": a cell is solid unless at some base-3 digit position two
                 or more of its three coordinates have the digit 1 (the
                 Menger sponge); a failed digit at position q empties the
                 whole 3^q-cell block, which the walk skips in one step;
  rule="dense":  an explicit (n, n, n) occupancy with its any-occupancy
                 mip pyramid, which gives the same block skipping.  The
                 port indexes the pyramid directly (one gather a step for
                 all levels); the reference's one-hot matmul row pick is
                 a TPU gather workaround with the same 0/1 result.

The hit is the first cell boundary along the ray where occupancy flips:
empty to solid is a front face, solid to empty (a ray that started
inside a solid) a back face; the normal is the crossing axis, stored
flipped against the ray.

The walk is eager PyTorch, one step a loop iteration.  Liveness is
checked every CHECK_EVERY steps (each check syncs with the device): a
dead lane's update is masked, so the extra steps change nothing, and
the step cap 6n + 3 levels + 8 is the reference's, so rays that reach
it agree.  The tracer's counters ``dda_calls`` and ``dda_steps``
(``utils.profiling``) count the calls and the steps run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.autodiff import refuse_grad
from ..utils import profiling
from .hit import INF, Hits

_BIG = 3.4e38
# DDA steps between liveness checks.
CHECK_EVERY = 8


class VoxelGrid(nn.Module):
    """origin (3,) world corner of cell (0, 0, 0); cell () edge length;
    material () int32 row; levels, rule as above.  rule="dense" keeps
    its mip pyramid as one flat uint8 table ``mips`` (level q's (m, m,
    m) cells, m = 3^(levels - q), at offset ``mip_offsets[q]``)."""

    def __init__(self, origin, cell, levels, material, rule="menger",
                 mips=None):
        """mips: rule="dense" only, the pyramid as the reference stores
        it: a sequence of levels + 1 arrays of shape (m * m, m), 0/1."""
        super().__init__()
        self.levels = int(levels)
        self.rule = rule
        self.register_buffer("origin",
                             torch.as_tensor(np.asarray(origin, np.float32)))
        self.register_buffer("cell", torch.tensor(np.float32(cell)))
        self.register_buffer("material", torch.tensor(np.int32(material)))
        if rule == "dense":
            flat = [np.asarray(m).reshape(-1) > 0.5 for m in mips]
            offsets = np.cumsum([0] + [f.size for f in flat[:-1]])
            self.register_buffer("mips", torch.as_tensor(
                np.concatenate(flat).astype(np.uint8)))
            self.mip_offsets = [int(x) for x in offsets]
        elif rule != "menger":
            raise ValueError(f"unknown voxel rule {rule!r}")

    @classmethod
    def create(cls, origin, cell, levels, material, rule="menger",
               occupancy=None):
        """As the reference's ``VoxelGrid.create``: rule="dense" takes an
        (n, n, n) bool occupancy and builds the pyramid on the host."""
        mips = None
        if rule == "dense":
            occ = np.asarray(occupancy, bool)
            n = 3 ** levels
            if occ.shape != (n, n, n):
                raise ValueError(f"dense occupancy must be {(n, n, n)}, "
                                 f"got {occ.shape}")
            mips, cur = [], occ
            for _ in range(levels + 1):
                m = cur.shape[0]
                mips.append(cur.reshape(m * m, m).astype(np.float32))
                if m > 1:
                    cur = cur.reshape(m // 3, 3, m // 3, 3, m // 3,
                                      3).any(axis=(1, 3, 5))
        return cls(origin, cell, levels, material, rule=rule, mips=mips)

    @property
    def n(self) -> int:
        return 3 ** self.levels

    def world_bounds(self):
        return self.origin, self.origin + self.n * self.cell

    def walk_constants(self, device):
        """The walk's per-grid constants on `device`: 3^q for q = 0 ..
        levels, the powers that empty levels give `skip`, and for the
        dense rule each level's side and its table offset."""
        q = torch.arange(self.levels + 1, device=device, dtype=torch.int32)
        k = {"scale": (3 ** q)[None, :, None]}
        if self.rule == "menger":
            k["pows"] = k["scale"][0, :-1, 0]
        else:
            k["pows"] = k["scale"][0, 1:, 0]
            k["side"] = (3 ** (self.levels - q))[None, :]
            k["offsets"] = torch.as_tensor(self.mip_offsets, device=device)
        return k

    def occupancy(self, c, k):
        """(occupied, skip, in_grid) for fine cells c (N, 3) int32: the
        cell is solid; skip = 3^q of the coarsest level q whose block is
        empty (1 when only the fine cell is, or it is solid); c lies in
        the grid.  Outside the grid the first two are values the walk
        never uses.  k: ``walk_constants``."""
        cq = torch.div(c[:, None, :], k["scale"], rounding_mode="floor")
        in_grid = (cq[:, -1] == 0).all(-1)  # c // 3^levels == 0
        if self.rule == "menger":
            empty = (torch.remainder(cq[:, :-1], 3) == 1).sum(-1) >= 2
            occupied = ~empty.any(-1)
        else:
            m = k["side"]
            cell = (cq[..., 0] * m + cq[..., 1]) * m + cq[..., 2]
            solid = self.mips[torch.clamp(k["offsets"] + cell, 0,
                                          self.mips.shape[0] - 1)]
            occupied = solid[:, 0] > 0
            empty = solid[:, 1:] == 0
        skip = torch.clamp(torch.amax(empty * k["pows"], dim=-1), min=1)
        return occupied, skip, in_grid


@profiling.spanned("L2v voxel DDA")
def intersect(grid: VoxelGrid, o, d, t_min, t_max) -> Hits:
    """Closest occupancy-flip boundary along each ray.  o, d: (N, 3), d
    may be unnormalised; t_min, t_max: scalars or (N,).  Raises
    ValueError where o, d or the grid require grad."""
    refuse_grad("voxel DDA", o, d, grid)
    n, N, dev = grid.n, o.shape[0], o.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32,
                            device=dev).expand(N)
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=dev).expand(N)
    origin, cell = grid.origin, grid.cell

    # Slabs of the grid box; a ray parallel to an axis is inside that
    # slab for all t or for none.
    lo, hi = origin, origin + n * cell
    moving = d != 0.0
    inv3 = torch.where(moving, 1.0 / torch.where(moving, d, 1.0), _BIG)
    para_in = (o >= lo) & (o <= hi)
    t0 = torch.where(moving, (lo - o) * inv3,
                     torch.where(para_in, -_BIG, _BIG))
    t1 = torch.where(moving, (hi - o) * inv3,
                     torch.where(para_in, _BIG, -_BIG))
    t_near, t_far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    nx, ny, nz = t_near.unbind(-1)
    near_raw = torch.maximum(nx, torch.maximum(ny, nz))
    far = torch.minimum(t_max, torch.amin(t_far, dim=-1))
    # The entry axis (x first on ties): the crossing axis when the ray
    # enters the box from outside.
    enter_axis = torch.where(near_raw == nx, 0,
                             torch.where(near_raw == ny, 1, 2))
    started_in_box = near_raw < t_min
    near = torch.maximum(near_raw, t_min)
    alive = near <= far
    dsign = d > 0.0

    # The start cell: a point on boundary b belongs to cell b going +,
    # b - 1 going -.  Entering through a box face, that axis's cell is
    # exactly 0 or n - 1 (floor of the crossing can be an ulp off).
    cf0 = (o + near[:, None] * d - origin) / cell
    fl = torch.floor(cf0)
    c = fl.to(torch.int32)
    c = torch.where((cf0 == fl) & ~dsign, c - 1, c)
    axes = torch.arange(3, device=dev)
    enter = (axes == enter_axis[:, None]) & ~started_in_box[:, None]
    c = torch.where(enter, torch.where(dsign, 0, n - 1).to(torch.int32), c)
    consts = grid.walk_constants(dev)
    occ0, _, in0 = grid.occupancy(c, consts)
    # Solid start cell: "inside" (walk to the exposed exit face) only when
    # the origin itself is in the box; entering the box straight into a
    # solid cell is a front hit on its face.
    inside = started_in_box & occ0 & in0

    hit_t = torch.full((N,), INF, device=dev)
    hit_axis = torch.zeros((N,), dtype=torch.int64, device=dev)
    hit_front = torch.zeros((N,), dtype=torch.bool, device=dev)
    inv_big = torch.abs(inv3) >= _BIG
    up = dsign.to(torch.int32)       # the far boundary of a block going +
    down = (~dsign).to(torch.int32)  # the cell before a boundary going -

    def step(t, c, axis, inside, alive, hit_t, hit_axis, hit_front):
        occ, skip, in_geom = grid.occupancy(c, consts)
        occ = occ & in_geom
        live = alive & (t <= far)  # past t_max or the box: never a hit
        # A hit where occupancy flips: empty to solid (front face) or,
        # walking inside a solid, solid to empty.  A lane hits once.
        newly = live & (occ != inside)
        hit_t = torch.where(newly, t, hit_t)
        hit_axis = torch.where(newly, axis, hit_axis)
        hit_front = hit_front | (newly & occ)
        still = live & ~newly & in_geom

        # Advance past the coarsest empty block (skip is 1 in a solid
        # cell): to the block's boundary on each axis, the nearest first
        # (x first on ties).
        blk = skip[:, None]
        bound_cell = (torch.div(c, blk, rounding_mode="floor") + up) * blk
        t_ax = (origin + bound_cell * cell - o) * inv3
        t_ax = torch.where(inv_big, _BIG, t_ax)
        t_next, exit_axis = torch.min(t_ax, dim=-1)
        # The other axes from the crossing point (a skipped block may
        # span many fine boundaries); the exit axis exactly, so the walk
        # advances even where t_next rounds to t.
        c_new = torch.floor((o + t_next[:, None] * d - origin)
                            / cell).to(torch.int32)
        ex = exit_axis[:, None]
        c_new = c_new.scatter(1, ex, torch.gather(bound_cell - down, 1, ex))
        return (torch.where(still, t_next, t),
                torch.where(still[:, None], c_new, c),
                torch.where(still, exit_axis, axis),
                torch.where(alive, occ, inside),
                still, hit_t, hit_axis, hit_front)

    state = (near, c, enter_axis, inside, alive, hit_t, hit_axis, hit_front)
    max_steps = 6 * n + 3 * grid.levels + 8
    steps = 0
    while steps < max_steps and bool(
            profiling.to_host(state[4].any(), "voxel DDA check")):
        k = min(CHECK_EVERY, max_steps - steps)
        for _ in range(k):
            state = step(*state)
        steps += k
    profiling.count("dda_calls")
    profiling.count("dda_steps", steps)
    hit_t, hit_axis, hit_front = state[5:]
    hit = hit_t < INF  # a hit's t is finite (it is at most `far`)
    t = hit_t
    # Stored normal: -sign(d) on the crossing axis for both senses;
    # front_face tells them apart.
    zeros3 = torch.zeros((N, 3), device=dev)
    nsign = torch.where(dsign, -1.0, 1.0)
    normal = torch.where(axes == hit_axis[:, None], nsign, 0.0)
    point = o + t[:, None] * d
    h3 = hit[:, None]
    return Hits(t=t, point=torch.where(h3, point, zeros3),
                normal=torch.where(h3, normal, zeros3),
                front_face=hit_front & hit, uv=zeros3[:, :2],
                material=torch.where(hit, grid.material.expand(N), 0),
                hit=hit, tangent=zeros3, bitangent=zeros3,
                prim_area=torch.zeros((N,), device=dev))

