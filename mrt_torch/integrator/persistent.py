"""Persistent-wavefront integrator with ray regeneration (mirrors
``mrt.integrator.persistent``).

A fixed pool of P lanes consumes a queue of (pixel, sample) work items;
the moment a path terminates, its lane claims the next item and
generates that sample's camera ray, so lanes stay busy at any depth.
Work items are pixel-major: item -> (pixel = item // samples,
sample = item % samples).  A shard of the frame (``parallel.render``)
passes ``pixel_offset``, ``n_pixels`` and ``sample_stride``: its items
cover pixels [pixel_offset, pixel_offset + n_pixels) and its k-th sample
of a pixel is sample_start + k * sample_stride; its film holds those
pixels alone.

Every random draw is the same pure function of (seed, pixel, sample,
bounce) as in the wavefront integrator, so both give the same
estimator; only the order of the film's float additions differs.

Each step deposits [radiance, scattered] of every active lane straight
into the packed (npix, 4) film with kernel B2 (``ops.deposit``).  In
the pending-deposit film mode (``pend``, ``MRT_FILM_PEND=1``) each lane
instead sums its path's contributions in a per-lane accumulator, and
only the lanes whose path ends this step add theirs to the film, with
kernel B4 (``ops.deposit.deposit_pending``).  The loop checks for
termination every FLUSH_STEPS steps; steps that find the queue empty
deposit nothing.

With ``sort_rays`` = k > 0 the pool is sorted every k steps by the
lanes' ray coherence key (``make_sorter``: kernel S1 the key,
``torch.sort``, kernel S2 the permutation; ``ops.sort``), so that a
warp's lanes hold rays that start in one region and point one way.  The
sort moves whole lanes: every draw is keyed on (ray_id, bounce) and
every deposit on the work item, so the estimator is unchanged and only
the order of the film's float additions differs.

Russian roulette (``rr_depth``) and next-event estimation (a scene with
a light table) are the wavefront integrator's, per lane; the MIS pdf of
a path's last continuation rides with the lane (``prev_pdf``, zero on a
new camera ray).
"""

from __future__ import annotations

import os

import torch

from ..materials import shade
from ..math.rng import MASK, Sampler, mul32
from ..ops.deposit import deposit, deposit_pending
from ..ops.sort import live_box, origin_box, permute_lanes, sort_keys
from .wavefront import (MAX_DEPTH, T_MIN, mis_emission, next_event,
                        roulette)

POOL = 1 << 17
# Steps between termination checks (each check syncs with the device).
FLUSH_STEPS = 8
# The pend film mode's default when neither the caller nor MRT_FILM_PEND
# chooses, as in the reference.
PEND_AUTO_ON = False


def pend_enabled(pend=None):
    """Resolve the pending-deposit film mode: True or False as given;
    None reads MRT_FILM_PEND ("1" on, "0" off) and else PEND_AUTO_ON.
    The reference also gates the mode on its TPU kernel's layout (pool %
    1024, film rows * 4 % 128); kernel B4 takes any shape, so the port
    has no such gate."""
    if pend is not None:
        return bool(pend)
    flag = os.environ.get("MRT_FILM_PEND")
    if flag in ("0", "1"):
        return flag == "1"
    return PEND_AUTO_ON


class LanePool:
    """A pass's constants, and the functions that start and advance its
    pool of lanes."""

    def __init__(self, scene, camera, width, height, seed, sample_start,
                 samples, max_depth, rr_depth=None, pend=False,
                 pixel_offset=0, n_pixels=None, sample_stride=1):
        self.scene, self.camera = scene, camera
        self.rr_depth, self.pend = rr_depth, pend
        self.width = width
        self.seed = seed
        self.sample_start, self.samples = sample_start, samples
        self.pixel_offset, self.sample_stride = pixel_offset, sample_stride
        self.max_depth = max_depth
        self.npix = n_pixels if n_pixels is not None else width * height
        self.total = self.npix * samples
        self.device = camera.origin.device
        # 1/width and 1/height rounded to float32: the camera multiplies
        # by them, as the reference's persistent integrator does.
        self.inv_w = float(1.0 / torch.tensor(float(width)))
        self.inv_h = float(1.0 / torch.tensor(float(height)))
        # Idle lanes park on a neutral ray that starts past the scene on
        # every axis and points away; every film contribution is gated
        # on `active`, so the ray only has to be cheap.
        bmin, bmax = scene.world_bounds()
        self.neutral_o = bmax + torch.clamp(bmax - bmin, min=1.0)
        self.neutral_d = torch.full((3,), 0.57735027, device=self.device)

    def make_rays(self, item):
        """Camera rays for work items (int64), with the exact RNG stream
        of wavefront.render_sample.  Returns (o, d, ray_id)."""
        q = item // self.samples
        s_idx = item - q * self.samples
        pixel = self.pixel_offset + q
        sample = (self.sample_start + s_idx * self.sample_stride) & MASK
        px = (pixel % self.width).to(torch.float32)
        py = (pixel // self.width).to(torch.float32)
        cam = Sampler(self.seed, (pixel + mul32(sample, 0x9E3779B9)) & MASK,
                      salt=0xC0FFEE)
        jx, jy, du, dv = cam.next4()
        s = (px + jx) * self.inv_w
        t = (py + jy) * self.inv_h
        o, d = self.camera.rays(s, t, du, dv)
        ray_id = pixel ^ mul32(sample, 0x85EBCA6B)
        return o, d, ray_id

    def init_state(self, pool):
        lane = torch.arange(pool, dtype=torch.int64, device=self.device)
        o, d, ray_id = self.make_rays(lane)
        st = dict(
            item=lane,
            bounce=torch.zeros((pool,), dtype=torch.int64, device=self.device),
            o=o, d=d, throughput=torch.ones_like(o), ray_id=ray_id,
            prev_pdf=torch.zeros((pool,), device=self.device),
            next_work=torch.tensor(pool, dtype=torch.int64,
                                   device=self.device))
        if self.pend:
            # Per-lane pending (radiance, bounce count) of the lane's path.
            st["acc"] = torch.zeros((pool, 4), device=self.device)
        return st

    def step(self, st, film):
        """One wavefront step: intersect, shade, deposit into `film`
        (npix, 4) in place, then regenerate dead lanes from the queue."""
        scene, total = self.scene, self.total
        item, b, o, d = st["item"], st["bounce"], st["o"], st["d"]
        throughput, ray_id = st["throughput"], st["ray_id"]
        seed = self.seed
        active = item < total
        q = torch.clamp(item, 0, total - 1) // self.samples

        vol_sampler = Sampler(seed, ray_id, salt=3 * b + 2)
        hits = scene.intersect(o, d, t_min=T_MIN, sampler=vol_sampler)
        em_sampler = Sampler(seed, ray_id, salt=3 * b)
        sc_sampler = Sampler(seed, ray_id, salt=3 * b + 1)
        emitted, atten, new_dir, scattered, lobe = shade.shade_hit(
            scene, hits, d, em_sampler, sc_sampler)
        hit = hits.hit & active
        miss = ~hits.hit & active
        background = scene.background_eval_masked(d, miss)
        emitted = mis_emission(scene, hits, o, d, st["prev_pdf"], emitted)
        radiance_add = background + torch.where(hit[:, None], emitted, 0.0)
        radiance_add = torch.where(active[:, None],
                                   throughput * radiance_add, 0.0)
        direct, did_nee, next_pdf = next_event(scene, hits, hit, lobe,
                                               new_dir, seed, ray_id, b)
        if direct is not None:
            radiance_add = radiance_add + torch.where(
                did_nee[:, None], throughput * atten * direct, 0.0)

        scat = hit & scattered
        cont = scat & (b + 1 < self.max_depth)
        if self.rr_depth is not None:
            # On `scat`, not the depth-gated `cont`, so bounce counts
            # match the wavefront integrator's.
            scat, apply_rr, p_survive = roulette(
                seed, ray_id, b, self.rr_depth, scat, throughput * atten)
            cont = cont & scat
            atten = torch.where(apply_rr[:, None],
                                atten / p_survive[:, None], atten)
        contrib = torch.cat([radiance_add, scat.to(torch.float32)[:, None]],
                            dim=1)
        slot = torch.where(active, q, -1).to(torch.int32)
        out = {}
        if self.pend:
            # Only the lanes whose path ends now touch the film.
            acc = st["acc"] + contrib
            dying = active & ~cont
            deposit_pending(film, slot, acc, dying)
            out["acc"] = torch.where(dying[:, None], 0.0, acc)
        else:
            deposit(film, slot, contrib)

        # Regenerate dead (and idle) lanes: the k-th claiming lane takes
        # item next_work + k while the queue lasts.
        claim = ~cont
        offsets = torch.cumsum(claim.to(torch.int64), 0) - 1
        new_item = st["next_work"] + offsets
        takes = claim & (new_item < total)
        next_work = st["next_work"] + takes.sum()
        item = torch.where(cont, item, torch.where(takes, new_item, total))
        no, nd, nrid = self.make_rays(torch.where(takes, new_item, 0))
        c3, t3 = cont[:, None], takes[:, None]
        return dict(
            out,
            item=item,
            bounce=torch.where(cont, b + 1, 0),
            o=torch.where(c3, hits.point, torch.where(t3, no, self.neutral_o)),
            d=torch.where(c3, new_dir, torch.where(t3, nd, self.neutral_d)),
            throughput=torch.where(
                c3, throughput * atten,
                torch.where(t3, torch.ones_like(throughput), throughput)),
            ray_id=torch.where(cont, ray_id, torch.where(takes, nrid, ray_id)),
            prev_pdf=torch.where(cont, next_pdf, 0.0),
            next_work=next_work)

    def busy(self, st):
        """True while any lane is active or the queue has work (syncs)."""
        return bool(((st["item"] < self.total).any()
                     | (st["next_work"] < self.total)).item())


def sort_lanes(st, total, box=None):
    """One sort of a pool's lane state `st`: every per-lane column (the
    pend accumulator too) permuted so that the lanes run in order of
    their coherence key, idle lanes (item >= total) last; next_work as it
    is.  box: the origin cells (``ops.sort.origin_box``), None for the
    active lanes' own origins.  On the card: S1, torch.sort and S2, and
    no host sync."""
    item, o = st["item"], st["o"]
    if box is None:
        box = live_box(item, o, total)
    keys = sort_keys(item, o, st["d"], total, box)
    return permute_lanes(torch.sort(keys, stable=True).indices, st)


def make_sorter(scene, total):
    """The reference's lane sorter (``_make_sorter``): a function of a
    lane state, ``sort_lanes`` over the scene's bounds, or with
    MRT_SORT_DYN=1 over the active lanes' origins at each sort."""
    dynamic = os.environ.get("MRT_SORT_DYN", "0") == "1"
    box = None if dynamic else origin_box(*scene.world_bounds())
    return lambda st: sort_lanes(st, total, box)


@torch.no_grad()
def render_samples_persistent(scene, camera, width, height, seed,
                              sample_start, samples, max_depth=MAX_DEPTH,
                              pool=POOL, film_sum=None, depth_sum=None,
                              rr_depth=None, pend=None, pixel_offset=0,
                              n_pixels=None, sample_stride=1,
                              sort_rays=0):
    """Render `samples` spp of the frame with a pool of `pool` lanes.
    rr_depth: Russian roulette from that bounce on (None: off); pend:
    the pending-deposit film mode (None: ``pend_enabled``'s default).
    pixel_offset, n_pixels, sample_stride: render the shard of pixels
    [pixel_offset, pixel_offset + n_pixels) (None: the whole frame) at
    samples sample_start + k * sample_stride, k < samples.
    sort_rays: the lane sorter's cadence, 0 (or False) off; k sorts the
    lanes after every k steps (True: 1), as the reference's
    ``_flush_block``: FLUSH_STEPS // k rounds of k steps between
    termination checks, k clipped to [1, FLUSH_STEPS].

    Returns (film_sum (npix, 3) float32, depth_sum (npix,) int32) with
    npix = n_pixels or width * height; pass them back in to accumulate
    further passes.  Records no autograd graph: like the reference's
    while_loop, the pass has no gradient
    (``trace_wavefront(differentiable=True)`` has).
    """
    lanes = LanePool(scene, camera, width, height, seed, sample_start,
                     samples, max_depth, rr_depth, pend_enabled(pend),
                     pixel_offset, n_pixels, sample_stride)
    device = lanes.device
    film = torch.zeros((lanes.npix, 4), dtype=torch.float32, device=device)
    if film_sum is not None:
        film[:, :3] = film_sum
    if depth_sum is not None:
        film[:, 3] = depth_sum.to(torch.float32)
    st = lanes.init_state(pool)
    sorter, cadence = None, FLUSH_STEPS
    if sort_rays:
        sorter = make_sorter(scene, lanes.total)
        cadence = max(1, min(int(sort_rays), FLUSH_STEPS))
    while lanes.busy(st):
        for _ in range(FLUSH_STEPS // cadence):
            for _ in range(cadence):
                st = lanes.step(st, film)
            if sorter is not None:
                st = sorter(st)
    return film[:, :3].contiguous(), torch.round(film[:, 3]).to(torch.int32)
