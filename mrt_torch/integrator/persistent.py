"""Persistent-wavefront integrator with ray regeneration (mirrors
``mrt.integrator.persistent``).

A fixed pool of P lanes consumes a queue of (pixel, sample) work items;
the moment a path terminates, its lane claims the next item and
generates that sample's camera ray, so lanes stay busy at any depth.
Work items are pixel-major: item -> (pixel = item // samples,
sample = item % samples).

Every random draw is the same pure function of (seed, pixel, sample,
bounce) as in the wavefront integrator, so both give the same
estimator; only the order of the film's float additions differs.

Each step deposits [radiance, scattered] of every active lane straight
into the packed (npix, 4) film with kernel B2 (``ops.deposit``).  The
loop checks for termination every FLUSH_STEPS steps; steps that find
the queue empty deposit nothing.
"""

from __future__ import annotations

import torch

from ..materials import shade
from ..math.rng import MASK, Sampler, mul32
from ..ops.deposit import deposit
from .wavefront import MAX_DEPTH, T_MIN

POOL = 1 << 17
# Steps between termination checks (each check syncs with the device).
FLUSH_STEPS = 8


class LanePool:
    """A pass's constants, and the functions that start and advance its
    pool of lanes."""

    def __init__(self, scene, camera, width, height, seed, sample_start,
                 samples, max_depth):
        self.scene, self.camera = scene, camera
        self.width = width
        self.seed = seed
        self.sample_start, self.samples = sample_start, samples
        self.max_depth = max_depth
        self.npix = width * height
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
        pixel = q
        sample = (self.sample_start + s_idx) & MASK
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
        return dict(
            item=lane,
            bounce=torch.zeros((pool,), dtype=torch.int64, device=self.device),
            o=o, d=d, throughput=torch.ones_like(o), ray_id=ray_id,
            next_work=torch.tensor(pool, dtype=torch.int64,
                                   device=self.device))

    def step(self, st, film):
        """One wavefront step: intersect, shade, deposit into `film`
        (npix, 4) in place, then regenerate dead lanes from the queue."""
        scene, total = self.scene, self.total
        item, b, o, d = st["item"], st["bounce"], st["o"], st["d"]
        throughput, ray_id = st["throughput"], st["ray_id"]
        active = item < total
        q = torch.clamp(item, 0, total - 1) // self.samples

        vol_sampler = Sampler(self.seed, ray_id, salt=3 * b + 2)
        hits = scene.intersect(o, d, t_min=T_MIN, sampler=vol_sampler)
        em_sampler = Sampler(self.seed, ray_id, salt=3 * b)
        sc_sampler = Sampler(self.seed, ray_id, salt=3 * b + 1)
        emitted, atten, new_dir, scattered = shade.shade_hit(
            scene, hits, d, em_sampler, sc_sampler)
        hit = hits.hit & active
        miss = ~hits.hit & active
        background = scene.background_eval_masked(d, miss)
        radiance_add = background + torch.where(hit[:, None], emitted, 0.0)
        radiance_add = torch.where(active[:, None],
                                   throughput * radiance_add, 0.0)

        scat = hit & scattered
        cont = scat & (b + 1 < self.max_depth)
        contrib = torch.cat([radiance_add, scat.to(torch.float32)[:, None]],
                            dim=1)
        slot = torch.where(active, q, -1).to(torch.int32)
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
            item=item,
            bounce=torch.where(cont, b + 1, 0),
            o=torch.where(c3, hits.point, torch.where(t3, no, self.neutral_o)),
            d=torch.where(c3, new_dir, torch.where(t3, nd, self.neutral_d)),
            throughput=torch.where(
                c3, throughput * atten,
                torch.where(t3, torch.ones_like(throughput), throughput)),
            ray_id=torch.where(cont, ray_id, torch.where(takes, nrid, ray_id)),
            next_work=next_work)

    def busy(self, st):
        """True while any lane is active or the queue has work (syncs)."""
        return bool(((st["item"] < self.total).any()
                     | (st["next_work"] < self.total)).item())


def render_samples_persistent(scene, camera, width, height, seed,
                              sample_start, samples, max_depth=MAX_DEPTH,
                              pool=POOL, film_sum=None, depth_sum=None):
    """Render `samples` spp of the frame with a pool of `pool` lanes.

    Returns (film_sum (npix, 3) float32, depth_sum (npix,) int32); pass
    them back in to accumulate further passes.
    """
    lanes = LanePool(scene, camera, width, height, seed, sample_start,
                     samples, max_depth)
    device = lanes.device
    film = torch.zeros((lanes.npix, 4), dtype=torch.float32, device=device)
    if film_sum is not None:
        film[:, :3] = film_sum
    if depth_sum is not None:
        film[:, 3] = depth_sum.to(torch.float32)
    st = lanes.init_state(pool)
    while lanes.busy(st):
        for _ in range(FLUSH_STEPS):
            st = lanes.step(st, film)
    return film[:, :3].contiguous(), torch.round(film[:, 3]).to(torch.int32)
