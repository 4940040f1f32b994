"""The wavefront path-tracing integrator (mirrors
``mrt.integrator.wavefront``).

A whole wavefront of N rays advances through a bounce loop carrying SoA
state (origin, direction, throughput, radiance, alive).  Termination
matches the reference:
  depth exhausted       -> contributes black
  miss                  -> throughput * background
  absorbed (no scatter) -> emitted only
  scatter               -> emitted + atten * recurse
Each ray also reports its bounce count, for the Depth display mode.

Two opt-in changes of estimator, as in the reference:
  - Russian roulette (``rr_depth``): from that bounce on, a scattered
    path survives with probability clip(max(throughput), 0.05, 1) and
    is reweighted by its inverse;
  - next-event estimation with MIS (a scene with a light table,
    ``materials/lights.py``): every NEE-capable vertex adds a light
    sample, and emission found by the BSDF continuation is weighed by
    the power heuristic against it (``prev_pdf`` carries the
    continuation's pdf to the next bounce).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..materials import lights as lights_mod
from ..materials import shade
from ..materials import table as T
from ..math import vec
from ..math.rng import MASK, Sampler

MAX_DEPTH = 50  # the reference default
T_MIN = 1e-3


def mis_emission(scene, hits, o, d, prev_pdf, emitted):
    """With NEE, emission reached by a BSDF continuation of an NEE vertex
    (prev_pdf > 0) weighed by the power heuristic; else `emitted`."""
    if scene.lights is None:
        return emitted
    is_light = scene.materials.mtype[hits.material] == T.DIFFUSE_LIGHT
    w_b = lights_mod.mis_bsdf_weight(scene, hits, o, d, prev_pdf)
    return emitted * torch.where(is_light & (prev_pdf > 0.0), w_b,
                                 1.0)[:, None]


def next_event(scene, hits, hit, lobe, new_dir, seed, ray_id, b):
    """With NEE: (direct light (N, 3) to weigh by throughput * atten,
    the lanes that took a light sample, the continuation's pdf (N,)).
    Without: (None, None, zeros)."""
    if scene.lights is None:
        return None, None, torch.zeros_like(hits.t)
    # A salt past every 3b + k bounce salt.
    nee_sampler = Sampler(seed, ray_id, salt=(1 << 30) + 3 * b)
    direct, did_nee = lights_mod.sample_direct(scene, hits, nee_sampler,
                                               lobe)
    return direct, did_nee & hit, lights_mod.bsdf_pdf(
        lobe, vec.unit(hits.normal), vec.unit(new_dir))


def roulette(seed, ray_id, b, rr_depth, scat, tp_next):
    """Russian roulette from bounce rr_depth on: (scat with the paths
    that lost removed, the survivors' weight 1 / p_survive where it
    applied, else 1)."""
    rr_sampler = Sampler(seed, ray_id, salt=(1 << 29) + b)
    p_survive = vec.clamp(torch.amax(tp_next, dim=-1), 0.05, 1.0)
    roll = rr_sampler.next1() < p_survive
    apply_rr = scat & (b >= rr_depth)
    return scat & (~apply_rr | roll), apply_rr, p_survive


def _bounce(scene, ray_id, seed, b, state, rr_depth=None):
    """One bounce: intersect, shade, terminate or continue."""
    o, d, throughput, radiance, alive, bounces, prev_pdf = state
    # Every draw is a pure function of (seed, ray_id, bounce).
    vol_sampler = Sampler(seed, ray_id, salt=3 * b + 2)
    hits = scene.intersect(o, d, t_min=T_MIN, sampler=vol_sampler)
    em_sampler = Sampler(seed, ray_id, salt=3 * b)
    sc_sampler = Sampler(seed, ray_id, salt=3 * b + 1)
    emitted, atten, new_dir, scattered, lobe = shade.shade_hit(
        scene, hits, d, em_sampler, sc_sampler)
    background = scene.background_eval(d)

    hit = hits.hit & alive
    miss = ~hits.hit & alive
    emitted = mis_emission(scene, hits, o, d, prev_pdf, emitted)
    contrib = (torch.where(miss[:, None], background, 0.0)
               + torch.where(hit[:, None], emitted, 0.0))
    radiance = radiance + throughput * contrib
    direct, did_nee, next_pdf = next_event(scene, hits, hit, lobe, new_dir,
                                           seed, ray_id, b)
    if direct is not None:
        radiance = radiance + torch.where(did_nee[:, None],
                                          throughput * atten * direct, 0.0)

    cont = hit & scattered
    c3 = cont[:, None]
    throughput = torch.where(c3, throughput * atten, throughput)
    if rr_depth is not None:
        cont, apply_rr, p_survive = roulette(seed, ray_id, b, rr_depth,
                                             cont, throughput)
        c3 = cont[:, None]
        throughput = torch.where(apply_rr[:, None],
                                 throughput / p_survive[:, None], throughput)
    o = torch.where(c3, hits.point, o)
    d = torch.where(c3, new_dir, d)
    bounces = bounces + cont.to(torch.int32)
    return (o, d, throughput, radiance, cont, bounces,
            torch.where(cont, next_pdf, 0.0))


def trace_wavefront(scene, o, d, ray_id, seed, max_depth=MAX_DEPTH,
                    alive0=None, rr_depth=None, differentiable=False):
    """Trace N rays to completion; stops early once every ray is dead.

    differentiable: run exactly `max_depth` bounces, with no early exit
    and no host sync, each under ``torch.utils.checkpoint`` (the
    reference's checkpointed ``lax.scan``), so autograd reaches the
    scene's tensors through hit geometry, attenuation, emission and the
    background.  A bounce keeps its 7 state tensors and is recomputed in
    the backward pass; every draw is a pure function of (seed, ray_id,
    bounce), so the recompute redraws the same values and the discrete
    events (hit selection, Fresnel and Mix branches, roulette) are
    constants.  Dead lanes change nothing, so both modes give the same
    radiance and bounces.

    Returns (radiance (N,3), bounces (N,) int32)."""
    n = o.shape[0]
    alive = (torch.ones((n,), dtype=torch.bool, device=o.device)
             if alive0 is None else alive0)
    state = (o, d, torch.ones_like(o), torch.zeros_like(o), alive,
             torch.zeros((n,), dtype=torch.int32, device=o.device),
             torch.zeros((n,), device=o.device))
    if differentiable:
        for b in range(max_depth):
            state = checkpoint(_bounce, scene, ray_id, seed, b, state,
                               rr_depth, use_reentrant=False,
                               preserve_rng_state=False)
        return state[3], state[5]
    b = 0
    while b < max_depth and bool(state[4].any()):
        state = _bounce(scene, ray_id, seed, b, state, rr_depth)
        b += 1
    return state[3], state[5]


# Rays per batch: bounds the intersection temporaries of the plain
# sphere scan.
RAY_BATCH = 1 << 17


def trace_batched(scene, o, d, ray_id, seed, max_depth=MAX_DEPTH,
                  batch_size=RAY_BATCH, rr_depth=None):
    """trace_wavefront over fixed-size sequential batches; pad lanes
    trace a throwaway +z ray and start dead."""
    n = o.shape[0]
    if n <= batch_size:
        return trace_wavefront(scene, o, d, ray_id, seed, max_depth,
                               rr_depth=rr_depth)
    radiance, bounces = [], []
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        pad = batch_size - (e - s)
        ob, db, ib = o[s:e], d[s:e], ray_id[s:e]
        alive = torch.ones((batch_size,), dtype=torch.bool, device=o.device)
        if pad:
            ob = torch.cat([ob, ob.new_zeros((pad, 3))])
            db = torch.cat([db, db.new_ones((pad, 3))])
            ib = torch.cat([ib, ib.new_zeros((pad,))])
            alive[e - s:] = False
        r, c = trace_wavefront(scene, ob, db, ib, seed, max_depth, alive,
                               rr_depth)
        radiance.append(r[:e - s])
        bounces.append(c[:e - s])
    return torch.cat(radiance), torch.cat(bounces)


def render_sample(scene, camera, width, height, seed, sample_index,
                  max_depth=MAX_DEPTH, rr_depth=None):
    """One 1-spp pass over the full frame.

    Returns (radiance (H,W,3), bounces (H,W) int32)."""
    return render_rows(scene, camera, width, height, 0, height, seed,
                       sample_index, max_depth, rr_depth)


def render_rows(scene, camera, width, height, row0, n_rows, seed,
                sample_index, max_depth=MAX_DEPTH, rr_depth=None):
    """One 1-spp pass over rows [row0, row0 + n_rows) of the frame, each
    ray's id its global pixel id, so a row tile draws the numbers the
    whole frame does (``parallel.render``).

    Returns (radiance (n_rows,W,3), bounces (n_rows,W) int32)."""
    device = camera.origin.device
    n = n_rows * width
    ray_id = row0 * width + torch.arange(n, dtype=torch.int64, device=device)
    px = (ray_id % width).to(torch.float32)
    py = (ray_id // width).to(torch.float32)

    sample = int(sample_index) & MASK
    cam = Sampler(seed, (ray_id + ((0x9E3779B9 * sample) & MASK)) & MASK,
                  salt=0xC0FFEE)
    jx, jy, du, dv = cam.next4()

    # Pixel-jittered viewport coords; t runs bottom-up.
    s = vec.div(px + jx, width)
    t = vec.div(py + jy, height)
    o, d = camera.rays(s, t, du, dv)
    sample_salt = (sample * 0x85EBCA6B) & MASK
    radiance, bounces = trace_batched(scene, o, d, ray_id ^ sample_salt,
                                      seed, max_depth=max_depth,
                                      rr_depth=rr_depth)
    return (radiance.reshape(n_rows, width, 3),
            bounces.reshape(n_rows, width))
