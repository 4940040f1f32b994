"""AOV (arbitrary output variable) passes: the albedo and normal guides
(mirrors ``mrt.integrator.aov``).

The reference renders them in a pre-pass that feeds the denoiser and
the Albedo and Normal display modes.  One first-hit intersection a
pixel, through the scene's kernels, at pixel centres.
"""

from __future__ import annotations

import torch

from ..materials import shade
from ..math import vec
from ..math.rng import Sampler
from . import wavefront


def albedo_normal(scene, o, d, ray_id, seed):
    """First-hit albedo and normal of each ray.

    Returns (albedo (N, 3), normal (N, 3)):
      hit and scatters -> (scatter attenuation, hit normal)
      hit and absorbs  -> (emitted, hit normal)
      miss             -> (background, zero)
    """
    vol_sampler = Sampler(seed, ray_id, salt=0xA06)
    hits = scene.intersect(o, d, t_min=wavefront.T_MIN, sampler=vol_sampler)
    em_sampler = Sampler(seed, ray_id, salt=0xA07)
    sc_sampler = Sampler(seed, ray_id, salt=0xA08)
    emitted, atten, _, scattered, _ = shade.shade_hit(
        scene, hits, d, em_sampler, sc_sampler)
    background = scene.background_eval(d)
    hit = hits.hit[:, None]
    albedo = torch.where(hit, torch.where(scattered[:, None], atten, emitted),
                         background)
    normal = torch.where(hit, hits.normal, 0.0)
    return albedo, normal


def albedo_normal_frame(scene, camera, width, height, seed=0):
    """The whole frame's guides at pixel centres without defocus (the
    reference's pre-pass jitters its rays; mrt takes centres for a
    deterministic guide), in batches of ``wavefront.RAY_BATCH`` rays, the
    last one short.  Returns (albedo, normal), each (H, W, 3), rows
    bottom-up."""
    device = camera.origin.device
    n = width * height
    ray_id = torch.arange(n, dtype=torch.int64, device=device)
    s = vec.div((ray_id % width).to(torch.float32) + 0.5, width)
    t = vec.div((ray_id // width).to(torch.float32) + 0.5, height)
    zeros = torch.zeros((n,), device=device)
    o, d = camera.rays(s, t, zeros, zeros)
    albedo, normal = [], []
    for start in range(0, n, wavefront.RAY_BATCH):
        part = slice(start, start + wavefront.RAY_BATCH)
        a, nrm = albedo_normal(scene, o[part], d[part], ray_id[part], seed)
        albedo.append(a)
        normal.append(nrm)
    return (torch.cat(albedo).reshape(height, width, 3),
            torch.cat(normal).reshape(height, width, 3))
