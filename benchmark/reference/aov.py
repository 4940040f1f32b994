"""The denoiser's guides at chosen pixels: the first hit's albedo and
normal of a ray through each pixel's centre, without defocus (a frozen
copy of the port's ``integrator/aov.py`` estimator).

  hit and scatters -> (the scatter's attenuation, the hit normal)
  hit and absorbs  -> (its emission, the hit normal)
  miss             -> (the background, zero)
"""

from __future__ import annotations

import torch

from . import tracer


def guides_at(scene, pixel, seed, width, height, dt=torch.float32):
    """(albedo (K, 3), normal (K, 3)) at `pixel` (K,) int64."""
    px = (pixel % width).to(dt)
    py = (pixel // width).to(dt)
    s = (px + 0.5) / torch.tensor(float(width), dtype=dt, device=pixel.device)
    t = (py + 0.5) / torch.tensor(float(height), dtype=dt,
                                  device=pixel.device)
    zero = torch.zeros_like(s)
    o, d = tracer.lens(scene["camera"], s, t, zero, zero)
    hits = tracer.intersect(scene, o, d)
    # The scatter stream of the pre-pass: salt 0xA08, after the Mix draws.
    u = tuple(x.to(dt) for x in tracer.draw4(seed, pixel, 0xA08,
                                             tracer.MIX_DRAWS))
    atten, _, scattered = tracer.scatter(scene, hits, d, u)
    m = scene["materials"]
    rows = hits["material"]
    light = (m["mtype"][rows] == tracer.DIFFUSE_LIGHT).to(dt)[:, None]
    emitted = torch.where(hits["hit"][:, None], m["emit"][rows] * light, 0.0)
    hit = hits["hit"][:, None]
    albedo = torch.where(hit, torch.where(scattered[:, None], atten, emitted),
                         tracer.background(scene, d))
    return albedo, torch.where(hit, hits["normal"], 0.0)
