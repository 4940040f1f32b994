"""The preview's image from a film: tonemap, the AOV-guided à-trous
filter and the bytes the PNG holds.  A frozen copy of the port's
``runtime/denoise.py`` and ``Film.to_float_rgb``/``to_rgb_bytes``
(mean, gamma 2.2, clamp; the SVGF-style filter with wrapped shifts;
bytes truncated from x * 255)."""

from __future__ import annotations

import numpy as np
import torch

from .tracer import sqrt

KERNEL = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _div(x, s):
    return x / x.new_full((), float(s))


def _shift(img, dy, dx):
    return torch.roll(torch.roll(img, dy, 0), dx, 1)


def _box3(img):
    acc = torch.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + _shift(img, dy, dx)
    return _div(acc, 9.0)


def _sq_dist(a, b):
    return torch.sum((a - b) ** 2, dim=-1, keepdim=True)


def denoise(rgb, albedo, normal, iterations=3, sigma_color=0.2,
            sigma_albedo=0.15, sigma_normal=0.25, firefly_k=4.0):
    """Edge-aware à-trous filter of (H, W, 3) tonemapped colour."""
    out = rgb
    mu = _box3(out)
    var = torch.clamp(_box3(out * out) - mu * mu, min=0.0)
    out = torch.minimum(out, mu + firefly_k * sqrt(var) + 1e-4)
    for it in range(iterations):
        step = 1 << it
        mu = _box3(out)
        var = _box3(_sq_dist(out, mu))
        color_denom = sigma_color ** 2 + 8.0 * var
        accum = torch.zeros_like(out)
        weight = out.new_zeros(out.shape[:2] + (1,))
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                c = _shift(out, dy, dx)
                w = out.new_full(out.shape[:2] + (1,),
                                 float(KERNEL[ky] * KERNEL[kx]))
                w = w * torch.exp(-_sq_dist(c, out) / color_denom)
                w = w * torch.exp(_div(
                    -_sq_dist(_shift(albedo, dy, dx), albedo),
                    sigma_albedo ** 2))
                w = w * torch.exp(_div(
                    -_sq_dist(_shift(normal, dy, dx), normal),
                    sigma_normal ** 2))
                accum = accum + c * w
                weight = weight + w
        out = accum / torch.clamp(weight, min=1e-8)
    return out


def tonemap(film_sum, samples):
    return torch.clamp(_div(film_sum, samples) ** (1.0 / 2.2), 0.0, 1.0)


def to_bytes(rgb):
    """uint8 RGB, rows as in the film (bottom-up)."""
    return (rgb.cpu().numpy() * 255.0).astype(np.uint8)
