"""The AOV-guided denoiser, an edge-aware à-trous filter (mirrors
``mrt.runtime.denoise``).

The reference's renderer can run Intel Open Image Denoise over the
tonemapped frame with albedo and normal guides; mrt stands in for it
with an SVGF-style à-trous wavelet filter whose weights join colour,
albedo and normal distances, called the same way (sRGB in, sRGB out).
Plain PyTorch ops on the frame's tensors, on whichever device they lie.

Shifts wrap around the image edges (``torch.roll``), as the reference's
``jnp.roll`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import vec
from ..utils import profiling

# B3-spline 5-tap kernel of the à-trous pyramid.
_KERNEL = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _shift2d(img, dy, dx):
    """(H, W, C) rolled by dy rows and dx columns, wrapping around."""
    return torch.roll(torch.roll(img, dy, 0), dx, 1)


def _box3(img):
    """3x3 box blur of (H, W, C) through shifts."""
    acc = torch.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + _shift2d(img, dy, dx)
    return vec.div(acc, 9.0)


def _sq_dist(a, b):
    return torch.sum((a - b) ** 2, dim=-1, keepdim=True)


@profiling.spanned("denoiser")
def denoise(rgb, albedo=None, normal=None, iterations=3, sigma_color=0.2,
            sigma_albedo=0.15, sigma_normal=0.25, firefly_k=4.0):
    """Edge-aware à-trous filter of (H, W, 3) tonemapped colour.

    albedo, normal: optional (H, W, 3) guides; each one present weighs a
    tap by exp(-|guide difference|^2 / sigma^2).
    firefly_k: pixels brighter than their 3x3 mean + k * std are pulled
    down to it before filtering (None or 0: off).
    Each iteration (tap spacing 1, 2, 4, ...) weighs the 5x5 B3-spline
    taps by colour distance over a local 3x3 noise estimate (SVGF's
    variance-adaptive weight) and by the guides.  Returns (H, W, 3)."""
    out = rgb
    if firefly_k:
        mu = _box3(out)
        var = torch.clamp(_box3(out * out) - mu * mu, min=0.0)
        out = torch.minimum(out, mu + firefly_k * vec.sqrt(var) + 1e-4)
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
                c = _shift2d(out, dy, dx)
                w = out.new_full(out.shape[:2] + (1,),
                                 float(_KERNEL[ky] * _KERNEL[kx]))
                w = w * torch.exp(-_sq_dist(c, out) / color_denom)
                if albedo is not None:
                    w = w * torch.exp(vec.div(
                        -_sq_dist(_shift2d(albedo, dy, dx), albedo),
                        sigma_albedo ** 2))
                if normal is not None:
                    w = w * torch.exp(vec.div(
                        -_sq_dist(_shift2d(normal, dy, dx), normal),
                        sigma_normal ** 2))
                accum = accum + c * w
                weight = weight + w
        out = accum / torch.clamp(weight, min=1e-8)
    return out


def make_denoiser(iterations=3):
    """The ``Film.to_float_rgb`` hook: (rgb, albedo, normal) -> rgb."""
    def fn(rgb, albedo, normal):
        return denoise(rgb, albedo, normal, iterations=iterations)
    return fn
