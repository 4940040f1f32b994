"""Closed-form Monte Carlo sampling primitives (mirrors
``mrt.math.sampling``).  Each takes pre-drawn uniforms, so callers
control the random stream."""

from __future__ import annotations

import math

import torch

from . import vec

TAU = 2.0 * math.pi


def unit_vector(u1, u2):
    """Uniform direction on S^2 from two uniforms."""
    z = 1.0 - 2.0 * u1
    r = vec.sqrt(vec.clamp(1.0 - z * z, 0.0))
    phi = TAU * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_sphere(u1, u2, u3):
    """Uniform point inside the unit ball from three uniforms.

    u3 is clamped off exact zero: r = cbrt(u3) would map the RNG's
    u3 == 0.0 draw (probability 2^-24) to the zero vector, a degenerate
    scatter direction.  The clamp moves that point mass to r ~ 0.003
    and leaves every nonzero draw unchanged.  The cube root is taken in
    float64 and rounded, as PyTorch has no float32 cbrt."""
    d = unit_vector(u1, u2)
    u = vec.clamp(u3, 2.0 ** -25)
    r = torch.pow(u.to(torch.float64), 1.0 / 3.0).to(torch.float32)
    return d * r[..., None]


def in_unit_disk(u1, u2):
    """Uniform point in the unit disk (z = 0) from two uniforms."""
    r = vec.sqrt(u1)
    phi = TAU * u2
    return torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi), torch.zeros_like(r)], dim=-1)
