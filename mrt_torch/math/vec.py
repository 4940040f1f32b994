"""Batched 3-vector math on tensors of shape (..., 3).

Mirrors ``mrt.math.vec``.  Sums over the component axis are written
out left to right, ``(x + y) + z``, so every device computes them in
the same order as the reference.
"""

from __future__ import annotations

import torch

# The reference's near-zero epsilon.
NEAR_ZERO_EPS = 1e-5


def dot(a, b):
    """Component dot product over the trailing axis -> (...)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def sqrt(x):
    """Correctly rounded float32 square root.  PyTorch's vectorised CPU
    sqrt can miss the correctly rounded result by one ulp; on the CPU the
    root is taken in float64 and rounded once, which is exact for
    float32 inputs.  CUDA's sqrtf is correctly rounded already."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def div(x, s):
    """x / s for a Python number s, the true quotient on every device.
    CUDA divides a tensor by a host scalar as x * (1 / s), an ulp off the
    quotient on some inputs, where the CPU and the reference divide
    (ROADMAP C20); a 0-dim tensor on x's device is divided by."""
    return x / x.new_full((), float(s))


def clamp(x, lo=None, hi=None):
    """torch.clamp with the reference's derivative at a bound: jnp.clip,
    jnp.maximum and jnp.minimum pass half the gradient where x equals
    the bound, torch.clamp all of it.  The values are torch.clamp's."""
    y = torch.clamp(x, lo, hi)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return y
    tie = torch.zeros_like(x, dtype=torch.bool)
    for bound in (lo, hi):
        if bound is not None:
            tie = tie | (x == bound)
    return torch.where(tie, 0.5 * y + 0.5 * y.detach(), y)


def length_squared(a):
    return dot(a, a)


def length(a):
    return sqrt(length_squared(a))


def unit(a):
    """a / |a|, with no epsilon (a zero vector gives NaN, as in the
    reference)."""
    return a / length(a)[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def near_zero(a):
    """All components within eps of zero."""
    return torch.all(torch.abs(a) <= NEAR_ZERO_EPS, dim=-1)


def reflect(v, n):
    """Mirror reflect v about normal n."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(uv, n, etai_over_etat):
    """Snell refraction of the *unit* vector uv; ``etai_over_etat`` is
    (...)-shaped."""
    cos_theta = clamp(dot(-uv, n), hi=1.0)
    r_out_perp = (uv + n * cos_theta[..., None]) * etai_over_etat[..., None]
    k = torch.abs(1.0 - length_squared(r_out_perp))
    safe = sqrt(torch.where(k > 0.0, k, 1.0))
    r_out_parallel = n * -torch.where(k > 0.0, safe, 0.0)[..., None]
    return r_out_perp + r_out_parallel
