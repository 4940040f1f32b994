"""The comparison that decides a frame cell's ``correct``."""

from __future__ import annotations

import torch


def pixels_off(port_rad, port_depth, ref_rad, ref_depth, rtol, atol):
    """Share of pixels whose film sums are not the reference's: a bounce
    count that differs, a radiance channel that is not finite or lies
    beyond ``atol + rtol * |reference|`` (float32 sums of the same terms
    added in another order stay well inside)."""
    port = port_rad.to(torch.float64)
    ref = ref_rad.to(torch.float64)
    far = (port - ref).abs() > atol + rtol * ref.abs()
    off = (far.any(dim=1) | ~torch.isfinite(port).all(dim=1)
           | (port_depth.to(torch.int64) != ref_depth.to(torch.int64)))
    return off.to(torch.float64).mean().item()


def mean_radiance_gap(port_rad, ref_rad):
    """|sum of the port's radiance - the reference's| over the
    reference's, over every channel of the compared pixels: a bias
    that moves every pixel a little, which no single pixel shows."""
    port = port_rad.to(torch.float64).sum()
    ref = ref_rad.to(torch.float64).sum()
    return (abs(port - ref) / ref).item()
