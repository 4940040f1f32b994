"""The card's peaks and the bytes a kernel call must move.

A kernel's roofline share is its least time (here bytes over the card's
memory bandwidth) over its device time.  The bytes are counted from each
call's shapes: its rays in, its scene tables and its winners out, each
once, whatever the kernel reads again.  No operation count is kept: a
nearest-hit search's operations depend on its algorithm, so a count of
one algorithm's work would read above 100% once a later one needs less.
"""

from __future__ import annotations

import torch

# Published peaks (NVIDIA's data sheet, SXM part, at the full 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12),
}


def peak(kind, what):
    """A peak of the card named `kind`, or None for a card not listed."""
    return PEAKS.get(kind, {}).get(what)


def nbytes(*xs):
    """Bytes of the tensors among `xs` (scalars move no bytes)."""
    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


def winners(n):
    """A nearest-hit call's output: t (float32) and index (int32) a ray."""
    return 8 * n


def b1_bytes(center, radius, o, d, t_min, t_max, groups=None):
    """B1 (``ops.spheres.nearest_t``): rays and bounds in, the group
    tables it walks (rows, index, boxes, order), winners out."""
    tables = groups[:4] if groups is not None else (center, radius)
    return nbytes(o, d, t_min, t_max, *tables) + winners(o.shape[0])


def b5_bytes(nodes, meta, sph, o, d, t_min, t_max, card=None):
    """B5 (``ops.bvh.sphere_bvh_hit``): rays and bounds in, the packed
    nodes and their octant orders and the sphere rows, winners out."""
    tables = card if card is not None else (nodes, meta)
    return nbytes(o, d, t_min, t_max, sph, *tables) + winners(o.shape[0])


def share(bytes_moved, device_s, kind):
    """Percent of the bytes bound in `device_s`, or None where the card
    has no listed peak or the kernel did not run."""
    bw = peak(kind, "hbm_bytes_per_s")
    if bw is None or not device_s:
        return None
    return 100.0 * bytes_moved / bw / device_s
