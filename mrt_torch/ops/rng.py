"""Kernel R1, the sampler's draw (``csrc/rng.cu``): the four uniform
floats of one ``Sampler.next4`` in one launch.

``pcg4d_draw(ray_id, seed, salt, draw)`` returns a (4, *ray_id.shape)
float32 tensor whose rows are the draws of ``math.rng.Sampler(seed,
ray_id, salt)`` at draw counter `draw`, bit for bit.  On CPU tensors it
runs its plain version ``pcg4d_draw_plain``, the int64 emulation of
``math/rng.py``; on CUDA tensors it launches the kernel; it raises on
any other device.

ray_id: a contiguous int64 tensor; seed: an int or a 0-d int64 tensor;
salt: an int, or an int64 tensor of shape () or ray_id's; draw: an int.
The kernel takes each value's low 32 bits.  A tensor seed or salt is
read from device memory, so a CUDA graph can replay the draw with new
values.  R1 replaces no Pallas kernel (the reference draws in XLA).
"""

from __future__ import annotations

import torch

from . import _build

MASK = 0xFFFFFFFF


def pcg4d_draw_plain(ray_id, seed, salt, draw):
    """Plain PyTorch version of R1, on any device: ``math.rng.pcg4d``
    on int64 carriers, its four rows stacked."""
    from ..math.rng import pcg4d, to_unit_float, u32

    ids = u32(ray_id)
    seed, salt = u32(seed, ids.device), u32(salt, ids.device)
    draw = int(draw) & MASK
    y = (salt + ((0x9E3779B9 * draw) & MASK)) & MASK
    w = ((seed << 8) & MASK) ^ draw
    hashes = pcg4d(ids, y.expand_as(ids), seed.expand_as(ids),
                   w.expand_as(ids))
    return torch.stack([to_unit_float(u) for u in hashes])


def _value(fn, name, x, device, shape=()):
    """(tensor, int) for an argument the kernel reads from memory or
    takes as a value; raises on a tensor it does not take."""
    if not isinstance(x, torch.Tensor):
        return None, int(x) & MASK
    if x.dtype != torch.int64:
        raise TypeError(f"{fn}: {name} is {x.dtype}, not torch.int64")
    if x.device != device or (x.shape != () and x.shape != shape):
        raise ValueError(f"{fn}: {name} {tuple(x.shape)} on {x.device}, "
                         f"expected () or {tuple(shape)} on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")
    return x, 0


def pcg4d_draw(ray_id, seed, salt, draw):
    """R1: (4, *ray_id.shape) float32, the four draws of every lane.
    Raises on an argument it does not take (TypeError on a dtype,
    ValueError on a shape, device or layout), then on a device with no
    kernel."""
    device = ray_id.device
    if ray_id.dtype != torch.int64:
        raise TypeError(f"pcg4d_draw: ray_id is {ray_id.dtype}, not "
                        "torch.int64")
    if not ray_id.is_contiguous():
        raise ValueError("pcg4d_draw: ray_id is not contiguous")
    seed_t, seed_v = _value("pcg4d_draw", "seed", seed, device)
    salt_t, salt_v = _value("pcg4d_draw", "salt", salt, device, ray_id.shape)
    if device.type == "cpu":
        return pcg4d_draw_plain(ray_id, seed, salt, draw)
    if device.type != "cuda":
        raise ValueError(f"pcg4d_draw: no kernel for device {device}")
    out = torch.empty((4, *ray_id.shape), dtype=torch.float32, device=device)
    _build.launch("mrt_pcg4d", device, ray_id, ray_id.numel(), seed_t, seed_v,
                  salt_t, int(salt_t is not None and salt_t.dim() > 0),
                  salt_v, int(draw) & MASK, out)
    return out
