"""Counter-based, order-invariant RNG (PCG4D) for wavefront path tracing.

Every draw is a pure hash of ``(seed, ray_id, salt, draw)``, so renders
are identical under any batching or lane order.  Bit-exact with
``mrt.math.rng``.

PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020) works on uint32 with wrap-around.  PyTorch has no unsigned
right shift on every device, so values are carried as int64 holding
uint32 bit patterns in [0, 2^32).  Products are formed from 16-bit
halves so no intermediate leaves int64 range, and every result is
masked back to 32 bits.  A ``Sampler`` draws through R1's wrapper
(``ops/rng.py``): on CPU tensors its plain version, this emulation; on
CUDA tensors the kernel, which computes the same hash in native uint32,
one launch a draw in place of the emulation's ~137.
"""

from __future__ import annotations

import torch

from ..ops.rng import pcg4d_draw

MASK = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223
_INV_2_24 = 1.0 / 16777216.0


def u32(x, device=None):
    """Any int or integer tensor -> int64 tensor of its uint32 value.  An
    int is filled in on the device: copied from the host, it would
    synchronise the host with the card."""
    if not torch.is_tensor(x):
        return torch.full((), int(x) & MASK, dtype=torch.int64,
                          device=device)
    return x.to(torch.int64) & MASK


def mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors (or ints) holding uint32."""
    if not torch.is_tensor(b):
        b = int(b) & MASK
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(x, y, z, w):
    """PCG4D hash: four uint32 arrays (int64 carriers) -> four uint32
    arrays."""
    x = (mul32(x, _MUL) + _INC) & MASK
    y = (mul32(y, _MUL) + _INC) & MASK
    z = (mul32(z, _MUL) + _INC) & MASK
    w = (mul32(w, _MUL) + _INC) & MASK
    x = (x + mul32(y, w)) & MASK
    y = (y + mul32(z, x)) & MASK
    z = (z + mul32(x, y)) & MASK
    w = (w + mul32(y, z)) & MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + mul32(y, w)) & MASK
    y = (y + mul32(z, x)) & MASK
    z = (z + mul32(x, y)) & MASK
    w = (w + mul32(y, z)) & MASK
    return x, y, z, w


def to_unit_float(u):
    """uint32 -> float32 in [0, 1) from the top 24 bits."""
    return (u >> 8).to(torch.float32) * _INV_2_24


class Sampler:
    """Per-ray random stream indexed by (seed, ray_id, salt, draw).

    ``ray_id`` is a contiguous int64 tensor; ``seed`` an int or a 0-d
    int64 tensor; ``salt`` an int, or an int64 tensor of shape () or
    ray_id's.  The three are kept as given: each draw is one call of
    ``ops.rng.pcg4d_draw``, which takes their low 32 bits.  The draw
    counter lives on the host, so each call site gets its own stream.
    """

    def __init__(self, seed, ray_id, salt=0):
        self._draw = 0
        self.ray_id, self.seed, self.salt = ray_id, seed, salt

    def next4(self):
        """Four independent uniform [0, 1) float32 tensors, ray_id-shaped."""
        draw = self._draw & MASK
        self._draw += 1
        return pcg4d_draw(self.ray_id, self.seed, self.salt, draw).unbind(0)

    def next1(self):
        a, _, _, _ = self.next4()
        return a

    def skip(self, n=1):
        """Advance the draw counter without drawing, so later streams
        stay the same when a consumer is elided."""
        self._draw += n
