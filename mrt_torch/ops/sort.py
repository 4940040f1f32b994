"""The lane coherence sorter's kernels: S1, the sort key, and S2, the
lane permutation (``csrc/sort.cu``).

The persistent pass (``integrator.persistent.make_sorter``) sorts its
pool of lanes by a 30-bit key so that neighbouring lanes, and so the
lanes of a warp, carry rays that start in one region and point one way:
6 bits an axis of the origin's cell over a box (the scene's bounds, or
the live origins' own), then 4 bits an axis of the unit direction's
cell, each triple interleaved as a Morton code.  Idle lanes get
``IDLE_KEY`` and sort last.  Between the two kernels ``torch.sort``
(stable) orders the keys, as ``jnp.argsort`` does in the reference
(``mrt/integrator/persistent.py::_make_sorter``), which computes the
whole sorter in XLA: no Pallas kernel is replaced.

``sort_keys`` and ``permute_lanes`` are the wrappers: on CPU tensors
they run their plain PyTorch versions ``sort_keys_plain`` and
``permute_lanes_plain``; on CUDA tensors they launch their kernels or
raise.  The kernels round like their plain versions, so both agree bit
for bit.

Keys are int32: an active key is below 2^30 and the idle key is
2^31 - 1, so their order is the reference's uint32 order with an idle
key of 0xFFFFFFFF.
"""

from __future__ import annotations

import torch

from . import _build

IDLE_KEY = 2 ** 31 - 1
ORIGIN_CELLS = 63.0     # the origin's cells an axis, less one (6 bits)
DIRECTION_CELLS = 15.0  # the direction's (4 bits)
# The per-lane columns of the persistent pool that S2 permutes; the pend
# film mode adds "acc".
COLUMNS = ("item", "bounce", "ray_id", "o", "d", "throughput", "prev_pdf")


def morton3(x, y, z):
    """Interleave three 6-bit integer coordinates into an 18-bit Morton
    code: bit b of x at 3b, of y at 3b + 1, of z at 3b + 2."""
    out = torch.zeros_like(x)
    for b in range(6):
        out = (out
               | (((x >> b) & 1) << (3 * b))
               | (((y >> b) & 1) << (3 * b + 1))
               | (((z >> b) & 1) << (3 * b + 2)))
    return out


def origin_box(lo, hi):
    """The origin cells over [lo, hi] as S1 reads them: (6,) float32, lo
    then inv = 63 / max(hi - lo, 1e-6), on the box's device.  inv is the
    true quotient, as the reference's: PyTorch computes ``63.0 / t`` as
    ``t.reciprocal() * 63``, an ulp off on some inputs, so a tensor is
    divided by a tensor."""
    ext = torch.clamp(hi - lo, min=1e-6)
    return torch.cat([lo, torch.full_like(ext, ORIGIN_CELLS) / ext])


def live_box(item, o, total):
    """``origin_box`` over the active lanes' origins (item < total): the
    reference's MRT_SORT_DYN=1 bounds, two masked reductions."""
    big = 3.4e38
    act = (item < total)[:, None]
    lo = torch.where(act, o, big).amin(0)
    hi = torch.where(act, o, -big).amax(0)
    return origin_box(lo, hi)


def rsqrt(x):
    """1 / sqrt(x) correctly rounded to float32: taken in float64 and
    rounded once (exact for every float32 in [1, 4), and so for every
    normal float32, since rsqrt(4x) = rsqrt(x) / 2)."""
    x = x.to(torch.float64)
    return (torch.ones_like(x) / torch.sqrt(x)).to(torch.float32)


def _cells(v, hi):
    """trunc(clip(v, 0, hi)) as int32, a NaN cell 0 (as XLA converts
    it)."""
    return torch.clamp(torch.nan_to_num(v, nan=0.0), 0.0, hi).to(torch.int32)


def sort_keys_plain(item, o, d, total, box):
    """Plain PyTorch version of S1: the int32 key of each lane (item
    (P,) int64, o, d (P, 3) float32), IDLE_KEY where item >= total; box
    (6,): the origin cells' lo and inv (``origin_box``)."""
    lo, inv = box[:3], box[3:]
    s = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    dn = d * rsqrt(torch.clamp(s, min=1e-20))[:, None]
    dcell = _cells((dn + 1.0) * 8.0, DIRECTION_CELLS)
    cell = _cells((o - lo) * inv, ORIGIN_CELLS)
    key = ((morton3(cell[:, 0], cell[:, 1], cell[:, 2]) << 12)
           | morton3(dcell[:, 0], dcell[:, 1], dcell[:, 2]))
    return torch.where(item < total, key, IDLE_KEY).to(torch.int32)


def _check_lanes(fn, **tensors):
    """Raise unless each (name: (tensor, dtype, trailing shape)) is
    contiguous, of its dtype and of P lanes on one device; returns the
    device."""
    device = lanes = None
    for name, (x, dtype, tail) in tensors.items():
        if x.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {x.dtype}, not {dtype}")
        if lanes is None:
            device, lanes = x.device, x.shape[0]
        if tuple(x.shape) != (lanes, *tail) or x.device != device:
            raise ValueError(f"{fn}: {name} {tuple(x.shape)} on {x.device}, "
                             f"expected {(lanes, *tail)} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    return device


def sort_keys(item, o, d, total, box):
    """S1: the int32 coherence key of each lane, as ``sort_keys_plain``.
    item (P,) int64; o, d (P, 3) float32; total: the pass's work items;
    box: (6,) float32 on the lanes' device (``origin_box``), which the
    kernel reads from device memory."""
    device = _check_lanes("sort_keys", item=(item, torch.int64, ()),
                          o=(o, torch.float32, (3,)),
                          d=(d, torch.float32, (3,)))
    if (box.dtype != torch.float32 or box.shape != (6,)
            or box.device != device or not box.is_contiguous()):
        raise ValueError(f"sort_keys: box {box.dtype} {tuple(box.shape)} on "
                         f"{box.device}, expected contiguous float32 (6,) "
                         f"on {device}")
    if device.type == "cpu":
        return sort_keys_plain(item, o, d, total, box)
    if device.type != "cuda":
        raise ValueError(f"sort_keys: no kernel for device {device}")
    lanes = item.shape[0]
    keys = torch.empty((lanes,), dtype=torch.int32, device=device)
    _build.launch("mrt_sort_keys", device, item, o, d, box, int(total), lanes,
                  keys)
    return keys


def permute_lanes_plain(perm, st):
    """Plain PyTorch version of S2: the lane state dict `st` with every
    per-lane column (COLUMNS, and "acc" if present) indexed by perm (P,)
    int64; other entries (the queue's next_work) as they are."""
    out = dict(st)
    for name in COLUMNS + (("acc",) if "acc" in st else ()):
        out[name] = st[name][perm]
    return out


def permute_lanes(perm, st):
    """S2: ``permute_lanes_plain`` in one launch.  perm (P,) int64, a
    permutation of the lanes; st: item, bounce, ray_id (P,) int64; o, d,
    throughput (P, 3), prev_pdf (P,) float32; optionally acc (P, 4)
    float32, 16-byte aligned (it moves as one float4)."""
    pend = "acc" in st
    i64, f32 = torch.int64, torch.float32
    spec = dict(perm=(perm, i64, ()), item=(st["item"], i64, ()),
                bounce=(st["bounce"], i64, ()),
                ray_id=(st["ray_id"], i64, ()), o=(st["o"], f32, (3,)),
                d=(st["d"], f32, (3,)),
                throughput=(st["throughput"], f32, (3,)),
                prev_pdf=(st["prev_pdf"], f32, ()))
    if pend:
        spec["acc"] = (st["acc"], f32, (4,))
    device = _check_lanes("permute_lanes", **spec)
    if device.type == "cpu":
        return permute_lanes_plain(perm, st)
    if device.type != "cuda":
        raise ValueError(f"permute_lanes: no kernel for device {device}")
    names = COLUMNS + (("acc",) if pend else ())
    if pend:
        _build.check_aligned("permute_lanes", 4, acc=st["acc"])
    out = dict(st)
    for name in names:
        out[name] = torch.empty_like(st[name])
    acc_in, acc_out = (st["acc"], out["acc"]) if pend else (None, None)
    _build.launch("mrt_permute_lanes", device, perm, perm.shape[0],
                  *(st[n] for n in COLUMNS), acc_in,
                  *(out[n] for n in COLUMNS), acc_out)
    return out
