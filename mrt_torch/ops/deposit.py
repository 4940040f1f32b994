"""Kernels B2, film segment-add ``film[idx[p]] += vals[p]``, and B4,
the pend film mode's masked deposit ``dest[slot[p]] += val[p]`` where
``die[p]``.

``deposit`` is B2's wrapper: on CPU tensors it runs the plain PyTorch
version ``deposit_plain``; on CUDA tensors it launches the CUDA kernel
``csrc/deposit.cu`` (which replaces the TPU kernels
``mrt/ops/pallas_onehot.py::onehot_deposit`` and ``onehot_deposit_f32``)
or raises.  ``deposit_pending`` is B4's, with ``deposit_pending_plain``,
in the same way (it replaces ``mrt/ops/pallas_deposit.py::deposit_add``;
its kernel is B2's at 4 columns, the die flags as the mask).  A row of
4 floats moves as one 16-byte vector (of 2, as 8 bytes), so on the card
both wrappers raise on a film or values not aligned to it.

Every version adds into its destination in place and returns it.  Lanes
whose index lies outside [0, n_rows), or that are unset in B2's optional
``mask``, are dropped; with B2's ``drop_nonfinite``, a non-finite value
adds +0.0 in its place.
"""

from __future__ import annotations

import torch

from . import _build


def deposit_plain(film, idx, vals, drop_nonfinite=False, mask=None):
    """Plain PyTorch version: ``index_add_`` of every lane, a dropped lane
    or value adding an exact zero to row 0.  It never syncs with the
    device."""
    keep = (idx >= 0) & (idx < film.shape[0])
    if mask is not None:
        keep = keep & mask
    v = torch.where(keep[:, None], vals, 0.0)
    if drop_nonfinite:
        v = torch.where(torch.isfinite(v), v, 0.0)
    rows = torch.where(keep, idx, 0).to(torch.int64)
    return film.index_add_(0, rows, v)


def _check(film, idx, vals):
    """Raise on what the kernels do not take; returns the device."""
    rows, lanes, shape = film.shape, idx.shape, vals.shape
    if len(rows) != 2 or len(shape) != 2 or len(lanes) != 1:
        raise ValueError(f"deposit: film {tuple(rows)}, idx {tuple(lanes)}, "
                         f"vals {tuple(shape)}: expected (R, C), (P,), (P, C)")
    if shape != (lanes[0], rows[1]):
        raise ValueError(f"deposit: vals {tuple(shape)} does not match idx "
                         f"{tuple(lanes)} and film {tuple(rows)}")
    if film.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"deposit: film {film.dtype} and vals {vals.dtype} "
                        "must be float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"deposit: idx is {idx.dtype}, not int32")
    if not 1 <= rows[1] <= _build.MAX_COLS:
        raise ValueError(f"deposit: {rows[1]} columns; the kernel takes 1 to "
                         f"{_build.MAX_COLS}")
    device = film.device
    if idx.device != device or vals.device != device:
        raise ValueError(f"deposit: film on {device}, idx on {idx.device}, "
                         f"vals on {vals.device}")
    for name, x in (("film", film), ("idx", idx), ("vals", vals)):
        if not x.is_contiguous():
            raise ValueError(f"deposit: {name} is not contiguous")
    return device


def deposit(film, idx, vals, drop_nonfinite=False, mask=None):
    """film (R, C) float32 += segment-sum of vals (P, C) float32 by
    idx (P,) int32, over the lanes set in mask (P,) bool if given.  In
    place; returns film."""
    device = _check(film, idx, vals)
    _build.check_mask("deposit", mask, idx.shape, device)
    if device.type == "cpu":
        return deposit_plain(film, idx, vals, drop_nonfinite, mask)
    if device.type != "cuda":
        raise ValueError(f"deposit: no kernel for device {device}")
    n_rows, cols = film.shape
    _build.check_aligned("deposit", cols, film=film, vals=vals)
    _build.launch("mrt_deposit", device, film, n_rows, cols, idx, mask, vals,
                  idx.shape[0], int(drop_nonfinite))
    return film


def deposit_pending_plain(dest, slot, val, die):
    """Plain PyTorch version of B4: ``index_add_`` of the lanes that die
    with a nonzero value (every other lane adds an exact zero to row 0;
    never a device sync)."""
    keep = (die & (val != 0.0).any(dim=1) & (slot >= 0)
            & (slot < dest.shape[0]))
    v = torch.where(keep[:, None], val, 0.0)
    rows = torch.where(keep, slot, 0).to(torch.int64)
    return dest.index_add_(0, rows, v)


def deposit_pending(dest, slot, val, die):
    """dest (R, 4) float32 += val (P, 4) float32 at rows slot (P,) int32
    of the lanes where die (P,) bool, skipping lanes whose four values
    are all zero.  In place; returns dest."""
    device = _check(dest, slot, val)
    if die.dtype != torch.bool or die.shape != slot.shape:
        raise TypeError(f"deposit_pending: die is {die.dtype} "
                        f"{tuple(die.shape)}, not bool {tuple(slot.shape)}")
    if die.device != device or not die.is_contiguous():
        raise ValueError(f"deposit_pending: die on {die.device}, "
                         f"contiguous {die.is_contiguous()}")
    if dest.shape[1] != 4:
        raise ValueError(f"deposit_pending: dest {tuple(dest.shape)} is not "
                         "(R, 4)")
    if device.type == "cpu":
        return deposit_pending_plain(dest, slot, val, die)
    if device.type != "cuda":
        raise ValueError(f"deposit_pending: no kernel for device {device}")
    _build.check_aligned("deposit_pending", 4, dest=dest, val=val)
    _build.launch("mrt_deposit_pending", device, dest, dest.shape[0],
                  slot, val, die, slot.shape[0])
    return dest
