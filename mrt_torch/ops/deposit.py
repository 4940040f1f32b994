"""Kernels B2, film segment-add ``film[idx[p]] += vals[p]``, and B4,
the pend film mode's masked deposit ``dest[slot[p]] += val[p]`` where
``die[p]``.

``deposit`` is B2's wrapper: on CPU tensors it runs the plain PyTorch
version ``deposit_plain``; on CUDA tensors it launches the CUDA kernel
``csrc/deposit.cu`` (which replaces the TPU kernels
``mrt/ops/pallas_onehot.py::onehot_deposit`` and ``onehot_deposit_f32``)
or raises.  ``deposit_pending`` is B4's, with ``deposit_pending_plain``,
in the same way (it replaces ``mrt/ops/pallas_deposit.py::deposit_add``).
``deposit.launches`` and ``deposit_pending.launches`` count kernel
launches.

Every version adds into its destination in place and returns it.  Lanes
whose index lies outside [0, n_rows) are dropped; with B2's
``drop_nonfinite``, non-finite values are skipped (added as nothing).
"""

from __future__ import annotations

import torch

from . import _build


def deposit_plain(film, idx, vals, drop_nonfinite=False):
    """Plain PyTorch version: ``index_add_`` of every lane, a dropped lane
    or value adding an exact zero to row 0.  It never syncs with the
    device."""
    keep = (idx >= 0) & (idx < film.shape[0])
    v = torch.where(keep[:, None], vals, 0.0)
    if drop_nonfinite:
        v = torch.where(torch.isfinite(v), v, 0.0)
    rows = torch.where(keep, idx, 0).to(torch.int64)
    return film.index_add_(0, rows, v)


def _check(film, idx, vals):
    if film.dim() != 2 or vals.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"deposit: film {tuple(film.shape)}, idx "
                         f"{tuple(idx.shape)}, vals {tuple(vals.shape)}: "
                         "expected (R, C), (P,), (P, C)")
    if vals.shape != (idx.shape[0], film.shape[1]):
        raise ValueError(f"deposit: vals {tuple(vals.shape)} does not match "
                         f"idx {tuple(idx.shape)} and film "
                         f"{tuple(film.shape)}")
    if film.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"deposit: film {film.dtype} and vals {vals.dtype} "
                        "must be float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"deposit: idx is {idx.dtype}, not int32")
    if not (film.device == idx.device == vals.device):
        raise ValueError(f"deposit: film on {film.device}, idx on "
                         f"{idx.device}, vals on {vals.device}")
    for name, x in (("film", film), ("idx", idx), ("vals", vals)):
        if not x.is_contiguous():
            raise ValueError(f"deposit: {name} is not contiguous")


def deposit(film, idx, vals, drop_nonfinite=False):
    """film (R, C) float32 += segment-sum of vals (P, C) float32 by
    idx (P,) int32.  In place; returns film."""
    _check(film, idx, vals)
    if film.device.type == "cpu":
        return deposit_plain(film, idx, vals, drop_nonfinite)
    if film.device.type != "cuda":
        raise ValueError(f"deposit: no kernel for device {film.device}")
    _build.launch("mrt_deposit", film.device, film, film.shape[0],
                  film.shape[1], idx, vals, idx.shape[0],
                  int(drop_nonfinite))
    deposit.launches += 1
    return film


deposit.launches = 0


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
    _check(dest, slot, val)
    if die.dtype != torch.bool or die.shape != slot.shape:
        raise TypeError(f"deposit_pending: die is {die.dtype} "
                        f"{tuple(die.shape)}, not bool {tuple(slot.shape)}")
    if die.device != dest.device or not die.is_contiguous():
        raise ValueError(f"deposit_pending: die on {die.device}, "
                         f"contiguous {die.is_contiguous()}")
    if dest.shape[1] != 4:
        raise ValueError(f"deposit_pending: dest {tuple(dest.shape)} is not "
                         "(R, 4)")
    if dest.device.type == "cpu":
        return deposit_pending_plain(dest, slot, val, die)
    if dest.device.type != "cuda":
        raise ValueError(f"deposit_pending: no kernel for device "
                         f"{dest.device}")
    _build.launch("mrt_deposit_pending", dest.device, dest, dest.shape[0],
                  slot, val, die, slot.shape[0])
    deposit_pending.launches += 1
    return dest


deposit_pending.launches = 0
