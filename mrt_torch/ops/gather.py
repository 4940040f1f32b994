"""Kernel B3: row gather, ``out[p] = table[idx[p]]``, 0 on invalid lanes.

A lane is valid where ``0 <= idx[p] < K`` and, if a ``mask`` is given,
``mask[p]`` is set.  ``gather`` is the wrapper: on CPU tensors it runs the
plain PyTorch version ``gather_plain``; on CUDA tensors it launches the
CUDA kernel ``csrc/gather.cu`` (which replaces the TPU kernel
``mrt/ops/pallas_onehot.py::onehot_gather``) or raises.  Both copy
values, so they agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build


def gather_plain(table, idx, mask=None):
    """Plain PyTorch version: where(valid, table[clamp(idx)], 0)."""
    valid = (idx >= 0) & (idx < table.shape[0])
    if mask is not None:
        valid = valid & mask
    rows = torch.clamp(idx, 0, table.shape[0] - 1).to(torch.int64)
    return torch.where(valid[:, None], table[rows], 0.0)


def _check(table, idx, mask):
    """Raise on what the kernel does not take; returns the device."""
    shape, lanes = table.shape, idx.shape
    if len(shape) != 2 or len(lanes) != 1:
        raise ValueError(f"gather: table {tuple(shape)}, idx {tuple(lanes)}: "
                         "expected (K, C), (P,)")
    if table.dtype != torch.float32:
        raise TypeError(f"gather: table is {table.dtype}, not float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather: idx is {idx.dtype}, not int32")
    if not 1 <= shape[1] <= _build.MAX_COLS:
        raise ValueError(f"gather: {shape[1]} columns; the kernel takes 1 to "
                         f"{_build.MAX_COLS}")
    device = table.device
    if idx.device != device:
        raise ValueError(f"gather: table on {device}, idx on {idx.device}")
    for name, x in (("table", table), ("idx", idx)):
        if not x.is_contiguous():
            raise ValueError(f"gather: {name} is not contiguous")
    _build.check_mask("gather", mask, lanes, device)
    return device


def gather(table, idx, mask=None):
    """Rows of table (K, C) float32 at idx (P,) int32 -> (P, C); lanes
    with idx outside [0, K), or unset in mask (P,) bool if given, get
    zeros."""
    device = _check(table, idx, mask)
    if device.type == "cpu":
        return gather_plain(table, idx, mask)
    if device.type != "cuda":
        raise ValueError(f"gather: no kernel for device {device}")
    rows, cols = table.shape
    _build.check_aligned("gather", cols, table=table)
    lanes = idx.shape[0]
    out = torch.empty((lanes, cols), dtype=torch.float32, device=device)
    _build.launch("mrt_gather", device, table, rows, cols, idx, mask, lanes,
                  out)
    return out
