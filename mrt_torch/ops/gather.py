"""Kernel B3: row gather, ``out[p] = table[idx[p]]``, 0 out of range.

``gather`` is the wrapper: on CPU tensors it runs the plain PyTorch
version ``gather_plain``; on CUDA tensors it launches the CUDA kernel
``csrc/gather.cu`` (which replaces the TPU kernel
``mrt/ops/pallas_onehot.py::onehot_gather``) or raises.
``gather.launches`` counts kernel launches.  Both copy values, so they
agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build


def gather_plain(table, idx):
    """Plain PyTorch version: where(valid, table[clamp(idx)], 0)."""
    valid = (idx >= 0) & (idx < table.shape[0])
    rows = torch.clamp(idx, 0, table.shape[0] - 1).to(torch.int64)
    return torch.where(valid[:, None], table[rows], 0.0)


def _check(table, idx):
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}: expected (K, C), (P,)")
    if table.dtype != torch.float32:
        raise TypeError(f"gather: table is {table.dtype}, not float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather: idx is {idx.dtype}, not int32")
    if table.device != idx.device:
        raise ValueError(f"gather: table on {table.device}, idx on "
                         f"{idx.device}")
    for name, x in (("table", table), ("idx", idx)):
        if not x.is_contiguous():
            raise ValueError(f"gather: {name} is not contiguous")


def gather(table, idx):
    """Rows of table (K, C) float32 at idx (P,) int32 -> (P, C); lanes
    with idx outside [0, K) get zeros."""
    _check(table, idx)
    if idx.device.type == "cpu":
        return gather_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"gather: no kernel for device {idx.device}")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32,
                      device=idx.device)
    _build.launch("mrt_gather", idx.device, table, table.shape[0],
                  table.shape[1], idx, idx.shape[0], out)
    gather.launches += 1
    return out


gather.launches = 0
