"""Masked lane compaction (mirrors ``mrt.ops.compact``).

``compact_apply(fn, mask, x, K)`` evaluates a row-wise function on the
masked rows only: each round packs at most K masked rows of x, in lane
order, to the front of a (K, C) buffer (``compact_rows``: each row
placed at its prefix position by kernel B2, one value a row, so the sum
is exact), applies fn there, and scatters the results back to their
lanes (``expand_rows``: kernel B3).  Both kernels take the prefix
positions and the mask as they are and read no unmasked row, so a
non-finite value there cannot leak.  Values are copied, never combined,
so the result equals ``where(mask, fn(x), 0)`` row for row, except that
a non-finite fn output is dropped to 0, as in the reference.

The rounds are ceil(P / K), fixed on the host, so the loop never waits
for the device; a round with no masked rows left adds exact zeros.
"""

from __future__ import annotations

import torch

from .deposit import deposit
from .gather import gather

# A round's rows for a wavefront of P lanes: max(MIN_ROWS, P // 4),
# rounded up to a multiple of ROW_ALIGN (the reference's choice).
MIN_ROWS = 2048
ROW_ALIGN = 128


def rows_for(p):
    """Rows K of one compaction round for a wavefront of p lanes."""
    k = max(MIN_ROWS, p // 4)
    return -(-k // ROW_ALIGN) * ROW_ALIGN


def compact_rows(mask, x, k, pad_row=None):
    """Pack the masked rows of x (P, C) float32 into the front of a
    (k, C) buffer, in lane order.  Rows past the masked count hold
    `pad_row` (C values, default zeros): give a value on which the
    caller's function is finite.  Masked rows past the first k are
    dropped.  Returns (xc (k, C), pos (P,) int32 prefix positions, count
    () int32 masked rows)."""
    c = x.shape[1]
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    count = pos[-1] + 1
    xc = torch.zeros((k, c), dtype=torch.float32, device=x.device)
    deposit(xc, pos, x.contiguous(), mask=mask)
    covered = torch.arange(k, dtype=torch.int32, device=x.device) < count
    pad = 0.0 if pad_row is None else torch.as_tensor(
        pad_row, dtype=torch.float32, device=x.device)
    xc = torch.where(covered[:, None], xc, pad)
    return xc, pos, count


def expand_rows(y, pos, mask):
    """The inverse of compact_rows for per-row results y (k, C):
    out[p] = y[pos[p]] where mask[p] and pos[p] < k, else 0."""
    return gather(y.contiguous(), pos, mask=mask)


def compact_apply(fn, mask, x, k, pad_row=None):
    """where(mask, fn(x), 0) with fn evaluated on at most k compacted
    rows a round, ceil(P / k) rounds.  fn must be row-wise and take any
    row count; non-finite outputs become 0."""
    p = x.shape[0]
    x = x.contiguous()
    if pad_row is not None:  # one copy to the device for all rounds
        pad_row = torch.as_tensor(pad_row, dtype=torch.float32,
                                  device=x.device)
    rounds = -(-p // k)
    out = None
    m = mask.contiguous()
    for r in range(rounds):
        # The first k lanes left in m take positions 0..k-1; the kernels
        # drop the rest (pos >= k), which the next round takes.
        xc, pos, _ = compact_rows(m, x, k, pad_row=pad_row)
        y = fn(xc)
        y = torch.where(torch.isfinite(y), y, 0.0)
        g = expand_rows(y, pos, m)
        # 0.0 + g as the reference's zeros + g: -0.0 becomes +0.0.
        out = g + 0.0 if out is None else out + g
        if r + 1 < rounds:
            m = m & (pos >= k)
    return out
