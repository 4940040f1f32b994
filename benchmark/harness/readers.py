"""What the per-layer readers (``metrics/<name>.py``) share.  Each
returns None where its job left nothing to read: a range that never ran,
a run with no device time, a kernel that was not launched."""

from __future__ import annotations

from . import roofline


def range_ms(record, *names):
    """Device ms inside the named host ranges, summed; None where none
    of them ran or nothing ran on the device."""
    calls = record.get("range_calls", {})
    if not record.get("kernel_s") or not any(calls.get(n) for n in names):
        return None
    return sum(record["ranges_ms"][n] for n in names)


def kernel_share(record, kernel):
    """A kernel's share of its bytes bound, percent, over every call of
    the traced job."""
    ms = record.get("kernels_ms", {}).get(kernel)
    moved = record.get("kernel_bytes", {}).get(kernel)
    if not ms or not moved:
        return None
    return roofline.share(moved, ms / 1e3, record["kind"])
