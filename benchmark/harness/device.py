"""The card a run measures: the check that it is there, its name, its
power limit and the peak of its memory.  A run without the cards its
cell asks for stops here; nothing falls back to the CPU."""

from __future__ import annotations

import subprocess
import sys
import time

import torch


class NoCard(SystemExit):
    """Raised where the cell's cards are not there (exit code 3)."""

    def __init__(self, message):
        print(f"benchmark: {message}", file=sys.stderr)
        super().__init__(3)


def require(chips):
    """The first card, or NoCard where CUDA or enough cards are
    missing."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stamp(dev):
    """A mark in time once the device has caught up with the host: a CUDA
    event, which the idle device passes as soon as it is queued, so the
    time between two marks is read on the device's clock (microseconds,
    where the host's clock is good to about half a millisecond); on the
    CPU, which only the tests drive, the host's clock."""
    sync(dev)
    if dev.type != "cuda":
        return time.perf_counter()
    mark = torch.cuda.Event(enable_timing=True)
    mark.record()
    return mark


def seconds_between(a, b):
    """Seconds from mark `a` to mark `b` (both of ``stamp``)."""
    if isinstance(a, float):
        return b - a
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def describe(dev, chips):
    """The result line's ``device``; the peak is of allocated bytes on
    the fullest card used."""
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=chips,
                    memory_peak_bytes=0)
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=chips, memory_peak_bytes=int(peak),
                power_limit=power_limit())


def power_limit():
    """The card's power limit as nvidia-smi reads it, or "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"
