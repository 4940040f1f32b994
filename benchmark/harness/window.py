"""The measured window and the statistics of its jobs.

Jobs run back to back in a closed loop: a user waits for one before
asking for the next.  The window starts before the first job and ends
at the synchronisation that ends the last one, which may overrun the
window's length; only jobs that completed count.
"""

from __future__ import annotations

import math
import time


def closed_loop(job, seconds, clock=time.perf_counter):
    """Run ``job(i)`` for i = 0, 1, ... until `seconds` have passed at a
    job's end (each job ends synchronised).  Returns (jobs done, the
    window's seconds, each job's seconds)."""
    times = []
    start = last = clock()
    while True:
        job(len(times))
        now = clock()
        times.append(now - last)
        last = now
        if now - start >= seconds:
            return len(times), now - start, times


def rate(units, seconds):
    """All the window's work over all its time."""
    return units / seconds


def quantile(values, q):
    """The q-quantile of `values` by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values, q):
    """How many of `values` lie above their q-quantile."""
    cut = quantile(values, q)
    return sum(v > cut for v in values)
