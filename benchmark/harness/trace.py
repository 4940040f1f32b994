"""The traced run's instruments and the reading of its profile.

Ranges are put around the program's layers from outside, as
``record_function`` wrappers installed for the traced job and removed
after it; the hand kernels are named by their device names.  ``LAYERS``,
``KERNELS`` and the idle share's arithmetic are frozen copies of
``mrt_torch/profile.py``'s, so that the yardstick does not move
with the program.  Two host ranges are added, the step and its
termination check, so that an idle gap on the device can be put down to
what the host was doing.  Taps record the bytes of each call of a
kernel whose roofline share is read (``roofline``).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import re

import numpy as np

from . import roofline

LAYERS = (
    # (range name, module path, attribute)
    ("L1 make_rays", "mrt_torch.integrator.persistent", "LanePool.make_rays"),
    ("L2 intersect", "mrt_torch.geometry.scene", "Scene.intersect"),
    ("L2v voxel DDA", "mrt_torch.geometry.voxels", "intersect"),
    ("L3 shade_hit", "mrt_torch.materials.shade", "shade_hit"),
    ("L3 background", "mrt_torch.geometry.scene",
     "Scene.background_eval_masked"),
    ("L3n sample_direct", "mrt_torch.materials.lights", "sample_direct"),
    ("L4 deposit", "mrt_torch.integrator.persistent", "deposit"),
    ("L4 deposit_pending", "mrt_torch.integrator.persistent",
     "deposit_pending"),
    ("L5s lane sorter", "mrt_torch.integrator.persistent", "sort_lanes"),
)
HOST = (
    ("step", "mrt_torch.integrator.persistent", "LanePool.step"),
    ("termination check", "mrt_torch.integrator.persistent",
     "LanePool.busy"),
)
# Each hand kernel's device name, a regular expression: B2 and B4 are
# instances of one template, deposit_kernel<C, drop, pend>, told apart by
# pend (demangled as the profiler shows it, or mangled).
KERNELS = {"B1": "nearest_t_kernel",
           "B2": r"deposit_kernel(<\d+, \w+, false>|ILi\d+ELb[01]ELb0E)",
           "B3": "row_gather_kernel",
           "B4": r"deposit_kernel(<4, false, true>|ILi4ELb0ELb1E)",
           "B5": "sphere_bvh_kernel", "B6": "tri_bvh_kernel",
           "B7": "tlas_kernel", "S1": "sort_key_kernel",
           "S2": "permute_lanes_kernel"}
# Kernels whose calls' bytes are recorded: (module, function, counter).
TAPS = {"B1": ("mrt_torch.ops.spheres", "nearest_t", roofline.b1_bytes),
        "B5": ("mrt_torch.ops.bvh", "sphere_bvh_hit", roofline.b5_bytes)}
TOP = 10


def events(prof):
    """A finished profile's raw events (``_KinetoEvent``s).  They are read
    as they are: building the profiler's own event tree takes minutes at
    a pass's millions of events."""
    return prof.profiler.kineto_results.events()


def on_device(event):
    return str(event.device_type()).endswith("CUDA")


def owner(module, attr):
    """(the object holding `attr` of `module`, its last name)."""
    owner = importlib.import_module(module)
    *path, leaf = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, leaf


@contextlib.contextmanager
def instrumented(tally, ranges=LAYERS + HOST, taps=TAPS):
    """Install the ranges (each also counts its calls in
    ``tally["calls"]``) and the taps (bytes a kernel's calls move, in
    ``tally["bytes"]``); restore the functions on exit."""
    from torch.profiler import record_function

    calls = tally.setdefault("calls", {})
    moved = tally.setdefault("bytes", {})

    # functools.wraps keeps a function's attributes, such as the launch
    # counters that the port's kernel wrappers bump through their own
    # module's name, which is the wrapper while it is installed.
    def ranged(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    def tapped(name, fn, count):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            moved[name] = moved.get(name, 0) + count(*args, **kwargs)
            return fn(*args, **kwargs)
        return wrapped

    saved = []
    try:
        for name, module, attr in ranges:
            owner_, leaf = owner(module, attr)
            saved.append((owner_, leaf, getattr(owner_, leaf)))
            setattr(owner_, leaf, ranged(name, getattr(owner_, leaf)))
        for name, (module, attr, count) in taps.items():
            owner_, leaf = owner(module, attr)
            saved.append((owner_, leaf, getattr(owner_, leaf)))
            setattr(owner_, leaf, tapped(name, getattr(owner_, leaf), count))
        yield tally
    finally:
        for obj, leaf, fn in reversed(saved):
            setattr(obj, leaf, fn)


@contextlib.contextmanager
def timed(dev, tally, parts):
    """Wrap each of `parts`, (name, object, attribute), so that its calls
    add their milliseconds to ``tally[name]``, each call between two
    marks taken once the device has caught up (``device.stamp``); restore
    the functions on exit."""
    from . import device

    def wrap(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = device.stamp(dev)
            out = fn(*args, **kwargs)
            ms = 1e3 * device.seconds_between(t0, device.stamp(dev))
            tally[name] = tally.get(name, 0.0) + ms
            return out
        return wrapped

    saved = [(obj, attr, getattr(obj, attr)) for _, obj, attr in parts]
    try:
        for name, obj, attr in parts:
            setattr(obj, attr, wrap(name, getattr(obj, attr)))
        yield tally
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def read(events, range_names):
    """The numbers of one profiled job from its raw events: device ms of
    the operations launched inside each host range (a launch is placed
    by the host time of the runtime call that made it, found by its
    correlation id: the hand kernels, launched through ctypes, belong to
    no PyTorch op), each hand kernel's ms, the count and
    seconds of every device operation, the device's busy seconds (the
    union of its operations' intervals), and the ``breakdown``: the
    device operations that took most time and the idle gaps summed by
    the innermost host range open at each gap's middle, "outside any
    range" where none was (the device's idle head and tail within the
    host's events count as gaps).  Times in ns; ``unplaced`` counts operations
    whose launch was not found (placed by their own start)."""
    names = set(range_names)
    host, launched, dev = [], {}, []
    first, last = None, None  # the host's first and last event
    for e in events:
        name = e.name()
        start = e.start_ns()
        if on_device(e):
            if name not in names:  # not a range's span on the device
                dev.append((start, start + e.duration_ns(), name,
                            e.correlation_id()))
            continue
        end = start + e.duration_ns()
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
        if name in names:
            host.append((start, end, name))
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            launched[e.correlation_id()] = start
    at = np.array([launched.get(c, s) for s, _, _, c in dev], np.int64)
    took = np.array([e - s for s, e, _, _ in dev], np.float64)
    ranges_ms = {}
    for name in range_names:
        iv = np.array(sorted((s, e) for s, e, n in host if n == name),
                      np.int64).reshape(-1, 2)
        i = np.searchsorted(iv[:, 0], at, side="right") - 1
        inside = (i >= 0) & (at < iv[np.maximum(i, 0), 1]) if len(iv) else \
            np.zeros(len(at), bool)
        ranges_ms[name] = float(took[inside].sum()) / 1e6
    ops = {}
    for (_, _, name, _), t in zip(dev, took):
        ops[name] = ops.get(name, 0.0) + t
    kernels_ms = {}
    for name, ns in ops.items():
        for k, pattern in KERNELS.items():
            if re.search(pattern, name):
                kernels_ms[k] = kernels_ms.get(k, 0.0) + ns / 1e6
    busy_ns, gaps = _busy_and_gaps([(s, e) for s, e, _, _ in dev], first,
                                   last)
    idle = _attribute(gaps, host)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        ranges_ms=ranges_ms, kernels_ms=kernels_ms, launches=len(dev),
        kernel_s=float(took.sum()) / 1e9, busy_s=busy_ns / 1e9,
        unplaced=sum(c not in launched for _, _, _, c in dev),
        breakdown=dict(
            device_ops=[[name[:120], ns / 1e9] for name, ns in top],
            idle_gaps=[[name, ns / 1e9] for name, ns in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]))


def _busy_and_gaps(spans, first=None, last=None):
    """(busy time, [(gap start, gap end)]) of device intervals; the idle
    time before the first and after the last of them, from the host's
    first event to its last, is a gap too (a job that ends on the host,
    such as an image's PNG encoder, leaves the device idle there)."""
    spans = sorted(spans)
    busy, gaps, end = 0.0, [], None
    if spans and first is not None and first < spans[0][0]:
        gaps.append((first, spans[0][0]))
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    if end is not None and last is not None and last > end:
        gaps.append((end, last))
    return busy, gaps


def _attribute(gaps, host, depth=8):
    """Gap time summed by the innermost host range holding its
    middle."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "outside any range"
        for j in range(i, max(i - depth, -1), -1):
            if host[j][1] > mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0.0) + (g1 - g0)
    return out
