"""The port's tracer, and render statistics (``trace``, ``RenderStats``,
``stats_from_film`` and ``Timer`` mirror ``mrt.utils.profiling``).

The tracer has two tiers.

Coarse, always on.  Counters (``count``); each hand kernel's launches by
id (``launch_counts``, which ``ops._build.launch`` adds to); the
device-to-host reads of the frame, gradient and image paths, all through
``to_host``, counted with the nanoseconds the host was blocked in them,
by site; and one record a unit of work (``unit``): a persistent pass, a
gradient step, a scene build, the kernels' library load.  A record holds
the unit's wall ns, the reads made inside it by site (``syncs``,
``sync_ns``), Python's garbage collections and their ns, the ns of its
timed parts (``part``, by name), whether a ``torch.profiler`` session
was recording (``profiled``), and the fields its code adds.  The newest
``KEEP`` records of each kind are kept; ``snapshot()`` returns them with
the counters and each hand kernel's launch count.  The coarse tier costs
a few clock reads and dict updates a unit or a termination check: no
launch and no sync.

Fine, only inside ``tracing()``: spans, each a name, start and end ns
on ``time.time_ns()`` (the clock of the profiler's events, so spans and
device events line up without conversion), its enclosing span and the
unit it ran in.  Outside, a span site costs one check of a module
variable.  ``tracing(ranges=True)`` also opens a ``torch.profiler``
range for each span, so that a profiler's trace shows the program's
layers; nothing opens one otherwise.  ``trace(log_dir)`` (the CLI's
``--profile-dir``) records a ``torch.profiler`` trace with those ranges
and writes ``trace.json``, ``spans.json`` (Chrome trace events on the
Unix clock, in µs) and ``counters.json`` (``snapshot()``).

Spans: ``step``, ``L1 make_rays``, ``L2 intersect``, ``L2v voxel DDA``,
``L3 shade_hit``, ``L3 background``, ``L3n sample_direct``,
``L4 deposit``, ``L4 deposit_pending``, ``termination check`` and
``L5s lane sorter`` in a persistent pass; ``grad apply`` (with
``B1 group build`` under it), ``grad forward``, ``grad loss``,
``grad backward`` and ``grad adam`` in a gradient step; ``scene build``
(with ``BVH build``, ``B1 group build``, ``table upload`` and, for a
scene asked for next-event estimation, ``light table``),
``AOV pre-pass``, ``render pass``, ``denoiser``, ``png_encode`` and
``PNG write`` in an image; ``all_reduce`` across ranks.  The tracer
assumes one thread.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import time

import torch

# Records kept of each kind, the newest.
KEEP = 512
KINDS = ("pass", "grad_step", "scene_build", "library")

counters = {}
# Each hand kernel's launches so far, by id: ``ops._build`` enters the
# ids of its kernel table and counts every launch here.
launch_counts = {}
_syncs = {}                      # site -> [reads, ns blocked]
_records = {kind: collections.deque(maxlen=KEEP) for kind in KINDS}
_open = []                       # the units in progress, innermost last
_ids = itertools.count(1)
_gc = [0, 0, 0]                  # collections, their ns, the open one's start
_tracing = None                  # the open ``tracing`` session, or None


def _on_gc(phase, info):
    if phase == "start":
        _gc[2] = time.time_ns()
    else:
        _gc[0] += 1
        _gc[1] += time.time_ns() - _gc[2]


gc.callbacks.append(_on_gc)


def count(name, n=1):
    """Add `n` to the counter `name`."""
    counters[name] = counters.get(name, 0) + n


def profiler_on():
    """Whether a ``torch.profiler`` session is recording (the module flag
    torch keeps for such checks)."""
    flag = getattr(torch.autograd.profiler, "_is_profiler_enabled", None)
    return torch.autograd._profiler_enabled() if flag is None else flag


def to_host(x, site):
    """`x` copied to the host (itself on the CPU): the one device-to-host
    read of the frame, gradient and image paths.  Counts the read under
    `site`, with the ns the host was blocked in it."""
    t0 = time.time_ns()
    out = x.to("cpu")
    ns = time.time_ns() - t0
    tally = _syncs.get(site)
    if tally is None:
        tally = _syncs[site] = [0, 0]
    tally[0] += 1
    tally[1] += ns
    return out


def device_allocs(device):
    """The caching allocator's count of device allocations so far on a
    CUDA `device`; None elsewhere."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.memory_stats_as_nested_dict(device).get(
        "num_device_alloc")


@contextlib.contextmanager
def unit(kind, **fields):
    """Record the block as one unit of work of `kind` (``KINDS``); yields
    the record, which the block may add fields to.  The record is kept
    when the block ends without raising."""
    rec = dict(fields, kind=kind, id=next(_ids), profiled=profiler_on(),
               parts={})
    before = {site: tuple(t) for site, t in _syncs.items()}
    gc0, gc_ns0 = _gc[0], _gc[1]
    _open.append(rec)
    rec["start_ns"] = time.time_ns()
    try:
        yield rec
    finally:
        _open.pop()
    rec["wall_ns"] = time.time_ns() - rec["start_ns"]
    rec["syncs"], rec["sync_ns"] = {}, {}
    for site, (n, ns) in _syncs.items():
        n0, ns0 = before.get(site, (0, 0))
        if n > n0:
            rec["syncs"][site] = n - n0
            rec["sync_ns"][site] = ns - ns0
    rec["gc_collections"] = _gc[0] - gc0
    rec["gc_ns"] = _gc[1] - gc_ns0
    _records[kind].append(rec)


@contextlib.contextmanager
def part(name):
    """Add the block's ns to the innermost unit's ``parts[name]``; a span
    too when tracing."""
    t0 = time.time_ns()
    with span(name):
        yield
    if _open:
        parts = _open[-1]["parts"]
        parts[name] = parts.get(name, 0) + time.time_ns() - t0


class _Tracing:
    """An open ``tracing`` session: its spans, in the order they began."""

    def __init__(self, ranges):
        self.ranges = ranges
        self.spans = []
        self.stack = []          # indices of the open spans


class _Span:
    __slots__ = ("session", "name", "index", "range")

    def __init__(self, session, name):
        self.session, self.name = session, name

    def __enter__(self):
        s = self.session
        self.index = len(s.spans)
        s.spans.append(dict(
            name=self.name, start_ns=time.time_ns(), end_ns=None,
            parent=s.stack[-1] if s.stack else None,
            unit=_open[-1]["id"] if _open else None))
        s.stack.append(self.index)
        self.range = None
        if s.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        s = self.session
        s.spans[self.index]["end_ns"] = time.time_ns()
        s.stack.pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name):
    """A context manager recording the block as the span `name` inside
    ``tracing()``; a shared no-op outside it."""
    if _tracing is None:
        return _NO_SPAN
    return _Span(_tracing, name)


def spanned(name):
    """Decorator: each call of the function is the span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _tracing is None:
                return fn(*args, **kwargs)
            with _Span(_tracing, name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


@contextlib.contextmanager
def tracing(ranges=False):
    """Record spans inside the block; yields the session, whose
    ``spans`` lists them as dicts (name, start_ns, end_ns, parent: the
    enclosing span's index, unit: the id of the unit it ran in).
    ranges=True also opens a ``torch.profiler`` range for each."""
    global _tracing
    outer, _tracing = _tracing, _Tracing(ranges)
    try:
        yield _tracing
    finally:
        _tracing = outer


def kernel_launches():
    """Each hand kernel's launches so far, by id."""
    return dict(launch_counts)


def snapshot():
    """The coarse tier's state: counters, host reads and their ns by
    site, the gc's collections and ns, each hand kernel's launches, and
    the kept records of each kind (a list under the kind's name, oldest
    first)."""
    out = dict(counters=dict(counters),
               host_syncs={site: t[0] for site, t in _syncs.items()},
               host_sync_ns={site: t[1] for site, t in _syncs.items()},
               gc_collections=_gc[0], gc_ns=_gc[1],
               kernels=kernel_launches())
    for kind, recs in _records.items():
        out[kind] = [dict(r) for r in recs]
    return out


def reset():
    """Clear the counters, the host reads' tallies and the records."""
    counters.clear()
    _syncs.clear()
    for recs in _records.values():
        recs.clear()


def write(log_dir, session):
    """``spans.json`` (the session's spans as Chrome trace events, ts and
    dur in µs of the Unix clock) and ``counters.json`` (``snapshot()``)
    into `log_dir`."""
    os.makedirs(log_dir, exist_ok=True)
    events = [dict(name=s["name"], ph="X", ts=s["start_ns"] / 1e3,
                   dur=(s["end_ns"] - s["start_ns"]) / 1e3, pid=os.getpid(),
                   tid=0, args=dict(index=i, parent=s["parent"],
                                    unit=s["unit"]))
              for i, s in enumerate(session.spans) if s["end_ns"] is not None]
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms"), f)
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(snapshot(), f)


@contextlib.contextmanager
def trace(log_dir=None):
    """A torch.profiler trace of the block, with the program's spans as
    its ranges, written to ``log_dir/trace.json`` beside ``spans.json``
    and ``counters.json`` (``write``); no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing(ranges=True) as session, \
            profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    write(log_dir, session)


@dataclasses.dataclass
class RenderStats:
    """Per-render statistics derived from the film."""
    samples: int
    camera_rays: int
    path_segments: int      # camera rays + scatter events
    mean_path_length: float
    wall_seconds: float

    @property
    def rays_per_sec(self):
        return self.camera_rays / max(self.wall_seconds, 1e-9)

    @property
    def segments_per_sec(self):
        return self.path_segments / max(self.wall_seconds, 1e-9)

    def __str__(self):
        return (f"{self.samples} spp, "
                f"{self.camera_rays / 1e6:.2f}M camera rays, "
                f"mean path {self.mean_path_length:.2f}, "
                f"{self.rays_per_sec / 1e6:.2f}M rays/s, "
                f"{self.segments_per_sec / 1e6:.2f}M segments/s")


def stats_from_film(film, wall_seconds):
    """RenderStats of an accumulated film."""
    samples = int(film.samples)
    camera_rays = film.width * film.height * samples
    segments = camera_rays + int(film.depth_sum.sum())
    return RenderStats(
        samples=samples,
        camera_rays=camera_rays,
        path_segments=segments,
        mean_path_length=segments / max(camera_rays, 1),
        wall_seconds=wall_seconds,
    )


class Timer:
    """Wall-clock segment timer with named laps."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps = {}

    def lap(self, name):
        now = time.perf_counter()
        self.laps[name] = now - self.t0
        self.t0 = now
        return self.laps[name]
