"""Profiling and render statistics (mirrors ``mrt.utils.profiling``).

``trace`` records a ``torch.profiler`` trace (host and, with a card,
CUDA activity) and writes it as a Chrome trace, ``trace.json``, into its
directory.  A 1080p pass makes a trace of tens of MiB.  The statistics
are derived from the film.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir=None):
    """A torch.profiler trace of the block, written to
    ``log_dir/trace.json``; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
