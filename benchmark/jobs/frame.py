"""Job kind ``frame``: final-frame passes.

Each job is one ``render_pass_persistent`` pass of the configuration's
frame at the traffic's samples a pixel, into a fresh film, with the
lane sorter as the traffic says (null: the port's auto rule).  Pass i
renders samples [i * spp, (i + 1) * spp) of the seed, as a progressive
render does.  After each pass the film's sums at a sample of pixels
drawn from the seed are kept; once the window has closed, a sample of
the passes (drawn from the seed) is checked against the plain tracer
(``reference/``).

Traffic parameters: spp, sort_rays, check_pixels (pixels kept a pass),
check_passes (passes checked), pixel_rtol, pixel_atol.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import device, trace
from benchmark.harness import window as loop
from benchmark.reference import compare, scenes, tracer


class State:
    def __init__(self, cell, seed, dev):
        from mrt_torch.scenes import get

        self.config, self.traffic = cell.config, cell.traffic
        self.folders = cell.spec.folders  # where the scene's recipe is
        c = self.config
        self.width, self.height = c["width"], c["height"]
        self.dev = dev
        self.scene, self.camera = get(c["scene"])(
            aspect_ratio=self.width / self.height,
            **c.get("scene_args", {})).generate(device=dev)
        self.kept = []
        self.reseed(seed)

    def reseed(self, seed):
        """Draw the render's seed and the pixels to keep from `seed`."""
        self.seed = seed
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.perm = torch.randperm(self.width * self.height, generator=gen,
                                   device=self.dev)
        self.kept = []

    def render(self, i, spp=None):
        """Pass i at `spp` samples a pixel (default: the traffic's)."""
        from mrt_torch.runtime.film import Film
        from mrt_torch.runtime.render import render_pass_persistent

        c, spp = self.config, spp or self.traffic["spp"]
        film = Film.create(self.width, self.height, device=self.dev)
        return render_pass_persistent(
            self.scene, self.camera, film, self.seed, i * spp,
            width=self.width, height=self.height, max_depth=c["max_depth"],
            samples=spp, pool=c["pool"], sort_rays=self.traffic["sort_rays"])

    def keep(self, i, film, k=None):
        """Keep pass i's sums at its `k` pixels (default: check_pixels)."""
        k = k or self.traffic["check_pixels"]
        n = self.perm.shape[0]
        at = (i * k + torch.arange(k, device=self.dev)) % n
        idx = self.perm[at]
        self.kept.append((i, idx, film.sum.reshape(-1, 3).index_select(0, idx),
                          film.depth_sum.reshape(-1).index_select(0, idx)))

    def rays(self, passes):
        return passes * self.width * self.height * self.traffic["spp"]


def setup(cell, seed, dev):
    state = State(cell, seed, dev)
    # Warm-up: the kernels' build and every shape a pass uses, which are
    # the lane pool's whatever the samples a pixel, so one sample will do.
    state.render(0, spp=1)
    device.sync(dev)
    return state


def window_job(state):
    def job(i):
        state.keep(i, state.render(i))
        device.sync(state.dev)
    return job


def window(state, seconds):
    done, secs, times = loop.closed_loop(window_job(state), seconds)
    return dict(values=dict(
        camera_rays_per_s=loop.rate(state.rays(done), secs)),
        attempted=done, failed=0, job_seconds=times)


def traced(state):
    """One pass timed without the profiler, then one under it."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    window_job(state)(0)
    pass_s = time.perf_counter() - t0
    tally = {}
    acts = [ProfilerActivity.CPU]
    if state.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with trace.instrumented(tally), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        film = state.render(1)
        device.sync(state.dev)
        profiled_s = time.perf_counter() - t0
    state.keep(1, film)
    names = [name for name, _, _ in trace.LAYERS + trace.HOST]
    rec = trace.read(trace.events(prof), names)
    record = dict(rec, pass_s=pass_s, profiled_pass_s=profiled_s,
                  steps=tally["calls"].get("step", 0),
                  range_calls=tally["calls"], kernel_bytes=tally["bytes"])
    return dict(record=record, busy_s=rec["busy_s"], window_s=profiled_s,
                breakdown=rec["breakdown"], attempted=2, failed=0)


def release(state):
    state.scene = state.camera = None
    if state.dev.type == "cuda":
        torch.cuda.empty_cache()


def check(state, dtype=torch.float32):
    """pixels_off_share and mean_radiance_gap over check_passes passes
    drawn from the seed."""
    t, c = state.traffic, state.config
    ref = scenes.build(c, state.dev, dtype, state.folders)
    film_at = scenes.own(c, "film_at", tracer.film_at, state.folders)
    gen = torch.Generator().manual_seed(state.seed)
    pick = torch.randperm(len(state.kept), generator=gen)[:t["check_passes"]]
    port_r, port_d, ref_r, ref_d = [], [], [], []
    for j in sorted(pick.tolist()):
        i, idx, rad, depth = state.kept[j]
        r, d = film_at(ref, idx, i * t["spp"], t["spp"], state.seed,
                       state.width, state.height, c["max_depth"], dtype)
        port_r.append(rad), port_d.append(depth)
        ref_r.append(r), ref_d.append(d)
    return readings(torch.cat(port_r), torch.cat(port_d), torch.cat(ref_r),
                    torch.cat(ref_d), t)


def readings(port_rad, port_depth, ref_rad, ref_depth, traffic):
    return dict(
        pixels_off_share=compare.pixels_off(
            port_rad, port_depth, ref_rad, ref_depth, traffic["pixel_rtol"],
            traffic["pixel_atol"]),
        mean_radiance_gap=compare.mean_radiance_gap(port_rad, ref_rad))


def sound_reading(state, seed):
    """One pass of `seed`, as many pixels compared as a run compares."""
    t = state.traffic
    state.reseed(seed)
    state.keep(0, state.render(0), k=t["check_pixels"] * t["check_passes"])
    return check(state)


def control_reading(state, seed):
    """The reference in bfloat16 in the program's place, at the pixels
    that `sound_reading` compares."""
    t, c = state.traffic, state.config
    state.reseed(seed)
    k = t["check_pixels"] * t["check_passes"]
    idx = state.perm[:k]
    args = (idx, 0, t["spp"], seed, state.width, state.height,
            c["max_depth"])
    film_at = scenes.own(c, "film_at", tracer.film_at, state.folders)
    ref = film_at(scenes.build(c, state.dev, folders=state.folders), *args)
    low = film_at(scenes.build(c, state.dev, torch.bfloat16, state.folders),
                  *args, dtype=torch.bfloat16)
    return readings(*low, *ref, t)
