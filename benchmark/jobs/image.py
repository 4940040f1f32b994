"""Job kind ``image``: the CLI's whole job, one image after another.

Each job is ``mrt_torch.runtime.driver.run(RenderConfig(...))`` in this
process: the scene's build, the AOV pre-pass, the passes, the denoiser
and the PNG written to one file under ``TMPDIR`` (each image overwrites
it).  Image i renders with seed ``seed + i``.  After each image the
film's sums and guides at a sample of pixels drawn from the seed are
kept, and the last image's whole film.

The check: the films at those pixels of check_images images (the last
one, and the others drawn from the seed) against the plain tracer, as
the frame cells check them; the guides there against the plain pre-pass
(``reference/aov.py``); and the last PNG, decoded (``reference/png.py``),
against the plain denoiser applied to the last film and its guides.
That last step follows the program from its own state (its film and
guides), whose two stages are checked above at that image's pixels.

Traffic parameters: spp, samples_per_pass, check_pixels, check_images,
pixel_rtol, pixel_atol, guide_atol, png (the file name).
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import device, trace
from benchmark.harness import window as loop
from benchmark.reference import aov, compare, denoise, png, scenes, tracer


class State:
    def __init__(self, cell, seed, dev):
        self.config, self.traffic = cell.config, cell.traffic
        self.folders = cell.spec.folders  # where the scene's recipe is
        self.width, self.height = self.config["width"], self.config["height"]
        self.dev = dev
        self.png = Path(os.environ.get("TMPDIR", tempfile.gettempdir()),
                        self.traffic["png"])
        self.reseed(seed)

    def reseed(self, seed):
        self.seed = seed
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.perm = torch.randperm(self.width * self.height, generator=gen,
                                   device=self.dev)
        self.kept, self.last = [], None

    def render(self, i):
        """Image i, the CLI's job; returns its film."""
        from mrt_torch.runtime.config import RenderConfig
        from mrt_torch.runtime.driver import run

        c, t = self.config, self.traffic
        config = RenderConfig(
            scene=c["scene"], width=self.width, height=self.height,
            max_depth=c["max_depth"], spp=t["spp"],
            samples_per_pass=t["samples_per_pass"], seed=self.seed + i,
            denoise=True, display_mode="denoise", output=str(self.png))
        return run(config, log=lambda *args, **kwargs: None, device=self.dev)

    def keep(self, i, film, k=None):
        k = k or self.traffic["check_pixels"]
        n = self.perm.shape[0]
        idx = self.perm[(i * k + torch.arange(k, device=self.dev)) % n]
        pick = lambda x, cols: x.reshape(-1, cols).index_select(0, idx)
        self.kept.append((i, idx, pick(film.sum, 3),
                          film.depth_sum.reshape(-1).index_select(0, idx),
                          pick(film.albedo, 3), pick(film.normal, 3)))
        self.last = (i, film)


def setup(cell, seed, dev):
    state = State(cell, seed, dev)
    state.render(0)  # warm-up: the kernels' build and every shape
    device.sync(dev)
    return state


def window_job(state):
    def job(i):
        state.keep(i, state.render(i))
        device.sync(state.dev)
    return job


def window(state, seconds):
    done, secs, times = loop.closed_loop(window_job(state), seconds)
    return dict(values=dict(image_s=secs / done), attempted=done, failed=0,
                job_seconds=times)


PARTS = (("render pass", "mrt_torch.runtime.render", "render_pass_persistent"),
         ("AOV pre-pass", "mrt_torch.runtime.render", "aov_pass"),
         ("denoiser", "mrt_torch.runtime.denoise", "denoise"),
         ("png_encode", "mrt_torch.runtime.io", "png_encode"))


def traced(state):
    """One image timed part by part, one timed whole, one profiled."""
    from torch.profiler import ProfilerActivity, profile

    parts = {}
    owned = [(name, *trace.owner(module, attr)) for name, module, attr in PARTS]
    with trace.timed(state.dev, parts, owned):
        window_job(state)(0)
    t0 = time.perf_counter()
    window_job(state)(1)
    image_s = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU]
    if state.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with trace.instrumented({}, ranges=PARTS, taps={}), \
            profile(activities=acts) as prof:
        t0 = time.perf_counter()
        film = state.render(2)
        device.sync(state.dev)
        profiled_s = time.perf_counter() - t0
    state.keep(2, film)
    rec = trace.read(trace.events(prof), [name for name, _, _ in PARTS])
    record = dict(rec, image_s=image_s, parts_ms=parts)
    return dict(record=record, busy_s=rec["busy_s"], window_s=profiled_s,
                breakdown=rec["breakdown"], attempted=3, failed=0)


def release(state):
    if state.dev.type == "cuda":
        torch.cuda.empty_cache()


def readings(state):
    """The numbers compared, of the films and guides kept and the last
    PNG."""
    t, c = state.traffic, state.config
    ref = scenes.build(c, state.dev, folders=state.folders)
    film_at = scenes.own(c, "film_at", tracer.film_at, state.folders)
    guides_at = scenes.own(c, "guides_at", aov.guides_at, state.folders)
    # The last image, whose PNG is checked, and others drawn from the seed.
    gen = torch.Generator().manual_seed(state.seed)
    last = len(state.kept) - 1
    pick = [last] + torch.randperm(last, generator=gen)[
        :t["check_images"] - 1].tolist()
    rows = {k: [] for k in ("rad", "depth", "alb", "nrm", "r_rad", "r_depth",
                            "r_alb", "r_nrm")}
    args = (state.width, state.height)
    for j in sorted(pick):
        i, idx, rad, depth, alb, nrm = state.kept[j]
        seed = state.seed + i
        r, d = film_at(ref, idx, 0, t["spp"], seed, *args, c["max_depth"])
        ra, rn = guides_at(ref, idx, seed, *args)
        for key, x in zip(rows, (rad, depth, alb, nrm, r, d, ra, rn)):
            rows[key].append(x)
    x = {k: torch.cat(v) for k, v in rows.items()}
    guide_far = torch.maximum(
        (x["alb"].double() - x["r_alb"].double()).abs().amax(dim=1),
        (x["nrm"].double() - x["r_nrm"].double()).abs().amax(dim=1))
    out = dict(
        pixels_off_share=compare.pixels_off(
            x["rad"], x["depth"], x["r_rad"], x["r_depth"], t["pixel_rtol"],
            t["pixel_atol"]),
        mean_radiance_gap=compare.mean_radiance_gap(x["rad"], x["r_rad"]),
        guides_off_share=(~(guide_far <= t["guide_atol"])).double().mean()
        .item())
    _, film = state.last
    shown = png.decode_rgb(state.png.read_bytes())[::-1]
    want = denoise.to_bytes(denoise.denoise(
        denoise.tonemap(film.sum, film.samples), film.albedo, film.normal))
    out["png_bytes_off_share"] = float(np.mean(shown != want))
    return out


def check(state):
    return readings(state)


def sound_reading(state, seed):
    """One image of `seed`, as many pixels compared as a run compares."""
    t = state.traffic
    state.reseed(seed)
    state.keep(0, state.render(0), k=t["check_pixels"] * t["check_images"])
    return check(state)


def control_reading(state, seed):
    """The reference in bfloat16 in the program's place: its film and
    guides at the pixels `sound_reading` compares, and its denoiser on
    the image's film."""
    t, c = state.traffic, state.config
    state.reseed(seed)
    film = state.render(0)
    k = t["check_pixels"] * t["check_images"]
    idx = state.perm[:k]
    low = scenes.build(c, state.dev, torch.bfloat16, state.folders)
    args = (state.width, state.height)
    film_at = scenes.own(c, "film_at", tracer.film_at, state.folders)
    guides_at = scenes.own(c, "guides_at", aov.guides_at, state.folders)
    rad, depth = film_at(low, idx, 0, t["spp"], seed, *args, c["max_depth"],
                         torch.bfloat16)
    alb, nrm = guides_at(low, idx, seed, *args, torch.bfloat16)
    state.kept = [(0, idx, rad, depth, alb, nrm)]
    state.last = (0, film)
    shown = denoise.to_bytes(denoise.denoise(*(
        v.to(torch.bfloat16) for v in (denoise.tonemap(film.sum,
                                                       film.samples),
                                       film.albedo, film.normal))).float())
    got = readings(state)
    want = denoise.to_bytes(denoise.denoise(
        denoise.tonemap(film.sum, film.samples), film.albedo, film.normal))
    got["png_bytes_off_share"] = float(np.mean(shown != want))
    return got
