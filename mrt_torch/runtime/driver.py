"""The frame and animation driver (mirrors ``mrt.runtime.driver``).

Scene generation, the render, display-mode export, animation frames
with ETA logs, input record/replay, checkpoints with resume and retry,
the viewer, and an optional ``torch.profiler`` trace.  Everything runs
on ``device`` (None: the CUDA card; raises without one).

Multi-device rendering (``mesh_tile``, ``mesh_spp > 1``) renders over
a (tile, spp) mesh of ``torch.distributed`` ranks (``mrt_torch.parallel``);
a launcher that sets WORLD_SIZE > 1 (torchrun) makes ``run`` join its
process group, and only rank 0 writes files.  One of mrt's options
differs: ``profile_dir`` records a ``torch.profiler`` trace in place of
``jax.profiler``'s.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from .. import scenes
from ..parallel.mesh import init_from_launcher, is_leader, make_mesh
from ..parallel.render import render_sharded
from ..utils.profiling import trace
from .config import RenderConfig
from .film import DisplayMode, Film
from .input import InputCollection, InputRecorder, InputReplay
from .io import save_png
from .render import aov_pass, render


def _denoiser_for(config):
    if (config.denoise
            or config.display_mode == DisplayMode.DENOISE.value):
        from .denoise import make_denoiser
        return make_denoiser()
    return None


def _sync(film):
    """Wait for the film's device (the reference's block_until_ready)."""
    if film.sum.is_cuda:
        torch.cuda.synchronize(film.sum.device)


def render_frame(scene, camera, config: RenderConfig, film=None,
                 progress=None):
    """Render one frame as the config says (on one device or over a
    mesh of ranks), on the camera's device."""
    needs_aov = (config.denoise
                 or config.display_mode in ("denoise", "albedo", "normal"))
    if config.mesh_tile is not None or config.mesh_spp > 1:
        mesh = make_mesh(tile=config.mesh_tile, spp=config.mesh_spp,
                         device=camera.origin.device)
        film = render_sharded(
            scene, camera, config.width, config.height, mesh,
            spp=config.spp, seed=config.seed, max_depth=config.max_depth,
            samples_per_pass=config.samples_per_pass, film=film,
            persistent=config.persistent, rr_depth=config.rr_depth)
        if needs_aov:
            film = film.with_aov(*aov_pass(scene, camera, width=config.width,
                                           height=config.height,
                                           seed=config.seed))
        return film
    return render(scene, camera, config.width, config.height,
                  spp=config.spp, seed=config.seed,
                  max_depth=config.max_depth,
                  samples_per_pass=config.samples_per_pass,
                  with_aov=needs_aov, film=film, progress=progress,
                  persistent=config.persistent, rr_depth=config.rr_depth,
                  sort_rays=config.sort_rays)


def export(film: Film, path, config: RenderConfig):
    """Write the film's PNG in the config's display mode (rank 0 alone
    under a process group)."""
    if not is_leader():
        return
    mode = DisplayMode(config.display_mode)
    save_png(path, film.to_rgb_bytes(mode, denoiser=_denoiser_for(config)))


def _generate(sc, t, frame, inp, config, device):
    scene, camera = sc.generate(t, frame, inp, device=device)
    if config.nee:
        from ..geometry.scene import attach_lights
        scene = attach_lights(scene)
    return scene, camera


def run(config: RenderConfig, log=print, device=None):
    """Top-level entry: one frame, an animation, or the viewer."""
    device = init_from_launcher(device)
    sc = scenes.get(config.scene)(aspect_ratio=config.aspect_ratio)

    replay = InputReplay(config.read_input) if config.read_input else None
    recorder = InputRecorder() if config.write_input else None

    with trace(config.profile_dir):
        if config.serve or config.play:
            from .viewer import serve
            return serve(config, log=log, device=device)
        if not config.animate:
            return _single_frame(config, sc, replay, log, device)

        total = config.total_frames
        start = time.time()
        film = None
        for frame in range(total):
            inp = replay.frame(frame) if replay else InputCollection()
            if recorder is not None:
                recorder.record(inp)
            scene, camera = _generate(sc, frame / total, frame, inp, config,
                                      device)
            film = render_frame(scene, camera, _frame_config(config))
            _sync(film)
            export(film, os.path.join(config.animation_dir,
                                      f"frame_{frame:05d}.png"), config)
            elapsed = time.time() - start
            eta = elapsed / (frame + 1) * (total - frame - 1)
            log(f"frame {frame + 1}/{total} "
                f"({elapsed:.0f}s elapsed, ETA {eta:.0f}s)")
        if recorder is not None and is_leader():
            recorder.save(config.write_input)
        return film


def _single_frame(config, sc, replay, log, device):
    inp = replay.frame(0) if replay else InputCollection()
    scene, camera = _generate(sc, 0.0, 0, inp, config, device)
    film = None
    if config.checkpoint and os.path.exists(config.checkpoint):
        film, config.seed = Film.load_state(config.checkpoint, device=device)
        log(f"resuming from {config.checkpoint} at {film.samples} spp")
    t0 = time.time()

    def progress(f):
        # Checkpointing after every pass doubles as recovery: a fault
        # mid-render resumes from the last pass.
        if config.checkpoint and is_leader():
            f.save_state(config.checkpoint, seed=config.seed)
        if config.preview:
            export(f, config.output, config)

    attempts = 3 if config.checkpoint else 1
    for attempt in range(attempts):
        try:
            film = render_frame(scene, camera, config, film=film,
                                progress=progress)
            _sync(film)
            break
        except Exception as e:
            if attempt + 1 == attempts:
                raise
            log(f"render attempt {attempt + 1} failed ({e}); resuming from "
                "checkpoint")
            if os.path.exists(config.checkpoint):
                film, _ = Film.load_state(config.checkpoint, device=device)
    log(f"rendered {config.spp} spp in {time.time() - t0:.1f}s")
    if config.checkpoint and is_leader():
        film.save_state(config.checkpoint, seed=config.seed)
    export(film, config.output, config)
    if is_leader():
        log(f"wrote {config.output}")
    return film


def _frame_config(config: RenderConfig):
    return dataclasses.replace(config, spp=config.samples_per_frame)
