"""The render driver: progressive sample loop (mirrors
``mrt.runtime.render``)."""

from __future__ import annotations

from ..integrator import aov, wavefront
from ..integrator.persistent import POOL, render_samples_persistent
from .film import Film


def render_pass(scene, camera, film: Film, seed, sample_start, *, width,
                height, max_depth=wavefront.MAX_DEPTH, samples=1,
                rr_depth=None):
    """Render `samples` 1-spp frames and merge each into the film.
    rr_depth: Russian roulette from that bounce on (None: off)."""
    for i in range(samples):
        radiance, bounces = wavefront.render_sample(
            scene, camera, width, height, seed, sample_start + i,
            max_depth=max_depth, rr_depth=rr_depth)
        film = film.merge(radiance, bounces)
    return film


def render_pass_persistent(scene, camera, film: Film, seed, sample_start,
                           *, width, height,
                           max_depth=wavefront.MAX_DEPTH, samples=1,
                           pool=POOL, rr_depth=None, pend=None,
                           sort_rays=None):
    """Ray-regeneration render pass: lanes stay busy regardless of
    depth, the fast path for deep bounces.  rr_depth: Russian roulette
    from that bounce on (None: off); pend: the pending-deposit film mode
    (None: MRT_FILM_PEND decides, off by default); sort_rays: the lane
    sorter's cadence (steps between sorts; True is 1, False or 0 off),
    None the reference's auto rule (``Scene.prefers_sorted_rays`` and
    ``Scene.sort_cadence``: on the card only)."""
    if sort_rays is None:
        sort_rays = (scene.sort_cadence() if scene.prefers_sorted_rays()
                     else 0)
    film_sum, depth_sum = render_samples_persistent(
        scene, camera, width, height, seed, sample_start, samples,
        max_depth=max_depth, pool=pool,
        film_sum=film.sum.reshape(-1, 3),
        depth_sum=film.depth_sum.reshape(-1), rr_depth=rr_depth, pend=pend,
        sort_rays=int(sort_rays))
    return film.replace(sum=film_sum.reshape(height, width, 3),
                        depth_sum=depth_sum.reshape(height, width),
                        samples=film.samples + samples)


def aov_pass(scene, camera, *, width, height, seed=0):
    """The albedo and normal guide pre-pass: (albedo, normal), each
    (H, W, 3)."""
    return aov.albedo_normal_frame(scene, camera, width, height, seed=seed)


def render(scene, camera, width, height, spp=64, seed=1,
           max_depth=wavefront.MAX_DEPTH, samples_per_pass=None,
           with_aov=False, film=None, progress=None, persistent=False,
           rr_depth=None, sort_rays=None):
    """Progressive render to `spp` total samples.

    Args:
      samples_per_pass: spp per pass (None = all at once).
      with_aov: run the guide pre-pass first and attach its albedo and
        normal to the film (the denoiser's and the display modes').
      film: resume from an existing film (checkpointed state).
      progress: optional callback(film) after each pass.
      persistent: use the ray-regeneration integrator (same estimator,
        different float accumulation order).
      rr_depth: Russian roulette from that bounce on (None: off).
      sort_rays: the persistent pass's lane sorter (None: the auto
        rule; True, False or a cadence, ``render_pass_persistent``); the
        batched integrator never sorts.

    Returns the accumulated Film, on the camera's device.
    """
    if film is None:
        film = Film.create(width, height, device=camera.origin.device)
    if with_aov:
        film = film.with_aov(*aov_pass(scene, camera, width=width,
                                       height=height, seed=seed))
    chunk = samples_per_pass or spp
    done = film.samples
    while done < spp:
        step = min(chunk, spp - done)
        if persistent:
            # Lanes past the pass's work items would idle from the start
            # and change nothing: a small frame takes one lane an item.
            film = render_pass_persistent(
                scene, camera, film, seed, done, width=width, height=height,
                max_depth=max_depth, samples=step, rr_depth=rr_depth,
                pool=min(POOL, width * height * step), sort_rays=sort_rays)
        else:
            film = render_pass(scene, camera, film, seed, done, width=width,
                               height=height, max_depth=max_depth,
                               samples=step, rr_depth=rr_depth)
        done += step
        if progress is not None:
            progress(film)
    return film
