"""The render driver: progressive sample loop (mirrors
``mrt.runtime.render``)."""

from __future__ import annotations

from ..integrator import wavefront
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
                           pool=POOL, rr_depth=None, pend=None):
    """Ray-regeneration render pass: lanes stay busy regardless of
    depth, the fast path for deep bounces.  rr_depth: Russian roulette
    from that bounce on (None: off); pend: the pending-deposit film mode
    (None: MRT_FILM_PEND decides, off by default)."""
    film_sum, depth_sum = render_samples_persistent(
        scene, camera, width, height, seed, sample_start, samples,
        max_depth=max_depth, pool=pool,
        film_sum=film.sum.reshape(-1, 3),
        depth_sum=film.depth_sum.reshape(-1), rr_depth=rr_depth, pend=pend)
    return film.replace(sum=film_sum.reshape(height, width, 3),
                        depth_sum=depth_sum.reshape(height, width),
                        samples=film.samples + samples)


def render(scene, camera, width, height, spp=64, seed=1,
           max_depth=wavefront.MAX_DEPTH, samples_per_pass=None, film=None,
           progress=None, persistent=False, rr_depth=None):
    """Progressive render to `spp` total samples.

    Args:
      samples_per_pass: spp per pass (None = all at once).
      film: resume from an existing film (checkpointed state).
      progress: optional callback(film) after each pass.
      persistent: use the ray-regeneration integrator (same estimator,
        different float accumulation order).
      rr_depth: Russian roulette from that bounce on (None: off).

    Returns the accumulated Film, on the camera's device.
    """
    if film is None:
        film = Film.create(width, height, device=camera.origin.device)
    pass_fn = render_pass_persistent if persistent else render_pass
    chunk = samples_per_pass or spp
    done = film.samples
    while done < spp:
        step = min(chunk, spp - done)
        film = pass_fn(scene, camera, film, seed, done, width=width,
                       height=height, max_depth=max_depth, samples=step,
                       rr_depth=rr_depth)
        done += step
        if progress is not None:
            progress(film)
    return film
