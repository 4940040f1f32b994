"""Sharded progressive rendering over a (tile, spp) mesh of ranks
(mirrors ``mrt.parallel.render``).

Every rank renders its static row tile for its sample stride, then the
(radiance, bounce) sums are summed over the spp axis: the only
collective of a pass.  Each rank keeps its film's rows (``shard_film``);
``gather_film`` brings the whole film to every rank over the tile axis,
where the reference's arrays gather on host access.

RNG discipline: random draws are pure functions of (seed, global pixel
id, global sample index), so a render is the same for every mesh shape:
bounce counts exactly, radiance up to the order of its float sums.
"""

from __future__ import annotations

from ..integrator import wavefront
from ..integrator.persistent import POOL, render_samples_persistent
from ..runtime.film import Film
from .mesh import SPP_AXIS, TILE_AXIS, make_mesh


def _split(mesh, height, samples):
    """(rows a tile, samples a spp rank); raises where they do not
    divide."""
    n_tile, n_spp = mesh.shape[TILE_AXIS], mesh.shape[SPP_AXIS]
    if height % n_tile:
        raise ValueError(f"height {height} % tile axis {n_tile} != 0")
    if samples % n_spp:
        raise ValueError(f"samples {samples} % spp axis {n_spp} != 0")
    return height // n_tile, samples // n_spp


def _check_shard(film, rows_per, width):
    if tuple(film.sum.shape) != (rows_per, width, 3):
        raise ValueError(f"film {tuple(film.sum.shape)} is not a row tile "
                         f"({rows_per}, {width}, 3): pass shard_film(film, "
                         "mesh)")


def render_pass_sharded(scene, camera, film: Film, seed, sample_start, *,
                        width, height, samples, max_depth, mesh,
                        rr_depth=None):
    """One pass adding `samples` spp to this rank's row tile of the film
    (``shard_film``) with the wavefront integrator; rank (tile, s) traces
    the samples sample_start + i * n_spp + s.  `samples` must be a
    multiple of the spp-axis size."""
    rows_per, my_samples = _split(mesh, height, samples)
    _check_shard(film, rows_per, width)
    n_spp = mesh.shape[SPP_AXIS]
    row0 = mesh.tile_index * rows_per
    rad = film.sum.new_zeros(film.sum.shape)
    bounces = film.depth_sum.new_zeros(film.depth_sum.shape)
    for i in range(my_samples):
        r, b = wavefront.render_rows(
            scene, camera, width, height, row0, rows_per, seed,
            sample_start + i * n_spp + mesh.spp_index, max_depth, rr_depth)
        rad, bounces = rad + r, bounces + b
    # The sum over spp merges the sample strides (the reference's psum).
    rad = mesh.all_reduce(rad, SPP_AXIS)
    bounces = mesh.all_reduce(bounces, SPP_AXIS)
    return film.replace(sum=film.sum + rad, depth_sum=film.depth_sum + bounces,
                        samples=film.samples + samples)


def render_pass_sharded_persistent(scene, camera, film: Film, seed,
                                   sample_start, *, width, height, samples,
                                   max_depth, mesh, pool=None, pend=None,
                                   rr_depth=None):
    """Ray-regeneration pass on this rank's row tile: its lane pool
    consumes its own (row tile x sample stride) work queue, and the spp
    ranks' contributions are summed.  pool: lanes (None: POOL, at most
    one a work item); pend: the pending-deposit film mode (None: the
    persistent integrator's default)."""
    rows_per, my_samples = _split(mesh, height, samples)
    _check_shard(film, rows_per, width)
    n_pix = rows_per * width
    if pool is None:
        pool = min(POOL, n_pix * my_samples)
    fs_in = film.sum.reshape(-1, 3)
    ds_in = film.depth_sum.reshape(-1)
    fs_out, ds_out = render_samples_persistent(
        scene, camera, width, height, seed, sample_start + mesh.spp_index,
        my_samples, max_depth=max_depth, pool=pool, film_sum=fs_in,
        depth_sum=ds_in, rr_depth=rr_depth, pend=pend,
        pixel_offset=mesh.tile_index * n_pix, n_pixels=n_pix,
        sample_stride=mesh.shape[SPP_AXIS])
    # Each spp rank added its own samples to the shared base: sum the
    # deltas, so the base is not multiplied.
    fs = fs_in + mesh.all_reduce(fs_out - fs_in, SPP_AXIS)
    ds = ds_in + mesh.all_reduce(ds_out - ds_in, SPP_AXIS)
    return film.replace(sum=fs.reshape(rows_per, width, 3),
                        depth_sum=ds.reshape(rows_per, width),
                        samples=film.samples + samples)


def shard_film(film: Film, mesh) -> Film:
    """This rank's row tile of a whole film (the guides stay whole, as
    the reference's do)."""
    rows_per = film.height // mesh.shape[TILE_AXIS]
    if rows_per * mesh.shape[TILE_AXIS] != film.height:
        raise ValueError(f"height {film.height} % tile axis "
                         f"{mesh.shape[TILE_AXIS]} != 0")
    rows = slice(mesh.tile_index * rows_per, (mesh.tile_index + 1) * rows_per)
    return film.replace(sum=film.sum[rows].contiguous(),
                        depth_sum=film.depth_sum[rows].contiguous())


def gather_film(film: Film, mesh) -> Film:
    """The whole film from every rank's row tile, on every rank."""
    return film.replace(sum=mesh.all_gather(film.sum, TILE_AXIS),
                        depth_sum=mesh.all_gather(film.depth_sum, TILE_AXIS))


def render_sharded(scene, camera, width, height, mesh=None, spp=64, seed=1,
                   max_depth=wavefront.MAX_DEPTH, samples_per_pass=None,
                   film=None, persistent=False, rr_depth=None):
    """Progressive render over the mesh (None: ``make_mesh()``, every
    rank on the tile axis, on the card).  film: resume from a whole film.

    Returns the whole accumulated film on every rank, on the mesh's
    device."""
    if mesh is None:
        mesh = make_mesh()
    if film is None:
        film = Film.create(width, height, device=mesh.device)
    shard = shard_film(film, mesh)
    pass_fn = (render_pass_sharded_persistent if persistent
               else render_pass_sharded)
    chunk = samples_per_pass or spp
    done = shard.samples
    while done < spp:
        step = min(chunk, spp - done)
        shard = pass_fn(scene, camera, shard, seed, done, width=width,
                        height=height, samples=step, max_depth=max_depth,
                        mesh=mesh, rr_depth=rr_depth)
        done += step
    return gather_film(shard, mesh)
