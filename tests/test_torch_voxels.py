"""Port parity for voxel grids (mrt_torch vs mrt): the hierarchical DDA
of ``geometry/voxels.py`` under both occupancy rules, the Menger sponge
scene with ``voxel=True`` and the ``menger2_voxel_24`` golden.

Tolerances and why:
  - ``intersect`` against the op-by-op JAX walk (``jax.disable_jit``,
    ROADMAP C2): t, normal, front face, hit and material bit-equal, at
    levels 1-3 of both rules, on rays from outside and inside the grid,
    inside solids, exactly on cell boundaries, parallel to axes, and on
    rays whose rounding keeps them walking to the step cap.
  - The sponge scene: camera, world bounds and voxel grid bit-equal.
  - The golden through both port integrators: like ``menger2_24``
    (ROADMAP C10), the fuzzy-metal floor under the sponge flips paths on
    FMA contraction, so the film leaves C2's rule on ~24 of 576 pixels;
    on each of them the port's paths equal the op-by-op JAX paths (depth
    exact, sums within 1e-4).  Capped at 30 pixels.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import golden_scenes as G
import torch_golden_scenes as TG
from mrt.geometry import voxels as JV
from mrt.integrator import wavefront as JW
from mrt.scenes import get as jget
from mrt_torch.geometry import voxels as TV
from mrt_torch.integrator import wavefront as TW
from mrt_torch.scenes import get as tget
from mrt_torch.utils import profiling
from test_torch_textures import GOLDENS, _port_film, _rays, outside_c2

torch.set_num_threads(2)


def _grids(rule, level, origin=(-1.0, -2.0, 0.5), cell=0.75, material=3):
    n = 3 ** level
    occ = None
    if rule == "dense":
        # Sparse blocks, a solid slab and scattered cells: every mip level
        # has empty and full blocks.
        rs = np.random.default_rng(level)
        occ = rs.random((n, n, n)) < 0.08
        occ[: max(1, n // 3), :, :] &= False
        occ[-1, : n // 2, :] = True
    j = JV.VoxelGrid.create(origin, cell, level, material, rule=rule,
                            occupancy=occ)
    t = TV.VoxelGrid.create(origin, cell, level, material, rule=rule,
                            occupancy=occ)
    return j, t


def _grid_rays(grid, rs, count):
    """Rays of every kind the walk must agree on."""
    lo = np.asarray(grid.origin)
    side = float(grid.n * grid.cell)
    hi = lo + side
    o, d = [], []
    # From outside, aimed at points in the box.
    m = count // 4
    start = lo + side * rs.uniform(-1.0, 2.0, (m, 3))
    aim = lo + side * rs.uniform(0.1, 0.9, (m, 3))
    o.append(start), d.append(aim - start)
    # From inside (many in solid cells), random directions.
    o.append(lo + side * rs.uniform(0, 1, (m, 3)))
    d.append(rs.standard_normal((m, 3)))
    # From exact cell boundaries (integer cell coordinates).
    cells = rs.integers(0, grid.n + 1, (m, 3)).astype(np.float64)
    o.append(lo + cells * float(grid.cell))
    d.append(rs.standard_normal((m, 3)))
    # Parallel to one or two axes, inside and outside the slabs.
    k = count - 3 * m
    dd = rs.standard_normal((k, 3))
    dd[np.arange(k) % 3 == 0, 1] = 0.0
    dd[np.arange(k) % 3 == 1, :2] = 0.0
    dd[np.arange(k) % 3 == 2, 0] = 0.0
    o.append(lo + side * rs.uniform(-0.2, 1.2, (k, 3)))
    d.append(dd)
    o = np.concatenate(o).astype(np.float32)
    d = np.concatenate(d).astype(np.float32)
    assert np.all(hi > lo)
    return o, d


FIELDS = ("t", "normal", "front_face", "hit", "material", "point")


def _compare(jg, tg, o, d, t_min, t_max):
    with jax.disable_jit():
        want = JV.intersect(jg, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(t_min), jnp.asarray(t_max))
    got = TV.intersect(tg, torch.from_numpy(o), torch.from_numpy(d),
                       torch.as_tensor(t_min), torch.as_tensor(t_max))
    for name in FIELDS:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.tobytes() == g.astype(w.dtype).tobytes(), name
    return got


@pytest.mark.parametrize("rule", ["menger", "dense"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_intersect_matches_reference(rule, level):
    jg, tg = _grids(rule, level)
    rs = np.random.default_rng(10 * level + (rule == "dense"))
    o, d = _grid_rays(jg, rs, 512)
    t_min = np.full((len(o),), 1e-3, np.float32)
    t_max = np.where(rs.random(len(o)) < 0.2, 3.0, np.inf).astype(np.float32)
    got = _compare(jg, tg, o, d, t_min, t_max)
    # Both kinds of crossing occur.
    assert got.hit.any() and (got.hit & ~got.front_face).any()
    assert (got.hit & got.front_face).any()


def test_intersect_step_cap():
    # Far from the origin with small cells, the floor of the crossing
    # point rounds back and forth across boundaries, so some rays walk
    # until the step cap: both walks stop there alike.
    jg, tg = _grids("dense", 2, origin=(3.0e4, -3.0e4, 3.0e4), cell=0.002)
    rs = np.random.default_rng(5)
    o, d = _grid_rays(jg, rs, 256)
    before = profiling.counters.get("dda_steps", 0)
    _compare(jg, tg, o, d, np.float32(1e-3), np.float32(np.inf))
    steps = profiling.counters["dda_steps"] - before
    assert steps == 6 * jg.n + 3 * jg.levels + 8


def test_voxel_menger_scene_matches():
    js, jc = jget("menger")(aspect_ratio=1.0, level=3).generate()
    ts, tc = tget("menger")(aspect_ratio=1.0, level=3).generate(
        device="cpu")
    for k in tc.FIELDS:
        assert np.asarray(getattr(jc, k)).tobytes() == getattr(
            tc, k).numpy().tobytes(), k
    for a, b in zip(js.world_bounds(), ts.world_bounds()):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    (jg,), (tg,) = js.voxels, ts.voxels
    assert (jg.levels, jg.rule) == (tg.levels, tg.rule) == (3, "menger")
    for k in ("origin", "cell", "material"):
        assert np.asarray(getattr(jg, k)).tobytes() == getattr(
            tg, k).numpy().tobytes(), k


@pytest.mark.parametrize("integrator", ["wavefront", "persistent"])
def test_menger2_voxel_golden(integrator):
    gold = np.load(os.path.join(GOLDENS, f"menger2_voxel_{G.SIZE}.npz"))
    film = _port_film("menger2_voxel", integrator)
    flipped, off = outside_c2(film, gold)
    pix = np.flatnonzero(flipped | off)
    print(f"menger2_voxel_24 {integrator}: {flipped.sum()} px flip, "
          f"{off.sum()} more outside 5e-4")
    assert len(pix) <= 30, len(pix)  # C10: 24 seen
    if integrator == "persistent":
        return  # the same estimator; its paths are checked below
    js, jc = G.menger2_voxel()
    ts, _ = TG.menger2_voxel("cpu")
    with jax.disable_jit():
        o, d, ray_id = _rays(jc.rays, pix, np.arange(G.SPP), G.SIZE)
        want = JW.trace_wavefront(js, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(ray_id), G.SEED,
                                  max_depth=G.DEPTH)
    got = TW.trace_wavefront(ts, torch.tensor(o), torch.tensor(d),
                             torch.from_numpy(ray_id.astype(np.int64)),
                             G.SEED, max_depth=G.DEPTH)
    per_pixel = lambda x: np.asarray(x).reshape(len(pix), G.SPP,
                                                -1).sum(1)
    depth = per_pixel(got[1].numpy())[:, 0]
    np.testing.assert_array_equal(depth, per_pixel(want[1])[:, 0])
    np.testing.assert_allclose(per_pixel(got[0].numpy()), per_pixel(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(film.depth_sum.numpy().reshape(-1)[pix],
                                  depth)
