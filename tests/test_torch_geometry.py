"""Port parity: kernel B1 (sphere nearest hit), hit records and the
RTIOW scene (mrt_torch vs mrt).

B1's plain version (``mrt_torch.ops.spheres.nearest_t_plain``, the CPU
path of the ``nearest_t`` wrapper) computes the reference scan's
expanded-form expression in the same order, so:
  - against the reference scan ``mrt.geometry.spheres.nearest_t`` run
    op by op (``jax.disable_jit``), t and indices are bit-exact;
  - against the compiled scan and the expanded-form Pallas kernel
    ``nearest_t_x`` (interpret mode), indices are equal and t agrees to
    rtol 2e-3, the JAX suite's own tolerance between its kernels and
    the scan (tests/test_pallas.py): XLA contracts multiply-adds into
    FMAs when it compiles, and near-tangent hits amplify that last-bit
    difference through the square root;
  - against the direct-form Pallas kernel ``nearest_t`` (half_b and c
    from o - c), the same tolerance, with >= 99% equal indices, since
    near-ties may swap between the two expressions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.geometry import spheres as JS
from mrt.ops import pallas_spheres as PS
from mrt.scenes import get as jget
from mrt_torch import convert
from mrt_torch.geometry import spheres as TS
from mrt_torch.materials.table import MaterialTable
from mrt_torch.ops import spheres as B1
from mrt_torch.scenes import get as tget
from mrt_torch.utils import profiling

torch.set_num_threads(2)


def _case(seed, n_spheres, n_rays):
    rs = np.random.default_rng(seed)
    center = rs.uniform(-5, 5, (n_spheres, 3)).astype(np.float32)
    radius = rs.uniform(0.1, 1.2, n_spheres).astype(np.float32)
    o = rs.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rs.standard_normal((n_rays, 3)).astype(np.float32)
    return center, radius, o, d


def _jax_spheres(center, radius):
    return JS.Spheres(center=jnp.asarray(center), radius=jnp.asarray(radius),
                      material=jnp.zeros((len(radius),), jnp.int32))


def _port(center, radius, o, d, t_min, t_max):
    t, i = B1.nearest_t(*(torch.from_numpy(np.ascontiguousarray(x))
                          for x in (center, radius, o, d)),
                        torch.as_tensor(t_min), torch.as_tensor(t_max))
    return t.numpy(), i.numpy()


def _same(want, got, exact=False):
    wt, wi = (np.asarray(x) for x in want)
    gt, gi = got
    np.testing.assert_array_equal(np.isfinite(gt), np.isfinite(wt))
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(gt, wt)
    else:
        hit = np.isfinite(wt)
        np.testing.assert_allclose(gt[hit], wt[hit], rtol=2e-3, atol=1e-4)


def _scan(*args, compiled):
    if compiled:
        return JS.nearest_t(*args)
    with jax.disable_jit():
        return JS.nearest_t(*args)


@pytest.mark.parametrize("n_spheres,n_rays", [(1, 64), (13, 1000),
                                              (300, 1024)])
def test_b1_plain_matches_scan_and_expanded_kernel(n_spheres, n_rays):
    center, radius, o, d = _case(n_spheres, n_spheres, n_rays)
    got = _port(center, radius, o, d, 1e-3, np.inf)
    sph = _jax_spheres(center, radius)
    args = (sph, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.inf)
    _same(_scan(*args, compiled=False), got, exact=True)
    _same(_scan(*args, compiled=True), got)
    if n_spheres <= 13:  # interpret mode is slow; 300 spheres via the scan
        _same(PS.nearest_t_x(sph, jnp.asarray(o), jnp.asarray(d), 1e-3,
                             jnp.inf, interpret=True), got)


def test_b1_plain_matches_direct_kernel():
    center, radius, o, d = _case(7, 13, 1000)
    gt, gi = _port(center, radius, o, d, 1e-3, np.inf)
    wt, wi = (np.asarray(x) for x in PS.nearest_t(
        _jax_spheres(center, radius), jnp.asarray(o), jnp.asarray(d), 1e-3,
        jnp.inf, interpret=True))
    hit = np.isfinite(wt)
    np.testing.assert_array_equal(np.isfinite(gt), hit)
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=2e-3, atol=1e-4)
    assert (gi[hit] == wi[hit]).mean() > 0.99


def test_b1_per_lane_bounds():
    center, radius, o, d = _case(8, 16, 512)
    rs = np.random.default_rng(8)
    t_min = rs.uniform(1e-3, 1.0, 512).astype(np.float32)
    t_max = rs.uniform(2.0, 6.0, 512).astype(np.float32)
    got = _port(center, radius, o, d, t_min, t_max)
    assert np.isfinite(got[0]).any() and not np.isfinite(got[0]).all()
    sph = _jax_spheres(center, radius)
    args = (sph, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
            jnp.asarray(t_max))
    _same(_scan(*args, compiled=False), got, exact=True)
    _same(PS.nearest_t_x(*args, interpret=True), got)
    hit = np.isfinite(got[0])
    assert ((got[0][hit] >= t_min[hit]) & (got[0][hit] <= t_max[hit])).all()


def test_b1_ties_padding_misses_and_zero_directions():
    # Row 2 duplicates row 0 (a tie: the lower index wins), row 1 has
    # radius 0 (padding: never hit), and the rays include exact misses
    # and zero directions (NaN roots: a miss).
    center = np.array([[0, 0, 5], [0, 0, 3], [0, 0, 5], [9, 9, 9]],
                      np.float32)
    radius = np.array([1.0, 0.0, 1.0, 0.5], np.float32)
    o = np.zeros((6, 3), np.float32)
    d = np.array([[0, 0, 1], [0, 0, 2], [0, 1, 0], [0, 0, 0], [0, 0, 0],
                  [1, 1, 1]], np.float32)
    o[4] = (0, 0, 5)  # zero direction from inside a sphere
    got = _port(center, radius, o, d, 1e-3, np.inf)
    np.testing.assert_array_equal(got[1], [0, 0, 0, 0, 0, 3])
    np.testing.assert_array_equal(got[0][:2], [4.0, 2.0])
    assert np.isinf(got[0][2:5]).all()
    _same(_scan(_jax_spheres(center, radius), jnp.asarray(o),
                jnp.asarray(d), 1e-3, jnp.inf, compiled=False), got,
          exact=True)


def test_make_hits_matches_reference():
    center, radius, o, d = _case(9, 40, 800)
    material = np.arange(40, dtype=np.int32) % 7
    jsph = JS.Spheres(center=jnp.asarray(center), radius=jnp.asarray(radius),
                      material=jnp.asarray(material))
    with jax.disable_jit():  # unfused: the same roundings as the port
        want = JS.intersect(jsph, jnp.asarray(o), jnp.asarray(d), 1e-3,
                            jnp.inf)
    got = TS.intersect(TS.Spheres(center, radius, material),
                       torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                       float("inf"))
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.material.numpy()[hit],
                                  np.asarray(want.material)[hit])
    np.testing.assert_array_equal(got.front_face.numpy()[hit],
                                  np.asarray(want.front_face)[hit])
    for name in ("t", "point", "normal"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[hit],
                                      np.asarray(getattr(want, name))[hit])


@pytest.mark.parametrize("grid", [5, 11])
def test_rtiow_arrays_byte_equal_and_round_trip(grid):
    js, jc = jget("rtiow")(aspect_ratio=1.0, grid=grid).generate()
    ts, tc = tget("rtiow")(aspect_ratio=1.0, grid=grid).generate(
        device="cpu")
    spheres = {k: np.asarray(getattr(js.spheres, k))
               for k in ("center", "radius", "material")}
    materials = {k: np.asarray(getattr(js.materials, k))
                 for k in MaterialTable.FIELDS}
    for k, v in spheres.items():
        assert getattr(ts.spheres, k).numpy().tobytes() == v.tobytes(), k
    for k, v in materials.items():
        assert getattr(ts.materials, k).numpy().tobytes() == v.tobytes(), k
    assert ts.has_mix is js.has_mix is False
    assert ts.materials.mix_depth == js.materials.mix_depth
    if grid == 11:
        assert spheres["radius"].shape == (484,)

    back = convert.scene_from_numpy(spheres, materials, has_mix=js.has_mix,
                                    mix_depth=js.materials.mix_depth)
    for k, v in spheres.items():
        assert getattr(back.spheres, k).numpy().tobytes() == v.tobytes()
    for k, v in materials.items():
        assert getattr(back.materials, k).numpy().tobytes() == v.tobytes()
    cam = convert.camera_from_numpy(*(np.asarray(getattr(jc, k))
                                      for k in tc.FIELDS))
    for k in tc.FIELDS:
        np.testing.assert_array_equal(getattr(cam, k).numpy(),
                                      np.asarray(getattr(jc, k)))


def test_b1_wrapper_checks_arguments():
    center, radius, o, d = (torch.from_numpy(x) for x in _case(1, 4, 8))
    with pytest.raises(TypeError):
        B1.nearest_t(center, radius, o.double(), d, 1e-3, 1.0)
    with pytest.raises(ValueError):
        B1.nearest_t(center, radius, o[:, :2], d, 1e-3, 1.0)
    with pytest.raises(ValueError):
        B1.nearest_t(center, radius, o, d.t().contiguous().t(), 1e-3, 1.0)
    with pytest.raises(ValueError):
        B1.nearest_t(center, radius, o, d, torch.zeros(3), 1.0)
    meta = [x.to("meta") for x in (center, radius, o, d)]
    with pytest.raises(ValueError, match="no kernel"):
        B1.nearest_t(*meta, 1e-3, 1.0)
    assert profiling.launch_counts["B1"] == 0
