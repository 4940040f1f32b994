"""Port parity: host builds (m4, shapes, the median BVH), kernel B5
(sphere-BVH closest hit) and the sphere_grid scene (mrt_torch vs mrt).

Tolerances and why:
  - m4 transforms, shapes and BVH builds are host NumPy on both sides:
    byte-equal, sphere_grid's full 10,000-sphere tree included.
  - B5's plain version (``mrt_torch.ops.bvh.sphere_bvh_plain``, the CPU
    path of ``sphere_bvh_hit``) repeats the reference traversal's
    arithmetic in the same order: against
    ``mrt.geometry.bvh.intersect_bvh_spheres`` run op by op
    (``jax.disable_jit``) indices are equal and t is bit-equal, on rays
    that start on a slab plane with a zero direction component (NaN in
    the slab test culls the box) and on zero directions too.
  - Against the Pallas kernel in interpret mode (compiled by XLA, which
    contracts multiply-adds into FMAs) indices are equal and t within
    rtol 1e-5, plus atol 1e-6 for roots near t_min: a ray that starts
    just inside a sphere takes its far root from -half_b + sq, which
    cancels, and the FMA moves it by up to ~1e-7.  Its wrapper
    substitutes (1, 1, 1) for zero directions,
    so those rays are left out there.
  - sphere_grid (dim 4: 64 spheres, so it has a BVH) rendered by the
    port against the JAX render run op by op: sums within 1e-4, depth
    exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.geometry import bvh as JB
from mrt.geometry import shapes as JSH
from mrt.geometry import spheres as JS
from mrt.math import m4 as JM4
from mrt.ops import pallas_bvh as PB
from mrt.runtime.render import render as jrender
from mrt.scenes import get as jget
from mrt_torch import convert
from mrt_torch.geometry import bvh as TB
from mrt_torch.geometry import instance as TI
from mrt_torch.geometry import shapes as TSH
from mrt_torch.geometry import spheres as TS
from mrt_torch.geometry import triangles as TT
from mrt_torch.materials.table import MaterialTable
from mrt_torch.math import m4 as TM4
from mrt_torch.ops import bvh as B5
from mrt_torch.runtime.render import render
from mrt_torch.scenes import get as tget

torch.set_num_threads(2)

BVH_FIELDS = ("bmin", "bmax", "first", "count", "escape")


def _equal(want, got, what):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert want.tobytes() == got.tobytes(), what


def _bvh_equal(jbvh, tbvh):
    for k in BVH_FIELDS:
        _equal(getattr(jbvh, k), getattr(tbvh, k), k)


def test_m4_batches_byte_equal():
    rs = np.random.default_rng(3)
    t = rs.uniform(-5, 5, (9, 3)).astype(np.float32)
    r = rs.uniform(-1, 1, (9, 3)).astype(np.float32)
    s = rs.uniform(0.2, 3, (9, 3)).astype(np.float32)
    _equal(JM4.trs_batch_np(t, r, s), TM4.trs_batch_np(t, r, s), "trs")
    _equal(JM4.trs_inverse_batch_np(t, r, s),
           TM4.trs_inverse_batch_np(t, r, s), "inverse")
    np.testing.assert_allclose(TM4.trs_batch_np(t, r, s)
                               @ TM4.trs_inverse_batch_np(t, r, s),
                               np.broadcast_to(np.eye(4), (9, 4, 4)),
                               atol=1e-5)


@pytest.mark.parametrize("shape", ["cube", "quad", "sphere_mesh"])
def test_shapes_byte_equal(shape):
    args = dict(cube=((0.5, 1, 2), 2.0, 3),
                quad=((0, 0, 0), (1, 0, 0), (0, 2, 0), 1),
                sphere_mesh=((1, 0, 0), 0.7, 5, 7, 2))[shape]
    want, got = getattr(JSH, shape)(*args), getattr(TSH, shape)(*args)
    for k in TT.FIELDS:
        _equal(getattr(want, k), getattr(got, k), k)


def test_median_build_over_triangles_matches():
    tris = TSH.sphere_mesh((0, 0, 0), 2.0, lat=10, lon=14)
    jbvh, jtris = JB.build_over_triangles(JSH.sphere_mesh((0, 0, 0), 2.0,
                                                          lat=10, lon=14))
    tbvh, ttris = TB.build_over_triangles(tris)
    assert tbvh.n_nodes > 1
    _bvh_equal(jbvh, tbvh)
    for k in TT.FIELDS:
        _equal(getattr(jtris, k), getattr(ttris, k), k)


def _spheres(seed, s):
    rs = np.random.default_rng(seed)
    return (rs.uniform(-6, 6, (s, 3)).astype(np.float32),
            rs.uniform(0.1, 1.0, s).astype(np.float32),
            rs.integers(0, 5, s).astype(np.int32))


@pytest.mark.parametrize("s", [40, 300])
def test_median_build_over_spheres_matches(s):
    center, radius, material = _spheres(s, s)
    jbvh, jsph = JB.build_over_spheres(JS.Spheres(
        center=jnp.asarray(center), radius=jnp.asarray(radius),
        material=jnp.asarray(material)))
    tbvh, tsph = TB.build_over_spheres(TS.Spheres(center, radius, material))
    _bvh_equal(jbvh, tbvh)
    for k in ("center", "radius", "material"):
        _equal(getattr(jsph, k), getattr(tsph, k), k)


def test_sphere_grid_full_size_arrays_byte_equal():
    js, jc = jget("sphere_grid")().generate()
    ts, tc = tget("sphere_grid")().generate(device="cpu")
    assert ts.spheres.count == 10_000 and ts.sphere_bvh.n_nodes == 1023
    _bvh_equal(js.sphere_bvh, ts.sphere_bvh)
    for k in ("center", "radius", "material"):
        _equal(getattr(js.spheres, k), getattr(ts.spheres, k), k)
    for k in MaterialTable.FIELDS:
        _equal(getattr(js.materials, k), getattr(ts.materials, k), k)
    for k in tc.FIELDS:
        _equal(getattr(jc, k), getattr(tc, k), k)
    assert ts.tlas.n_instances == 1


def _b5_case(seed=0, s=300, n=480):
    """Spheres in BVH order and rays; rays 0-39 start on a slab plane of
    a node with a zero direction component, rays 40-47 have a zero
    direction."""
    center, radius, material = _spheres(seed, s)
    jbvh, jsph = JB.build_over_spheres(JS.Spheres(
        center=jnp.asarray(center), radius=jnp.asarray(radius),
        material=jnp.asarray(material)))
    rs = np.random.default_rng(seed + 1)
    o = rs.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = rs.standard_normal((n, 3)).astype(np.float32)
    bmin, bmax = np.asarray(jbvh.bmin), np.asarray(jbvh.bmax)
    node = rs.integers(0, len(bmin), 40)
    node[:10] = 0  # the root: these rays miss everything
    axis = rs.integers(0, 3, 40)
    plane = np.where(rs.random(40) < 0.5, bmin[node, axis],
                     bmax[node, axis])
    o[np.arange(40), axis] = plane
    d[np.arange(40), axis] = 0.0
    o[:10] = np.where(np.arange(3) == axis[:10, None], o[:10],
                      0.5 * (bmin[node[:10]] + bmax[node[:10]]))
    d[40:48] = 0.0
    t_max = rs.uniform(2.0, 20.0, n).astype(np.float32)
    return jbvh, jsph, o, d, t_max


def _capture(monkeypatch):
    """Record the (t, index) that the JAX traversals expand."""
    got = {}
    expand = JS.make_hits

    def spy(spheres, o, d, t, i):
        got["t"], got["i"] = np.asarray(t), np.asarray(i)
        return expand(spheres, o, d, t, i)

    monkeypatch.setattr(JS, "make_hits", spy)
    return got


def _port_b5(jbvh, jsph, o, d, t_min, t_max):
    tbvh = TB.FlatBVH.create(*(np.asarray(getattr(jbvh, k))
                               for k in BVH_FIELDS))
    sph = TS.Spheres(*(np.asarray(getattr(jsph, k))
                       for k in ("center", "radius", "material")))
    sph.build_kernel_table(in_bvh=True)
    t, i = B5.sphere_bvh_hit(tbvh.nodes, tbvh.meta, sph.krows,
                             torch.from_numpy(o), torch.from_numpy(d),
                             torch.as_tensor(t_min), torch.as_tensor(t_max))
    return t.numpy(), i.numpy()


@pytest.mark.parametrize("per_lane", [False, True])
def test_b5_plain_matches_xla_traversal(monkeypatch, per_lane):
    jbvh, jsph, o, d, t_max = _b5_case()
    t_max = t_max if per_lane else np.float32(np.inf)
    want = _capture(monkeypatch)
    with jax.disable_jit():
        JB.intersect_bvh_spheres(jsph, jbvh, jnp.asarray(o), jnp.asarray(d),
                                 1e-3, jnp.asarray(t_max))
    t, i = _port_b5(jbvh, jsph, o, d, 1e-3, t_max)
    np.testing.assert_array_equal(i, want["i"])
    np.testing.assert_array_equal(t, want["t"])
    hit = np.isfinite(t)
    assert 0.1 < hit.mean() < 0.9
    assert not hit[:10].any()  # culled at a NaN slab
    assert not hit[40:48].any()  # zero directions: NaN roots


@pytest.mark.parametrize("per_lane", [False, True])
def test_b5_plain_matches_pallas_kernel(monkeypatch, per_lane):
    jbvh, jsph, o, d, t_max = _b5_case(seed=4)
    o, d, t_max = o[48:], d[48:], t_max[48:]
    t_max = t_max if per_lane else np.float32(np.inf)
    want = _capture(monkeypatch)
    PB.intersect_bvh_spheres(jsph, jbvh, jnp.asarray(o), jnp.asarray(d),
                             1e-3, jnp.asarray(t_max), interpret=True)
    t, i = _port_b5(jbvh, jsph, o, d, 1e-3, t_max)
    np.testing.assert_array_equal(i, want["i"])
    hit = np.isfinite(want["t"])
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], want["t"][hit], rtol=1e-5, atol=1e-6)


def test_plain_triangle_bvh_and_make_hits_match_xla():
    tris = TSH.sphere_mesh((0, 0, 0), 2.0, lat=10, lon=14)
    jbvh, jtris = JB.build_over_triangles(JSH.sphere_mesh((0, 0, 0), 2.0,
                                                          lat=10, lon=14))
    tbvh, ttris = TB.build_over_triangles(tris)
    rs = np.random.default_rng(5)
    o = rs.uniform(-5, 5, (256, 3)).astype(np.float32)
    d = rs.standard_normal((256, 3)).astype(np.float32)
    t_min = rs.uniform(1e-3, 3.0, 256).astype(np.float32)
    with jax.disable_jit():
        want = [np.asarray(x) for x in JB.intersect_bvh_tris(
            jtris, jbvh, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(t_min), jnp.inf)]
        jhits = JB.intersect_bvh(jtris, jbvh, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t_min), jnp.inf)
    ttris = TT.TriangleTable(ttris)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = TB.intersect_bvh_tris(ttris, tbvh, to, td, torch.from_numpy(t_min),
                                float("inf"))
    hits = TT.make_hits(ttris, to, td, *got)
    got = [x.numpy() for x in got]
    hit = np.isfinite(want[0])
    assert hit.any()
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[hit], w[hit])
    # Hits: the winner's shading row, looked up directly.
    np.testing.assert_array_equal(hits.hit.numpy(), np.asarray(jhits.hit))
    for k in ("material", "front_face"):
        np.testing.assert_array_equal(getattr(hits, k).numpy()[hit],
                                      np.asarray(getattr(jhits, k))[hit])
    for k in ("t", "point", "normal"):
        np.testing.assert_allclose(getattr(hits, k).numpy()[hit],
                                   np.asarray(getattr(jhits, k))[hit],
                                   atol=1e-6)


def test_b5_wrapper_checks_arguments():
    tbvh, tsph = TB.build_over_spheres(TS.Spheres(*_spheres(1, 70)))
    sph = tsph.build_kernel_table(in_bvh=True).krows
    o = torch.zeros((8, 3))
    with pytest.raises(TypeError):
        B5.sphere_bvh_hit(tbvh.nodes, tbvh.meta.long(), sph, o, o, 1e-3, 1.0)
    with pytest.raises(ValueError):
        B5.sphere_bvh_hit(tbvh.nodes, tbvh.meta, sph[:, :3], o, o, 1e-3, 1.0)
    with pytest.raises(ValueError):
        B5.sphere_bvh_hit(tbvh.nodes, tbvh.meta, sph, o, o, 1e-3,
                          torch.ones(3))
    meta = [x.to("meta") for x in (tbvh.nodes, tbvh.meta, sph, o, o)]
    with pytest.raises(ValueError, match="no kernel"):
        B5.sphere_bvh_hit(*meta, 1e-3, 1.0)


def _scene_arrays(js):
    return dict(
        spheres={k: np.asarray(getattr(js.spheres, k))
                 for k in ("center", "radius", "material")},
        materials={k: np.asarray(getattr(js.materials, k))
                   for k in MaterialTable.FIELDS},
        has_mix=js.has_mix, mix_depth=js.materials.mix_depth,
        background=np.asarray(js.background.color),
        sphere_bvh={k: np.asarray(getattr(js.sphere_bvh, k))
                    for k in BVH_FIELDS},
        tlas={**{k: np.asarray(getattr(js.tlas, k)) for k in TI.FIELDS},
              "tris": {k: np.asarray(getattr(js.tlas.tris, k))
                       for k in TT.FIELDS}})


def test_sphere_grid_small_render_matches_unfused_reference():
    # dim 4: 8x8 = 64 spheres, the BVH threshold; 8x8 pixels, spp 2,
    # depth 4.
    js, jc = jget("sphere_grid")(aspect_ratio=1.0, dim=4).generate()
    assert js.sphere_bvh is not None
    with jax.disable_jit():
        want = jrender(js, jc, 8, 8, spp=2, max_depth=4, seed=3)
    ts, tc = tget("sphere_grid")(aspect_ratio=1.0, dim=4).generate(
        device="cpu")
    got = render(ts, tc, 8, 8, spp=2, max_depth=4, seed=3)
    np.testing.assert_array_equal(got.depth_sum.numpy(),
                                  np.asarray(want.depth_sum))
    np.testing.assert_allclose(got.sum.numpy(), np.asarray(want.sum),
                               rtol=1e-4, atol=1e-4)
    assert got.depth_sum.numpy().sum() > 0

    # The JAX scene carried across renders as the port's own factory.
    back = convert.scene_from_numpy(**_scene_arrays(js))
    again = render(back, tc, 8, 8, spp=2, max_depth=4, seed=3)
    np.testing.assert_array_equal(again.sum.numpy(), got.sum.numpy())
    np.testing.assert_array_equal(again.depth_sum.numpy(),
                                  got.depth_sum.numpy())
