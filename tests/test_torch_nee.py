"""Port parity for next-event estimation with MIS (mrt_torch vs mrt):
light collection, light sampling, the MIS weights, ``Hits.prim_area``
and the ``cornell_nee_24`` golden.

Tolerances and why:
  - Light tables: host NumPy on both sides over equal scene arrays, so
    every array is byte-equal (cornell's 12 instanced light triangles,
    lucy's sun sphere, a brute-force triangle light beside a sphere).
  - ``sample_direct`` and ``mis_bsdf_weight`` on the same hits, lobes
    and draws against op-by-op JAX (``jax.disable_jit``, C2): the lanes
    that take a light sample equal, the light's contribution and the
    weights within rtol 1e-5 (XLA's float32 sin and cos of the sphere
    cone differ from torch's by an ulp, C9).  The shadow ray draws from
    the sampler after its four light draws in both.
  - ``prim_area`` of the hits that the scene dispatch produces (sphere
    radius, brute triangle area, TLAS world area) within rtol 1e-6.
  - ``cornell_nee_24`` through both port integrators, and the
    persistent integrator's pend film mode: C2's rule (at most 1% of
    pixels with another bounce count, every other pixel within 5e-4).
  - The persistent NEE render against the wavefront one on the
    reference's box (``tests/test_nee.py``): sums within 3e-4, the
    reference's own tolerance.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import golden_scenes as G
import torch_golden_scenes as TG
from mrt.core.camera import Camera as JCamera
from mrt.geometry.hit import Hits as JHits
from mrt.geometry.scene import SceneBuilder as JBuilder
from mrt.geometry.scene import attach_lights as jattach
from mrt.geometry.shapes import cube as jcube
from mrt.geometry.shapes import quad as jquad
from mrt.materials import lights as JL
from mrt.materials.background import SolidBackground as JSolid
from mrt.materials.table import MaterialBuilder as JMats
from mrt.math.rng import Sampler as JSampler
from mrt.scenes import get as jget
from mrt_torch.core.camera import Camera
from mrt_torch.geometry.hit import Hits
from mrt_torch.geometry.scene import SceneBuilder, attach_lights
from mrt_torch.geometry.shapes import cube, quad
from mrt_torch.materials import lights as TL
from mrt_torch.materials.background import SolidBackground
from mrt_torch.materials.table import MaterialBuilder
from mrt_torch.math.rng import Sampler
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass, render_pass_persistent
from mrt_torch.scenes import get as tget
from test_torch_textures import GOLDENS, MAX_FLIPPED, _port_film, outside_c2

torch.set_num_threads(2)


def _tables_equal(jt, tt):
    assert jt.count == tt.count
    for k in TL.LightTable.FIELDS:
        w, g = np.asarray(getattr(jt, k)), getattr(tt, k).numpy()
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), k


def _mixed(mats_cls, builder_cls, solid, quad_fn):
    """A sphere light and a brute-force triangle light over a floor."""
    mat = mats_cls()
    floor = mat.lambertian((0.7, 0.7, 0.7))
    fog = mat.lambertian((0.4, 0.6, 0.8))
    lamp = mat.diffuse_light((8.0, 7.0, 6.0))
    panel = mat.diffuse_light((2.0, 3.0, 4.0))
    sb = builder_cls(mat, solid.create((0.02, 0.02, 0.02)))
    sb.add_triangles(quad_fn((-4, 0, -4), (8, 0, 0), (0, 0, 8),
                             material=floor))
    sb.add_triangles(quad_fn((-1, 3, -1), (2, 0, 0), (0, 0, 2),
                             material=panel))
    sb.add_sphere((2.5, 2.0, 0.5), 0.6, lamp)
    sb.add_sphere((-1.0, 0.8, 0.5), 0.8, fog)
    return sb


def mixed_scenes():
    js = _mixed(JMats, JBuilder, JSolid, jquad).build(nee=True)
    ts = _mixed(MaterialBuilder, SceneBuilder, SolidBackground,
                quad).build("cpu", nee=True)
    return js, ts


def test_collect_lights_matches():
    js, jc = jget("cornell")().generate()
    ts, _ = tget("cornell")().generate(device="cpu")
    jt, tt = JL.collect_lights(js), TL.collect_lights(ts)
    assert tt.count == 12 and (tt.kind.numpy() == TL.TRI).all()
    _tables_equal(jt, tt)
    # attach_lights attaches the same table; a scene without lights none.
    _tables_equal(jattach(js).lights, attach_lights(ts).lights)
    rt, _ = tget("rtiow")(grid=2).generate(device="cpu")
    assert TL.collect_lights(rt) is None and attach_lights(rt).lights is None

    jm, tm = mixed_scenes()
    assert tm.lights.kind.tolist() == [TL.SPHERE, TL.TRI, TL.TRI]
    _tables_equal(jm.lights, tm.lights)


def test_collect_lights_lucy_sun():
    js, _ = jget("lucy")().generate()
    ts, _ = tget("lucy")().generate(device="cpu")
    jt, tt = JL.collect_lights(js), TL.collect_lights(ts)
    assert tt.count == 1 and tt.kind.item() == TL.SPHERE
    _tables_equal(jt, tt)


def _hits_from(th):
    """The JAX Hits record with the port's arrays."""
    return JHits(**{k: jnp.asarray(getattr(th, k).numpy())
                    for k in ("t", "point", "normal", "front_face", "uv",
                              "material", "hit", "tangent", "bitangent",
                              "prim_area")})


def _scene_hits(ts, rs, n, camera_at, spread):
    """Hits of random rays from around `camera_at` through the port's
    scene dispatch."""
    o = (np.asarray(camera_at, np.float32)
         + rs.uniform(-spread, spread, (n, 3)).astype(np.float32))
    d = rs.standard_normal((n, 3)).astype(np.float32)
    d[:, 1] -= 0.5
    th = ts.intersect(torch.from_numpy(o), torch.from_numpy(d))
    return o, d, th


@pytest.mark.parametrize("which", ["cornell", "mixed"])
def test_sample_direct_and_mis_weight_match(which):
    if which == "cornell":
        js, _ = jget("cornell")().generate()
        ts, _ = tget("cornell")().generate(device="cpu")
        js, ts = jattach(js), attach_lights(ts)
        at, spread = (0.0, 5.0, 0.0), 4.0
    else:
        js, ts = mixed_scenes()
        at, spread = (0.0, 1.5, 0.0), 1.5
    rs = np.random.default_rng(4)
    n = 2048
    o, d, th = _scene_hits(ts, rs, n, at, spread)
    with jax.disable_jit():
        jh = js.intersect(jnp.asarray(o), jnp.asarray(d))
    # prim_area from the dispatch: the same winners, areas and radii.
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_allclose(th.prim_area.numpy(),
                               np.asarray(jh.prim_area), rtol=1e-6)
    assert (th.prim_area.numpy() > 0).any()
    if which == "mixed":
        assert (th.prim_area.numpy() < 0).any()

    lobe = np.where(th.hit.numpy(), rs.integers(0, 3, n), 0).astype(np.int32)
    ids = rs.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    jhits = _hits_from(th)
    with jax.disable_jit():
        js_s = JSampler(5, jnp.asarray(ids), salt=(1 << 30) + 6)
        want, want_did = JL.sample_direct(js, jhits, js_s,
                                          lobe=jnp.asarray(lobe))
    ts_s = Sampler(5, torch.from_numpy(ids.astype(np.int64)),
                   salt=(1 << 30) + 6)
    got, did = TL.sample_direct(ts, th, ts_s, torch.from_numpy(lobe))
    assert js_s._draw == ts_s._draw
    np.testing.assert_array_equal(did.numpy(), np.asarray(want_did))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    lit = (got.numpy() > 0).any(-1)
    assert lit.sum() > n // 20 and (did.numpy() & ~lit).any()  # shadowed

    prev = np.where(rs.random(n) < 0.8, rs.uniform(0, 2, n), 0).astype(
        np.float32)
    with jax.disable_jit():
        want_w = JL.mis_bsdf_weight(js, jhits, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(prev))
        want_pdf = JL.bsdf_pdf(jnp.asarray(lobe), jnp.asarray(
            th.normal.numpy()), jnp.asarray(d))
    got_w = TL.mis_bsdf_weight(ts, th, torch.from_numpy(o),
                               torch.from_numpy(d), torch.from_numpy(prev))
    got_pdf = TL.bsdf_pdf(torch.from_numpy(lobe), th.normal,
                          torch.from_numpy(d))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got_pdf.numpy(), np.asarray(want_pdf),
                               rtol=1e-6, atol=1e-7)
    assert ((got_w.numpy() > 0) & (got_w.numpy() < 1)).any()


@pytest.mark.parametrize("integrator", ["wavefront", "persistent", "pend"])
def test_cornell_nee_golden(integrator):
    gold = np.load(os.path.join(GOLDENS, f"cornell_nee_{G.SIZE}.npz"))
    if integrator == "pend":
        scene, camera = TG.cornell_nee("cpu")
        film = render_pass_persistent(
            scene, camera, Film.create(G.SIZE, G.SIZE, device="cpu"), G.SEED,
            0, width=G.SIZE, height=G.SIZE, max_depth=G.DEPTH,
            samples=G.SPP, pool=1024, pend=True)
    else:
        film = _port_film("cornell_nee", integrator)
    flipped, off = outside_c2(film, gold)
    assert flipped.sum() <= MAX_FLIPPED and not off.any(), (flipped.sum(),
                                                             off.sum())


def _box(mats_cls, builder_cls, solid, cube_fn, camera_cls, nee, **build):
    """tests/test_nee.py's box with a ceiling panel light."""
    mat = mats_cls()
    white = mat.lambertian((0.75, 0.75, 0.75))
    red = mat.lambertian((0.8, 0.2, 0.2))
    light = mat.diffuse_light((12.0, 12.0, 12.0))
    sb = builder_cls(mat, solid.create((0, 0, 0)))
    mesh = sb.add_mesh(cube_fn(size=2.0))
    s = 4.0
    sb.add_instance(mesh, (-s - 1, 0, 0), scale=(1, s, s), material=red)
    sb.add_instance(mesh, (s + 1, 0, 0), scale=(1, s, s), material=white)
    sb.add_instance(mesh, (0, -s - 1, 0), scale=(s, 1, s), material=white)
    sb.add_instance(mesh, (0, s + 1, 0), scale=(s, 1, s), material=white)
    sb.add_instance(mesh, (0, 0, -s - 1), scale=(s, s, 1), material=white)
    sb.add_instance(mesh, (0, s - 0.01, 0), scale=(1.0, 0.01, 1.0),
                    material=light)
    camera = camera_cls.create(55.0, (0, 0, 2 * s), (0, 0, 0), (0, 1, 0),
                               aspect_ratio=1.0, focus_distance=2 * s)
    return sb.build(nee=nee, **build), camera


def test_persistent_nee_matches_wavefront():
    ts, tc = _box(MaterialBuilder, SceneBuilder, SolidBackground, cube,
                  Camera, True, device="cpu")
    js, _ = _box(JMats, JBuilder, JSolid, jcube, JCamera, True)
    assert ts.lights.count == 12
    _tables_equal(js.lights, ts.lights)
    w = h = 10
    args = dict(width=w, height=h, max_depth=4, samples=4)
    batch = render_pass(ts, tc, Film.create(w, h, device="cpu"), 3, 0,
                        **args)
    pers = render_pass_persistent(ts, tc, Film.create(w, h, device="cpu"),
                                  3, 0, pool=128, **args)
    np.testing.assert_allclose(pers.sum.numpy(), batch.sum.numpy(),
                               rtol=3e-4, atol=3e-4)
    assert batch.sum.numpy().mean() > 0.05
