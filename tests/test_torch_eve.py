"""Port parity: EVE packed-PBR shading, normal maps, the alpha test, the
eve fleet scene and the eve_ball_24 golden (mrt_torch vs mrt).

Tolerances and why:
  - Scene building is host NumPy on both sides: the fleet's material
    table, atlas, TLAS, volume and cube map are byte-equal.
  - Shading on the same hits and samplers, JAX op by op: the cases of
    tests/test_eve.py and tests/test_alpha.py, and random hits over the
    fleet's materials.  RNG-driven choices and masks exact; floats
    within 1e-6 (XLA and PyTorch round sin, cos and cbrt differently by
    up to 2 ulp, tests/test_torch_shade.py).
  - eve_ball_24 through both port integrators against the committed
    golden: the C2 rule (at most 1% of pixels with another bounce
    count, every other pixel within 5e-4).
  - The fleet at 32x32, spp 2, depth 6, against the compiled JAX
    render (ROADMAP C11): B7's plain version and the reference's XLA
    traversal round (u, v) differently in the last bits (agreeing to
    1e-5, tests/test_torch_tlas.py); the hit's UV picks the normal-map
    texels, and the tangent frame of the stand-in hulls (unnormalised,
    lengths up to ~80) scales the difference up, so some paths drift
    apart while keeping their bounce count.  Held: at most 1% of
    pixels with another bounce count and at most 1% more outside 5e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import golden_scenes as G
import torch_golden_scenes as TG
from mrt.geometry.hit import Hits as JHits
from mrt.geometry.scene import Scene as JScene
from mrt.geometry.scene import SceneBuilder as JBuilder
from mrt.geometry.shapes import quad as jquad
from mrt.materials import background as jbg
from mrt.materials import shade as jshade
from mrt.materials.table import MaterialBuilder as JMats
from mrt.math.rng import Sampler as JSampler
from mrt.runtime.render import render as jrender
from mrt.scenes import get as jget
from mrt.textures.atlas import AtlasBuilder as JAtlas
from mrt_torch.geometry.hit import Hits
from mrt_torch.geometry.scene import Scene, SceneBuilder
from mrt_torch.geometry.shapes import quad
from mrt_torch.geometry import instance as TI
from mrt_torch.materials import background as tbg
from mrt_torch.materials import shade
from mrt_torch.materials.table import MaterialBuilder, MaterialTable
from mrt_torch.math.rng import Sampler
from mrt_torch.runtime.render import render, render_pass_persistent
from mrt_torch.runtime.film import Film
from mrt_torch.scenes import get
from mrt_torch.textures.atlas import CLAMP, AtlasBuilder, TextureAtlas
from test_torch_textures import GOLDENS, MAX_FLIPPED, _port_film, outside_c2

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _bytes_equal(want, got, what):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, what
    assert want.tobytes() == got.tobytes(), what


def test_fleet_scene_arrays_equal():
    js, jc = jget("eve")(aspect_ratio=1.0).generate()
    ts, tc = get("eve")(aspect_ratio=1.0).generate(device="cpu")
    for k in MaterialTable.FIELDS:
        _bytes_equal(getattr(js.materials, k), getattr(ts.materials, k), k)
    for k in TextureAtlas.FIELDS:
        _bytes_equal(getattr(js.atlas, k), getattr(ts.atlas, k), k)
    for k in ("faces", "transform"):
        _bytes_equal(getattr(js.background, k), getattr(ts.background, k), k)
    for k in ("center", "radius", "neg_inv_density", "material"):
        _bytes_equal(getattr(js.volumes, k), getattr(ts.volumes, k), k)
    for k in ("center", "radius", "material"):
        _bytes_equal(getattr(js.spheres, k), getattr(ts.spheres, k), k)
    for k in TI.FIELDS:
        if k != "inv_transform":
            _bytes_equal(getattr(js.tlas, k), getattr(ts.tlas, k), k)
    assert ts.tlas.n_instances == 37 and ts.spheres.count == 1
    assert js.mat_tex_raw is ts.mat_tex_raw is True
    assert js.needs_alpha is ts.needs_alpha is False
    assert js.background.faces_raw is ts.background.faces_raw is True
    for k in tc.FIELDS:
        _bytes_equal(getattr(jc, k), getattr(tc, k), k)


def _eve_scenes(ar_px, no_px, pmdg_px, palette, glow=(0.5, 0.85, 2.0)):
    """tests/test_eve.py's one-texel EVE scene, from both packages."""
    out = []
    for atlas_cls, mats_cls, scene_cls, bg in (
            (JAtlas, JMats, JScene, jbg), (AtlasBuilder, MaterialBuilder,
                                           Scene, tbg)):
        atlas = atlas_cls()
        ids = [atlas.add_raw(np.broadcast_to(np.asarray(px, np.float32),
                                             (1, 1, 4)).copy())
               for px in (ar_px, no_px, pmdg_px)]
        mats = mats_cls()
        row = mats.eve(ids[0], ids[1], ids[2], palette, glow=glow)
        out.append(scene_cls(materials=mats.build(),
                             background=bg.SolidBackground.create((0, 0, 0)),
                             atlas=atlas.build()))
    return out[0], out[1], row


def _hits(n, material, tangent=(0, 0, 0), bitangent=(0, 0, 0), rs=None):
    """tests/test_eve.py's hits (normal +y, uv 0.5), or random ones."""
    f = dict(
        t=np.ones(n, np.float32), point=np.zeros((n, 3), np.float32),
        normal=np.tile(np.float32([0, 1, 0]), (n, 1)),
        front_face=np.ones(n, bool), uv=np.full((n, 2), 0.5, np.float32),
        material=np.broadcast_to(np.int32(material), (n,)).copy(),
        hit=np.ones(n, bool),
        tangent=np.tile(np.float32(tangent), (n, 1)),
        bitangent=np.tile(np.float32(bitangent), (n, 1)))
    if rs is not None:
        nrm = rs.standard_normal((n, 3)).astype(np.float32)
        f.update(
            normal=nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
            front_face=rs.random(n) < 0.7, hit=rs.random(n) < 0.9,
            uv=rs.uniform(-2, 3, (n, 2)).astype(np.float32),
            tangent=rs.standard_normal((n, 3)).astype(np.float32) * 5,
            bitangent=rs.standard_normal((n, 3)).astype(np.float32) * 5)
        f["tangent"][::7] = 0.0  # no frame: no normal map
    jh = JHits(prim_area=jnp.zeros(n), **{k: jnp.asarray(v)
                                          for k, v in f.items()})
    return jh, Hits(**{k: torch.from_numpy(v) for k, v in f.items()})


def _down(n):
    d = np.tile(np.float32([0, -1, 0]), (n, 1))
    return jnp.asarray(d), torch.from_numpy(d)


def _samplers(n, seed=0):
    return (JSampler(seed, jnp.arange(n, dtype=jnp.uint32)),
            Sampler(seed, torch.arange(n)))


def _scatter_both(js, ts, jh, th, d, seed=0):
    jd, td = d
    js_s, ts_s = _samplers(len(td), seed)
    with jax.disable_jit():
        want = jshade.scatter(js, jh, jd, js_s)
    got = shade.scatter(ts, th, td, ts_s)
    assert js_s._draw == ts_s._draw
    for name, w, g in zip(("atten", "dir", "scattered", "lobe"), want, got):
        if g.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)
    return [g.numpy() for g in got[:3]]


@pytest.mark.parametrize("case", ["palette", "paint"])
def test_eve_surface_cases(case):
    # palette: mask 1/3 -> exactly palette[1]; paint 1 -> the albedo.
    if case == "palette":
        args = ((1, 1, 1, 1.0), (0.5, 0.5, 1.0, 0.5),
                (0.0, 1.0 / 3.0, 0.0, 0.0),
                [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)])
        expect = [0, 1, 0]
    else:
        args = ((0.3, 0.6, 0.9, 1.0), (0.5, 0.5, 1.0, 0.5),
                (1.0, 0.0, 0.0, 0.0), [(1, 0, 0)] * 4)
        expect = [0.3, 0.6, 0.9]
    js, ts, row = _eve_scenes(*args)
    n = 64
    atten, _, scattered = _scatter_both(js, ts, *_hits(n, row), _down(n))
    assert scattered.all()
    np.testing.assert_allclose(atten, [expect] * n, atol=1e-5)


def test_glow_emission():
    js, ts, row = _eve_scenes((1, 1, 1, 1.0), (0.5, 0.5, 1.0, 0.5),
                              (0.0, 0.0, 0.0, 0.5), [(1, 1, 1)] * 4)
    n = 8
    jh, th = _hits(n, row)
    js_s, ts_s = _samplers(n, seed=1)
    with jax.disable_jit():
        want = np.asarray(jshade.emitted(js, jh, js_s))
    got = shade.emitted(ts, th, ts_s).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, [np.array([0.5, 0.85, 2.0]) * 5.0] * n,
                               rtol=1e-5)


def test_roughness_zero_is_specular():
    js, ts, row = _eve_scenes((0.2, 0.2, 0.2, 0.0), (0.5, 0.5, 1.0, 0.5),
                              (1.0, 0.0, 0.0, 0.0), [(1, 1, 1)] * 4)
    n = 1 << 12
    atten, _, scattered = _scatter_both(js, ts, *_hits(n, row), _down(n))
    assert scattered.all()
    r0 = ((1 - 1 / 1.8) / (1 + 1 / 1.8)) ** 2
    assert abs(np.isclose(atten[:, 0], 1.0).mean() - r0) < 0.02


def test_normal_map_tilts_normal():
    js, ts, row = _eve_scenes((1, 1, 1, 1.0), (0.0, 0.75, 1.0, 0.5),
                              (0.0, 0.0, 0.0, 0.0), [(1, 1, 1)] * 4)
    n = 4
    jh, th = _hits(n, row, tangent=(1, 0, 0), bitangent=(0, 0, 1))
    jd, td = _down(n)
    with jax.disable_jit():
        want = jshade.apply_normal_maps(js, jh, jd)
    got = shade.apply_normal_maps(ts, th, td)
    np.testing.assert_array_equal(got.normal.numpy(), np.asarray(want.normal))
    np.testing.assert_allclose(got.normal.numpy(),
                               [[0.5, np.sqrt(0.75), 0.0]] * n, atol=1e-4)
    assert got.front_face.numpy().all()


@pytest.mark.parametrize("compact", ["0", "1"])
def test_fleet_shading_matches_reference(monkeypatch, compact):
    # Random hits over the fleet's rows (EVE, isotropic, light): the
    # texel fetches, EVE decode, glow and normal maps, with and without
    # texel compaction (the reference's compaction through XLA).
    monkeypatch.setenv("MRT_TEX_COMPACT", compact)
    monkeypatch.setenv("MRT_ONEHOT", "xla")
    js, _ = jget("eve")(aspect_ratio=1.0).generate()
    ts, _ = get("eve")(aspect_ratio=1.0).generate(device="cpu")
    rs = np.random.default_rng(16)
    n = 4096  # compaction: K = 2048, two rounds
    rows = rs.integers(0, ts.materials.mtype.shape[0], n)
    jh, th = _hits(n, rows, rs=rs)
    d = rs.standard_normal((n, 3)).astype(np.float32)
    ids = rs.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    tid = torch.from_numpy(ids.astype(np.int64))
    with jax.disable_jit():
        jm = jshade.apply_normal_maps(js, jh, jnp.asarray(d))
        want = jshade.shade_hit(js, jm, jnp.asarray(d),
                                JSampler(5, jnp.asarray(ids), salt=9),
                                JSampler(5, jnp.asarray(ids), salt=10))
    tm = shade.apply_normal_maps(ts, th, torch.from_numpy(d))
    np.testing.assert_array_equal(tm.front_face.numpy(),
                                  np.asarray(jm.front_face))
    np.testing.assert_allclose(tm.normal.numpy(), np.asarray(jm.normal),
                               **TOL)
    got = shade.shade_hit(ts, tm, torch.from_numpy(d),
                          Sampler(5, tid, salt=9), Sampler(5, tid, salt=10))
    for name, w, g in zip(("emitted", "atten", "dir", "scattered", "lobe"),
                          want, got):
        if g.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)
    mtype = ts.materials.mtype.numpy()[rows]
    assert set(np.unique(mtype)) == {3, 4, 8}  # light, isotropic, EVE
    assert (got[0].numpy()[mtype == 8] > 0).any()  # some glow


def _cutout_scenes():
    """tests/test_alpha.py's scene: a quad whose left half is clear, a
    solid quad behind it, from both packages."""
    out = []
    for atlas_cls, mats_cls, builder, quad_fn, bg in (
            (JAtlas, JMats, JBuilder, jquad, jbg),
            (AtlasBuilder, MaterialBuilder, SceneBuilder, quad, tbg)):
        atlas = atlas_cls()
        px = np.zeros((1, 4, 4), np.float32)
        px[..., 0] = 1.0
        px[0, 3, 3] = 1.0
        tex = atlas.add_raw(px, wrap=CLAMP)
        mats = mats_cls()
        front = mats.lambertian(tex=tex)
        back = mats.lambertian((0.0, 0.0, 1.0))
        sb = builder(mats, bg.SolidBackground.create((0, 0, 0)),
                     atlas=atlas.build())
        sb.add_triangles(quad_fn((-1.0, -1.0, 2.0), (2.0, 0.0, 0.0),
                                 (0.0, 2.0, 0.0), material=front))
        sb.add_triangles(quad_fn((-1.0, -1.0, 4.0), (2.0, 0.0, 0.0),
                                 (0.0, 2.0, 0.0), material=back))
        out.append(sb.build() if builder is JBuilder
                   else sb.build(device="cpu"))
    return out


def test_transparent_texel_passes_through():
    js, ts = _cutout_scenes()
    assert js.needs_alpha and ts.needs_alpha
    assert js.mat_tex_raw is ts.mat_tex_raw is True
    rs = np.random.default_rng(17)
    n = 256
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rs.uniform(-0.95, 0.95, (n, 2))
    o[:2] = [[-0.9, -0.5, 0.0], [0.9, -0.5, 0.0]]
    d = np.tile(np.float32([0, 0, 1]), (n, 1))
    d[2:] += rs.normal(0, 0.05, (n - 2, 3)).astype(np.float32)
    with jax.disable_jit():
        want = js.intersect(jnp.asarray(o), jnp.asarray(d),
                            sampler=JSampler(0, jnp.arange(n,
                                                           dtype=jnp.uint32)))
    sampler = Sampler(0, torch.arange(n))
    got = ts.intersect(torch.from_numpy(o), torch.from_numpy(d),
                       sampler=sampler)
    # The left ray sees the back quad (t=4), the right one the front.
    np.testing.assert_allclose(got.t.numpy()[:2], [4.0, 2.0], atol=1e-4)
    assert got.material.numpy()[0] != got.material.numpy()[1]
    for k in ("hit", "material", "front_face"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    # Each of the three rounds resolved the rows: 4 draws skipped each.
    assert sampler._draw == 12
    assert 0.2 < (got.t.numpy() > 3).mean() < 0.8


def test_alpha_test_matches_reference():
    js, ts = _cutout_scenes()
    rs = np.random.default_rng(18)
    n = 1024
    rows = rs.integers(0, 2, n).astype(np.int32)
    uv = rs.uniform(-0.5, 1.5, (n, 2)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jshade.alpha_test(
            js, jnp.asarray(rows), jnp.asarray(uv),
            JSampler(0, jnp.arange(n, dtype=jnp.uint32))))
    got = shade.alpha_test(ts, torch.from_numpy(rows), torch.from_numpy(uv),
                           Sampler(0, torch.arange(n))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < (~got).mean() < 0.5


def test_may_alpha_test_flags():
    mats = MaterialBuilder()
    mats.lambertian((1.0, 0.5, 0.2))
    assert not mats.may_alpha_test()
    mats.lambertian(tex=3)
    assert mats.may_alpha_test()
    mats = MaterialBuilder()
    mats.mix(0.5, mats.null(), mats.lambertian(tex=3))
    assert mats.may_alpha_test()


@pytest.mark.parametrize("integrator", ["wavefront", "persistent"])
def test_eve_ball_golden(integrator):
    gold = np.load(f"{GOLDENS}/eve_ball_{G.SIZE}.npz")
    film = _port_film("eve_ball", integrator)
    flipped, off = outside_c2(film, gold)
    assert flipped.sum() <= MAX_FLIPPED and not off.any(), (flipped.sum(),
                                                             off.sum())


@pytest.mark.parametrize("name", ["eve", "textured", "volume"])
def test_convert_carries_the_scene(name):
    # The JAX scene's arrays (atlas, cube map, volumes, alpha and raw
    # flags included) carried into the port render what the port's own
    # factory renders.
    from mrt_torch import convert
    from test_torch_mesh_scenes import scene_numpy

    if name == "eve":
        js, _ = jget("eve")(aspect_ratio=1.0).generate()
        ts, tc = get("eve")(aspect_ratio=1.0).generate(device="cpu")
    else:
        js, _ = G.FACTORIES[name]()
        ts, tc = TG.FACTORIES[name]("cpu")
    back = convert.scene_from_numpy(**scene_numpy(js))
    assert back.needs_alpha is ts.needs_alpha
    assert type(back.background) is type(ts.background)
    want, got = (render(s, tc, 16, 16, spp=1, max_depth=4, seed=3)
                 for s in (ts, back))
    np.testing.assert_array_equal(got.sum.numpy(), want.sum.numpy())
    np.testing.assert_array_equal(got.depth_sum.numpy(),
                                  want.depth_sum.numpy())
    assert want.depth_sum.sum() > 0


def test_convert_makes_a_sky_sphere():
    from mrt_torch import convert

    sky = convert._background(dict(tex=np.int32(2)))
    assert isinstance(sky, tbg.SkySphere) and int(sky.tex) == 2


@pytest.fixture(scope="module")
def fleet_jax():
    scene, camera = jget("eve")(aspect_ratio=1.0).generate()
    film = jrender(scene, camera, 32, 32, spp=2, max_depth=6, seed=5)
    return np.asarray(film.sum), np.asarray(film.depth_sum)


@pytest.mark.parametrize("integrator", ["wavefront", "persistent"])
def test_fleet_matches_reference(fleet_jax, integrator):
    scene, camera = get("eve")(aspect_ratio=1.0).generate(device="cpu")
    if integrator == "wavefront":
        film = render(scene, camera, 32, 32, spp=2, max_depth=6, seed=5)
    else:
        film = render_pass_persistent(scene, camera,
                                      Film.create(32, 32, device="cpu"), 5, 0,
                                      width=32, height=32, max_depth=6,
                                      samples=2, pool=4096)
    want_sum, want_depth = fleet_jax
    flipped, off = outside_c2(film, dict(sum=want_sum, depth=want_depth))
    print(f"eve 32x32 {integrator}: {flipped.sum()} px flip, {off.sum()} "
          "more outside 5e-4, of 1024")
    assert flipped.sum() <= 10 and off.sum() <= 10  # C11: 5 and 3 seen
    assert torch.isfinite(film.sum).all()
