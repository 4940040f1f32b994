"""Port parity: shading, backgrounds and the film (mrt_torch vs mrt).

The same hits, incoming directions and samplers go to both packages'
``shade_hit``; JAX runs op by op (``jax.disable_jit``), so no
multiply-add is contracted on its side.  Tolerance: RNG-driven choices
(material class, Mix branch, Fresnel reflect/refract, absorption) must
agree exactly; float outputs agree to atol/rtol 1e-6, because XLA and
PyTorch round cos, sin and cbrt differently by up to 2 ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.geometry.hit import Hits as JHits
from mrt.geometry.scene import Scene as JScene
from mrt.materials import background as jbg
from mrt.materials import shade as jshade
from mrt.materials.table import MaterialBuilder as JBuilder
from mrt.math.rng import Sampler as JSampler
from mrt.runtime.film import DisplayMode as JMode
from mrt.runtime.film import Film as JFilm
from mrt_torch.geometry.hit import Hits
from mrt_torch.geometry.scene import Scene
from mrt_torch.materials import background as bg
from mrt_torch.materials import shade
from mrt_torch.materials.table import MaterialBuilder, MaterialTable
from mrt_torch.math.rng import Sampler
from mrt_torch.runtime.film import DisplayMode, Film

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _table(b, with_mix):
    lam = b.lambertian((0.8, 0.3, 0.2))
    met = b.metal(0.3, (0.7, 0.6, 0.5))
    diel = b.dielectric(1.5)
    b.diffuse_light((4.0, 3.0, 2.0))
    b.isotropic((0.5, 0.6, 0.7))
    b.specular(1.8, (0.2, 0.4, 0.9))
    b.null()
    b.metal(0.0, (0.9, 0.9, 0.9))
    if with_mix:
        inner = b.mix(0.4, lam, met)
        b.mix(0.7, inner, diel)  # nested two deep
    return b


def _scenes(with_mix):
    """The same table from both packages' builders: byte-equal arrays."""
    jb, tb = _table(JBuilder(), with_mix), _table(MaterialBuilder(), with_mix)
    jmat, tmat = jb.build(), tb.build()
    for k in MaterialTable.FIELDS:
        assert (getattr(tmat, k).numpy().tobytes()
                == np.asarray(getattr(jmat, k)).tobytes()), k
    assert tmat.mix_depth == jmat.mix_depth == (2 if with_mix else 0)
    assert tb.has_mix() is jb.has_mix() is with_mix
    js = JScene(materials=jmat, background=jbg.SkyBackground.create(),
                has_mix=jb.has_mix())
    ts = Scene(materials=tmat, background=bg.SkyBackground.create(),
               has_mix=tb.has_mix())
    return js, ts, jmat.count


def test_material_builder_rejects_bad_mix_nesting():
    b = MaterialBuilder()
    b.mix(0.5, 1, 0)
    b.mix(0.5, 0, 0)  # rows 0 and 1 refer to each other
    with pytest.raises(ValueError, match="cycle"):
        b.build()
    b = MaterialBuilder()
    leaf = b.lambertian()
    for _ in range(5):
        leaf = b.mix(0.5, leaf, 0)
    with pytest.raises(ValueError, match="MAX_MIX_DEPTH"):
        b.build()


def _hits(rs, n, rows):
    normal = rs.standard_normal((n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = rs.standard_normal((n, 3)).astype(np.float32)
    arrays = dict(
        t=rs.uniform(0.5, 5, n).astype(np.float32),
        point=rs.uniform(-3, 3, (n, 3)).astype(np.float32),
        normal=normal,
        front_face=rs.random(n) < 0.7,
        material=rs.integers(0, rows, n).astype(np.int32),
        hit=rs.random(n) < 0.9,
    )
    z3, z2 = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32)
    jh = JHits(uv=jnp.asarray(z2), tangent=jnp.asarray(z3),
               bitangent=jnp.asarray(z3), prim_area=jnp.zeros(n),
               **{k: jnp.asarray(v) for k, v in arrays.items()})
    th = Hits(uv=torch.from_numpy(z2), tangent=torch.from_numpy(z3),
              bitangent=torch.from_numpy(z3),
              **{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jh, th, d


@pytest.mark.parametrize("with_mix", [False, True])
def test_shade_hit_matches_reference(with_mix):
    js, ts, rows = _scenes(with_mix)
    rs = np.random.default_rng(21 + with_mix)
    n = 4096
    jh, th, d = _hits(rs, n, rows)
    ids = rs.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    bounce = 3
    with jax.disable_jit():
        want = jshade.shade_hit(
            js, jh, jnp.asarray(d),
            JSampler(5, jnp.asarray(ids), salt=3 * bounce),
            JSampler(5, jnp.asarray(ids), salt=3 * bounce + 1))
    tid = torch.from_numpy(ids.astype(np.int64))
    got = shade.shade_hit(ts, th, torch.from_numpy(d),
                          Sampler(5, tid, salt=3 * bounce),
                          Sampler(5, tid, salt=3 * bounce + 1))
    names = ("emitted", "atten", "new_dir", "scattered", "lobe")
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), g.numpy()
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    # Every class took part.
    mtype = ts.materials.mtype[th.material].numpy()
    assert len(np.unique(mtype[th.hit.numpy()])) == len(np.unique(
        ts.materials.mtype.numpy()))


def test_backgrounds_match_reference():
    rs = np.random.default_rng(22)
    d = rs.standard_normal((2048, 3)).astype(np.float32)
    with jax.disable_jit():
        sky = np.asarray(jbg.SkyBackground.create().eval(jnp.asarray(d)))
        solid = np.asarray(jbg.SolidBackground.create(
            (0.1, 0.2, 0.3)).eval(jnp.asarray(d)))
    td = torch.from_numpy(d)
    np.testing.assert_array_equal(bg.SkyBackground.create().eval(td).numpy(),
                                  sky)
    np.testing.assert_array_equal(
        bg.SolidBackground.create((0.1, 0.2, 0.3)).eval(td).numpy(), solid)


def test_film_tonemap_and_checkpoint(tmp_path):
    rs = np.random.default_rng(23)
    s = (rs.random((6, 5, 3)) * 3).astype(np.float32)
    depth = rs.integers(0, 40, (6, 5)).astype(np.int32)
    jf = JFilm(sum=jnp.asarray(s), depth_sum=jnp.asarray(depth),
               samples=jnp.asarray(4, jnp.int32))
    tf = Film(sum=torch.from_numpy(s), depth_sum=torch.from_numpy(depth),
              samples=4)
    for jm, tm in ((JMode.DEFAULT, DisplayMode.DEFAULT),
                   (JMode.DEPTH, DisplayMode.DEPTH)):
        np.testing.assert_allclose(tf.to_float_rgb(tm).numpy(),
                                   np.asarray(jf.to_float_rgb(jm)), **TOL)
        assert np.abs(tf.to_rgb_bytes(tm).astype(int)
                      - jf.to_rgb_bytes(jm).astype(int)).max() <= 1
    assert not Film.create(5, 6, device="cpu").to_float_rgb().any()

    merged = tf.merge(torch.from_numpy(s), torch.from_numpy(depth))
    assert merged.samples == 5
    np.testing.assert_array_equal(merged.depth_sum.numpy(), 2 * depth)
    path = tmp_path / "film.npz"
    merged.save_state(path, seed=9)
    back, seed = Film.load_state(path, device="cpu")
    assert seed == 9 and back.samples == 5
    np.testing.assert_array_equal(back.sum.numpy(), merged.sum.numpy())
    np.testing.assert_array_equal(back.depth_sum.numpy(),
                                  merged.depth_sum.numpy())
    # The JAX package reads the port's checkpoint.
    jback, jseed = JFilm.load_state(path)
    assert jseed == 9 and int(jback.samples) == 5
