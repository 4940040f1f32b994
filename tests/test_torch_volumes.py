"""Port parity: participating media bounded by spheres and by instanced
meshes, their draws, and the volume_24 golden (mrt_torch vs mrt).

Tolerances and why:
  - Sphere volumes on the same uniforms, JAX op by op: XLA:CPU's
    float32 ``log`` is not correctly rounded (it differs from torch's by
    an ulp on ~14% of inputs, ROADMAP C9), so free-flight distances may
    differ by an ulp: events equal, t within rtol 1e-6.  With XLA's log
    in place of torch's the hits are bit-equal.
  - Mesh volumes: the boundary's entry and exit come from B7's plain
    version, whose t agrees with the reference's XLA traversal to rtol
    1e-5 (tests/test_torch_tlas.py): events equal on 99.9% of the lanes
    (a free flight at the inside distance's edge may go either way), t
    within rtol 1e-5.
  - Draw order: a scene's intersect draws one uniform a sphere volume,
    then one a mesh volume, from the caller's sampler: the sampler's
    counter after intersect equals JAX's.
  - volume_24 through both port integrators against the committed
    golden: the C2 rule (at most 1% of pixels with another bounce count,
    every other pixel within 5e-4).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import golden_scenes as G
import torch_golden_scenes as TG
from mrt.geometry import volumes as JV
from mrt.math.rng import Sampler as JSampler
from mrt_torch.geometry import volumes as TV
from mrt_torch.math.rng import Sampler
from test_torch_textures import GOLDENS, MAX_FLIPPED, _port_film, outside_c2
from test_torch_textures import xla

torch.set_num_threads(2)


def _rays(rs, n, spread, at=(0.0, 0.0, 0.0)):
    """Rays from a box of half-width `spread` around `at`, most aimed at
    points within 1.5 of it."""
    at = np.asarray(at, np.float32)
    o = (at + rs.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = (at + rs.uniform(-1.5, 1.5, (n, 3)) - o).astype(np.float32)
    d[::5] = rs.standard_normal((len(d[::5]), 3))
    return o, d


@pytest.mark.parametrize("xla_log", [False, True])
def test_sphere_volumes_match_reference(monkeypatch, xla_log):
    js, _ = G.volume()
    ts, _ = TG.volume("cpu")
    rs = np.random.default_rng(13)
    n = 4096
    o, d = _rays(rs, n, 3.0)
    # Two spheres: the golden's and a denser, overlapping one.
    center = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.2, 0.0]], np.float32)
    radius = np.asarray([1.2, 0.8], np.float32)
    nid = np.asarray([-1 / 1.2, -1 / 4.0], np.float32)
    mat = np.asarray([1, 2], np.int32)
    jv = JV.VolumeSpheres(*(jnp.asarray(a) for a in (center, radius, nid,
                                                     mat)))
    tv = TV.VolumeSpheres(center, radius, nid, mat)
    u = rs.random((n, 2)).astype(np.float32)
    t_min = rs.uniform(-1.0, 1.0, n).astype(np.float32)
    t_max = np.where(rs.random(n) < 0.5, np.inf,
                     rs.uniform(0.5, 6.0, n)).astype(np.float32)
    with jax.disable_jit():
        want = JV.intersect(jv, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(t_min), jnp.asarray(t_max),
                            jnp.asarray(u))
    if xla_log:
        monkeypatch.setattr(torch, "log", xla(jnp.log))
    got = TV.intersect(tv, *(torch.from_numpy(a) for a in (o, d, t_min,
                                                            t_max, u)))
    hit = np.asarray(want.hit)
    assert 0.2 < hit.mean() < 0.8
    for k in ("hit", "material", "front_face", "normal", "uv", "tangent"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    if xla_log:
        for k in ("t", "point"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)))
    else:
        np.testing.assert_allclose(got.t.numpy()[hit],
                                   np.asarray(want.t)[hit], rtol=1e-6)
    del ts


def test_mesh_volume_matches_reference():
    js, _ = G.volume()
    ts, _ = TG.volume("cpu")
    jvol, tvol = js.mesh_volumes[0], ts.mesh_volumes[0]
    rs = np.random.default_rng(14)
    n = 2048
    o, d = _rays(rs, n, 4.0, at=(2.2, 0.0, 0.0))
    u = rs.random(n).astype(np.float32)
    t_min = rs.uniform(-1.0, 1.0, n).astype(np.float32)
    t_max = np.where(rs.random(n) < 0.5, np.inf,
                     rs.uniform(0.5, 6.0, n)).astype(np.float32)
    with jax.disable_jit():
        want = JV.intersect_mesh(jvol, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t_min), jnp.asarray(t_max),
                                 jnp.asarray(u))
    got = TV.intersect_mesh(tvol, *(torch.from_numpy(a) for a in (
        o, d, t_min, t_max, u)))
    hit = np.asarray(want.hit)
    assert 0.1 < hit.mean() < 0.9
    assert (got.hit.numpy() == hit).mean() > 0.999
    both = hit & got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(want.t)[both],
                               rtol=1e-5, atol=1e-6)
    assert (got.material.numpy() == int(tvol.material)).all()


def test_intersect_draws_like_reference():
    js, jc = G.volume()
    ts, tc = TG.volume("cpu")
    n = 64
    o, d = _rays(np.random.default_rng(15), n, 1.0)
    ids = np.arange(n, dtype=np.uint32)
    js_s, ts_s = JSampler(5, jnp.asarray(ids), 2), Sampler(5, torch.arange(n),
                                                           2)
    with jax.disable_jit():
        want = js.intersect(jnp.asarray(o), jnp.asarray(d), sampler=js_s)
    got = ts.intersect(torch.from_numpy(o), torch.from_numpy(d),
                       sampler=ts_s)
    assert ts_s._draw == js_s._draw == 2  # one sphere, one mesh volume
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    with pytest.raises(ValueError, match="sampler"):
        ts.intersect(torch.from_numpy(o), torch.from_numpy(d))


def test_volume_scene_arrays_equal():
    js, _ = G.volume()
    ts, _ = TG.volume("cpu")
    for k in ("center", "radius", "neg_inv_density", "material"):
        want, got = np.asarray(getattr(js.volumes, k)), getattr(
            ts.volumes, k).numpy()
        assert want.dtype == got.dtype and want.tobytes() == got.tobytes(), k
    jm, tm = js.mesh_volumes[0], ts.mesh_volumes[0]
    assert np.asarray(jm.neg_inv_density).tobytes() == \
        tm.neg_inv_density.numpy().tobytes()
    assert int(jm.material) == int(tm.material)
    np.testing.assert_array_equal(np.asarray(js.materials.albedo),
                                  ts.materials.albedo.numpy())


@pytest.mark.parametrize("integrator", ["wavefront", "persistent"])
def test_volume_golden(integrator):
    gold = np.load(os.path.join(GOLDENS, f"volume_{G.SIZE}.npz"))
    film = _port_film("volume", integrator)
    flipped, off = outside_c2(film, gold)
    assert flipped.sum() <= MAX_FLIPPED and not off.any(), (flipped.sum(),
                                                             off.sum())
