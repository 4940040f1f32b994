"""Port parity: RNG, vector math, sampling and camera (mrt_torch vs mrt).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances:
  - PCG4D and Sampler draws are integer hashes: bit-exact.
  - Float helpers: atol 1e-6 (<= 4 ulp on these O(1) values).  XLA and
    PyTorch round transcendentals (cos, sin, cbrt) differently by up to
    2 ulp, and XLA contracts multiply-adds into FMAs under jit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrt.core.camera import Camera as JCamera
from mrt.math import rng as jrng
from mrt.math import sampling as jsampling
from mrt.math import vec as jvec
from mrt_torch.core.camera import Camera
from mrt_torch.math import rng, sampling, vec

torch.set_num_threads(2)

ATOL = 1e-6


def _u32(rs, n):
    """uint32 values including the top of the range and 0."""
    x = rs.integers(0, 2 ** 32, n, dtype=np.uint64)
    x[:8] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 - 2,
             0x9E3779B9, 0xFFFF0000]
    return x.astype(np.uint32)


def test_pcg4d_bit_exact():
    rs = np.random.default_rng(11)
    xs = [_u32(rs, 4096) for _ in range(4)]
    want = jrng.pcg4d(*(jnp.asarray(x) for x in xs))
    got = rng.pcg4d(*(torch.from_numpy(x.astype(np.int64)) for x in xs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


@pytest.mark.parametrize("salt", [0, 7, 0xC0FFEE, 2 ** 32 - 3])
@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 17])
def test_sampler_draws_bit_exact(seed, salt):
    rs = np.random.default_rng(seed % 1000 + salt % 1000)
    ids = _u32(rs, 2048)
    js = jrng.Sampler(np.uint32(seed), jnp.asarray(ids), salt=np.uint32(salt))
    ts = rng.Sampler(seed, torch.from_numpy(ids.astype(np.int64)), salt=salt)
    for _ in range(3):  # several draw counters, with a skip between
        for w, g in zip(js.next4(), ts.next4()):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        js.skip(4)
        ts.skip(4)


def test_sampler_per_lane_salt():
    # The persistent integrator salts each lane with its own bounce.
    rs = np.random.default_rng(3)
    ids = _u32(rs, 1024)
    bounce = rs.integers(0, 50, 1024).astype(np.int32)
    js = jrng.Sampler(9, jnp.asarray(ids), salt=3 * jnp.asarray(bounce) + 1)
    ts = rng.Sampler(9, torch.from_numpy(ids.astype(np.int64)),
                     salt=3 * torch.from_numpy(bounce).long() + 1)
    js.skip(4)
    ts.skip(4)
    for w, g in zip(js.next4(), ts.next4()):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# Ray ids at the edges of the kernel's 32-bit view: 0, 2^31, 2^32 - 1,
# negative int64 and values of 2^32 and more (their low 32 bits count).
EDGE_IDS = [0, 2 ** 31, 2 ** 32 - 1, -1, -(2 ** 31) - 3, 2 ** 32, 2 ** 32 + 9,
            2 ** 40 + 77, 2 ** 63 - 1, -(2 ** 63)]


def _edge_ids(n=512):
    rs = np.random.default_rng(17)
    ids = rs.integers(-(2 ** 62), 2 ** 62, n, dtype=np.int64)
    ids[:len(EDGE_IDS)] = EDGE_IDS
    return ids


def _jax_draws(seed, ids, salt, draw):
    """The reference's four draws at draw counter `draw` (mod 2^32)."""
    u32 = lambda x: np.asarray(x, dtype=np.int64) & 0xFFFFFFFF
    js = jrng.Sampler(u32(seed).astype(np.uint32),
                      jnp.asarray(u32(ids).astype(np.uint32)),
                      salt=jnp.asarray(u32(salt).astype(np.uint32)))
    js.skip(draw & 0xFFFFFFFF)
    return [np.asarray(x) for x in js.next4()]


@pytest.mark.parametrize("draw", [0, 1, 5, 2 ** 32, 2 ** 32 + 5])
@pytest.mark.parametrize("salt_kind", ["int", "0-d", "per-lane"])
@pytest.mark.parametrize("seed_kind", ["int", "0-d"])
def test_r1_plain_version_bit_exact(seed_kind, salt_kind, draw):
    # ops.rng.pcg4d_draw_plain, the plain version of kernel R1, takes R1's
    # arguments as they are: int64 ids, int or 0-d seeds, int, 0-d or
    # per-lane salts, any draw counter.
    from mrt_torch.ops import rng as R1

    ids = _edge_ids()
    seed = 2 ** 31 + 17 if seed_kind == "int" else torch.tensor(-(2 ** 40) - 3)
    salts = {"int": 0xC0FFEE, "0-d": torch.tensor(2 ** 33 + 7),
             "per-lane": 3 * torch.from_numpy(ids % 50) + 1}
    salt = salts[salt_kind]
    got = R1.pcg4d_draw_plain(torch.from_numpy(ids), seed, salt, draw)
    want = _jax_draws(int(seed), ids,
                      salt.numpy() if torch.is_tensor(salt) else salt, draw)
    assert got.shape == (4, ids.size) and got.dtype == torch.float32
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("skips", [(0, 0), (3, 1), (2 ** 32 - 1, 2)])
def test_sampler_next1_after_skip_bit_exact(skips):
    # The CPU Sampler's draws, next1 and next4 around skips, against the
    # reference; the counter past 2^32 wraps as the reference's uint32.
    ids = _edge_ids()
    js = jrng.Sampler(np.uint32(7), jnp.asarray(
        (ids & 0xFFFFFFFF).astype(np.uint32)), salt=np.uint32(11))
    ts = rng.Sampler(7, torch.from_numpy(ids), salt=11)
    for n in skips:
        js.skip(n)
        ts.skip(n)
        js._draw &= 0xFFFFFFFF  # its counter as the uint32 it becomes
        np.testing.assert_array_equal(np.asarray(js.next1()),
                                      ts.next1().numpy())
        js._draw &= 0xFFFFFFFF
        for w, g in zip(js.next4(), ts.next4()):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _r1_counted(monkeypatch):
    """R1's wrapper in the Sampler's hands, with its calls counted: a
    list that each call appends its arguments to."""
    from mrt_torch.ops import rng as R1

    calls = []

    def counted(ray_id, seed, salt, draw):
        calls.append((ray_id, seed, salt, draw))
        return R1.pcg4d_draw(ray_id, seed, salt, draw)

    monkeypatch.setattr(rng, "pcg4d_draw", counted)
    return calls


@pytest.mark.parametrize("salt_kind", ["int", "per-lane"])
def test_sampler_card_path_keeps_its_arguments(monkeypatch, salt_kind):
    # A Sampler keeps seed, ray_id and salt as given, hands them to R1's
    # wrapper once a next4 or next1 with the draw counter mod 2^32, skips
    # without a call, and its draws equal R1's plain version's.
    from mrt_torch.ops import rng as R1

    calls = _r1_counted(monkeypatch)
    ids = torch.from_numpy(_edge_ids())
    salt = 5 if salt_kind == "int" else 3 * (ids % 7) + 2
    sampler = rng.Sampler(2 ** 33 + 1, ids, salt)
    assert sampler.ray_id is ids and sampler.seed == 2 ** 33 + 1
    assert sampler.salt is salt
    sampler.skip(4)
    for w, g in zip(R1.pcg4d_draw_plain(ids, 2 ** 33 + 1, salt, 4),
                    sampler.next4()):
        assert torch.equal(w, g)
    sampler.skip(2 ** 32 + 2)
    assert torch.equal(R1.pcg4d_draw_plain(ids, 2 ** 33 + 1, salt, 7)[0],
                       sampler.next1())
    assert [draw for _, _, _, draw in calls] == [4, 7]
    assert all(r is ids and s == 2 ** 33 + 1 and t is salt
               for r, s, t, _ in calls)


def _vecs(rs, n=4096):
    return rs.standard_normal((n, 3)).astype(np.float32)


def test_vec_ops():
    rs = np.random.default_rng(4)
    a, b = _vecs(rs), _vecs(rs)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    eta = rs.uniform(0.5, 1.8, a.shape[0]).astype(np.float32)
    ua, ta_u = jvec.unit(jnp.asarray(a)), vec.unit(ta)
    pairs = [
        (jvec.dot(a, b), vec.dot(ta, tb)),
        (jvec.cross(a, b), vec.cross(ta, tb)),
        (ua, ta_u),
        (jvec.reflect(a, b), vec.reflect(ta, tb)),
        (jvec.refract(ua, jvec.unit(jnp.asarray(b)), jnp.asarray(eta)),
         vec.refract(ta_u, vec.unit(tb), torch.from_numpy(eta))),
        (jvec.near_zero(a * 1e-5), vec.near_zero(ta * 1e-5)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ATOL, atol=ATOL)


def test_sampling():
    rs = np.random.default_rng(5)
    u = rs.random((3, 4096)).astype(np.float32)
    u[2, :4] = [0.0, 2.0 ** -24, 2.0 ** -26, 1.0 - 2.0 ** -24]
    ju = [jnp.asarray(x) for x in u]
    tu = [torch.from_numpy(x) for x in u]
    pairs = [
        (jsampling.unit_vector(*ju[:2]), sampling.unit_vector(*tu[:2])),
        (jsampling.in_unit_sphere(*ju), sampling.in_unit_sphere(*tu)),
        (jsampling.in_unit_disk(*ju[:2]), sampling.in_unit_disk(*tu[:2])),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ATOL, atol=ATOL)
    # The zero draw is clamped off the zero vector.
    assert (torch.linalg.norm(pairs[1][1][:1], dim=-1) > 1e-3).all()


def test_camera_create_and_rays():
    kw = dict(vertical_fov_deg=20.0, look_from=(13.0, 2.0, 3.0),
              look_at=(0.0, 0.0, 0.0), view_up=(0.0, 1.0, 0.0),
              aspect_ratio=16 / 9, aperture=0.1, focus_distance=10.0)
    jc, tc = JCamera.create(**kw), Camera.create(**kw)
    for name in Camera.FIELDS:
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   rtol=ATOL, atol=ATOL)
    rs = np.random.default_rng(6)
    s, t, du, dv = rs.random((4, 2048)).astype(np.float32)
    jo, jd = jc.rays(*(jnp.asarray(x) for x in (s, t, du, dv)))
    to, td = tc.rays(*(torch.from_numpy(x) for x in (s, t, du, dv)))
    # Direction components reach ~10: 4 ulp there is ~4e-6.
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=ATOL,
                               atol=4e-6)
