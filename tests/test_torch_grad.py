"""Port parity of the gradient path: ``mrt_torch.inverse`` against
``mrt.inverse`` on the cases of tests/test_grad.py (albedo, emission,
metal fuzz, sphere centre; the texel and triangle-vertex cases are in
test_torch_grad_scenes.py), and the pieces the port adds: the winner's
recomputed root, the differentiable wavefront's forward values, and
JAX's bf16 material-row gradient (ROADMAP C17).

Tolerances and why:
  - Each case's loss and gradient against JAX's jitted
    ``value_and_grad`` with MRT_NO_ROWMM=1: rtol 1e-4.  The jitted program
    contracts multiply-adds into FMAs (C2), which moves values by ulps;
    no path flips at these settings.
  - The recomputed root: bit for bit on every hit lane.
  - The differentiable mode's radiance and bounces against the default
    mode's, and with parameters that require grad against without:
    bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_grad_scenes as S
from mrt_torch.geometry import spheres as TS
from mrt_torch.integrator import wavefront
from mrt_torch.scenes import get

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["albedo", "emission", "fuzz", "center"])
def test_gradient_matches_jax(name):
    tv, tg = S.torch_value_and_grad(name)
    jv, jg = S.jax_value_and_grad(name)
    assert np.isfinite(tg).all() and (np.abs(tg) > 0).any()
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=1e-4,
                               atol=1e-4 * np.abs(jg).max())


def test_material_rows_round_to_bf16_in_jax():
    # C17: JAX's material-row gradient through the one-hot lookup
    # (rowlookup.take_rows: an f32 table split into three bf16 terms) is
    # the gather's rounded to bf16; the port's is the gather's.
    import jax
    import jax.numpy as jnp

    from mrt.ops import rowlookup

    rs = np.random.default_rng(4)
    table = rs.uniform(0, 1, (5, 9)).astype(np.float32)
    rows = rs.integers(0, 5, 1000)
    w = rs.uniform(0, 1, (1000, 9)).astype(np.float32)
    onehot = np.asarray(jax.grad(lambda t: jnp.sum(rowlookup.take_rows(
        t, jnp.asarray(rows, jnp.int32)) * w))(jnp.asarray(table)))
    gather = np.asarray(jax.grad(lambda t: jnp.sum(
        t[jnp.asarray(rows)] * w))(jnp.asarray(table)))
    x = torch.tensor(table, requires_grad=True)
    torch.sum(x[torch.from_numpy(rows)] * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(x.grad.numpy(), gather, rtol=1e-5)
    rel = np.abs(onehot / gather - 1.0)
    assert rel.max() <= 2.0 ** -8 and rel.max() > 1e-5, rel.max()


def _rtiow_rays(n=2048, seed=6):
    scene, camera = get("rtiow")(aspect_ratio=1.0, grid=3).generate(
        device="cpu")
    rs = np.random.default_rng(seed)
    s, t, du, dv = (torch.from_numpy(x) for x in
                    rs.random((4, n)).astype(np.float32))
    o, d = camera.rays(s, t, du, dv)
    return scene, o, d


def test_recomputed_root_equals_winner_bitwise():
    scene, o, d = _rtiow_rays()
    sph = scene.spheres
    # Camera rays, then rays from their hit points (t_min 1e-3 excludes
    # the sphere they start on), then an alpha-style per-lane t_min.
    t, i = TS.nearest_t(sph, o, d, 1e-3, float("inf"))
    hit = torch.isfinite(t)
    p = torch.where(hit[:, None], o + d * torch.where(hit, t, 0.0)[:, None],
                    o)
    d2 = torch.roll(d, 1, 0)
    t_min3 = torch.where(hit, t * 0.5, 1e-3)
    for oo, dd, t_min in ((o, d, 1e-3), (p, d2, 1e-3), (o, d, t_min3)):
        t, i = TS.nearest_t(sph, oo, dd, t_min, float("inf"))
        hit = torch.isfinite(t)
        assert hit.sum() > 100
        k = i.to(torch.int64)
        root = TS.winner_root(sph.center[k], sph.radius[k], oo, dd, hit,
                              t_min)
        assert torch.equal(root[hit], t[hit])


def test_winner_t_keeps_search_value():
    scene, o, d = _rtiow_rays()
    sph = scene.spheres
    t, i = TS.nearest_t(sph, o, d, 1e-3, float("inf"))
    k = i.to(torch.int64)
    c = sph.center[k].clone().requires_grad_(True)
    got = TS.winner_t(c, sph.radius[k], o, d, t, 1e-3)
    assert got.requires_grad and torch.equal(got.detach(), t)
    # Nothing requires grad: the search's own tensor, no recompute.
    assert TS.winner_t(sph.center[k], sph.radius[k], o, d, t, 1e-3) is t
    got.sum().backward()
    assert torch.isfinite(c.grad).all()
    assert torch.equal(c.grad[~torch.isfinite(t)],
                       torch.zeros_like(c.grad[~torch.isfinite(t)]))


@pytest.mark.parametrize("rr_depth", [None, 2])
def test_differentiable_forward_equals_wavefront(rr_depth):
    scene, o, d = _rtiow_rays(1024, seed=8)
    ids = torch.arange(o.shape[0])
    want = wavefront.trace_wavefront(scene, o, d, ids, 5, max_depth=6,
                                     rr_depth=rr_depth)
    got = wavefront.trace_wavefront(scene, o, d, ids, 5, max_depth=6,
                                    rr_depth=rr_depth, differentiable=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # With the albedo table and the centres requiring grad: the same.
    params = (scene.materials.albedo.clone().requires_grad_(True),
              scene.spheres.center.clone().requires_grad_(True))
    graded = scene.replace(
        materials=scene.materials.replace(albedo=params[0]),
        spheres=scene.spheres.replace(center=params[1]))
    got = wavefront.trace_wavefront(graded, o, d, ids, 5, max_depth=6,
                                    rr_depth=rr_depth, differentiable=True)
    assert torch.equal(got[0].detach(), want[0])
    assert torch.equal(got[1], want[1])
    got[0].sum().backward()
    for x in params:
        assert torch.isfinite(x.grad).all() and (x.grad != 0).any()
