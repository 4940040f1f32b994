"""Port parity of the gradient path, continued: the texel and
triangle-vertex cases against JAX, ``replace`` on the scene's modules,
and the derivatives at ties (ROADMAP C18).

Tolerances and why:
  - Texel and triangle vertex against JAX's jitted ``value_and_grad``
    with MRT_NO_ROWMM=1 (C17): rtol 1e-4.
  - ``vec.clamp`` and ``torch.amax`` at ties: exactly JAX's halves and
    thirds.  ``vec.sqrt``'s derivative on the CPU (its float64 route,
    C5) rounds 1/(2 sqrt x) once where JAX rounds three times: within
    2 ulp (C18).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_grad_scenes as S
from mrt_torch.geometry import spheres as TS
from mrt_torch.math import vec
from mrt_torch.scenes import get

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["texel", "tri_vertex"])
def test_gradient_matches_jax(name):
    tv, tg = S.torch_value_and_grad(name)
    jv, jg = S.jax_value_and_grad(name)
    assert np.isfinite(tg).all() and (np.abs(tg) > 0).any()
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=1e-4,
                               atol=1e-4 * np.abs(jg).max())


def test_replace_shares_buffers_and_keeps_graph():
    scene, _ = get("rtiow")(aspect_ratio=1.0, grid=2).generate(device="cpu")
    m = scene.materials
    albedo = m.albedo.clone().requires_grad_(True)
    m2 = m.replace(albedo=albedo * 2.0, mix_depth=1)
    assert m2.albedo.grad_fn is not None and m2.mix_depth == 1
    assert m.albedo is not m2.albedo and m.mix_depth != 1
    assert m2.emit is m.emit and m2.mtype is m.mtype
    s2 = scene.replace(materials=m2)
    assert s2.materials is m2 and scene.materials is m
    assert s2.spheres is scene.spheres and s2.background is scene.background
    with pytest.raises(TypeError, match="no field 'albedos'"):
        m.replace(albedos=albedo)
    # A list becomes a buffer of the old dtype.
    assert m.replace(ior=[1.5] * m.ior.shape[0]).ior.dtype == torch.float32


def test_spheres_replace_rebuilds_kernel_table():
    scene, _ = get("rtiow")(aspect_ratio=1.0, grid=2).generate(device="cpu")
    sph = scene.spheres
    center = (sph.center + 0.25).requires_grad_(True)
    moved = sph.replace(center=center)
    assert moved.center is center and sph.center is not center
    want = TS.Spheres(center.detach(), sph.radius, sph.material)
    want.build_kernel_table(in_bvh=False)
    for name in TS.Spheres.GROUP_TABLE:
        got = getattr(moved, name)
        assert not got.requires_grad
        assert torch.equal(got, getattr(want, name))
    assert moved.n_big == want.n_big
    assert torch.equal(sph.g_rows, scene.spheres.g_rows)  # untouched
    bare = TS.Spheres(sph.center, sph.radius, sph.material)
    assert bare.replace(center=center).groups is None
    # A scene given spheres without a table builds theirs.
    assert scene.replace(spheres=bare).spheres.groups is not None
    # B5's rows: detached.
    grid, _ = get("sphere_grid")(aspect_ratio=1.0, dim=4).generate(
        device="cpu")
    rows = grid.spheres.replace(center=grid.spheres.center.clone()
                                .requires_grad_(True)).krows
    assert rows is not None and not rows.requires_grad


def test_clamp_and_amax_ties_follow_jax():
    x = torch.tensor([0.0, 0.5, 1.0, 1.5, -1.0], requires_grad=True)
    vec.clamp(x, 0.0, 1.0).sum().backward()
    jx = jnp.asarray(x.detach().numpy())
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jx)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert torch.equal(vec.clamp(x, 0.0, 1.0), torch.clamp(x, 0.0, 1.0))
    y = torch.tensor([[0.5, 0.5, 0.5], [0.2, 0.7, 0.7]], requires_grad=True)
    torch.amax(y, dim=-1).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.max(v, axis=-1)))(
        jnp.asarray(y.detach().numpy()))
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(want), rtol=1e-7)


def _blend_atlas(builder_cls, ta):
    """Rows whose blends and YCbCr conversion land exactly on a clamp's
    bound: 0.25 + 0.75 = 1 (addition), 0.5 - 0.5 = 0 (subtraction),
    luma 1 with neutral chroma gives RGB 1 (YCbCr)."""
    b = builder_cls()
    px = lambda *c: np.array(c, np.float32).reshape(1, 1, 4)
    lo, hi = b.add_raw(px(0.25, 0.5, 0.0, 1.0)), b.add_raw(px(0.75, 0.5, 0.0,
                                                               1.0))
    luma, chroma = b.add_raw(px(1.0, 0.0, 0.0, 1.0)), b.add_raw(
        px(0.5, 0.5, 0.0, 1.0))
    ids = [b.add_blend(m, lo, hi) for m in (ta.LIGHTEN, ta.DARKEN,
                                            ta.ADDITION, ta.SUBTRACTION)]
    ids.append(b.add_ycbcr(luma, chroma))
    return b.build(), np.array(ids, np.int32)


def _clamp_site(name, pkg):
    """(f, x): a function of the port (pkg "torch") or of JAX whose float
    clamp is at its bound on input x."""
    if name == "atlas_blend":
        if pkg == "torch":
            from mrt_torch.textures import atlas as ta
            atlas, ids = _blend_atlas(ta.AtlasBuilder, ta)
            ids, uv = torch.from_numpy(ids), torch.full((5, 2), 0.5)
            return (lambda x: atlas.replace(data=x).sample(ids, uv),
                    atlas.data.numpy())
        from mrt.textures import atlas as ja
        atlas, ids = _blend_atlas(ja.AtlasBuilder, ja)
        atlas = atlas.replace(qdata=None, meta=None)
        uv = jnp.full((5, 2), 0.5)
        return (lambda x: atlas.replace(data=x).sample(jnp.asarray(ids), uv),
                np.asarray(atlas.data))
    if name == "bsdf_pdf":
        # The cosine lobe at a direction in the tangent plane.
        lobe, n = np.array([1, 1], np.int32), np.array(
            [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
        w = np.array([[1.0, 0.0, 0.0], [0.6, 0.0, 0.8]], np.float32)
        if pkg == "torch":
            from mrt_torch.materials import lights
            return (lambda x: lights.bsdf_pdf(torch.from_numpy(lobe),
                                              torch.from_numpy(n), x), w)
        from mrt.materials import lights
        return lambda x: lights.bsdf_pdf(jnp.asarray(lobe), jnp.asarray(n),
                                         x), w
    # in_unit_sphere: a radius draw at the clamp's floor.
    u = np.array([[0.3, 0.6, 2.0 ** -25], [0.3, 0.6, 0.5]], np.float32)
    if pkg == "torch":
        from mrt_torch.math import sampling
        return lambda x: sampling.in_unit_sphere(x[:, 0], x[:, 1],
                                                 x[:, 2]), u
    from mrt.math import sampling
    return lambda x: sampling.in_unit_sphere(x[:, 0], x[:, 1], x[:, 2]), u


@pytest.mark.parametrize("name", ["atlas_blend", "bsdf_pdf",
                                  "in_unit_sphere"])
def test_clamp_sites_at_their_bound_follow_jax(name):
    # C18: the float clamps of shading, lights, sampling and the atlas
    # give JAX's half derivative at a bound (torch.clamp would pass all
    # of it).  A weighted sum keeps each output's derivative apart.
    f, x = _clamp_site(name, "torch")
    jf, jx = _clamp_site(name, "jax")
    np.testing.assert_array_equal(x, jx)
    t = torch.tensor(x, requires_grad=True)
    y = f(t)
    wts = np.random.default_rng(3).uniform(0.5, 1.5, tuple(y.shape)).astype(
        np.float32)
    (y * torch.from_numpy(wts)).sum().backward()
    jy, jg = jax.value_and_grad(lambda v: jnp.sum(jf(v) * wts))(
        jnp.asarray(jx))
    np.testing.assert_allclose(float((y.detach() * torch.from_numpy(wts))
                                     .sum()), float(jy), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


def test_sqrt_derivative_within_two_ulp_of_jax():
    rs = np.random.default_rng(5)
    x = np.concatenate([rs.uniform(1e-6, 1e6, 4000),
                        rs.uniform(0.5, 2.0, 4000)]).astype(np.float32)
    t = torch.tensor(x, requires_grad=True)
    vec.sqrt(t).sum().backward()
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.sqrt(v)))(
        jnp.asarray(x)))
    ulp = np.spacing(np.abs(want))
    assert np.abs(t.grad.numpy() - want).max() <= (2 * ulp).max()
    assert (np.abs(t.grad.numpy() - want) <= 2 * ulp).all()


def test_tied_spheres_give_the_winner_t_derivative():
    # C18: two spheres at one place tie on every ray; JAX's scan min
    # splits t's derivative between them, the port gives it to the
    # winner (the lower index).  Their sum is the same.
    from mrt.geometry import spheres as JS

    c = np.array([[0.0, 0.0, -3.0], [0.0, 0.0, -3.0]], np.float32)
    r = np.array([1.0, 1.0], np.float32)
    m = np.zeros(2, np.int32)
    rs = np.random.default_rng(1)
    o = np.zeros((64, 3), np.float32)
    d = np.concatenate([rs.uniform(-0.2, 0.2, (64, 2)),
                        -np.ones((64, 1))], 1).astype(np.float32)

    def jt(cc):
        s = JS.Spheres(center=cc, radius=jnp.asarray(r),
                       material=jnp.asarray(m))
        t, _ = JS.nearest_t(s, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.inf)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    jg = np.asarray(jax.grad(jt)(jnp.asarray(c)))
    ct = torch.tensor(c, requires_grad=True)
    h = TS.intersect(TS.Spheres(ct, r, m), torch.from_numpy(o),
                     torch.from_numpy(d), 1e-3, float("inf"))
    assert h.hit.all()
    torch.where(h.hit, h.t, 0.0).sum().backward()
    g = ct.grad.numpy()
    np.testing.assert_allclose(jg[0], jg[1], rtol=1e-6)
    np.testing.assert_allclose(g[0], jg[0] + jg[1], rtol=1e-5)
    np.testing.assert_array_equal(g[1], 0.0)


def test_tangent_root_has_finite_derivative():
    # C18: a ray grazing a sphere (disc == 0 exactly) has an infinite
    # sqrt derivative; JAX's where-before-sqrt lets it through (inf or
    # NaN in the centre's gradient), the port's guard drops that term.
    from mrt.geometry import spheres as JS

    c = np.array([[0.0, 0.0, -3.0]], np.float32)
    r, m = np.array([1.0], np.float32), np.zeros(1, np.int32)
    o = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.1, -1.0]], np.float32)

    def jt(cc):
        s = JS.Spheres(center=cc, radius=jnp.asarray(r),
                       material=jnp.asarray(m))
        t, _ = JS.nearest_t(s, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.inf)
        return jnp.sum(t)

    jt_val = float(jt(jnp.asarray(c)))
    assert not np.isfinite(np.asarray(jax.grad(jt)(jnp.asarray(c)))).all()
    ct = torch.tensor(c, requires_grad=True)
    h = TS.intersect(TS.Spheres(ct, r, m), torch.from_numpy(o),
                     torch.from_numpy(d), 1e-3, float("inf"))
    assert h.hit.all() and float(h.t[0].detach()) == 3.0
    np.testing.assert_allclose(float(h.t.sum().detach()), jt_val, rtol=1e-6)
    h.t.sum().backward()
    assert torch.isfinite(ct.grad).all()
