"""Port parity: instanced meshes, kernel B7 (two-level TLAS closest hit,
which also stands for B8's streamed kernel) and the cornell scene
(mrt_torch vs mrt).

Tolerances and why:
  - ``MeshRegistry.build`` is host NumPy on both sides: the TLAS tables
    are byte-equal (the world-flattened and brute-scan fields, which the
    port does not keep, aside).
  - B7's plain version (``mrt_torch.ops.bvh.tlas_plain``, the CPU path
    of ``tlas_hit``) warps rays in the Pallas kernel's order, where the
    reference's XLA traversal uses an einsum; every kernel and traversal
    rounds differently in the last bits.  So against the XLA traversal
    run op by op, both Pallas bodies (interpret mode) and the streamed
    kernel under all four residency plans: hit and (instance, triangle)
    exact, t rtol 1e-5, u and v atol 1e-5; on the Hits record material
    exact, normal and point atol 1e-5.
  - Rays that start on slab planes with a zero direction component (NaN
    in the slab test) are held against the XLA traversal only: there,
    as in the port, NaN culls the box for that ray.  The packet kernels
    test a leaf for all 1024 lanes when any lane's slab test passes, so
    such a ray can still win a hit there.
  - cornell_24 through the port's integrators against the committed
    golden (compiled JAX, FMA-contracted): at most 1% of pixels with
    another bounce count, every other pixel within 5e-4, the rule
    tests/test_torch_render.py holds rtiow_24 to.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import golden_scenes as G
from mrt.geometry import instance as JI
from mrt.geometry.shapes import cube as jcube
from mrt.geometry.shapes import sphere_mesh as jsphere_mesh
from mrt.ops import pallas_bvh as PB
from mrt.ops import pallas_stream as PS
from mrt.scenes import get as jget
from mrt_torch.geometry import instance as TI
from mrt_torch.geometry.shapes import cube, sphere_mesh
from mrt_torch.ops import bvh as B7
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render, render_pass_persistent
from mrt_torch.scenes import get as tget

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      f"cornell_{G.SIZE}.npz")
MAX_FLIPPED = 5  # 1% of 576 pixels
STREAM_PLANS = [
    dict(tlas=False, inst=False, blas=False, tri=False),
    dict(tlas=True, inst=True, blas=True, tri=True),
    dict(tlas=True, inst=True, blas=False, tri=False),
    dict(tlas=False, inst=False, blas=True, tri=True),
]


def _registry(reg_cls, cube_fn, sphere_fn, seed=0, n_inst=40):
    """tests/test_stream.py's registry: cubes and coarse sphere meshes at
    random transforms, with material overrides."""
    rng = np.random.default_rng(seed)
    reg = reg_cls()
    m_cube = reg.add_mesh(cube_fn(size=1.0))
    m_sphere = reg.add_mesh(sphere_fn(radius=0.6, lat=5, lon=7))
    for i in range(n_inst):
        reg.add_instance(m_cube if i % 2 else m_sphere,
                         translation=rng.uniform(-6, 6, 3),
                         rotation=rng.uniform(0, 1, 3),
                         scale=rng.uniform(0.4, 1.8),
                         material=int(rng.integers(0, 5)))
    return reg.build()


def _tables_equal(jt, tt):
    for k in TI.FIELDS:
        if k == "inv_transform":  # kept as the kernel's rows, below
            continue
        want, got = np.asarray(getattr(jt, k)), getattr(tt, k).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, k
        assert want.tobytes() == got.tobytes(), k
    inv = np.asarray(jt.inv_transform)
    rows = np.concatenate([inv[:, :3, :3].reshape(-1, 9), inv[:, :3, 3]],
                          axis=1)
    assert rows.tobytes() == tt.inst.numpy().tobytes()
    rows = np.concatenate([np.asarray(getattr(jt.tris, k))
                           for k in ("va", "e_ab", "e_ac")], axis=1)
    assert rows.tobytes() == tt.tris.numpy().tobytes()


@pytest.mark.parametrize("which", ["cornell", "stream40"])
def test_registry_build_matches(which):
    if which == "cornell":
        jt = jget("cornell")(aspect_ratio=1.0).generate()[0].tlas
        tt = tget("cornell")(aspect_ratio=1.0).generate(device="cpu")[0].tlas
        assert tt.n_tlas_nodes == 13 and tt.n_instances == 7
    else:
        jt = _registry(JI.MeshRegistry, jcube, jsphere_mesh)
        tt = _registry(TI.MeshRegistry, cube, sphere_mesh)
    _tables_equal(jt, tt)


def _cornell_rays(seed=2, n=400):
    """Rays inside the cornell box in random directions, with per-lane
    t_min; rays 0-29 start on a TLAS node's slab plane with a zero
    direction component (0-9 on the root's)."""
    jt = jget("cornell")(aspect_ratio=1.0).generate()[0].tlas
    rs = np.random.default_rng(seed)
    o = rs.uniform((-4.9, 0.1, -4.9), (4.9, 9.9, 9.0), (n, 3))
    d = rs.standard_normal((n, 3))
    t_min = rs.uniform(1e-3, 2.0, n)
    bmin, bmax = np.asarray(jt.t_bmin), np.asarray(jt.t_bmax)
    node = rs.integers(0, len(bmin), 30)
    node[:10] = 0
    axis = rs.integers(0, 3, 30)
    plane = np.where(rs.random(30) < 0.5, bmin[node, axis],
                     bmax[node, axis])
    o[np.arange(30), axis] = plane
    d[np.arange(30), axis] = 0.0
    f32 = lambda x: x.astype(np.float32)
    return jt, f32(o), f32(d), f32(t_min)


def _capture(monkeypatch):
    """Record the winners (t, instance, triangle, u, v) that the JAX
    traversals expand."""
    got = {}
    expand = JI.expand_winner

    def spy(tlas, o, d, *winners):
        got["w"] = [np.asarray(x) for x in winners]
        return expand(tlas, o, d, *winners)

    monkeypatch.setattr(JI, "expand_winner", spy)
    return got


def _port(o, d, t_min):
    tt = tget("cornell")(aspect_ratio=1.0).generate(device="cpu")[0].tlas
    args = (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_min), float("inf"))
    winners = [x.numpy() for x in B7.tlas_hit(tt, *args)]
    return winners, TI.intersect_tlas(tt, *args)


def _same_winners(want, got):
    hit = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    np.testing.assert_array_equal(got[1][hit], want[1][hit])  # instance
    np.testing.assert_array_equal(got[2][hit], want[2][hit])  # triangle
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
    for k in (3, 4):  # u, v
        np.testing.assert_allclose(got[k][hit], want[k][hit], atol=1e-5)
    assert (got[1][~hit] == -1).all()


def test_b7_plain_matches_xla_traversal(monkeypatch):
    jt, o, d, t_min = _cornell_rays()
    want = _capture(monkeypatch)
    with jax.disable_jit():
        jhits = JI.intersect_tlas(jt, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(t_min), jnp.inf)
    winners, hits = _port(o, d, t_min)
    _same_winners(want["w"], winners)
    hit = winners[0] < np.inf
    assert 0.5 < hit.mean() and not hit[:10].any()
    np.testing.assert_array_equal(hits.hit.numpy(), np.asarray(jhits.hit))
    np.testing.assert_array_equal(hits.material.numpy()[hit],
                                  np.asarray(jhits.material)[hit])
    np.testing.assert_array_equal(hits.front_face.numpy()[hit],
                                  np.asarray(jhits.front_face)[hit])
    for k in ("normal", "point"):
        np.testing.assert_allclose(getattr(hits, k).numpy()[hit],
                                   np.asarray(getattr(jhits, k))[hit],
                                   atol=1e-5)


@pytest.mark.parametrize("ordered", ["0", "1"])
def test_b7_plain_matches_pallas_bodies(monkeypatch, ordered):
    # "0": _tlas_kernel (escape order); "1": _tlas_kernel_ordered.
    jt, o, d, t_min = _cornell_rays(seed=3)
    o, d, t_min = o[30:], d[30:], t_min[30:]  # no NaN-slab rays
    want = _capture(monkeypatch)
    monkeypatch.setattr(PB, "_ORD_ENV", ordered)
    PB.intersect_tlas(jt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                      jnp.inf, interpret=True)
    _same_winners(want["w"], _port(o, d, t_min)[0])


@pytest.mark.parametrize("plan", STREAM_PLANS,
                         ids=["resident", "all-streamed", "top-streamed",
                              "bottom-streamed"])
def test_b7_plain_matches_streamed_kernel(monkeypatch, plan):
    # B8: the same function with tables paged from HBM.
    jt, o, d, t_min = _cornell_rays(seed=4, n=230)
    o, d, t_min = o[30:], d[30:], t_min[30:]  # no NaN-slab rays
    want = _capture(monkeypatch)
    PS.intersect_tlas(jt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                      jnp.inf, interpret=True, streamed=plan)
    _same_winners(want["w"], _port(o, d, t_min)[0])


def test_b7_wrapper_checks_arguments():
    tt = tget("cornell")(aspect_ratio=1.0).generate(device="cpu")[0].tlas
    o = torch.zeros((8, 3))
    with pytest.raises(ValueError):
        B7.tlas_hit(tt, o[:, :2], o, 1e-3, 1.0)
    with pytest.raises(TypeError):
        B7.tlas_hit(tt, o.double(), o.double(), 1e-3, 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        B7.tlas_hit(tt, o.to("meta"), o.to("meta"), 1e-3, 1.0)


def _close(film, gold):
    """At most MAX_FLIPPED pixels with another bounce count, every other
    pixel's sum within 5e-4.  Returns the number flipped."""
    flipped = film.depth_sum.numpy() != gold["depth"]
    assert flipped.sum() <= MAX_FLIPPED, flipped.sum()
    keep = ~flipped
    np.testing.assert_allclose(film.sum.numpy()[keep], gold["sum"][keep],
                               rtol=5e-4, atol=5e-4)
    return int(flipped.sum())


@pytest.mark.parametrize("integrator", ["wavefront", "persistent"])
def test_cornell_golden(integrator):
    scene, camera = tget("cornell")(aspect_ratio=1.0).generate(device="cpu")
    if integrator == "wavefront":
        film = render(scene, camera, G.SIZE, G.SIZE, spp=G.SPP,
                      max_depth=G.DEPTH, seed=G.SEED)
    else:
        film = render_pass_persistent(
            scene, camera, Film.create(G.SIZE, G.SIZE, device="cpu"),
            G.SEED, 0, width=G.SIZE, height=G.SIZE, max_depth=G.DEPTH,
            samples=G.SPP, pool=1024)
    gold = np.load(GOLDEN)
    flipped = _close(film, gold)
    print(f"cornell_24 {integrator}: {flipped} of 576 pixels flip paths")
    assert film.depth_sum.numpy().sum() > 0
