"""Port parity for the sphere kernels' card walks (B5's octant order and
whole-leaf rule, B1's two-level grouped walk), mrt_torch vs mrt.

Tolerances and why:
  - B5's plain walk in octant order (``sphere_bvh_plain(order=)``, the
    kernel's order) repeats the escape-order walk's arithmetic, so on the
    same rays (t, index) are bit-equal to it, on a small sphere_grid
    (dim 8, threaded in octant order whatever its size) and on random
    spheres (a 187-node tree, the threading the card stores).  Against
    the reference's XLA traversal (``mrt.geometry.bvh``): op by op
    (``jax.disable_jit``) bit-equal on sphere_grid; compiled on the
    random spheres (op by op that walk takes ~25 s here; XLA contracts
    multiply-adds, ROADMAP C2): indices equal, t within rtol 1e-4 (on a
    grazing ray the discriminant cancels, and the contraction moved one
    root of 430 by 2.2e-5 relative).
  - The whole-leaf rule at the entry limit (the kernel's warp leaf step
    and ``sphere_leaf``) against the reference's sequential leaf, which
    shrinks its limit sphere by sphere: on one leaf of 1-32 spheres with
    duplicates, per-lane t_max and zero direction components, bit-equal
    to the XLA traversal op by op; against the Pallas kernel in
    interpret mode (FMA-contracted) indices equal and t within rtol 1e-5
    plus atol 1e-6, except on lanes whose two lowest roots lie within
    rtol 1e-5 of each other, where the contraction may order them
    either way.
  - B1's grouped walk's plain model (``nearest_t_grouped_plain``) takes
    the brute force's winners (``nearest_t_plain``), t and index bit for
    bit: the group-box test is conservative, so no ray may differ.
  - The warp counts of B5's plain walk on a hand-made four-ray case, and
    B1's pair counts on a hand-made warp, are integers, compared
    exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from mrt.geometry import bvh as JB
from mrt.geometry import spheres as JS
from mrt.ops import pallas_bvh as PB
from mrt_torch.geometry import bvh as TB
from mrt_torch.geometry import spheres as TS
from mrt_torch.integrator.persistent import LanePool
from mrt_torch.materials import shade
from mrt_torch.math.rng import Sampler
from mrt_torch.ops import bvh as B5
from mrt_torch.ops import spheres as B1
from mrt_torch.scenes import get as tget

torch.set_num_threads(2)

INF = float("inf")


def _winners(traverse, *args, jit=False, **kw):
    """(t, index) of a JAX sphere traversal: what it passes to
    ``make_hits`` (both the XLA traversal and the Pallas wrapper end
    there); with ``jit``, the traversal compiled."""
    expand = JS.make_hits

    def run(*a):
        got = {}

        def spy(spheres, o, d, t, i):
            got["t"], got["i"] = t, i
            return expand(spheres, o, d, t, i)

        JS.make_hits = spy
        try:
            traverse(*a, **kw)
        finally:
            JS.make_hits = expand
        return got["t"], got["i"]

    t, i = (jax.jit(run) if jit else run)(*args)
    return np.asarray(t), np.asarray(i)


def _octant_order(tree):
    """``tree``'s octant threading whatever its size."""
    return torch.from_numpy(TB.order_table(*TB.thread_octants(
        tree.count.numpy(), tree.escape.numpy(), tree.bmin.numpy(),
        tree.bmax.numpy())))


def _jax_tables(tree, spheres):
    jbvh = JB.FlatBVH(*(jnp.asarray(getattr(tree, k).numpy())
                        for k in TB.FlatBVH.FIELDS))
    jsph = JS.Spheres(*(jnp.asarray(getattr(spheres, k).numpy())
                        for k in ("center", "radius", "material")))
    return jbvh, jsph


def _grid_case():
    scene, camera = tget("sphere_grid")(dim=8).generate(device="cpu")
    g = torch.Generator().manual_seed(21)
    s, t = torch.rand((2, 768), generator=g)
    z = torch.zeros(768)
    o, d = camera.rays(s, t, z, z)
    return scene.sphere_bvh, scene.spheres, o.contiguous(), d.contiguous()


def _random_case():
    rs = np.random.default_rng(22)
    s = 3000
    spheres = TS.Spheres(rs.uniform(-10, 10, (s, 3)).astype(np.float32),
                         rs.uniform(0.1, 0.9, s).astype(np.float32),
                         np.zeros(s, np.int32))
    tree, spheres = TB.build_over_spheres(spheres)
    spheres.build_kernel_table(in_bvh=True)
    o = rs.uniform(-15, 15, (1024, 3)).astype(np.float32)
    d = rs.standard_normal((1024, 3)).astype(np.float32)
    o[:32, 0] = tree.bmin[0, 0].item()  # NaN slab at the root
    d[:32, 0] = 0.0
    return tree, spheres, torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("case", ["sphere_grid dim 8", "random spheres"])
def test_b5_octant_walk_matches_escape_and_xla(case):
    tree, spheres, o, d = (_grid_case() if case == "sphere_grid dim 8"
                           else _random_case())
    order = (_octant_order(tree) if tree.n_nodes < TB.OCTANT_MIN_NODES
             else tree.order)
    assert not torch.equal(order[0], order[7])  # not the escape order
    n = o.shape[0]
    lo, hi = torch.full((n,), 1e-3), torch.full((n,), INF)
    sph = spheres.krows
    walked, escaped = {}, {}
    got = B5.sphere_bvh_plain(tree.nodes, tree.meta, sph, o, d, lo, hi,
                              counts=walked, order=order)
    esc = B5.sphere_bvh_plain(tree.nodes, tree.meta, sph, o, d, lo, hi,
                              counts=escaped)
    for a, b in zip(got, esc):
        assert torch.equal(a, b)
    assert walked["nodes"] <= escaped["nodes"]
    assert walked["prims"] <= escaped["prims"]
    jbvh, jsph = _jax_tables(tree, spheres)
    args = (jsph, jbvh, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 1e-3,
            jnp.inf)
    t, i = got[0].numpy(), got[1].numpy()
    if case == "sphere_grid dim 8":
        with jax.disable_jit():
            want_t, want_i = _winners(JB.intersect_bvh_spheres, *args)
        np.testing.assert_array_equal(want_t, t)
    else:
        want_t, want_i = _winners(JB.intersect_bvh_spheres, *args, jit=True)
        hit = np.isfinite(want_t)
        np.testing.assert_array_equal(np.isfinite(t), hit)
        np.testing.assert_allclose(t[hit], want_t[hit], rtol=1e-4)
    np.testing.assert_array_equal(want_i, i)
    assert 0.1 < np.isfinite(t).mean() < 0.99


# One leaf: up to 32 spheres on a coarse grid (duplicates and exact ties
# come often), under a node box that every ray enters.
LEAF_RAYS = 48
_coord = st.integers(-8, 8).map(lambda k: k / 4.0)
_sphere = st.tuples(_coord, _coord, _coord,
                    st.integers(1, 8).map(lambda k: k / 8.0))


@st.composite
def _leaf(draw):
    count = draw(st.integers(1, 32))
    rows = draw(st.lists(_sphere, min_size=count, max_size=count))
    rows += [rows[i % count] for i in draw(st.lists(
        st.integers(0, 31), min_size=0, max_size=4))]  # duplicates
    rows = (rows * 32)[:32]
    seed = draw(st.integers(0, 2 ** 16))
    return count, np.array(rows, np.float32), seed


def _leaf_rays(seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-4, 4, (LEAF_RAYS, 3)).astype(np.float32)
    d = rs.standard_normal((LEAF_RAYS, 3)).astype(np.float32)
    axis = rs.integers(0, 3, LEAF_RAYS // 4)
    d[np.arange(LEAF_RAYS // 4), axis] = 0.0  # zero components
    # One t_min a leaf (the Pallas kernel takes one), t_max a lane.
    t_min = np.full(LEAF_RAYS, rs.choice([1e-3, 0.5, 2.0]), np.float32)
    t_max = rs.choice([np.inf, 3.0, 6.0], LEAF_RAYS).astype(np.float32)
    return o, d, t_min, t_max


def _roots(rows, count, o, d, t_min, t_max):
    """(N, count): each sphere's root in [t_min, t_max] (+inf where none)
    in the port's arithmetic, for the tie guard."""
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    a = B5.dot(dt, dt)
    zero, one = (torch.full((len(o),), k, dtype=torch.int64) for k in (0, 1))
    out = [B5.sphere_leaf(torch.from_numpy(rows[k:k + 1]), zero, one, ot, dt,
                          a, 1.0 / a, torch.from_numpy(t_min),
                          torch.from_numpy(t_max))[0] for k in range(count)]
    return torch.stack(out, dim=1).numpy()


@settings(max_examples=20, deadline=None, derandomize=True)
@given(_leaf())
def test_whole_leaf_rule_matches_the_sequential_leaf(leaf):
    count, rows, seed = leaf
    o, d, t_min, t_max = _leaf_rays(seed)
    nodes = np.zeros((1, 8), np.float32)
    nodes[0, 0:3], nodes[0, 4:7] = -1e4, 1e4
    meta = np.array([[0, count, 1, 0]], np.int32)
    got = B5.sphere_bvh_plain(
        torch.from_numpy(nodes), torch.from_numpy(meta),
        torch.from_numpy(rows), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_min), torch.from_numpy(t_max))
    t, i = (x.numpy() for x in got)
    jbvh = JB.FlatBVH(jnp.asarray(nodes[:, 0:3]), jnp.asarray(nodes[:, 4:7]),
                      *(jnp.asarray(meta[:, k]) for k in range(3)))
    jsph = JS.Spheres(jnp.asarray(rows[:, :3]), jnp.asarray(rows[:, 3]),
                      jnp.zeros(32, jnp.int32))
    args = (jsph, jbvh, jnp.asarray(o), jnp.asarray(d))
    with jax.disable_jit():  # the reference's sequential leaf, op by op
        seq_t, seq_i = _winners(JB.intersect_bvh_spheres, *args,
                                jnp.asarray(t_min), jnp.asarray(t_max))
    np.testing.assert_array_equal(seq_t, t)
    np.testing.assert_array_equal(seq_i, i)
    p_t, p_i = _winners(PB.intersect_bvh_spheres, *args, float(t_min[0]),
                        jnp.asarray(t_max), interpret=True)
    hit = np.isfinite(p_t)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], p_t[hit], rtol=1e-5, atol=1e-6)
    roots = np.sort(np.concatenate([_roots(rows, count, o, d, t_min, t_max),
                                    np.full((LEAF_RAYS, 1), INF)], axis=1),
                    axis=1)
    clear = (roots[:, 0] == INF) | ~(
        roots[:, 1] <= roots[:, 0] * (1 + 1e-5) + 1e-6)
    np.testing.assert_array_equal(i[clear], p_i[clear])


def _rtiow_main_path_rays(n):
    """n RTIOW main-path rays at 1920x1080: n/2 camera rays of
    consecutive pool items (the pool's claim order) and n/2 first
    bounces, as chip_smoke.py's path_rays makes them."""
    scene, camera = tget("rtiow")().generate(device="cpu")
    lanes = LanePool(scene, camera, 1920, 1080, 1, 0, 2, 50)
    items = torch.arange(n) + 2 * 1920 * 540 + 700
    o, d, ray_id = lanes.make_rays(items)
    half = n // 2
    hits = scene.intersect(o[half:], d[half:])
    new_dir, scat = shade.shade_hit(scene, hits, d[half:],
                                    Sampler(1, ray_id[half:], 0),
                                    Sampler(1, ray_id[half:], 1))[2:4]
    keep = scat[:, None]
    o = torch.cat([o[:half], torch.where(keep, hits.point, o[half:])])
    d = torch.cat([d[:half], torch.where(keep, new_dir, d[half:])])
    return scene.spheres, o.contiguous(), d.contiguous()


def _grazing_rays(spheres, n, seed):
    """Rays from far away aimed at points on the group boxes' faces and at
    the spheres' silhouettes: the box test's and the root test's
    borderline cases."""
    rs = np.random.default_rng(seed)
    boxes = spheres.g_boxes.numpy()
    c, r = spheres.center.numpy(), spheres.radius.numpy()
    g = rs.integers(0, len(boxes), n // 2)
    lo, hi = boxes[g, 0:3], boxes[g, 4:7]
    target = rs.uniform(lo, hi)
    axis = rs.integers(0, 3, n // 2)
    face = np.where(rs.random((n // 2, 1)) < 0.5, lo, hi)
    target[np.arange(n // 2), axis] = face[np.arange(n // 2), axis]
    k = rs.integers(0, len(r), n - n // 2)
    side = rs.standard_normal((n - n // 2, 3))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    target = np.concatenate([target, c[k] + side * np.abs(r[k])[:, None]])
    o = target + rs.standard_normal((n, 3)) * 30.0
    d = (target - o) * rs.uniform(0.5, 2.0, (n, 1))
    d[: n // 8, 1] = 0.0  # rays in a plane: infinite slab limits
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def _far_spheres():
    """Small spheres far from the origin (|c| ~ 500): the expanded form
    rounds most there, and the box pad must cover it."""
    rs = np.random.default_rng(31)
    s = 200
    c = rs.uniform(-20, 20, (s, 3)) + np.array([480.0, -150.0, 60.0])
    r = rs.uniform(0.01, 1.5, s)
    c[150:155], r[150:155] = c[3], r[3]  # duplicates split across groups
    r[7] = 0.0
    return TS.Spheres(c.astype(np.float32), r.astype(np.float32),
                      np.zeros(s, np.int32)).build_kernel_table(in_bvh=False)


def _face_rays():
    """20 spheres of radius 0.5 far out on the x axis (one group) and
    rays from y ~ -1000 along ~+y that pass just outside the group box's
    top face (z = 0.5 + delta at y = 0): they never enter the box, yet
    the expanded form, rounding at |o| + |c| ~ 2,500, takes roots on some
    of them.  The box pad must keep those rays' group."""
    k = np.arange(20)
    c = np.stack([1000.0 + 4.0 * k, 0 * k, 0 * k], 1).astype(np.float32)
    spheres = TS.Spheres(c, np.full(20, 0.5, np.float32),
                         np.zeros(20, np.int32)).build_kernel_table(False)
    n = 2048
    rs = np.random.default_rng(35)
    target = np.stack([c[rs.integers(0, 20, n), 0], np.zeros(n),
                       0.5 + rs.uniform(1e-3, 0.4, n)], 1)
    tilt = rs.uniform(2e-4, 1e-3, (n, 2)) * rs.choice([-1.0, 1.0], (n, 2))
    d = np.stack([tilt[:, 0], np.ones(n), tilt[:, 1]], 1)
    o = target - 1000.0 * d
    return spheres, *(torch.from_numpy(x.astype(np.float32)) for x in (o, d))


@pytest.mark.parametrize("case", ["rtiow main path", "rtiow grazing",
                                  "far spheres grazing",
                                  "far spheres, rays along a box face",
                                  "duplicates split across groups"])
def test_grouped_walk_matches_brute_force(case):
    if case == "far spheres, rays along a box face":
        spheres, o, d = _face_rays()
        assert spheres.n_big == 0 and spheres.g_boxes.shape[0] == 1
    elif case == "rtiow main path":
        spheres, o, d = _rtiow_main_path_rays(4096)
    elif case == "rtiow grazing":
        spheres = tget("rtiow")().generate(device="cpu")[0].spheres
        o, d = _grazing_rays(spheres, 4096, seed=32)
    elif case == "far spheres grazing":
        spheres = _far_spheres()
        o, d = _grazing_rays(spheres, 4096, seed=33)
    else:
        rs = np.random.default_rng(34)
        c = rs.uniform(-6, 6, (120, 3)).astype(np.float32)
        r = rs.uniform(0.2, 0.8, 120).astype(np.float32)
        # 41 copies of sphere 3 (one Morton code): more than a group.
        c[60:100], r[60:100] = c[3], r[3]
        spheres = TS.Spheres(c, r, np.zeros(120, np.int32))
        spheres.build_kernel_table(in_bvh=False)
        # A warp's rays start near one another and aim near one sphere,
        # the duplicated ones among them.
        warp = np.arange(2048) // 32
        k = np.array([3, 70, 99, 5, 40, 11, 77, 110])[warp % 8]
        away = rs.standard_normal((64, 3))
        away /= np.linalg.norm(away, axis=1, keepdims=True)
        o = c[k] + away[warp] * 10.0 + rs.normal(0, 0.3, (2048, 3))
        d = c[k] + rs.normal(0, 0.3, (2048, 3)) - o
        o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    n = o.shape[0]
    t_min = torch.full((n,), 1e-3)
    t_max = torch.where(torch.arange(n) % 3 == 0, 50.0, INF)
    counts = {}
    want = B1.nearest_t_plain(spheres.center, spheres.radius, o, d, t_min,
                              t_max)
    got = B1.nearest_t_grouped_plain(spheres.groups, o, d, t_min, t_max,
                                     counts=counts)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if case == "far spheres, rays along a box face":
        assert 0 < torch.isfinite(want[0]).sum() < n // 2
        return
    assert torch.isfinite(want[0]).float().mean() > 0.05
    assert counts["pairs"] < n * spheres.count  # it culled something
    assert counts["pairs"] <= counts["warp_pairs"]
    if case == "duplicates split across groups":
        index = spheres.g_index.numpy()
        group = lambda k: (np.nonzero(index == k)[0][0] - spheres.n_big) // 32
        assert len({group(k) for k in [3] + list(range(60, 100))}) >= 2
        assert (got[1] == 3).float().mean() > 0.2
        assert not ((got[1] >= 60) & (got[1] < 100)).any()


def test_group_table_layout():
    spheres = tget("rtiow")().generate(device="cpu")[0].spheres
    rows, index, boxes, order, n_big = spheres.groups
    assert n_big == 1 and spheres.radius[index[0]] == 1000.0
    assert torch.equal(torch.sort(index.long()).values, torch.arange(484))
    assert torch.equal(rows, B1.sphere_table(spheres.center,
                                             spheres.radius)[index.long()])
    for g in range(boxes.shape[0]):
        k = index[n_big + 32 * g: n_big + 32 * (g + 1)].long()
        assert torch.equal(k, torch.sort(k).values)  # ascending in a group
        c, r = spheres.center[k], spheres.radius[k, None]
        assert (boxes[g, 0:3] <= (c - r).amin(0)).all()
        assert (boxes[g, 4:7] >= (c + r).amax(0)).all()
    for o in range(8):
        assert torch.equal(torch.sort(order[o].long()).values,
                           torch.arange(boxes.shape[0]))


def test_b5_warp_counts_on_four_rays():
    # A root over two leaves: A (3 spheres) in x in [-1, 1], B (5) in
    # x in [9, 11]; the spheres are small, so no ray hits one and no box
    # is culled by a hit.
    bmin = np.array([[-1, -1, -1], [-1, -1, -1], [9, -1, -1]], np.float32)
    bmax = np.array([[11, 1, 1], [1, 1, 1], [11, 1, 1]], np.float32)
    tree = TB.FlatBVH.create(bmin, bmax, [0, 0, 3], [0, 3, 5], [3, 2, 3])
    sph = torch.tensor([[x, 0.0, 0.0, 0.1] for x in (-0.5, 0.0, 0.5)]
                       + [[x, 0.0, 0.0, 0.1] for x in (9.5, 9.8, 10.0,
                                                       10.2, 10.5)])
    o = torch.tensor([[-5.0, 0.5, 0.5],    # through A and B
                      [0.0, 0.5, -5.0],    # A only
                      [5.0, 5.0, -5.0],    # misses the root
                      [10.0, 0.5, -5.0]])  # B only
    d = torch.tensor([[1.0, 0, 0], [0, 0, 1.0], [0, 0, 1.0], [0, 0, 1.0]])
    counts = {}
    t, i = B5.sphere_bvh_plain(tree.nodes, tree.meta, sph, o, d,
                               torch.full((4,), 1e-3), torch.full((4,), INF),
                               counts=counts)
    assert torch.isinf(t).all() and (i == 0).all()
    # Iterations: the root (4 lanes, ray 2 leaves); A (rays 0, 1 at a
    # hit leaf of 3); B (rays 0, 3 at a hit leaf of 5).
    assert counts == dict(nodes=10, prims=16, warps=1, warp_iters=3,
                          warp_iters_p99=3.0, leaf_lanes=4, leaf_steps=8)


def test_b1_pair_counts_on_one_warp():
    # Two groups on the x axis: A (scene rows 0-31) at x ~ +100, B at
    # x ~ -100.  Lane 0 runs along ~+x into A; lanes 1-31 run along
    # ~+y and enter no box (no direction component is zero: a ray
    # parallel to a slab outside it gets an infinite near limit, which
    # the box test's slack makes NaN, and tests the group).  The warp
    # tests A on all 32 lanes; only lane 0 needs it.
    k = np.arange(32, dtype=np.float32)
    x = np.concatenate([100.0 + 0.1 * k, -100.0 - 0.1 * k])
    c = np.stack([x, 0 * x, 0 * x], 1).astype(np.float32)
    spheres = TS.Spheres(c, np.full(64, 0.01, np.float32),
                         np.zeros(64, np.int32)).build_kernel_table(False)
    assert spheres.n_big == 0 and spheres.g_boxes.shape[0] == 2
    o = torch.zeros((32, 3))
    d = torch.tensor([[1.0, 1e-5, 1e-5]] + [[0.3, 1.0, 0.2]] * 31)
    bounds = torch.full((32,), 1e-3), torch.full((32,), INF)
    counts = {}
    t, i = B1.nearest_t_grouped_plain(spheres.groups, o, d, *bounds,
                                      counts=counts)
    want = B1.nearest_t_plain(spheres.center, spheres.radius, o, d, *bounds)
    assert torch.equal(t, want[0]) and torch.equal(i, want[1])
    assert i[0] == 0 and torch.isfinite(t[0]) and torch.isinf(t[1:]).all()
    assert counts == dict(pairs=32, warp_pairs=32 * 32, boxes=64, entered=1)
