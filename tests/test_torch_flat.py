"""Port parity: the SAH build, the world-flattened TLAS tables and
their routing gates, kernel B6 (triangle-BVH closest hit) and the brute
triangle scan (mrt_torch vs mrt).

Tolerances and why:
  - BVH builds, ``_build_flat`` and ``_build_flat_parts`` are host NumPy
    on both sides: byte-equal, array for array.  Above 1,024 primitives
    the reference builds with its C++ builder (``mrt.native``), so those
    cases hold the port's Python builder against the C++ one.
  - B6's plain version (``mrt_torch.ops.bvh.tri_bvh_plain``, the CPU
    path of ``tri_bvh_hit``) repeats the reference traversal's
    arithmetic in the same order: against
    ``mrt.geometry.bvh.intersect_bvh_tris`` run op by op
    (``jax.disable_jit``) t, triangle, u and v are bit-equal, on rays
    that start on a slab plane with a zero direction component (NaN in
    the slab test culls the box, C7) and on zero directions (C6) too.
  - Against the Pallas kernel in interpret mode (compiled by XLA, which
    contracts multiply-adds into FMAs) the triangle is equal and t
    within rtol 1e-5, u and v within 1e-5, without the C6/C7 rays: the
    Pallas wrapper replaces a zero direction by (1, 1, 1), and its
    packets test a leaf for every lane when any lane's slab test passes.
  - The brute scan is bit-equal to ``mrt.geometry.triangles.nearest_hit``
    run op by op, and a scene's brute triangle set gives the same Hits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.geometry import bvh as JB
from mrt.geometry import instance as JI
from mrt.geometry import triangles as JT
from mrt.geometry.scene import SceneBuilder as JSceneBuilder
from mrt.geometry.shapes import cube as jcube
from mrt.geometry.shapes import sphere_mesh as jsphere_mesh
from mrt.materials.background import SkyBackground as JSky
from mrt.materials.table import MaterialBuilder as JMaterialBuilder
from mrt.ops import pallas_bvh as PB
from mrt.scenes import get as jget
from mrt.scenes import lucy as JLucy
from mrt_torch import convert
from mrt_torch.geometry import bvh as TB
from mrt_torch.geometry import instance as TI
from mrt_torch.geometry import triangles as TT
from mrt_torch.geometry.scene import SceneBuilder as TSceneBuilder
from mrt_torch.geometry.shapes import cube, sphere_mesh
from mrt_torch.materials.background import SkyBackground as TSky
from mrt_torch.materials.table import MaterialBuilder as TMaterialBuilder
from mrt_torch.materials.table import MaterialTable
from mrt_torch.ops import bvh as B6
from mrt_torch.scenes import get as tget
from mrt_torch.scenes import lucy as TLucy

torch.set_num_threads(2)

BVH_FIELDS = TB.FlatBVH.FIELDS
KINDS = ["", "auto", "flat", "packet", "brute"]


@pytest.fixture(autouse=True)
def _no_route_env(monkeypatch):
    for name in ("MRT_TLAS_KERNEL", "MRT_FLAT_SPLIT", "MRT_BVH"):
        monkeypatch.delenv(name, raising=False)


def _equal(want, got, what):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert want.tobytes() == got.tobytes(), what


def _bvh_equal(jbvh, tbvh):
    for k in BVH_FIELDS:
        _equal(getattr(jbvh, k), getattr(tbvh, k), k)


def _rows(jtris):
    return np.concatenate([np.asarray(getattr(jtris, k))
                           for k in ("va", "e_ab", "e_ac")], axis=1)


def _soup(n, seed=0, dup=0):
    """n random triangles; the first `dup` are one triangle repeated (a
    node of coincident centroids: the SAH finds no split there)."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-5, 5, (n, 1, 3)) * np.array([1.0, 0.2, 1.0])
    v = (c + rs.normal(0, 0.3, (n, 3, 3))).astype(np.float32)
    v[:dup] = v[0]
    return [v[:, k] for k in range(3)]


@pytest.mark.parametrize("case", ["statue", "soup300", "dup", "soup3000"])
@pytest.mark.parametrize("split", ["median", "sah"])
def test_builds_match(case, split):
    if case == "statue":  # lucy's 672-triangle stand-in
        jtris, tris = JLucy._standin_statue()[0], TLucy._standin_statue()[0]
    else:
        n, dup = dict(soup300=(300, 0), dup=(200, 70),
                      soup3000=(3000, 0))[case]
        corners = _soup(n, seed=n, dup=dup)
        jtris = JT.Triangles.from_soup(*corners)
        tris = TT.Triangles.from_soup(*corners)
    jbvh, jout = JB.build_over_triangles(jtris, split=split)
    tbvh, tout = TB.build_over_triangles(tris, split=split)
    _bvh_equal(jbvh, tbvh)
    for k in TT.FIELDS:
        _equal(getattr(jout, k), getattr(tout, k), k)
    if split == "sah" and case != "dup":
        median, _ = TB.build_over_triangles(tris)
        assert not np.array_equal(median.meta.numpy(), tbvh.meta.numpy())


def _fleet(reg_cls, cube_fn, sphere_fn, ni=4):
    """tests/test_tlas_flat.py's instance grid with overrides and a
    non-uniform scale."""
    reg = reg_cls()
    m1 = reg.add_mesh(cube_fn(size=1.0, material=1))
    m2 = reg.add_mesh(sphere_fn(radius=0.6, lat=6, lon=8, material=2))
    for i in range(ni):
        for j in range(ni):
            reg.add_instance(m1 if (i + j) % 2 == 0 else m2,
                             translation=(i * 3.0, 0.0, j * 3.0),
                             rotation=(0.0, 0.1 * i, 0.05 * j),
                             scale=(1.0 + 0.2 * j, 1.0, 0.8),
                             material=7 if (i + j) % 3 == 0 else None)
    return reg.build()


def flat_tables_equal(jt, tt):
    """The world-flattened tables of both packages' TLAS are equal."""
    assert (jt.flat_tris is None) == (tt.flat_tris is None)
    if jt.flat_tris is not None:
        assert jt.flat_tris.unit_normal and tt.flat_tris.unit_normal
        _bvh_equal(jt.flat_bvh, tt.flat_bvh)
        _equal(_rows(jt.flat_tris), tt.flat_tris.rows, "flat rows")
        _equal(np.asarray(JT.shading_table(jt.flat_tris)),
               tt.flat_tris.shading, "flat shading")
    assert (jt.flat_parts is None) == (tt.flat_parts is None)
    if jt.flat_parts is not None:
        assert len(jt.flat_parts) == len(tt.flat_parts)
        for jp, tp in zip(jt.flat_parts, tt.flat_parts):
            _bvh_equal(jp.bvh, tp.bvh)
            _equal(_rows(jp.tris), tp.rows, "part rows")
            _equal(jp.packed, tp.packed, "packed")
    for k in ("tri_first", "tri_count", "w_min", "w_max"):
        _equal(getattr(jt, k), getattr(tt, k), k)


@pytest.mark.parametrize("split", ["", "96"])
def test_fleet_flat_tables_match(monkeypatch, split):
    # "": the single flat set; "96": MRT_FLAT_SPLIT forces parts of at
    # most 96 triangles instead.
    if split:
        monkeypatch.setenv("MRT_FLAT_SPLIT", split)
    jt = _fleet(JI.MeshRegistry, jcube, jsphere_mesh)
    tt = _fleet(TI.MeshRegistry, cube, sphere_mesh)
    assert (tt.flat_parts is not None) == bool(split)
    if split:
        assert len(tt.flat_parts) >= 3
    flat_tables_equal(jt, tt)


@pytest.mark.parametrize("kind", ["", "flat"])
def test_lucy_flat_tables_match(monkeypatch, kind):
    # Lucy's 81,324 world triangles pass FLAT_MAX_TRIS: no single flat
    # set; the opt-in builds 16 parts of 4,032-6,048 triangles, each
    # under a median BVH past 1,024 triangles (the C++ builder there).
    if kind:
        monkeypatch.setenv("MRT_TLAS_KERNEL", kind)
    jt = jget("lucy")().generate()[0].tlas
    tt = tget("lucy")().generate(device="cpu")[0].tlas
    assert tt.flat_tris is None
    if kind:
        sizes = [p.rows.shape[0] for p in tt.flat_parts]
        assert len(sizes) == 16 and sum(sizes) == 81_324
        assert min(sizes) >= 4032 and max(sizes) == 6048
        packed = tt.flat_packed.numpy()
        inst, tri = packed >> 20, packed & 0xFFFFF
        lo = tt.tri_first.numpy()[inst]
        assert ((tri >= lo) & (tri < lo + tt.tri_count.numpy()[inst])).all()
    else:
        assert tt.flat_parts is None
    flat_tables_equal(jt, tt)


def test_flat_gates_match(monkeypatch):
    jt = _fleet(JI.MeshRegistry, jcube, jsphere_mesh, ni=2)
    tt = _fleet(TI.MeshRegistry, cube, sphere_mesh, ni=2)
    monkeypatch.setenv("MRT_FLAT_SPLIT", "100")
    jp = _fleet(JI.MeshRegistry, jcube, jsphere_mesh, ni=2)
    tp = _fleet(TI.MeshRegistry, cube, sphere_mesh, ni=2)
    monkeypatch.delenv("MRT_FLAT_SPLIT")
    assert not TI.FLAT_AUTO_ON and not TI.PARTS_AUTO_ON
    for kind in KINDS:
        monkeypatch.setenv("MRT_TLAS_KERNEL", kind)
        for auto in (True, False):
            got = (TI.wants_flat(tt, auto), TI.wants_flat_parts(tp, auto),
                   TI.wants_flat(tp, auto), TI.wants_flat_parts(tt, auto))
            want = (JI.wants_flat(jt, auto), JI.wants_flat_parts(jp, auto),
                    JI.wants_flat(jp, auto), JI.wants_flat_parts(jt, auto))
            assert got == want, (kind, auto)
            assert got[:2] == ((kind in ("flat", "auto"),) * 2)
    assert not TI.wants_flat(None) and not TI.wants_flat_parts(None)


def _b6_case(seed, n=300, split="sah"):
    """The stand-in statue under a BVH, and rays around it with per-lane
    t_min and t_max; rays 0-29 start on a node's slab plane with a zero
    direction component (0-9 on the root's), rays 30-35 have a zero
    direction."""
    jtris = JLucy._standin_statue()[0]
    jbvh, jtris = JB.build_over_triangles(jtris, split=split)
    rs = np.random.default_rng(seed)
    o = rs.uniform(-1.6, 1.6, (n, 3))
    d = rs.uniform((-0.4, -0.9, -0.4), (0.4, 0.9, 0.4), (n, 3)) - o
    bmin, bmax = np.asarray(jbvh.bmin), np.asarray(jbvh.bmax)
    node = rs.integers(0, len(bmin), 30)
    node[:10] = 0
    axis = rs.integers(0, 3, 30)
    o[np.arange(30), axis] = np.where(rs.random(30) < 0.5,
                                      bmin[node, axis], bmax[node, axis])
    d[np.arange(30), axis] = 0.0
    d[30:36] = 0.0
    t_min = rs.uniform(1e-3, 0.3, n)
    t_max = rs.uniform(1.0, 6.0, n)
    f32 = lambda x: x.astype(np.float32)
    return jbvh, jtris, f32(o), f32(d), f32(t_min), f32(t_max)


def _port_b6(jbvh, jtris, o, d, t_min, t_max):
    tbvh = TB.FlatBVH.create(*(np.asarray(getattr(jbvh, k))
                               for k in BVH_FIELDS))
    counts = {}
    args = (tbvh.nodes, tbvh.meta, torch.from_numpy(_rows(jtris)),
            torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_min),
            torch.from_numpy(t_max))
    got = [x.numpy() for x in B6.tri_bvh_hit(*args)]
    again = [x.numpy() for x in B6.tri_bvh_plain(*args, counts=counts)]
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    assert counts["nodes"] >= len(o) and counts["prims"] > 0
    return got


@pytest.mark.parametrize("split", ["median", "sah"])
def test_b6_plain_matches_xla_traversal(split):
    jbvh, jtris, o, d, t_min, t_max = _b6_case(1, split=split)
    with jax.disable_jit():
        want = [np.asarray(x) for x in JB.intersect_bvh_tris(
            jtris, jbvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
            jnp.asarray(t_max))]
    got = _port_b6(jbvh, jtris, o, d, t_min, t_max)
    for w, g in zip(want, got):
        _equal(w, g, "t, triangle, u, v")
    hit = np.isfinite(got[0])
    assert 0.2 < hit.mean() < 0.9
    assert not hit[:10].any()    # culled at a NaN slab (C7)
    assert not hit[30:36].any()  # zero directions walk as given (C6)


def test_b6_plain_matches_pallas_kernel():
    jbvh, jtris, o, d, t_min, t_max = _b6_case(2, n=292)
    o, d, t_min, t_max = o[36:], d[36:], t_min[36:], t_max[36:]
    want = [np.asarray(x) for x in PB.traverse_bvh_tris(
        jtris, jbvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
        jnp.asarray(t_max), interpret=True)]
    got = _port_b6(jbvh, jtris, o, d, t_min, t_max)
    hit = np.isfinite(want[0])
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    np.testing.assert_array_equal(got[1][hit], want[1][hit])
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
    for k in (2, 3):
        np.testing.assert_allclose(got[k][hit], want[k][hit], atol=1e-5)


def test_b6_wrapper_checks_arguments():
    tbvh, ttris = TB.build_over_triangles(cube(size=1.0))
    rows = TT.TriangleTable(ttris).rows
    o = torch.zeros((8, 3))
    with pytest.raises(TypeError):
        B6.tri_bvh_hit(tbvh.nodes, tbvh.meta.long(), rows, o, o, 1e-3, 1.0)
    with pytest.raises(ValueError):
        B6.tri_bvh_hit(tbvh.nodes, tbvh.meta, rows[:, :6], o, o, 1e-3, 1.0)
    meta = [x.to("meta") for x in (tbvh.nodes, tbvh.meta, rows, o, o)]
    with pytest.raises(ValueError, match="no kernel"):
        B6.tri_bvh_hit(*meta, 1e-3, 1.0)


def _brute_case(seed=3, n=240):
    corners = _soup(400, seed=seed)
    corners[1][:4] = corners[1][4]  # repeated triangles: ties
    corners[0][:4], corners[2][:4] = corners[0][4], corners[2][4]
    rs = np.random.default_rng(seed)
    o = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(2, 4, n)
    target = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    target[:, 1] = 0.0
    target[:8] = corners[0][4] + 0.1 * (corners[1][4] - corners[0][4])
    return corners, o, (target - o).astype(np.float32)


def test_brute_scan_matches():
    corners, o, d = _brute_case()
    jtris = JT.Triangles.from_soup(*corners)
    t_min = np.float32(1e-3)
    with jax.disable_jit():
        want = [np.asarray(x) for x in JT.nearest_hit(
            jtris, jnp.asarray(o), jnp.asarray(d), t_min, jnp.inf)]
    table = TT.TriangleTable(TT.Triangles.from_soup(*corners))
    got = [x.numpy() for x in TT.nearest_hit(
        table, torch.from_numpy(o), torch.from_numpy(d), t_min,
        float("inf"))]
    for w, g in zip(want, got):
        _equal(w, g, "t, triangle, u, v")
    assert np.isfinite(got[0]).mean() > 0.3
    # Of the tied copies 0-4, only the lowest ever wins.
    assert (got[1][:8] == 0).any() and not np.isin(got[1], [1, 2, 3, 4]).any()


def test_scene_brute_triangles_match():
    # SceneBuilder.add_triangles: no BVH, the brute scan, folded after
    # the spheres (equal t: the sphere keeps the hit).
    corners, o, d = _brute_case(seed=4)
    scenes = []
    for mb, bg, sb_cls, tri_cls in (
            (JMaterialBuilder, JSky, JSceneBuilder, JT.Triangles),
            (TMaterialBuilder, TSky, TSceneBuilder, TT.Triangles)):
        mat = mb()
        sb = sb_cls(mat, bg.create())
        red = mat.lambertian((0.8, 0.2, 0.2))
        sb.add_sphere((0.0, 0.0, 0.0), 1.5, mat.metal(0.1))
        sb.add_triangles(tri_cls.from_soup(*corners, material=red))
        sb.add_triangles(tri_cls.from_soup(*_soup(20, seed=9)))
        scenes.append(sb)
    js = scenes[0].build()
    ts = scenes[1].build(device="cpu")
    assert ts.triangles.count == 420 and ts.bvh is None
    with jax.disable_jit():
        want = js.intersect(jnp.asarray(o), jnp.asarray(d))
    got = ts.intersect(torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    for k in ("t", "material", "front_face", "point", "normal"):
        _equal(np.asarray(getattr(want, k))[hit],
               getattr(got, k).numpy()[hit], k)


def test_scene_mesh_bvh_matches():
    # Scene.triangles under Scene.bvh (no builder sets it; convert
    # carries it): kernel B6's route, folded after a sphere.
    jbvh, jtris, o, d, _, _ = _b6_case(5, n=160)
    mat = JMaterialBuilder()
    sb = JSceneBuilder(mat, JSky.create())
    sb.add_sphere((0.0, 0.9, 0.0), 0.3, mat.metal(0.2))
    js = sb.build().replace(triangles=jtris, bvh=jbvh)
    arr = lambda obj, keys: {k: np.asarray(getattr(obj, k)) for k in keys}
    ts = convert.scene_from_numpy(
        arr(js.spheres, ("center", "radius", "material")),
        arr(js.materials, MaterialTable.FIELDS), has_mix=js.has_mix,
        triangles=arr(jtris, TT.FIELDS), bvh=arr(jbvh, BVH_FIELDS))
    o, d = o[36:], d[36:]
    with jax.disable_jit():
        want = js.intersect(jnp.asarray(o), jnp.asarray(d))
    got = ts.intersect(torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(want.hit)
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    for k in ("t", "material", "front_face"):
        _equal(np.asarray(getattr(want, k))[hit],
               getattr(got, k).numpy()[hit], k)
    for k in ("point", "normal"):
        np.testing.assert_allclose(getattr(got, k).numpy()[hit],
                                   np.asarray(getattr(want, k))[hit],
                                   atol=1e-6)
