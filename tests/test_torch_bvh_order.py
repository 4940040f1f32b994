"""Port parity for the card's BVH layout and walk order (kernels B6 and
B7): the octant threading, the packed tables, the octant-order walks,
the flat-parts forest, and the film's checkpoint guides (mrt_torch vs
mrt).

Tolerances and why:
  - ``thread_octants`` is host NumPy on both sides: array-equal, on
    playground's flat BVH, two of lucy's flat parts and their forest.
    The stored threading (``card_order``) is the reference's octant
    threading on a tree of ``OCTANT_MIN_NODES`` nodes or more, else the
    escape order in every octant: on those trees, lucy's and eve's TLAS
    and each of their BLAS (the TLAS's stored threading of a BLAS
    compared after removing its node offset, its ``blas_end`` the
    sentinel).  The packed tables unpack to the reference tables bit for
    bit.
  - The plain walks in octant order repeat the escape-order walks'
    arithmetic, so on the same rays (t, index, u, v) are bit-equal.
    Against the reference's XLA traversal: B6 on playground op by op
    (``jax.disable_jit``), bit-equal as the escape order is
    (tests/test_torch_flat.py), u and v within 1e-6; on a lucy part
    compiled (~30 s op by op here; XLA contracts multiply-adds, C2):
    triangles equal, t rtol 1e-6, u and v 1e-4 (on the ground cube's
    2,000-unit world triangles the FMAs move the barycentrics by up to
    4e-5, tests/test_torch_lucy.py); B7 compiled, with
    tests/test_torch_tlas.py's tolerances (the plain version warps rays
    in the Pallas order, XLA by an einsum): hits and (instance,
    triangle) equal, t rtol 1e-5, u and v 1e-5.
  - Work: the octant order visits no more nodes than the escape order,
    summed over the rays, on lucy's parts and the 64-instance TLAS.  On
    playground's 15-node BVH it visits 0.1% more nodes (9,392 against
    9,382 on these rays) and tests 1.6% fewer triangles: there the test
    holds the triangle tests and the work (26 operations a visit, 58 a
    test, as chip_smoke.py counts them).
  - The forest's plain version (``tri_bvh_parts_plain``) against
    ``mrt.geometry.instance.intersect_tlas_flat_parts(use_pallas=False)``
    on lucy's 24x24 camera rays: op by op that reference takes ~200 s
    here, so it runs compiled (XLA contracts multiply-adds, C2): hits,
    rows, instances and triangles equal, t rtol 1e-6, u and v 1e-4.
  - B7's regime follows its tables' bytes: cornell's below
    ``SHARED_MIN_BYTES`` and the 8,000-instance set's past the card's
    limit read global memory, lucy's shared memory.
  - A checkpoint keeps the AOV guides (C14): arrays equal.
  - ptxas's report parses into each kernel's registers, stack, spills
    and shared memory (chip_smoke.py's phase 2 prints them).
"""

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.geometry import bvh as JB
from mrt.geometry import instance as JI
from mrt.geometry.shapes import cube as jcube
from mrt.geometry.shapes import sphere_mesh as jsphere_mesh
from mrt.runtime.film import Film as JFilm
from mrt.scenes import get as jget
from mrt_torch.geometry import bvh as TB
from mrt_torch.geometry import instance as TI
from mrt_torch.geometry.shapes import cube, sphere_mesh
from mrt_torch.ops import bvh as K
from mrt_torch.runtime.film import Film
from mrt_torch.scenes import get as tget

torch.set_num_threads(2)

OPS_NODE, OPS_TRI = 26, 58


@pytest.fixture(scope="module")
def scenes():
    """The port's lucy (flat parts built), playground and eve, and a
    64-instance TLAS as chip_smoke.py::many_instances builds one."""
    old = os.environ.pop("MRT_TLAS_KERNEL", None)
    os.environ["MRT_TLAS_KERNEL"] = "flat"
    try:
        lucy = tget("lucy")(aspect_ratio=1.0).generate(device="cpu")
        playground = tget("playground")(aspect_ratio=1.0).generate(
            device="cpu")
    finally:
        os.environ.pop("MRT_TLAS_KERNEL")
        if old is not None:
            os.environ["MRT_TLAS_KERNEL"] = old
    eve = tget("eve")(aspect_ratio=1.0).generate(device="cpu")
    return dict(lucy=lucy, playground=playground, eve=eve,
                many=_registry(TI.MeshRegistry, cube, sphere_mesh))


def _registry(reg_cls, cube_fn, sphere_fn, n_inst=64, seed=0):
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


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _uncard_nodes(knodes):
    """``ops.bvh.card_nodes``' rows back to (nodes with zero pads, a,
    b)."""
    a = knodes[:, 3].contiguous().view(torch.int32)
    b = knodes[:, 7].contiguous().view(torch.int32)
    nodes = knodes.clone()
    nodes[:, 3] = 0.0
    nodes[:, 7] = 0.0
    return nodes, a, b


def _uncard_tris(krows):
    """``ops.bvh.card_tris``' rows back to (T, 9)."""
    return krows.reshape(-1, 3, 4)[:, :, :3].reshape(-1, 9)


def _reference_order(count, escape, bmin, bmax):
    hitp, missp = JB.thread_octants(_np(count), _np(escape), _np(bmin),
                                    _np(bmax))
    return np.stack([hitp, missp], axis=-1)


def _card_order(count, escape, bmin, bmax):
    """The threading the card should walk: the reference's octant orders,
    or on a tree under OCTANT_MIN_NODES nodes the escape order in every
    octant (a hit inner node to node + 1, anything else to its
    escape)."""
    count, escape = _np(count), _np(escape)
    if len(count) >= TB.OCTANT_MIN_NODES:
        return _reference_order(count, escape, bmin, bmax)
    hit = np.where(count == 0, np.arange(len(count)) + 1, escape)
    return np.broadcast_to(np.stack([hit, escape], axis=-1),
                           (8, len(count), 2))


def _octant_order(tree):
    """``tree``'s octant threading whatever its size."""
    return torch.from_numpy(TB.order_table(*TB.thread_octants(
        tree.count.numpy(), tree.escape.numpy(), tree.bmin.numpy(),
        tree.bmax.numpy())))


def _trees(scenes):
    """(name, FlatBVH) of every single-level tree the card walks."""
    lucy = scenes["lucy"][0].tlas.flat_parts
    return [("playground flat", scenes["playground"][0].tlas.flat_bvh),
            ("lucy part 0", lucy[0].bvh), ("lucy part 9", lucy[9].bvh),
            ("lucy forest", lucy.forest)]


def test_thread_octants_match_reference(scenes):
    for name, tree in _trees(scenes):
        want = JB.thread_octants(tree.count.numpy(), tree.escape.numpy(),
                                 tree.bmin.numpy(), tree.bmax.numpy())
        got = TB.thread_octants(tree.count.numpy(), tree.escape.numpy(),
                                tree.bmin.numpy(), tree.bmax.numpy())
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and np.array_equal(w, g), name
        card = _card_order(tree.count, tree.escape, tree.bmin, tree.bmax)
        assert np.array_equal(tree.order.numpy(), card), name
    # Both kinds occur: playground's 15-node BVH walks the escape order.
    sizes = [tree.n_nodes for _, tree in _trees(scenes)]
    assert min(sizes) < TB.OCTANT_MIN_NODES <= max(sizes)


@pytest.mark.parametrize("scene", ["lucy", "eve"])
def test_tlas_threading_matches_reference(scenes, scene):
    tl = scenes[scene][0].tlas
    leaf = (tl.t_inst >= 0).to(torch.int32)
    want = _card_order(leaf, tl.t_escape, tl.t_bmin, tl.t_bmax)
    assert np.array_equal(tl.t_order.numpy(), want)
    blas = sorted(set(zip(tl.blas_root.tolist(), tl.blas_end.tolist())))
    assert len(blas) >= 2
    for root, end in blas:
        local = slice(root, end)
        want = _card_order(tl.count[local], tl.escape[local] - root,
                           tl.bmin[local], tl.bmax[local])
        got = tl.b_order[:, local].numpy() - root
        assert np.array_equal(got, want), (scene, root, end)
        assert got.max() == end - root  # the sentinel: blas_end


def test_packed_tables_unpack_bit_for_bit(scenes):
    bits = lambda x: _np(x).view(np.uint32)
    for name, tree in _trees(scenes):
        nodes, first, count = _uncard_nodes(tree.knodes)
        assert np.array_equal(bits(nodes), bits(tree.nodes)), name
        assert np.array_equal(first.numpy(), tree.first.numpy()), name
        assert np.array_equal(count.numpy(), tree.count.numpy()), name
    table = scenes["playground"][0].tlas.flat_tris
    assert np.array_equal(bits(_uncard_tris(table.krows)), bits(table.rows))
    parts = scenes["lucy"][0].tlas.flat_parts
    rows = torch.cat([p.rows for p in parts])
    assert np.array_equal(bits(_uncard_tris(parts.krows)), bits(rows))
    for scene in ("lucy", "eve"):
        tl = scenes[scene][0].tlas
        nodes, inst, zero = _uncard_nodes(tl.k_tnodes)
        assert np.array_equal(bits(nodes), bits(tl.tnodes))
        assert np.array_equal(inst.numpy(), tl.t_inst.numpy())
        assert not zero.any()
        nodes, first, count = _uncard_nodes(tl.k_bnodes)
        assert np.array_equal(bits(nodes), bits(tl.bnodes))
        assert np.array_equal(first.numpy(), tl.first.numpy())
        assert np.array_equal(count.numpy(), tl.count.numpy())
        assert np.array_equal(bits(_uncard_tris(tl.k_tris)), bits(tl.tris))


def test_forest_leaves_cover_every_part_row(scenes):
    parts = scenes["lucy"][0].tlas.flat_parts
    f = parts.forest
    leaf = f.count > 0
    covered = torch.zeros(parts.krows.shape[0], dtype=torch.int32)
    for first, count in zip(f.first[leaf].tolist(), f.count[leaf].tolist()):
        covered[first:first + count] += 1
    assert (covered == 1).all()
    assert int(leaf.sum()) == sum(int((p.bvh.count > 0).sum())
                                  for p in parts)
    assert f.escape[0] == f.n_nodes


def _rays(camera, bmin, bmax, seed=0):
    """The camera's 24x24 pixel-centre rays, then 448 rays from around
    the box [bmin, bmax] in random directions."""
    g = (np.arange(24) + 0.5) / 24
    s, t = (torch.tensor(x.ravel(), dtype=torch.float32)
            for x in np.meshgrid(g, g))
    z = torch.zeros(576)
    o, d = camera.rays(s, t, z, z)
    rs = np.random.default_rng(seed)
    lo, hi = np.asarray(bmin, np.float64), np.asarray(bmax, np.float64)
    ext = hi - lo
    o2 = rs.uniform(lo - 0.2 * ext, hi + 0.2 * ext, (448, 3))
    d2 = rs.standard_normal((448, 3))
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))
    return (torch.cat([o, f32(o2)]).contiguous(),
            torch.cat([d, f32(d2)]).contiguous())


class _JTris(NamedTuple):
    va: object
    e_ab: object
    e_ac: object

    @property
    def count(self):
        return self.va.shape[0]


def _xla_b6(tree, rows, o, d, lo, hi, compiled):
    """The reference's XLA traversal on the port's tables: op by op, or
    compiled (``compiled``)."""
    jbvh = JB.FlatBVH(*(jnp.asarray(getattr(tree, k).numpy())
                        for k in TB.FlatBVH.FIELDS))
    r = rows.numpy()
    jtris = _JTris(jnp.asarray(r[:, 0:3]), jnp.asarray(r[:, 3:6]),
                   jnp.asarray(r[:, 6:9]))
    args = (jtris, jbvh) + tuple(jnp.asarray(x.numpy())
                                 for x in (o, d, lo, hi))
    if compiled:
        return [np.asarray(x) for x in jax.jit(JB.intersect_bvh_tris)(*args)]
    with jax.disable_jit():
        return [np.asarray(x) for x in JB.intersect_bvh_tris(*args)]


@pytest.mark.parametrize("case", ["playground", "lucy part 9"])
def test_b6_octant_walk_matches_escape_and_xla(scenes, case):
    if case == "playground":
        scene, camera = scenes["playground"]
        tree, rows = scene.tlas.flat_bvh, scene.tlas.flat_tris.rows
    else:
        scene, camera = scenes["lucy"]
        part = scene.tlas.flat_parts[9]
        tree, rows = part.bvh, part.rows
    o, d = _rays(camera, tree.bmin[0], tree.bmax[0])
    n = o.shape[0]
    lo, hi = torch.full((n,), 1e-3), torch.full((n,), float("inf"))
    walked, escaped = {}, {}
    got = K.tri_bvh_plain(tree.nodes, tree.meta, rows, o, d, lo, hi,
                          counts=walked, order=_octant_order(tree))
    esc = K.tri_bvh_plain(tree.nodes, tree.meta, rows, o, d, lo, hi,
                          counts=escaped)
    for a, b in zip(got, esc):
        assert torch.equal(a, b)
    # Op by op (bit-equal) on playground; compiled on the lucy part,
    # whose walk takes ~30 s op by op here (C2: t rtol 1e-6).
    compiled = case != "playground"
    want = _xla_b6(tree, rows, o, d, lo, hi, compiled)
    np.testing.assert_array_equal(want[1], got[1].numpy())
    if compiled:
        hit = np.isfinite(want[0])
        np.testing.assert_array_equal(np.isfinite(got[0].numpy()), hit)
        np.testing.assert_allclose(got[0].numpy()[hit], want[0][hit],
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(want[0], got[0].numpy())
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_allclose(w, g.numpy(), rtol=0,
                                   atol=1e-4 if compiled else 1e-6)
    assert 0.1 < torch.isfinite(got[0]).float().mean() < 0.95
    work = lambda c: c["nodes"] * OPS_NODE + c["prims"] * OPS_TRI
    if case == "playground":
        assert walked["prims"] <= escaped["prims"]
        assert work(walked) <= work(escaped)
    else:
        assert walked["nodes"] <= escaped["nodes"]
        assert walked["prims"] <= escaped["prims"]


def test_b7_octant_walk_matches_escape_and_xla(scenes, monkeypatch):
    tl = scenes["many"]
    rs = np.random.default_rng(1)
    o = torch.from_numpy(rs.uniform(-10, 10, (512, 3)).astype(np.float32))
    d = torch.from_numpy(rs.standard_normal((512, 3)).astype(np.float32))
    n = o.shape[0]
    lo, hi = torch.full((n,), 1e-3), torch.full((n,), float("inf"))
    walked, escaped = {}, {}
    got = K.tlas_plain(tl, o, d, lo, hi, counts=walked, ordered=True)
    esc = K.tlas_plain(tl, o, d, lo, hi, counts=escaped)
    for a, b in zip(got, esc):
        assert torch.equal(a, b)
    visits = lambda c: c["tlas_nodes"] + c["blas_nodes"]
    assert visits(walked) <= visits(escaped)
    assert walked["prims"] <= escaped["prims"]

    jt = _registry(JI.MeshRegistry, jcube, jsphere_mesh)
    monkeypatch.setattr(JI, "expand_winner", lambda tlas, o, d, *w: w)
    want = [np.asarray(x) for x in jax.jit(
        lambda o, d, lo: JI.intersect_tlas(jt, o, d, lo, jnp.inf))(
            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(lo.numpy()))]
    got = [x.numpy() for x in got]
    hit = np.isfinite(want[0])
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    for k in (1, 2):  # instance, triangle
        np.testing.assert_array_equal(got[k][hit], want[k][hit])
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
    for k in (3, 4):
        np.testing.assert_allclose(got[k][hit], want[k][hit], atol=1e-5)


def test_forest_plain_matches_reference_fold(scenes, monkeypatch):
    monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
    js, _ = jget("lucy")(aspect_ratio=1.0).generate()
    ts, camera = scenes["lucy"]
    g = (np.arange(24) + 0.5) / 24
    s, t = (torch.tensor(x.ravel(), dtype=torch.float32)
            for x in np.meshgrid(g, g))
    z = torch.zeros(576)
    o, d = camera.rays(s, t, z, z)
    n = o.shape[0]
    lo, hi = torch.full((n,), 1e-3), torch.full((n,), float("inf"))
    t_, row, u, v = K.tri_bvh_parts_plain(ts.tlas.flat_parts, o, d, lo, hi)
    packed = ts.tlas.flat_packed[row.to(torch.int64)]
    got = [t_.numpy(), (packed >> 20).numpy(),
           (packed & ((1 << 20) - 1)).numpy(), u.numpy(), v.numpy()]
    # The forest in octant order: the kernel's walk, bit-equal to the fold.
    f = ts.tlas.flat_parts.forest
    rows = torch.cat([p.rows for p in ts.tlas.flat_parts])
    walk = K.tri_bvh_plain(f.nodes, f.meta, rows, o, d, lo, hi,
                           order=f.order)
    for a, b in zip(walk, (t_, row, u, v)):
        assert torch.equal(a, b)

    monkeypatch.setattr(JI, "expand_winner", lambda tlas, o, d, *w: w)
    want = [np.asarray(x) for x in jax.jit(
        lambda o, d: JI.intersect_tlas_flat_parts(
            js.tlas, o, d, 1e-3, jnp.inf, use_pallas=False))(
                jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))]
    hit = np.isfinite(want[0])
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    for k in (1, 2):  # instance, triangle
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6)
    for k in (3, 4):
        np.testing.assert_allclose(got[k][hit], want[k][hit], atol=1e-4)


def test_tlas_regime_follows_table_bytes(scenes, monkeypatch):
    # The H100's opt-in limit a block (probe P3), without asking a card.
    monkeypatch.setattr(K, "smem_optin", lambda device: 232448)
    small = tget("cornell")(aspect_ratio=1.0).generate(device="cpu")[0]
    big = _registry(TI.MeshRegistry, cube, sphere_mesh, n_inst=8000)
    want = [(small.tlas, "global"), (scenes["lucy"][0].tlas, "shared"),
            (big, "global")]
    for tl, regime in want:
        assert K.tlas_regime(tl) == regime, K.tlas_table_bytes(tl)
    assert (K.tlas_table_bytes(small.tlas) < K.SHARED_MIN_BYTES
            <= K.tlas_table_bytes(scenes["lucy"][0].tlas) <= 232448
            < K.tlas_table_bytes(big))
    # The sizes as the kernel lays the tables out, each from 16 bytes.
    tl = scenes["many"]
    assert K.tlas_table_bytes(tl) == sum(
        -(-getattr(tl, name).numel() * 4 // 16) * 16
        for name in ("k_tnodes", "t_order", "inst", "imeta", "k_bnodes",
                     "b_order", "k_tris"))


def test_ptxas_report_parses_per_kernel():
    # chip_smoke.py's phase 2 prints each kernel's resources from this.
    from mrt_torch.ops import _build

    ns = "_GLOBAL__N__7f3e_6_bvh_cu_5a1b"
    report = f"""\
ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}11tlas_kernelILb1EEEvNS_10TlasTablesEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN{len(ns)}{ns}11tlas_kernelILb1EEEvNS_10TlasTablesEPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 70 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}14tri_bvh_kernelEPK6float4' for 'sm_90a'
ptxas info    : Function properties for _ZN{len(ns)}{ns}14tri_bvh_kernelEPK6float4
    16 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 55 registers, 1024 bytes smem, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}14deposit_kernelILi4ELb0EEEvPfiPKiPKhPKfi' for 'sm_90a'
ptxas info    : Used 14 registers, used 0 barriers
"""
    got = _build.kernel_resources(report)
    assert got == [
        dict(name="tlas_kernel<1>", registers=70, stack=0, spill_stores=0,
             spill_loads=0, smem=0),
        dict(name="tri_bvh_kernel", registers=55, stack=16, spill_stores=24,
             spill_loads=20, smem=1024),
        dict(name="deposit_kernel<4,0>", registers=14, stack=0,
             spill_stores=0, spill_loads=0, smem=0)]


def test_checkpoint_keeps_the_aov_guides(tmp_path):
    rs = np.random.default_rng(3)
    f32 = lambda *shape: rs.standard_normal(shape).astype(np.float32)
    film = JFilm(sum=jnp.asarray(f32(8, 6, 3)),
                 depth_sum=jnp.asarray(rs.integers(0, 9, (8, 6), np.int32)),
                 samples=jnp.asarray(5, jnp.int32),
                 albedo=jnp.asarray(f32(8, 6, 3)),
                 normal=jnp.asarray(f32(8, 6, 3)))
    first, second = tmp_path / "jax.npz", tmp_path / "port.npz"
    film.save_state(first, seed=11)
    port, seed = Film.load_state(first, device="cpu")
    assert seed == 11 and port.albedo is not None
    port = port.merge(torch.zeros((8, 6, 3)),
                      torch.zeros((8, 6), dtype=torch.int32))
    port = port.replace(samples=port.samples - 1)  # merge keeps the guides
    port.save_state(second, seed=seed)
    a, b = np.load(first), np.load(second)
    for k in ("sum", "depth_sum", "samples", "seed", "albedo", "normal"):
        assert np.array_equal(a[k], b[k]), k
    # A film without guides saves them empty and loads them as None.
    Film.create(6, 8, device="cpu").save_state(second)
    z = np.load(second)
    assert z["albedo"].size == 0 and z["normal"].size == 0
    assert Film.load_state(second, device="cpu")[0].normal is None
