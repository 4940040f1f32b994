"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; they skip on a machine without CUDA.  Run them on
a GPU machine with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
The kernels are built with --fmad=false and round like their plain
versions, so results must be bit-equal (B2: on dyadic values, whose
sums are exact in any order); B6 and B7 against their plain versions
walking the same octant order (B1 also
equal to its grouped walk's plain model, with its tables in shared and
in global memory).  B1 and B5 replay in a CUDA graph.  B5, B6 and B7
include rays on a NaN slab
plane and, for B7, a TLAS past the card's shared memory (global
regime), cornell's small tables (global) and lucy's tables (shared,
and global as if they did not fit); each also holds the escape order's
winners on 99.9% of rays.  B6 runs on lucy's flat parts
(one launch for all 16) and on a SAH statue with per-lane t bounds and
zero directions.  The B6 and B7 wrappers raise on a missing threading
table and on misaligned tables.
B3 copies rows at the eve fleet's compaction shapes, at every column
count it is compiled for (1 to 10), with and without the compaction
mask; B2 adds masked rows at 1 to 5 columns, bit-equal on unique rows
(compaction's placer) and on dyadic values, within f32 reassociation with
all 2^17 lanes on one row (its count column exact); both wrappers refuse
misaligned vector rows, and both kernels replay in a CUDA graph;
``compact_apply`` through B2 and B3 equals its plain version on the CPU.  B4 adds the
dying lanes' dyadic values like its plain version, bit for bit, on lane
counts that are not a multiple of the block, with every lane dying and
with none, with slots out of range; 1,000 lanes on one row within f32
reassociation (bounce counts exact); its wrapper refuses misaligned rows.
The probes P1-P3 give their plain versions' values (P3 up to the card's
opt-in limit and a refusal past it, its sizes asked in either order, and
in a CUDA graph); P1's pages arrive in order and its wrapper refuses a
misaligned table; each of P2's walks visits every entry, and its wrapper
refuses a misaligned chain.  The gradient path (``mrt_torch.inverse``) launches B1
in the forward and in the checkpoint's recompute, and its gradients
equal those with the plain version's winners.  Divisions by a host
number give the CPU's quotient on the card (ROADMAP C20): the wavefront's
camera coordinates, ``Film.mean``, the lights' pdf; with the CPU's sin
and cos substituted on the card (its own differ, ROADMAP C22) and M1's
plain version in M1's place a 256x144 RTIOW wavefront film is bit-equal
to the CPU's.  The lane sorter's S1
and S2 equal their plain versions bit for bit on 2^17 lanes and on
2^17 - 37 (idle lanes, zero, NaN and huge directions, NaN and infinite
origins; S2 with and without the pend accumulator), also replayed in a
CUDA graph with the sort between them; S2 refuses a misaligned
accumulator; a sorted sphere_grid pass at 256x144 runs the steps and
B-kernel launches of an unsorted one, with S1 and S2 once a sort.
Every synchronisation the card reports in a persistent pass (RTIOW and
sphere_grid) and in RTIOW's gradient steps is a read through the
tracer's ``to_host``.  The sampler's draw R1 equals its plain version
bit for bit on edge ray ids, int and 0-d seeds, int, 0-d and per-lane
salts and draw counters past 2^32, and a Sampler through it equals one
through its plain version around next1 and skip; it replays in a CUDA
graph with a new seed and salt; its wrapper is its plain version on CPU
tensors and refuses mixed devices, int32 ids and mis-shaped salts; RTIOW
and sphere_grid spp-1 passes through it equal those through its plain
version bit for bit, with two launches a step and one to fill the
pool.  L3 shading's M1 equals the eager composition on all
five outputs, bit for bit: on a synthetic wavefront that reaches every
class and edge (tests/torch_shade_cases.py), each case on its own lanes,
and on the 2^17 lanes of steps 2 and 64 of RTIOW, sphere_grid and
cornell NEE passes at 1080p; an spp-2 RTIOW pass through it deposits
what the eager pass deposits, step by step, with one M1 launch a step;
its wrapper is its plain version on CPU tensors and refuses mixed
devices, a wrong dtype and a strided input.  L2's hit record H1 equals
its plain version and Scene.intersect's eager chain on every column and
lane, bit for bit: on the calls of step 64 of RTIOW, sphere_grid and
cornell NEE passes at 1080p (cornell's shadow ray too), with the sets
tied or one ulp apart, and on rays that miss every set; it replays in a
CUDA graph on new inputs; spp-2 RTIOW and cornell NEE passes through it
deposit what the eager passes deposit, step by step, with one H1 launch
a step (two with NEE); its wrapper is its plain version on CPU tensors
and refuses mixed devices, a wrong dtype and a strided input.
"""

import pytest
import torch

from mrt_torch.ops import bvh, compact
from mrt_torch.ops import deposit as B2
from mrt_torch.ops import gather as B3
from mrt_torch.ops import spheres as B1
from mrt_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("s", [300, 4000])
def test_b1_kernel_matches_plain(cuda, s):
    # 4000 spheres: ~90 KB of group tables, past what a block copies into
    # shared memory: read from global memory.
    g = torch.Generator().manual_seed(1)
    n = 5000  # n is not a multiple of the block size
    center = torch.rand((s, 3), generator=g) * 10 - 5
    radius = torch.rand((s,), generator=g) * 30 / s ** (1 / 3) + 0.05
    center[7] = center[3]  # a tie: the lower index wins
    radius[7] = radius[3]
    center[s - 5] = center[3]  # a tie split across groups
    radius[s - 5] = radius[3]
    radius[11] = 0.0  # padding: never hit
    center[20], radius[20] = torch.tensor([0.0, -1000.0, 0.0]), 1000.0
    o = torch.rand((n, 3), generator=g) * 16 - 8
    d = torch.randn((n, 3), generator=g)
    d[:4] = 0.0  # zero directions miss
    t_min = torch.rand((n,), generator=g)
    t_max = torch.rand((n,), generator=g) * 8 + 2
    args = [x.to(cuda) for x in (center, radius, o, d, t_min, t_max)]
    groups = B1.group_table(args[0], args[1])
    assert groups[4] == 1  # the radius-1000 sphere is not grouped
    for bounds in (args[4:], (1e-3, float("inf"))):
        before = profiling.launch_counts["B1"]
        t_k, i_k = B1.nearest_t(*args[:4], *bounds, groups=groups)
        lanes = [torch.as_tensor(b, device=cuda).expand(n).contiguous()
                 for b in bounds]
        t_p, i_p = B1.nearest_t_plain(*args[:4], *lanes)
        t_g, i_g = B1.nearest_t_grouped_plain(groups, *args[2:4], *lanes)
        torch.cuda.synchronize()
        assert profiling.launch_counts["B1"] == before + 1
        assert torch.equal(i_k, i_p) and torch.equal(i_g, i_p)
        assert torch.equal(t_k, t_p) and torch.equal(t_g, t_p)
        assert torch.isfinite(t_k).any() and torch.isinf(t_k[:4]).all()
        assert not (i_k == 7).any() and not (i_k == 11).any()
        assert not (i_k == s - 5).any()


def test_b2_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(2)
    rows, p = 1000, 20000
    idx = torch.randint(-10, rows + 10, (p,), generator=g, dtype=torch.int32)
    vals = torch.randint(-64, 64, (p, 4), generator=g).float() / 8
    vals[5, 1] = float("nan")
    vals[6, 2] = float("inf")
    idx, vals = idx.to(cuda), vals.to(cuda)
    for drop in (False, True):
        k = B2.deposit(torch.zeros((rows, 4), device=cuda), idx, vals, drop)
        q = B2.deposit_plain(torch.zeros((rows, 4), device=cuda), idx, vals,
                             drop)
        torch.cuda.synchronize()
        assert torch.equal(torch.nan_to_num(k), torch.nan_to_num(q))
        assert torch.equal(torch.isfinite(k), torch.isfinite(q))
    assert torch.isfinite(k).all()  # drop_nonfinite=True


def test_b1_kernel_matches_plain_along_a_box_face(cuda):
    # Spheres far out (|c| ~ 1,000) in one group, rays passing just
    # outside the group box's face: the expanded form takes roots on some
    # of them, and the kernel's padded box test must keep their group.
    g = torch.Generator().manual_seed(6)
    k = torch.arange(20, dtype=torch.float32)
    center = torch.stack([1000.0 + 4.0 * k, 0 * k, 0 * k], 1)
    radius = torch.full((20,), 0.5)
    n = 4096
    target = torch.stack([center[torch.randint(0, 20, (n,), generator=g), 0],
                          torch.zeros(n),
                          0.5 + torch.rand((n,), generator=g) * 0.4], 1)
    sign = torch.randint(0, 2, (n, 2), generator=g) * 2.0 - 1.0
    tilt = (torch.rand((n, 2), generator=g) * 8e-4 + 2e-4) * sign
    d = torch.stack([tilt[:, 0], torch.ones(n), tilt[:, 1]], 1)
    o = target - 1000.0 * d
    center, radius, o, d = (x.to(cuda) for x in (center, radius, o, d))
    groups = B1.group_table(center, radius)
    t_k, i_k = B1.nearest_t(center, radius, o, d, 1e-3, float("inf"),
                            groups=groups)
    lanes = [torch.full((n,), v, device=cuda) for v in (1e-3, float("inf"))]
    t_p, i_p = B1.nearest_t_plain(center, radius, o, d, *lanes)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    assert 0 < torch.isfinite(t_k).sum() < n // 2


def test_b1_wrapper_raises_instead_of_falling_back(cuda):
    o = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError):
        B1.nearest_t(torch.zeros((2, 3)), torch.ones(2), o, o, 1e-3, 1.0)
    center, radius = torch.zeros((2, 3), device=cuda), torch.ones(2,
                                                                 device=cuda)
    with pytest.raises(ValueError, match="no kernel tables"):
        B1.nearest_t(center, radius, o, o, 1e-3, 1.0)
    groups = B1.group_table(center, radius)
    with pytest.raises(ValueError):  # tables of other spheres
        B1.nearest_t(torch.zeros((40, 3), device=cuda),
                     torch.ones(40, device=cuda), o, o, 1e-3, 1.0,
                     groups=groups)


def _sphere_case(g, s, n):
    from mrt_torch.geometry import bvh as geometry_bvh
    from mrt_torch.geometry import spheres

    center = torch.rand((s, 3), generator=g) * 20 - 10
    radius = torch.rand((s,), generator=g) * 0.8 + 0.1
    tree, sph = geometry_bvh.build_over_spheres(spheres.Spheres(
        center, radius, torch.zeros((s,), dtype=torch.int32)))
    o = torch.rand((n, 3), generator=g) * 30 - 15
    d = torch.randn((n, 3), generator=g)
    # NaN slab: on the root box's x = bmin plane, zero x direction.
    o[:64, 0] = tree.bmin[0, 0]
    d[:64, 0] = 0.0
    d[64:72] = 0.0  # zero directions
    return tree, sph.build_kernel_table(in_bvh=True).krows, o, d


def test_b5_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(3)
    tree, sph, o, d = _sphere_case(g, 3000, 5000)
    assert tree.n_nodes >= 32  # threaded in octant order
    tree = tree.to(cuda)
    n = o.shape[0]
    args = [x.to(cuda) for x in (tree.nodes, tree.meta, sph, o, d)]
    card = (tree.knodes, tree.order)
    lo = torch.full((n,), 1e-3, device=cuda)
    for hi in (torch.full((n,), float("inf")),
               torch.rand((n,), generator=g) * 30 + 1, float("inf")):
        hi = hi.to(cuda) if torch.is_tensor(hi) else hi
        lanes = torch.as_tensor(hi, device=cuda).expand(n).contiguous()
        before = profiling.launch_counts["B5"]
        t_k, i_k = bvh.sphere_bvh_hit(*args, 1e-3, hi, card=card)
        t_p, i_p = bvh.sphere_bvh_plain(*args, lo, lanes, order=tree.order)
        torch.cuda.synchronize()
        assert profiling.launch_counts["B5"] == before + 1
        assert torch.equal(i_k, i_p)
        assert torch.equal(t_k, t_p)
        assert torch.isfinite(t_k).any() and torch.isinf(t_k[:72]).all()
        _agrees_with_escape_order(t_k, i_k, bvh.sphere_bvh_plain(
            *args, lo, lanes))


def test_b1_and_b5_in_a_cuda_graph(cuda):
    from mrt_torch.scenes import get

    scene, camera = get("sphere_grid")(dim=12).generate(device=cuda)
    tree, sph = scene.sphere_bvh, scene.spheres
    # The scene walks its spheres with B5; B1 gets its own table.
    groups = B1.group_table(sph.center, sph.radius)
    o, d = _camera_rays(camera, 4096, seed=12)
    calls = {
        "B1": lambda: B1.nearest_t(sph.center, sph.radius, o, d, 1e-3,
                                   float("inf"), groups=groups),
        "B5": lambda: bvh.sphere_bvh_hit(
            tree.nodes, tree.meta, sph.krows, o, d, 1e-3, float("inf"),
            card=(tree.knodes, tree.order)),
    }
    for name, fn in calls.items():
        want = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn()
        for x in got:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        assert torch.isfinite(want[0]).float().mean() > 0.2, name


def _instances(n_inst, seed=0):
    """tests/test_stream.py's registry with n_inst instances."""
    import numpy as np

    from mrt_torch.geometry.instance import MeshRegistry
    from mrt_torch.geometry.shapes import cube, sphere_mesh

    rng = np.random.default_rng(seed)
    reg = MeshRegistry()
    m_cube = reg.add_mesh(cube(size=1.0))
    m_sphere = reg.add_mesh(sphere_mesh(radius=0.6, lat=5, lon=7))
    for i in range(n_inst):
        reg.add_instance(m_cube if i % 2 else m_sphere,
                         translation=rng.uniform(-6, 6, 3),
                         rotation=rng.uniform(0, 1, 3),
                         scale=rng.uniform(0.4, 1.8),
                         material=int(rng.integers(0, 5)))
    return reg.build()


@pytest.mark.parametrize("n_inst", [40, 8000])
def test_b7_kernel_matches_plain(cuda, n_inst):
    # 8000 instances: ~2 MB of kernel tables, past the card's shared
    # memory a block and the 448 KB that the TPU kernel kept resident
    # (B8's regime): B7 reads them from global memory.
    tl = _instances(n_inst).to(cuda)
    assert bvh.tlas_regime(tl) == ("global" if n_inst == 8000 else "shared")
    assert bvh.tlas_table_bytes(tl) >= bvh.SHARED_MIN_BYTES
    g = torch.Generator().manual_seed(4)
    n = 4000
    o = torch.rand((n, 3), generator=g) * 20 - 10
    d = torch.randn((n, 3), generator=g)
    o[:64, 1] = tl.t_bmin[0, 1].cpu()  # NaN slab at the root
    d[:64, 1] = 0.0
    t_min = torch.rand((n,), generator=g) * 0.5
    o, d, t_min = o.to(cuda), d.to(cuda), t_min.to(cuda)
    t_max = torch.full((n,), float("inf"), device=cuda)
    before = profiling.launch_counts["B7"]
    k = bvh.tlas_hit(tl, o, d, t_min, t_max)
    p = bvh.tlas_plain(tl, o, d, t_min, t_max, ordered=True)
    torch.cuda.synchronize()
    assert profiling.launch_counts["B7"] == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.isfinite(k[0]).any() and (k[1][:64] == -1).all()
    _agrees_with_escape_order(k[0], _pair(k), bvh.tlas_plain(
        tl, o, d, t_min, t_max))


@pytest.mark.parametrize("regime", ["shared", "global"])
def test_b7_kernel_matches_plain_on_lucy(cuda, regime, monkeypatch):
    from mrt_torch.scenes import get

    scene, camera = get("lucy")().generate(device=cuda)
    tl = scene.tlas
    assert bvh.tlas_regime(tl) == "shared"  # 68,752 B of tables
    if regime == "global":  # as if the card's shared memory were too small
        monkeypatch.setattr(bvh, "smem_optin", lambda device: 0)
    assert bvh.tlas_regime(tl) == regime
    o, d = _camera_rays(camera, 4096, seed=9)
    lo = torch.full((o.shape[0],), 1e-3, device=cuda)
    hi = torch.full((o.shape[0],), float("inf"), device=cuda)
    k = bvh.tlas_hit(tl, o, d, lo, hi)
    p = bvh.tlas_plain(tl, o, d, lo, hi, ordered=True)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert (k[1] >= 0).float().mean() > 0.9
    _agrees_with_escape_order(k[0], _pair(k), bvh.tlas_plain(tl, o, d, lo,
                                                             hi))


def test_b7_small_tables_read_global_memory(cuda):
    from mrt_torch.scenes import get

    scene, camera = get("cornell")().generate(device=cuda)
    tl = scene.tlas
    assert bvh.tlas_table_bytes(tl) < bvh.SHARED_MIN_BYTES
    assert bvh.tlas_regime(tl) == "global"
    o, d = _camera_rays(camera, 4096, seed=10)
    lo = torch.full((o.shape[0],), 1e-3, device=cuda)
    hi = torch.full((o.shape[0],), float("inf"), device=cuda)
    k = bvh.tlas_hit(tl, o, d, lo, hi)
    p = bvh.tlas_plain(tl, o, d, lo, hi, ordered=True)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert (k[1] >= 0).float().mean() > 0.5


def test_bvh_wrappers_raise_instead_of_falling_back(cuda):
    tree, sph, o, d = _sphere_case(torch.Generator().manual_seed(5), 100, 8)
    with pytest.raises(ValueError):
        bvh.sphere_bvh_hit(tree.nodes, tree.meta, sph, o.to(cuda),
                          d.to(cuda), 1e-3, 1.0)
    tree = tree.to(cuda)
    args = (tree.nodes, tree.meta, sph.to(cuda), o.to(cuda), d.to(cuda))
    with pytest.raises(ValueError, match="no kernel tables"):
        bvh.sphere_bvh_hit(*args, 1e-3, 1.0)
    with pytest.raises(ValueError, match="aligned"):
        bvh.sphere_bvh_hit(*args, 1e-3, 1.0,
                           card=(_misaligned(tree.knodes), tree.order))


def _statue_case(g, n):
    """lucy's stand-in statue under a SAH BVH (a FlatBVH), its triangles
    (a TriangleTable) and rays around it."""
    from mrt_torch.geometry import bvh as geometry_bvh
    from mrt_torch.geometry import triangles
    from mrt_torch.scenes import lucy

    tree, tris = geometry_bvh.build_over_triangles(
        lucy._standin_statue()[0], split="sah")
    o = torch.rand((n, 3), generator=g) * 3.2 - 1.6
    d = torch.rand((n, 3), generator=g) * 0.8 - 0.4 - o
    o[:64, 2] = tree.bmax[0, 2]  # NaN slab at the root
    d[:64, 2] = 0.0
    d[64:72] = 0.0  # zero directions
    return tree, triangles.TriangleTable(tris), o, d


def _camera_rays(camera, n, seed):
    g = torch.Generator().manual_seed(seed)
    dev = camera.origin.device
    s, t = torch.rand((2, n), generator=g).to(dev)
    z = torch.zeros(n, device=dev)
    o, d = camera.rays(s, t, z, z)
    return o.contiguous(), d.contiguous()


def test_b6_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(6)
    tree, table, o, d = _statue_case(g, 5000)
    tree, table = tree.to(cuda), table.to(cuda)
    n = o.shape[0]
    args = (tree.nodes, tree.meta, table.rows, o.to(cuda), d.to(cuda))
    card = (tree.knodes, tree.order, table.krows)
    lo = (torch.rand((n,), generator=g) * 0.3).to(cuda)
    for hi in (torch.full((n,), float("inf")),
               torch.rand((n,), generator=g) * 3 + 0.5):
        hi = hi.to(cuda)
        before = profiling.launch_counts["B6"]
        k = bvh.tri_bvh_hit(*args, lo, hi, card=card)
        p = bvh.tri_bvh_plain(*args, lo, hi, order=tree.order)
        torch.cuda.synchronize()
        assert profiling.launch_counts["B6"] == before + 1
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        assert torch.isfinite(k[0]).any() and torch.isinf(k[0][:72]).all()
        _agrees_with_escape_order(k[0], k[1], bvh.tri_bvh_plain(*args, lo,
                                                                hi))


def test_b6_kernel_matches_plain_on_lucy_parts(cuda, monkeypatch):
    from mrt_torch.scenes import get

    monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
    scene, camera = get("lucy")().generate(device=cuda)
    o, d = _camera_rays(camera, 4096, seed=7)
    n = o.shape[0]
    lo = torch.full((n,), 1e-3, device=cuda)
    hi = torch.full((n,), float("inf"), device=cuda)
    parts = scene.tlas.flat_parts
    assert len(parts) == 16
    for part in parts:
        args = (part.bvh.nodes, part.bvh.meta, part.rows, o, d, lo, hi)
        card = (part.bvh.knodes, part.bvh.order, bvh.card_tris(part.rows))
        got = bvh.tri_bvh_hit(*args, card=card)
        for a, b in zip(got, bvh.tri_bvh_plain(*args, order=part.bvh.order)):
            assert torch.equal(a, b)
    # All 16 parts in one launch: the forest's octant walk, and the
    # reference's fold of one walk a part.
    before = profiling.launch_counts["B6"]
    k = bvh.tri_bvh_parts_hit(parts, o, d, lo, hi)
    assert profiling.launch_counts["B6"] == before + 1
    f = parts.forest
    rows = torch.cat([part.rows for part in parts])
    walk = bvh.tri_bvh_plain(f.nodes, f.meta, rows, o, d, lo, hi,
                             order=f.order)
    fold = bvh.tri_bvh_parts_plain(parts, o, d, lo, hi)
    for a, b, c in zip(k, walk, fold):
        assert torch.equal(a, b) and torch.equal(a, c)
    # The scene's dispatch takes the flat parts: one launch for all.
    before = profiling.launch_counts["B6"]
    hits = scene.intersect(o, d)
    assert profiling.launch_counts["B6"] == before + 1
    assert hits.hit.float().mean() > 0.9


def _pair(hits):
    """One id a ray for B7's (instance, triangle)."""
    return hits[1].to(torch.int64) * (1 << 31) + hits[2]


def _agrees_with_escape_order(t_k, i_k, escape):
    """The kernel's winners against the plain walk in the escape order
    (the reference's): at least 99.9% equal (an order may cull a box
    whose triangle lies just below its computed entry, ROADMAP C15), t
    within rtol 1e-5 where they are."""
    t_e, i_e = escape[0], (_pair(escape) if len(escape) == 5 else escape[1])
    same = i_k == i_e
    assert same.float().mean() >= 0.999
    fin = same & torch.isfinite(t_e)
    torch.testing.assert_close(t_k[fin], t_e[fin], rtol=1e-5, atol=0)


def _misaligned(x):
    """x's values in a buffer that starts 4 bytes past an aligned one."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def test_b6_wrapper_raises_instead_of_falling_back(cuda):
    tree, table, o, d = _statue_case(torch.Generator().manual_seed(8), 8)
    with pytest.raises(ValueError):
        bvh.tri_bvh_hit(tree.nodes, tree.meta, table.rows, o.to(cuda),
                        d.to(cuda), 1e-3, 1.0)
    tree, table = tree.to(cuda), table.to(cuda)
    args = (tree.nodes, tree.meta, table.rows, o.to(cuda), d.to(cuda), 1e-3,
            1.0)
    with pytest.raises(ValueError, match="threading"):
        bvh.tri_bvh_hit(*args)  # no kernel tables
    with pytest.raises(ValueError, match="aligned"):
        bvh.tri_bvh_hit(*args, card=(tree.knodes, tree.order,
                                     _misaligned(table.krows)))
    with pytest.raises(ValueError, match="order"):
        bvh.tri_bvh_hit(*args, card=(tree.knodes, tree.order[:, :-1],
                                     table.krows))


def test_b7_wrapper_raises_instead_of_falling_back(cuda):
    import types

    tl = _instances(40).to(cuda)
    o = torch.zeros((8, 3), device=cuda)
    d = torch.ones((8, 3), device=cuda)
    names = ("tnodes", "tmeta", "inst", "imeta", "bnodes", "bmeta", "tris",
             "k_tnodes", "t_order", "k_bnodes", "b_order", "k_tris")
    view = lambda **kw: types.SimpleNamespace(
        **{**{k: getattr(tl, k) for k in names}, **kw})
    with pytest.raises(ValueError, match="threading"):
        bvh.tlas_hit(view(b_order=None), o, d, 1e-3, 1.0)
    with pytest.raises(ValueError, match="aligned"):
        bvh.tlas_hit(view(k_tris=_misaligned(tl.k_tris)), o, d, 1e-3, 1.0)
    with pytest.raises(ValueError, match="t_order"):
        bvh.tlas_hit(view(t_order=tl.t_order[:4]), o, d, 1e-3, 1.0)


@pytest.mark.parametrize("cols", range(1, 11))
def test_b3_kernel_matches_plain(cuda, cols):
    # The eve fleet at 1080p: 2^17 lanes, K = 32,768 compacted rows; one
    # lane past the last full warp.
    g = torch.Generator().manual_seed(3)
    p, k = (1 << 17) + 1, 32768
    table = (torch.randn((k, cols), generator=g)
             * 10.0 ** torch.randint(-20, 20, (k, cols), generator=g))
    table[5] = -0.0
    idx = torch.randint(-5, k + 5, (p,), generator=g, dtype=torch.int32)
    idx[:9] = torch.tensor([-1, k, k + 1, 0, k - 1, -(2 ** 31),
                            -(2 ** 31) + 1, 2 ** 31 - 1, 5],
                           dtype=torch.int32)
    mask = torch.rand((p,), generator=g) < 0.7
    table, idx, mask = table.to(cuda), idx.to(cuda), mask.to(cuda)
    for m in (None, mask):
        before = profiling.launch_counts["B3"]
        got = B3.gather(table, idx, mask=m)
        want = B3.gather_plain(table, idx, mask=m)
        torch.cuda.synchronize()
        assert profiling.launch_counts["B3"] == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (got[:3] == 0).all() and (got[5:8] == 0).all()
    assert torch.equal(got.cpu(), B3.gather_plain(table.cpu(), idx.cpu(),
                                                  mask=mask.cpu()))


def test_b3_wrapper_raises_instead_of_falling_back(cuda):
    table = torch.zeros((8, 3), device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        B3.gather(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        B3.gather(table.t(), idx)
    with pytest.raises(ValueError, match="columns"):
        B3.gather(torch.zeros((8, 11), device=cuda), idx)
    with pytest.raises(TypeError, match="mask"):
        B3.gather(table, idx, mask=torch.ones(4, dtype=torch.uint8,
                                              device=cuda))
    with pytest.raises(ValueError, match="mask"):
        B3.gather(table, idx, mask=torch.ones(4, dtype=torch.bool))
    for cols in (2, 4):
        with pytest.raises(ValueError, match="aligned"):
            B3.gather(_misaligned(torch.zeros((8, cols), device=cuda)), idx)


def _b2_case(cuda, cols, unique, seed):
    """2^17 lanes of dyadic values (exact sums in any order), ~70%
    masked; unique rows (compaction: the first 32,768 masked lanes at
    their prefix positions) or random rows with repeats."""
    g = torch.Generator().manual_seed(seed)
    p = 1 << 17
    mask = torch.rand((p,), generator=g) < 0.7
    if unique:
        rows = 32768
        idx = (torch.cumsum(mask.to(torch.int32), 0) - 1).to(torch.int32)
    else:
        rows = 5000
        idx = torch.randint(-10, rows + 10, (p,), generator=g,
                            dtype=torch.int32)
    vals = torch.randint(-64, 64, (p, cols), generator=g).float() / 8
    vals[~mask] = float("nan")  # never read
    return rows, idx.to(cuda), vals.to(cuda), mask.to(cuda)


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("unique", [True, False])
def test_b2_kernel_with_mask_matches_plain(cuda, cols, unique):
    rows, idx, vals, mask = _b2_case(cuda, cols, unique, 20 + cols)
    for drop in (False, True):
        before = profiling.launch_counts["B2"]
        k = B2.deposit(torch.zeros((rows, cols), device=cuda), idx, vals,
                       drop, mask=mask)
        q = B2.deposit_plain(torch.zeros((rows, cols), device=cuda), idx,
                             vals, drop, mask=mask)
        torch.cuda.synchronize()
        assert profiling.launch_counts["B2"] == before + 1
        assert torch.equal(k.view(torch.int32), q.view(torch.int32))
        assert torch.isfinite(k).all() and k.abs().sum() > 0


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 5])
def test_b2_kernel_all_lanes_onto_one_row(cuda, cols):
    # Every lane adds into row 3: the worst contention.  Sums of 2^17
    # values in [0, 1) within f32 reassociation (rtol 1e-4); the last
    # column counts bounces (integers < 2^24): exact.
    g = torch.Generator().manual_seed(30 + cols)
    p = 1 << 17
    idx = torch.full((p,), 3, dtype=torch.int32, device=cuda)
    vals = torch.rand((p, cols), generator=g).to(cuda)
    vals[:, -1] = (vals[:, -1] < 0.6).float()
    vals[7, 0] = float("nan")  # dropped with drop_nonfinite
    film = torch.full((8, cols), -0.0, device=cuda)
    k = B2.deposit(film.clone(), idx, vals, drop_nonfinite=True)
    q = B2.deposit_plain(film.clone(), idx, vals, drop_nonfinite=True)
    torch.cuda.synchronize()
    assert torch.equal(k[:, -1], q[:, -1])
    assert torch.allclose(k, q, rtol=1e-4, atol=0)
    # Rows no lane touched keep their -0.0.
    assert torch.equal(k[4:].view(torch.int32), film[4:].view(torch.int32))
    assert torch.equal(k[4:].view(torch.int32), q[4:].view(torch.int32))


def test_b2_wrapper_raises_instead_of_falling_back(cuda):
    idx = torch.zeros(16, dtype=torch.int32, device=cuda)
    for cols in (2, 4):
        film = torch.zeros((8, cols), device=cuda)
        vals = torch.zeros((16, cols), device=cuda)
        with pytest.raises(ValueError, match="film is not"):
            B2.deposit(_misaligned(film), idx, vals)
        with pytest.raises(ValueError, match="vals is not"):
            B2.deposit(film, idx, _misaligned(vals))
    with pytest.raises(ValueError, match="columns"):
        B2.deposit(torch.zeros((8, 11), device=cuda), idx,
                   torch.zeros((16, 11), device=cuda))
    with pytest.raises(TypeError, match="mask"):
        B2.deposit(film, idx, vals, mask=idx)


def test_b2_and_b3_in_a_cuda_graph(cuda):
    # As compaction calls them: B2 places the masked rows, B3 expands.
    rows, idx, vals, mask = _b2_case(cuda, 3, True, 40)
    vals = torch.nan_to_num(vals)
    film = torch.zeros((rows, 3), device=cuda)
    calls = {
        "B2": lambda: (B2.deposit(film.zero_(), idx, vals, mask=mask),),
        "B3": lambda: (B3.gather(vals[:rows].contiguous(), idx, mask=mask),),
    }
    for name, fn in calls.items():
        want = [x.clone() for x in fn()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn()
        for x in got:
            x.fill_(7.0)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name


def test_compact_apply_through_kernels(cuda):
    g = torch.Generator().manual_seed(4)
    p, k = 20000, 2048  # 10 rounds
    x = torch.randn((p, 3), generator=g)
    mask = torch.rand((p,), generator=g) < 0.3
    fn = lambda v: v[:, 0:2] * v[:, 1:3] + 3.0
    b2, b3 = profiling.launch_counts["B2"], profiling.launch_counts["B3"]
    got = compact.compact_apply(fn, mask.to(cuda), x.to(cuda), k,
                                pad_row=(1.0, 0.0, 0.0))
    torch.cuda.synchronize()
    assert profiling.launch_counts["B2"] == b2 + 10
    assert profiling.launch_counts["B3"] == b3 + 10
    want = compact.compact_apply(fn, mask, x, k, pad_row=(1.0, 0.0, 0.0))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, torch.where(mask[:, None], fn(x), 0.0))


def test_b4_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(4)
    rows, p = 1000, 20001  # p is not a multiple of the block size
    slot = torch.randint(-10, rows + 10, (p,), generator=g,
                         dtype=torch.int32)
    slot[:500] = 17  # many dying lanes on one row
    val = torch.randint(-64, 64, (p, 4), generator=g).float() / 8
    val[::7] = 0.0  # all-zero lanes add nothing
    die = torch.rand((p,), generator=g) < 0.35
    slot, val, die = slot.to(cuda), val.to(cuda), die.to(cuda)
    before = profiling.launch_counts["B4"]
    k = B2.deposit_pending(torch.ones((rows, 4), device=cuda), slot, val, die)
    q = B2.deposit_pending_plain(torch.ones((rows, 4), device=cuda), slot,
                                 val, die)
    torch.cuda.synchronize()
    assert profiling.launch_counts["B4"] == before + 1
    assert torch.equal(k, q) and not torch.equal(k, torch.ones_like(k))
    with pytest.raises(TypeError):
        B2.deposit_pending(torch.ones((rows, 4), device=cuda), slot, val,
                           die.to(torch.uint8))
    with pytest.raises(ValueError):
        B2.deposit_pending(torch.ones((rows, 4), device=cuda), slot.cpu(),
                           val, die)


def _b4_case(cuda, p, rows, rate, seed):
    """p lanes of dyadic values (exact sums in any order) into `rows`
    film rows, a fraction `rate` dying, slots out of range on some lanes,
    a tenth of the lanes all zero, small-integer bounce counts."""
    g = torch.Generator().manual_seed(seed)
    slot = torch.randint(-10, rows + 10, (p,), generator=g,
                         dtype=torch.int32)
    val = torch.randint(-64, 64, (p, 4), generator=g).float() / 8
    val[:, 3] = torch.randint(0, 8, (p,), generator=g).float()
    val[torch.rand((p,), generator=g) < 0.1] = 0.0
    die = torch.rand((p,), generator=g) < rate
    return slot.to(cuda), val.to(cuda), die.to(cuda)


@pytest.mark.parametrize("p,rate", [(20001, 0.35), (1 << 17, 1.0),
                                    (1 << 17, 0.0), (257, 0.5)],
                         ids=["odd-lanes", "all-dying", "none-dying",
                              "one-block-and-one"])
def test_b4_kernel_cases_match_plain(cuda, p, rate):
    rows = 5000
    slot, val, die = _b4_case(cuda, p, rows, rate, 50 + p % 97)
    film = torch.full((rows, 4), 0.5, device=cuda)
    before = profiling.launch_counts["B4"]
    k = B2.deposit_pending(film.clone(), slot, val, die)
    q = B2.deposit_pending_plain(film.clone(), slot, val, die)
    torch.cuda.synchronize()
    assert profiling.launch_counts["B4"] == before + 1
    assert torch.equal(k.view(torch.int32), q.view(torch.int32))
    assert torch.equal(k, film) == (rate == 0.0)


def test_b4_kernel_drops_out_of_range_slots(cuda):
    rows, p = 64, 4096
    slot, val, die = _b4_case(cuda, p, rows, 1.0, 61)
    slot = torch.where(torch.arange(p, device=cuda) % 2 == 0,
                       torch.tensor([-1, rows, 2**31 - 1, -2**31],
                                    dtype=torch.int32,
                                    device=cuda).repeat(p // 4), slot)
    k = B2.deposit_pending(torch.zeros((rows, 4), device=cuda), slot, val,
                           die)
    q = B2.deposit_pending_plain(torch.zeros((rows, 4), device=cuda), slot,
                                 val, die)
    torch.cuda.synchronize()
    assert torch.equal(k, q) and k.abs().sum() > 0


def test_b4_kernel_all_lanes_onto_one_row(cuda):
    # 1,000 dying lanes into row 5: sums of values in [0, 1) within f32
    # reassociation (rtol 1e-5); the bounce counts (integers) exact.
    g = torch.Generator().manual_seed(62)
    p = 1000
    slot = torch.full((p,), 5, dtype=torch.int32, device=cuda)
    val = torch.rand((p, 4), generator=g).to(cuda)
    val[:, 3] = torch.randint(1, 8, (p,), generator=g).float().to(cuda)
    die = torch.ones((p,), dtype=torch.bool, device=cuda)
    k = B2.deposit_pending(torch.zeros((8, 4), device=cuda), slot, val, die)
    q = B2.deposit_pending_plain(torch.zeros((8, 4), device=cuda), slot, val,
                                 die)
    torch.cuda.synchronize()
    assert torch.equal(k[:, 3], q[:, 3])
    assert torch.allclose(k, q, rtol=1e-5, atol=0)
    assert torch.equal(k[6:], torch.zeros_like(k[6:]))


def test_b4_wrapper_raises_on_misaligned_rows(cuda):
    slot, val, die = _b4_case(cuda, 64, 8, 0.5, 63)
    dest = torch.zeros((8, 4), device=cuda)
    before = profiling.launch_counts["B4"]
    with pytest.raises(ValueError, match="val is not 16-byte aligned"):
        B2.deposit_pending(dest, slot, _misaligned(val), die)
    with pytest.raises(ValueError, match="dest is not 16-byte aligned"):
        B2.deposit_pending(_misaligned(dest), slot, val, die)
    assert profiling.launch_counts["B4"] == before


@pytest.mark.parametrize("variant", ["paged", "l2", "shared"])
def test_p2_each_variant_visits_every_entry(cuda, variant):
    from mrt_torch.tools import probe_stream as P

    before = profiling.launch_counts["P2"]
    for seed in range(3):
        chain = torch.from_numpy(P.chain(seed=seed)).to(cuda)
        visited, cycles, fills = P.probe_b(chain, variant)
        torch.cuda.synchronize()
        assert visited.item() == P.CHAIN == P.probe_b_plain(chain).item()
        assert cycles.item() > 0
        # The kernel's own count of its cache's fills (tags, victim).
        want = P.paged_misses(chain) if variant == "paged" else 0
        assert fills.item() == want
    assert profiling.launch_counts["P2"] == before + 3


def test_p2_wrapper_raises_on_a_misaligned_chain(cuda):
    from mrt_torch.tools import probe_stream as P

    chain = torch.from_numpy(P.chain()).to(cuda)
    before = profiling.launch_counts["P2"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        P.probe_b(_misaligned(chain))
    with pytest.raises(ValueError, match="whole pages"):
        P.probe_b(chain[:1000])
    assert profiling.launch_counts["P2"] == before


def test_p1_pages_in_flight_match_closed_form(cuda):
    from mrt_torch.tools import probe_stream as P

    f, i = P.tables(cuda)
    before = profiling.launch_counts["P1"]
    for _ in range(5):
        got, cycles = P.probe_a(f, i)
        torch.cuda.synchronize()
        assert got.item() == P.closed_form() == 7208.0
        # Each page's arrival from one start, all four in flight.
        arrivals = cycles.tolist()
        assert arrivals[0] > 0 and arrivals == sorted(arrivals)
    assert profiling.launch_counts["P1"] == before + 5


def test_p1_wrapper_raises_on_a_misaligned_table(cuda):
    from mrt_torch.tools import probe_stream as P

    f, i = P.tables(cuda)
    before = profiling.launch_counts["P1"]
    with pytest.raises(ValueError, match="f is not contiguous and 16-byte"):
        P.probe_a(_misaligned(f), i)
    with pytest.raises(ValueError, match="i is not contiguous and 16-byte"):
        P.probe_a(f, _misaligned(i))
    with pytest.raises(ValueError, match="f is not contiguous"):
        P.probe_a(f.t().contiguous().t(), i)
    assert profiling.launch_counts["P1"] == before


@pytest.mark.parametrize("order", [(228, 227, 48), (48, 227, 228)])
def test_p3_sizes_in_either_order(cuda, order):
    # The attribute is raised once a process, to the opt-in limit,
    # whichever size the first call asks for.
    from mrt_torch.tools import probe_stream as P

    x = torch.full((1,), 1.5, device=cuda)
    before = profiling.launch_counts["P3"]
    for kb in order:
        out, codes = P.probe_c(x, kb)
        if kb == 228:
            assert out is None and codes[1] != 0
        else:
            assert codes is None and out.item() == 4.5
    assert profiling.launch_counts["P3"] == before + 2


def test_p3_in_a_cuda_graph(cuda):
    # A call is one launch: five captured at 227 KB replay to 3x each.
    from mrt_torch.tools import probe_stream as P

    x = torch.ones((1,), device=cuda)
    assert P.probe_c(x, 227)[1] is None  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [P.probe_c(x, 227)[0] for _ in range(5)]
    for out in outs:
        out.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert [out.item() for out in outs] == [3.0] * 5


def test_probes_match_plain(cuda):
    from mrt_torch.tools import probe_stream as P

    res = P.run(cuda)  # raises where a probe disagrees with its plain one
    assert res["p1"]["value"] == res["p1"]["closed_form"] == P.closed_form()
    assert set(res["p2"]) == set(P.VARIANTS)
    assert res["p2"]["paged"]["fills"] == P.paged_misses(
        torch.from_numpy(P.chain()))
    assert res["p3"][227] == "3.0" and res["p3"][228].startswith("refused")


def test_gradient_pass_b1_winners_match_plain(cuda, monkeypatch):
    # The gradient path on the card: B1 searches the winners in the
    # forward and again in the checkpoint's recompute; with
    # nearest_t_plain's winners on the same CUDA tensors the loss is the
    # same and the gradients within atomics' reassociation.
    from mrt_torch import inverse
    from mrt_torch.scenes import get

    scene, camera = get("rtiow")(aspect_ratio=1.0, grid=3).generate(
        device=cuda)

    def grads():
        a = scene.materials.albedo.clone().requires_grad_(True)
        c = scene.spheres.center.clone().requires_grad_(True)
        moved = scene.replace(
            materials=scene.materials.replace(albedo=a),
            spheres=scene.spheres.replace(center=c))
        img = inverse.render_image(moved, camera, 48, 48, spp=1, seed=2,
                                   max_depth=4)
        loss = torch.mean(img ** 2)
        loss.backward()
        return loss.item(), a.grad, c.grad

    before = profiling.launch_counts["B1"]
    lk, *gk = grads()
    # 4 bounces, forward and recompute.
    assert profiling.launch_counts["B1"] == before + 8
    plain = lambda center, radius, o, d, lo, hi, groups=None: (
        B1.nearest_t_plain(center.detach(), radius, o.detach(), d.detach(),
                           torch.as_tensor(lo, device=cuda).expand(
                               o.shape[0]).contiguous(),
                           torch.as_tensor(hi, device=cuda).expand(
                               o.shape[0]).contiguous()))
    monkeypatch.setattr(B1, "nearest_t", plain)
    lp, *gp = grads()
    assert lk == lp
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all() and (a != 0).any()
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())


def cpu_trig(monkeypatch):
    """The CPU's float32 sin and cos on every device: CUDA's differ from
    them by an ulp on some inputs (ROADMAP C22).  L3 shading takes M1's
    plain version in M1's place: the kernel's sinf and cosf are the
    card's, and M1 equals the plain version on the card bit for bit
    (the M1 tests below)."""
    from mrt_torch.materials import shade
    from mrt_torch.ops import shade as M1

    for name in ("sin", "cos"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name,
                            lambda x, fn=fn: fn(x.cpu()).to(x.device))
    monkeypatch.setattr(shade, "shade_lanes", M1.shade_lanes_plain)


def test_c20_wavefront_film_equals_the_cpu(cuda, monkeypatch):
    from mrt_torch.core.camera import Camera
    from mrt_torch.integrator import wavefront
    from mrt_torch.scenes import get

    cpu_trig(monkeypatch)
    seen = []
    rays = Camera.rays

    def spy(self, s, t, du, dv):
        seen.append((s.cpu(), t.cpu()))
        return rays(self, s, t, du, dv)

    monkeypatch.setattr(Camera, "rays", spy)
    films = []
    for dev in ("cpu", "cuda"):
        scene, camera = get("rtiow")().generate(device=dev)
        films.append([x.cpu() for x in wavefront.render_sample(
            scene, camera, 256, 144, 1, 3, max_depth=8)])
    (s0, t0), (s1, t1) = seen
    assert torch.equal(s0, s1) and torch.equal(t0, t1)
    assert torch.equal(films[0][1], films[1][1])
    assert torch.equal(films[0][0], films[1][0])
    assert films[0][1].sum() > 0


def test_c20_film_mean_and_light_pdf_equal_the_cpu(cuda, monkeypatch):
    import types

    import numpy as np

    from mrt_torch.geometry.hit import Hits
    from mrt_torch.materials import lights
    from mrt_torch.math.rng import Sampler
    from mrt_torch.runtime.film import Film

    rs = np.random.default_rng(20)
    total = torch.from_numpy(rs.random((144, 256, 3)).astype(np.float32))
    means = [Film(sum=total.to(dev), depth_sum=None, samples=7).mean().cpu()
             for dev in ("cpu", "cuda")]
    assert torch.equal(means[0], means[1])

    # mis_bsdf_weight's light pdf, from the same hits on both devices.
    n = 1 << 16
    cols = {k: rs.standard_normal((n, 3)).astype(np.float32)
            for k in ("o", "d", "point", "normal")}
    area = (rs.random(n) * 4 - 2).astype(np.float32)
    t = rs.random(n).astype(np.float32) * 5
    pdf = rs.random(n).astype(np.float32)
    scene = types.SimpleNamespace(lights=types.SimpleNamespace(count=3))
    out = []
    for dev in ("cpu", "cuda"):
        on = lambda x: torch.from_numpy(x).to(dev)
        hits = Hits.none(n, device=dev)
        hits = hits.__class__(**dict(
            vars(hits), t=on(t), point=on(cols["point"]),
            normal=on(cols["normal"]), prim_area=on(area),
            hit=on(area != 0), front_face=torch.ones(n, dtype=torch.bool,
                                                     device=dev)))
        out.append(lights.mis_bsdf_weight(scene, hits, on(cols["o"]),
                                          on(cols["d"]), on(pdf)).cpu())
    assert torch.equal(out[0], out[1])

    # sample_direct's light pdf on cornell's first hits (found on the
    # CPU), with the CPU's sin and cos on the card.
    import torch_golden_scenes as TG

    cpu_trig(monkeypatch)
    pdfs = []
    div = lights.div

    def spy(x, s):
        q = div(x, s)
        pdfs.append(q.cpu())
        return q

    monkeypatch.setattr(lights, "div", spy)
    scene, camera = TG.cornell_nee("cpu")
    s, t = (torch.from_numpy(rs.random(4096).astype(np.float32))
            for _ in range(2))
    zeros = torch.zeros(4096)
    o, d = camera.rays(s, t, zeros, zeros)
    hits = scene.intersect(o, d, t_min=1e-3)
    lobe = torch.where(hits.hit, 1, 0)
    for dev in ("cpu", "cuda"):
        moved = hits.__class__(**{k: v if v is None else v.to(dev)
                                  for k, v in vars(hits).items()})
        lights.sample_direct(TG.cornell_nee(dev)[0], moved,
                             Sampler(5, torch.arange(4096, device=dev),
                                     salt=7), lobe.to(dev))
    assert len(pdfs) == 2 and bool(torch.isfinite(pdfs[0]).all())
    assert torch.equal(pdfs[0], pdfs[1])


def _sort_lanes(cuda, n, seed):
    """A seeded lane state of n lanes (some idle; zero, NaN and huge
    directions, NaN and infinite origins) and its work items."""
    g = torch.Generator().manual_seed(seed)
    total = 100_000
    item = torch.randint(0, total, (n,), generator=g)
    item[torch.rand(n, generator=g) < 0.2] = total
    o = torch.rand((n, 3), generator=g) * 36 - 18
    d = torch.randn((n, 3), generator=g) * (torch.rand((n, 1), generator=g)
                                            * 3 + 0.1)
    d[:8] = 0.0
    d[8:12, 0] = float("nan")
    o[12:14, 1] = float("nan")
    o[14:16, 2] = float("inf")
    d[16:20] = torch.tensor([3e19, 1.0, 1.0])
    st = dict(item=item, bounce=torch.randint(0, 8, (n,), generator=g), o=o,
              d=d, throughput=torch.rand((n, 3), generator=g),
              ray_id=torch.randint(0, 2 ** 32, (n,), generator=g),
              prev_pdf=torch.rand((n,), generator=g),
              acc=torch.rand((n, 4), generator=g))
    st = {k: v.to(cuda) for k, v in st.items()}
    st["next_work"] = torch.tensor(total, device=cuda)
    return st, total


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("n", [1 << 17, (1 << 17) - 37])
def test_sort_kernels_match_plain(cuda, n):
    from mrt_torch.ops import sort as S

    st, total = _sort_lanes(cuda, n, n)
    item, o, d = st["item"], st["o"], st["d"]
    boxes = (S.origin_box(torch.full((3,), -15.0, device=cuda),
                          torch.full((3,), 15.0, device=cuda)),
             S.live_box(item[16:], o[16:], total))
    launches = profiling.launch_counts["S1"], profiling.launch_counts["S2"]
    for box in boxes:
        keys = S.sort_keys(item, o, d, total, box)
        assert torch.equal(keys, S.sort_keys_plain(item, o, d, total, box))
        assert (keys[item >= total] == S.IDLE_KEY).all()
        assert (keys[item < total] < 2 ** 30).all()
    perm = torch.sort(keys, stable=True).indices
    for lanes in (dict(st), {k: v for k, v in st.items() if k != "acc"}):
        got = S.permute_lanes(perm, lanes)
        want = S.permute_lanes_plain(perm, lanes)
        assert got.keys() == want.keys() == lanes.keys()
        assert all(torch.equal(_bits(got[k]), _bits(want[k])) for k in want)
        assert got["next_work"] is lanes["next_work"]
    assert (profiling.launch_counts["S1"], profiling.launch_counts["S2"]) == (
        launches[0] + 2, launches[1] + 2)
    # S1, the sort and S2 replay in a CUDA graph.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S.permute_lanes(perm, st)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        k = S.sort_keys(item, o, d, total, boxes[0])
        out = S.permute_lanes(torch.sort(k, stable=True).indices, st)
    graph.replay()
    torch.cuda.synchronize()
    want = S.permute_lanes_plain(torch.sort(S.sort_keys_plain(
        item, o, d, total, boxes[0]), stable=True).indices, st)
    assert all(torch.equal(_bits(out[k]), _bits(want[k])) for k in want)


def test_sort_wrappers_raise_instead_of_falling_back(cuda):
    from mrt_torch.ops import sort as S

    st, total = _sort_lanes(cuda, 1000, 3)
    perm = torch.arange(1000, device=cuda)
    flat = torch.zeros(1000 * 4 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        S.permute_lanes(perm, dict(st, acc=flat[1:].view(1000, 4)))
    with pytest.raises(ValueError, match="box"):
        S.sort_keys(st["item"], st["o"], st["d"], total,
                    torch.zeros(6))
    with pytest.raises(ValueError, match="on"):
        S.permute_lanes(perm.cpu(), st)


def test_sorted_pass_runs_the_same_steps(cuda, monkeypatch):
    # sphere_grid at 256x144: unsorted, then as the auto rule sorts it
    # (every 4 steps): the same steps and B-kernel launches, S1 and S2
    # once a sort, equal bounce counts, radiance within f32
    # reassociation of the film's atomic adds.
    from mrt_torch.integrator import persistent
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.ops import sort as S
    from mrt_torch.scenes import get

    scene, camera = get("sphere_grid")().generate(device=cuda)
    assert scene.prefers_sorted_rays() and scene.sort_cadence() == 4
    step, steps = persistent.LanePool.step, [0]

    def counted(self, *a):
        steps[0] += 1
        return step(self, *a)

    monkeypatch.setattr(persistent.LanePool, "step", counted)
    ids = ("B1", "B2", "B5", "B7", "S1", "S2")
    runs = []
    for sort_rays in (False, None):
        steps[0] = 0
        before = {k: profiling.launch_counts[k] for k in ids}
        film = render_pass_persistent(
            scene, camera, Film.create(256, 144, device=cuda), 1, 0,
            width=256, height=144, max_depth=50, samples=2,
            sort_rays=sort_rays)
        runs.append((film, steps[0], {k: profiling.launch_counts[k] - before[k]
                                      for k in ids}))
    (a, n, la), (b, m, lb) = runs
    assert n == m and n > 0 and n % 8 == 0
    assert {k: v for k, v in la.items() if k[0] == "B"} == {
        k: v for k, v in lb.items() if k[0] == "B"}
    assert la["S1"] == la["S2"] == 0 and lb["S1"] == lb["S2"] == n // 4
    assert lb["B5"] > 0 and lb["B2"] > 0
    assert torch.equal(a.depth_sum, b.depth_sum)
    scale = a.sum.abs().max().item()
    assert (a.sum - b.sum).abs().max().item() <= 1e-5 * scale


def _syncs_outside_to_host(fn):
    """The synchronising operations the card reports while fn runs whose
    stack holds no ``profiling.to_host``, as "file:line function"."""
    import traceback
    import warnings

    found, armed = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        # The switch to the debug mode is itself reported, once a process
        # (seen on the card), before fn runs: only what fn does counts.
        if not armed or "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        if any(fr.filename.endswith("profiling.py") and fr.name == "to_host"
               for fr in stack):
            return
        prog = [fr for fr in stack if "mrt_torch" in fr.filename]
        found.append(" <- ".join(f"{fr.filename}:{fr.lineno} {fr.name}"
                                 for fr in prog[::-1][:3]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        armed.append(True)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return found


@pytest.mark.parametrize("name", ["rtiow", "sphere_grid"])
def test_every_sync_of_a_pass_and_a_grad_step_is_a_to_host_read(cuda, name):
    from mrt_torch import inverse
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    kw = dict(grid=3) if name == "rtiow" else dict(dim=6)
    scene, camera = get(name)(aspect_ratio=2.0, **kw).generate(device=cuda)

    def frame():
        render_pass_persistent(scene, camera, Film.create(128, 64,
                                                          device=cuda),
                               1, 0, width=128, height=64, max_depth=8,
                               samples=2, pool=4096)

    frame()  # the library's build and first launches
    assert _syncs_outside_to_host(frame) == []
    if name != "rtiow":
        return
    target = inverse.render_image(scene, camera, 64, 32, spp=1,
                                  max_depth=3).detach()

    def apply(c):
        return scene.replace(spheres=scene.spheres.replace(center=c))

    def grad():
        inverse.optimize(apply, scene.spheres.center + 0.01, camera, 64, 32,
                         target, steps=2, spp=1, max_depth=3)

    grad()
    assert _syncs_outside_to_host(grad) == []


# Ray ids at the edges of R1's 32-bit view: 0, 2^31, 2^32 - 1, negative
# int64 and values of 2^32 and more (their low 32 bits count).
R1_EDGE_IDS = [0, 2 ** 31, 2 ** 32 - 1, -1, -(2 ** 31) - 3, 2 ** 32,
               2 ** 32 + 9, 2 ** 40 + 77, 2 ** 63 - 1, -(2 ** 63)]


def _r1_case(cuda, n, seed_kind, salt_kind):
    """(ray_id, seed, salt) on the card: n ids with the edge values first;
    an int or 0-d seed; an int, 0-d or per-lane salt."""
    g = torch.Generator().manual_seed(18)
    ids = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=g)
    ids[:len(R1_EDGE_IDS)] = torch.tensor(R1_EDGE_IDS)
    seeds = {"int": 2 ** 31 + 17, "0-d": torch.tensor(-(2 ** 40) - 3)}
    salts = {"int": 0xC0FFEE, "0-d": torch.tensor(2 ** 33 + 7),
             "per-lane": 3 * torch.randint(0, 50, (n,), generator=g) + 1}
    on = lambda x: x.to(cuda) if torch.is_tensor(x) else x
    return ids.to(cuda), on(seeds[seed_kind]), on(salts[salt_kind])


@pytest.mark.parametrize("draw", [0, 1, 5, 2 ** 32 + 5])
@pytest.mark.parametrize("salt_kind", ["int", "0-d", "per-lane"])
@pytest.mark.parametrize("seed_kind", ["int", "0-d"])
def test_r1_kernel_matches_plain(cuda, seed_kind, salt_kind, draw):
    # 5000 lanes: not a multiple of the block.
    from mrt_torch.ops import rng as R1

    ids, seed, salt = _r1_case(cuda, 5000, seed_kind, salt_kind)
    before = profiling.launch_counts["R1"]
    got = R1.pcg4d_draw(ids, seed, salt, draw)
    want = R1.pcg4d_draw_plain(ids, seed, salt, draw)
    torch.cuda.synchronize()
    assert profiling.launch_counts["R1"] == before + 1
    assert got.shape == (4, 5000) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    assert ((got >= 0) & (got < 1)).all()


@pytest.mark.parametrize("salt_kind", ["int", "per-lane"])
def test_r1_sampler_matches_the_plain_sampler(cuda, monkeypatch, salt_kind):
    # A Sampler on the card (R1) against one with R1's plain version in
    # the wrapper's place, on 2^17 lanes: next4, next1 and skip between
    # draws, one launch a draw and none at construction or skip.
    from mrt_torch.math import rng
    from mrt_torch.ops import rng as R1

    ids, seed, salt = _r1_case(cuda, 1 << 17, "int", salt_kind)

    def draws():
        sampler = rng.Sampler(seed, ids, salt)
        sampler.skip(3)
        out = [sampler.next4()]
        sampler.skip(2 ** 32)
        return out + [(sampler.next1(),), sampler.next4()]

    before = profiling.launch_counts["R1"]
    card = draws()
    assert profiling.launch_counts["R1"] == before + 3
    monkeypatch.setattr(rng, "pcg4d_draw", R1.pcg4d_draw_plain)
    plain = draws()
    torch.cuda.synchronize()
    for want, got in zip(plain, card):
        assert all(torch.equal(_bits(w), _bits(g)) for w, g in zip(want, got))
    assert profiling.launch_counts["R1"] == before + 3


def test_r1_in_a_cuda_graph_with_a_new_seed(cuda):
    # The seed and salt are read from device memory: a replay after they
    # change draws the new stream.
    from mrt_torch.ops import rng as R1

    ids, seed, salt = _r1_case(cuda, 1 << 17, "0-d", "0-d")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        R1.pcg4d_draw(ids, seed, salt, 7)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = R1.pcg4d_draw(ids, seed, salt, 7)
    for s, t in ((5, 9), (2 ** 31 + 17, 0xC0FFEE), (-1, 2 ** 32 + 1)):
        seed.fill_(s)
        salt.fill_(t)
        graph.replay()
        want = R1.pcg4d_draw_plain(ids, s, t, 7)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(want))


def test_r1_wrapper_raises_instead_of_falling_back(cuda):
    from mrt_torch.ops import rng as R1

    # On CPU tensors the wrapper is its plain version; on the card it
    # launches or raises, with no fallback, also on mixed devices.
    ids, seed, salt = _r1_case(cuda, 1000, "0-d", "per-lane")
    cpu = (ids.cpu(), seed.cpu(), salt.cpu())
    before = profiling.launch_counts["R1"]
    assert torch.equal(_bits(R1.pcg4d_draw(*cpu, 5)),
                       _bits(R1.pcg4d_draw_plain(*cpu, 5)))
    assert profiling.launch_counts["R1"] == before
    with pytest.raises(ValueError, match="seed"):
        R1.pcg4d_draw(ids.cpu(), seed, 2, 0)
    with pytest.raises(TypeError, match="int64"):
        R1.pcg4d_draw(ids.to(torch.int32), 1, 2, 0)
    with pytest.raises(ValueError, match="salt"):
        R1.pcg4d_draw(ids, seed, salt[1:], 0)
    with pytest.raises(ValueError, match="salt"):
        R1.pcg4d_draw(ids, seed, salt.cpu(), 0)
    with pytest.raises(TypeError, match="salt"):
        R1.pcg4d_draw(ids, seed, salt.to(torch.int32), 0)
    with pytest.raises(ValueError, match="seed"):
        R1.pcg4d_draw(ids, seed.expand(2).contiguous(), 2, 0)
    with pytest.raises(ValueError, match="contiguous"):
        R1.pcg4d_draw(ids[::2], seed, 2, 0)


@pytest.mark.parametrize("name", ["rtiow", "sphere_grid"])
def test_r1_pass_equals_the_plain_sampler_pass(cuda, monkeypatch, name):
    # A 256x144 spp-1 pass (one lane a pixel, so B2's adds to a row come
    # in step order and the film is deterministic) with R1 and with the
    # plain version in R1's place: film and depth bit-equal; R1 once to
    # fill the pool and twice a step (camera and scatter).
    from mrt_torch.math import rng
    from mrt_torch.ops import rng as R1
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    scene, camera = get(name)().generate(device=cuda)

    def one_pass():
        return render_pass_persistent(
            scene, camera, Film.create(256, 144, device=cuda), 1, 0,
            width=256, height=144, max_depth=50, samples=1)

    card = one_pass()
    rec = profiling.snapshot()["pass"][-1]
    assert rec["steps"] > 0
    assert rec["draw_launches"] == 2 * rec["steps"] + 1
    monkeypatch.setattr(rng, "pcg4d_draw", R1.pcg4d_draw_plain)
    before = profiling.launch_counts["R1"]
    plain = one_pass()
    assert profiling.launch_counts["R1"] == before
    assert profiling.snapshot()["pass"][-1]["steps"] == rec["steps"]
    assert torch.equal(_bits(card.sum), _bits(plain.sum))
    assert torch.equal(card.depth_sum, plain.depth_sum)
    assert card.depth_sum.sum() > 0


# Kernel M1, L3 shading (ops/shade.py), against the eager composition.
M1_OUTPUTS = ("emitted", "attenuation", "new_direction", "scattered", "lobe")


def _m1_equal(got, want, what):
    for name, g, w in zip(M1_OUTPUTS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert torch.equal(_bits(g), _bits(w)), (what, name)


@pytest.mark.parametrize("drop", [0, 37])
def test_m1_matches_eager_on_every_class_and_edge(cuda, drop):
    # The synthetic wavefront of tests/torch_shade_cases.py, each case on
    # its own lanes (drop: lanes cut from the end, so the count is not a
    # multiple of the block).
    import torch_shade_cases as cases
    from mrt_torch.ops import shade as M1

    tab, args, parts = cases.wavefront(cuda)
    n = args[0].shape[0] - drop
    cut = lambda a: a[:n] if torch.is_tensor(a) else tuple(x[:n] for x in a)
    args = tuple(cut(a) for a in args)
    before = profiling.launch_counts["M1"]
    got = M1.shade_lanes(tab, *args)
    want = M1.shade_lanes_plain(tab, *args)
    torch.cuda.synchronize()
    assert profiling.launch_counts["M1"] == before + 1
    for case, part in parts.items():
        part = slice(part.start, min(part.stop, n))
        _m1_equal([g[part] for g in got], [w[part] for w in want], case)
        if part.stop - part.start == cases.LANES:
            cases.check_edge(case, tab, args, want, part)
    _m1_equal(got, want, "all lanes")


def _m1_recorded_steps(cuda, monkeypatch, name):
    """{step: M1's arguments} at steps 2 and 64 of a 1080p pass of
    `name` (2^17 lanes, spp 1, stopped after the check past step 64)."""
    from mrt_torch.integrator import persistent
    from mrt_torch.materials import shade
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    nee = name == "cornell_nee"
    scene, camera = get("cornell" if nee else name)(nee=nee).generate(
        device=cuda)
    real, calls, out = shade.shade_lanes, [0], {}

    def spy(*args):
        if calls[0] in (2, 64):
            out[calls[0]] = tuple(
                a.clone() if torch.is_tensor(a)
                else tuple(x.clone() for x in a) if isinstance(a, tuple)
                else a for a in args)
        calls[0] += 1
        return real(*args)

    busy = persistent.LanePool.busy
    monkeypatch.setattr(shade, "shade_lanes", spy)
    monkeypatch.setattr(persistent.LanePool, "busy", lambda self, st: (
        self.record["steps"] < 65 and busy(self, st)))
    render_pass_persistent(scene, camera, Film.create(1920, 1080, device=cuda),
                           1, 0, width=1920, height=1080, max_depth=50,
                           samples=1, pool=1 << 17)
    assert sorted(out) == [2, 64]
    return out


@pytest.mark.parametrize("name", ["rtiow", "sphere_grid", "cornell_nee"])
def test_m1_matches_eager_on_recorded_steps(cuda, monkeypatch, name):
    from mrt_torch.ops import shade as M1

    for step, args in _m1_recorded_steps(cuda, monkeypatch, name).items():
        assert args[1].shape == (1 << 17, 3)
        got = M1.shade_lanes(*args)
        want = M1.shade_lanes_plain(*args)
        torch.cuda.synchronize()
        _m1_equal(got, want, f"{name} step {step}")


def test_m1_spp2_rtiow_pass_equals_the_eager_pass(cuda, monkeypatch):
    # A 256x144 spp-2 RTIOW pass through M1 and with the eager composition
    # forced: every step's deposit (slots and values) bit-equal, so the
    # films differ only by the order of B2's atomic adds (bounce counts
    # exact); one M1 launch a step and R1's draws unchanged.
    from mrt_torch.integrator import persistent
    from mrt_torch.materials import shade
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    scene, camera = get("rtiow")().generate(device=cuda)
    deposit = persistent.deposit

    def one_pass():
        seen = []

        def spy(film, slot, contrib):
            seen.append((slot.clone(), contrib.clone()))
            return deposit(film, slot, contrib)

        monkeypatch.setattr(persistent, "deposit", spy)
        film = render_pass_persistent(
            scene, camera, Film.create(256, 144, device=cuda), 1, 0,
            width=256, height=144, max_depth=50, samples=2)
        return film, seen, dict(profiling.snapshot()["pass"][-1])

    m1, m1_deposits, m1_rec = one_pass()
    monkeypatch.setattr(shade, "shades_on_card", lambda *args: False)
    eager, eager_deposits, eager_rec = one_pass()
    assert m1_rec["steps"] == eager_rec["steps"] == len(m1_deposits) > 0
    assert m1_rec["shade_launches"] == m1_rec["steps"]
    assert eager_rec["shade_launches"] == 0
    assert m1_rec["draw_launches"] == eager_rec["draw_launches"] == (
        2 * m1_rec["steps"] + 1)
    for k, ((s1, c1), (s2, c2)) in enumerate(zip(m1_deposits,
                                                 eager_deposits)):
        assert torch.equal(s1, s2) and torch.equal(_bits(c1), _bits(c2)), k
    assert torch.equal(m1.depth_sum, eager.depth_sum)
    assert m1.depth_sum.sum() > 0
    torch.testing.assert_close(m1.sum, eager.sum, rtol=1e-6, atol=1e-6)


def test_m1_wrapper_raises_instead_of_falling_back(cuda):
    import torch_shade_cases as cases
    from mrt_torch.ops import shade as M1

    # On CPU tensors the wrapper is its plain version; on the card it
    # launches or raises, with no fallback, also on mixed devices.
    tab, (normal, front, rows, hit, d_in, u), _ = cases.wavefront(cuda)
    cpu = (cases.table("cpu"), normal.cpu(), front.cpu(), rows.cpu(),
           hit.cpu(), d_in.cpu(), tuple(x.cpu() for x in u))
    before = profiling.launch_counts["M1"]
    _m1_equal(M1.shade_lanes(*cpu), M1.shade_lanes_plain(*cpu), "the CPU")
    assert profiling.launch_counts["M1"] == before
    with pytest.raises(ValueError, match="normal"):
        M1.shade_lanes(tab, normal.cpu(), front, rows, hit, d_in, u)
    with pytest.raises(TypeError, match="material"):
        M1.shade_lanes(tab, normal, front, rows.long(), hit, d_in, u)
    with pytest.raises(ValueError, match="d_in is not contiguous"):
        M1.shade_lanes(tab, normal, front, rows, hit,
                       torch.cat([d_in, d_in], dim=1)[:, 3:], u)


# Kernel H1, L2's hit record (ops/hits.py), against the eager chain.
def _h1_steps(cuda, name):
    """(scene, {call: (o, d, t_min, t_max, shading_aux)}): the calls of
    Scene.intersect at step 64 of a 1080p pass of `name` (2^17 lanes,
    spp 1; with NEE the step's primary and shadow rays)."""
    import torch_hit_cases as cases

    scene, camera = cases.build(name, cuda)
    keep = (128, 129) if name == "cornell_nee" else (64,)
    return scene, cases.recorded_calls(scene, camera, keep, 1920, 1080,
                                       1 << 17, steps=72)


@pytest.mark.parametrize("name", ["rtiow", "sphere_grid", "cornell_nee"])
def test_h1_matches_eager_on_step_64(cuda, monkeypatch, name):
    # Every column on every lane, bit for bit: H1 against its plain
    # version and against the eager chain of Scene.intersect, on the
    # step's calls as recorded, with the sets tied and one ulp apart
    # (where the scene has both), and on rays sent away from the scene.
    import torch_hit_cases as cases
    from mrt_torch.geometry import scene as scene_mod
    from mrt_torch.ops import hits as H1

    scene, calls = _h1_steps(cuda, name)
    for call, (o, d, t_min, t_max, aux) in calls.items():
        assert o.shape == (1 << 17, 3)
        sph, inst = scene.winners(o, d, t_min, t_max)
        lanes = {"as called": (o, d, sph, inst)}
        if sph is not None and inst is not None and aux:
            s, i, tie, ulp = cases.tied(sph, inst)
            assert len(tie) > 0 and len(ulp) > 0
            lanes["tied"] = (o, d, s, i)
        ao, ad = cases.missing(scene, o, d)
        lanes["missed"] = (ao, ad, *scene.winners(ao, ad, t_min, t_max))
        for what, (o_, d_, s, i) in lanes.items():
            before = profiling.launch_counts["H1"]
            got = H1.hit_record(o_, d_, scene.spheres, s, scene.tlas, i)
            assert profiling.launch_counts["H1"] == before + 1
            want = H1.hit_record_plain(o_, d_, scene.spheres, s,
                                       scene.tlas, i)
            torch.cuda.synchronize()
            assert not cases.differing(got, want), (
                name, call, what, cases.differing(got, want))
        with monkeypatch.context() as m:
            m.setattr(scene_mod, "records_on_card", lambda *a: False)
            eager = scene._intersect_once(o, d, t_min, t_max, None, aux)
        got = H1.hit_record(o, d, scene.spheres, sph, scene.tlas, inst)
        assert not cases.differing(got, eager), (name, call)
        assert got.hit.any() or not aux


def test_h1_in_a_cuda_graph(cuda):
    # Captured on cornell NEE's step-64 lanes (both sets), replayed on
    # those and, written into the captured inputs, on bounce lanes of
    # another step: bit-equal to the plain version each time.
    import torch_hit_cases as cases
    from mrt_torch.ops import hits as H1

    scene, camera = cases.build("cornell_nee", cuda)
    calls = cases.recorded_calls(scene, camera, (8, 128), 1920, 1080,
                                 1 << 17, steps=72)
    args = {}
    for call, (o, d, t_min, t_max, _) in calls.items():
        sph, inst = scene.winners(o, d, t_min, t_max)
        args[call] = (o, d, sph, inst)
    o, d, sph, inst = (x.clone() if torch.is_tensor(x)
                       else tuple(y.clone() for y in x)
                       for x in args[128])
    fn = lambda: H1.hit_record(o, d, scene.spheres, sph, scene.tlas, inst)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    for call in (128, 8):
        src_o, src_d, src_s, src_i = args[call]
        for dst, src in zip((o, d, *sph, *inst),
                            (src_o, src_d, *src_s, *src_i)):
            dst.copy_(src)
        for name in cases.FIELDS:
            getattr(got, name).zero_()
        graph.replay()
        torch.cuda.synchronize()
        want = H1.hit_record_plain(src_o, src_d, scene.spheres, src_s,
                                   scene.tlas, src_i)
        assert not cases.differing(got, want), (call,
                                                cases.differing(got, want))
        assert want.hit.any()


@pytest.mark.parametrize("name", ["rtiow", "cornell_nee"])
def test_h1_spp2_pass_equals_the_eager_pass(cuda, monkeypatch, name):
    # A 256x144 spp-2 pass through H1 and with the eager chain forced:
    # every step's deposit (slots and values) bit-equal, so the films
    # differ only by the order of B2's atomic adds (bounce counts exact);
    # H1 once a step, twice with NEE; the other kernels' launches equal.
    import torch_hit_cases as cases
    from mrt_torch.geometry import scene as scene_mod
    from mrt_torch.integrator import persistent
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent

    scene, camera = cases.build(name, cuda)
    deposit = persistent.deposit

    def one_pass():
        seen = []

        def spy(film, slot, contrib):
            seen.append((slot.clone(), contrib.clone()))
            return deposit(film, slot, contrib)

        monkeypatch.setattr(persistent, "deposit", spy)
        before = dict(profiling.launch_counts)
        film = render_pass_persistent(
            scene, camera, Film.create(256, 144, device=cuda), 1, 0,
            width=256, height=144, max_depth=50, samples=2)
        launches = {k: v - before[k]
                    for k, v in profiling.launch_counts.items()}
        return film, seen, dict(profiling.snapshot()["pass"][-1]), launches

    h1, h1_deposits, h1_rec, h1_launches = one_pass()
    monkeypatch.setattr(scene_mod, "records_on_card", lambda *a: False)
    eager, eager_deposits, eager_rec, eager_launches = one_pass()
    per_step = 2 if name == "cornell_nee" else 1
    assert h1_rec["steps"] == eager_rec["steps"] == len(h1_deposits) > 0
    assert h1_rec["hit_launches"] == per_step * h1_rec["steps"]
    assert eager_rec["hit_launches"] == 0
    assert h1_launches.pop("H1") == per_step * h1_rec["steps"]
    assert eager_launches.pop("H1") == 0
    assert h1_launches == eager_launches
    for k, ((s1, c1), (s2, c2)) in enumerate(zip(h1_deposits,
                                                 eager_deposits)):
        assert torch.equal(s1, s2) and torch.equal(_bits(c1), _bits(c2)), k
    assert torch.equal(h1.depth_sum, eager.depth_sum)
    assert h1.depth_sum.sum() > 0
    torch.testing.assert_close(h1.sum, eager.sum, rtol=1e-6, atol=1e-6)


def test_h1_wrapper_raises_instead_of_falling_back(cuda):
    import torch_hit_cases as cases
    from mrt_torch.ops import hits as H1

    # On CPU tensors the wrapper is its plain version; on the card it
    # launches or raises, with no fallback, also on mixed devices.
    scene, _ = cases.build("cornell_nee", cuda)
    cpu_scene, _ = cases.build("cornell_nee", "cpu")
    g = torch.Generator().manual_seed(3)
    o = torch.rand((5000, 3), generator=g) * 2 - 1
    d = torch.randn((5000, 3), generator=g)
    sph, inst = cpu_scene.winners(o, d, 1e-3, float("inf"))
    before = profiling.launch_counts["H1"]
    got = H1.hit_record(o, d, cpu_scene.spheres, sph, cpu_scene.tlas, inst)
    assert not cases.differing(got, H1.hit_record_plain(
        o, d, cpu_scene.spheres, sph, cpu_scene.tlas, inst))
    assert profiling.launch_counts["H1"] == before
    oc, dc = o.to(cuda), d.to(cuda)
    sc, ic = (tuple(x.to(cuda) for x in w) for w in (sph, inst))
    with pytest.raises(ValueError, match="hit_record: d "):
        H1.hit_record(oc, d, scene.spheres, sc, scene.tlas, ic)
    with pytest.raises(ValueError, match="center"):
        H1.hit_record(oc, dc, cpu_scene.spheres, sc, scene.tlas, ic)
    with pytest.raises(TypeError, match="triangle"):
        H1.hit_record(oc, dc, scene.spheres, sc, scene.tlas,
                      (ic[0], ic[1], ic[2].long(), *ic[3:]))
    with pytest.raises(ValueError, match="d is not contiguous"):
        H1.hit_record(oc, torch.cat([dc, dc], dim=1)[:, 3:], scene.spheres,
                      sc, scene.tlas, ic)
    assert profiling.launch_counts["H1"] == before
