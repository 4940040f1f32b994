"""Port parity for the lane coherence sorter (``mrt_torch.ops.sort``,
``integrator.persistent.make_sorter``) and the auto rule that turns it
on (``Scene.prefers_sorted_rays``, ``Scene.sort_cadence``,
``ops.budget.tlas_tables_bytes``), against the JAX package.

Tolerances and why:
  - The sorter against the reference's ``_make_sorter`` run op by op on
    one seeded 2^14-lane state (idle lanes, zero, tiny, huge and NaN
    directions, NaN and infinite origins), with static and live-origin
    bounds, with and without the pend film mode's accumulator: the
    permuted state bit for bit.  The key rounds as the reference's
    except the root: the port's 1/sqrt is correctly rounded, XLA's
    ``rsqrt`` is not (it differs on ~14% of these lanes' |d|^2), and no
    lane's cell changes with it: substituting XLA's values leaves every
    key as it is.
  - The auto rule, with both packages' gates patched on (the
    reference's is its TPU kernels', the port's the card's): equal
    answers on all seven registered scenes and on a TLAS past the table
    budget.  Unpatched on the CPU, the port never sorts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.geometry import spheres as jspheres
from mrt.geometry.scene import SceneBuilder as JBuilder
from mrt.geometry.shapes import cube as jcube
from mrt.integrator import persistent as JP
from mrt.materials.background import SkyBackground as JSky
from mrt.materials.table import MaterialBuilder as JMaterials
from mrt.ops import budget as jbudget
from mrt.scenes import get as jget
from mrt.scenes import names
from mrt_torch.geometry import scene as tscene
from mrt_torch.geometry.scene import SceneBuilder as TBuilder
from mrt_torch.geometry.shapes import cube as tcube
from mrt_torch.integrator import persistent as TP
from mrt_torch.materials.background import SkyBackground as TSky
from mrt_torch.materials.table import MaterialBuilder as TMaterials
from mrt_torch.ops import budget as tbudget
from mrt_torch.ops import sort as S
from mrt_torch.scenes import get as tget
from mrt_torch.utils import profiling

torch.set_num_threads(2)

LANES = 1 << 14
TOTAL = 10_000


@pytest.fixture(scope="module")
def cornell():
    """cornell in both packages: the sorter's static bounds."""
    js, _ = jget("cornell")().generate()
    ts, _ = tget("cornell")().generate(device="cpu")
    for a, b in zip(js.world_bounds(), ts.world_bounds()):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    return js, ts


def _state(bounds):
    """A seeded lane state: origins over the bounds and past them, some
    idle lanes, and special lanes up front."""
    rs = np.random.default_rng(14)
    lo, hi = (np.asarray(x) for x in bounds)
    item = rs.integers(0, TOTAL, LANES)
    item[rs.random(LANES) < 0.2] = TOTAL
    o = (lo + rs.uniform(-0.1, 1.1, (LANES, 3)) * (hi - lo)).astype(np.float32)
    d = (rs.standard_normal((LANES, 3))
         * rs.uniform(0.1, 3.0, (LANES, 1))).astype(np.float32)
    d[:8] = 0.0
    d[8:12, 0] = np.nan
    o[12:14, 1] = np.nan
    o[14:16, 2] = np.inf
    d[16:20] = (1e-30, 0.0, 0.0)
    d[20:24] = (3e19, 1.0, 1.0)
    item[:24] = 7
    return dict(item=item, bounce=rs.integers(0, 8, LANES),
                o=o, d=d, throughput=rs.random((LANES, 3)).astype(np.float32),
                ray_id=rs.integers(0, 2 ** 32, LANES),
                prev_pdf=rs.random(LANES).astype(np.float32),
                acc=rs.random((LANES, 4)).astype(np.float32))


def _jax_state(st, pend):
    """The reference's state tuple (its slot accumulator and flush
    frontier are not lane data: placeholders)."""
    out = (jnp.asarray(st["item"], jnp.int32),
           jnp.asarray(st["bounce"], jnp.int32), jnp.asarray(st["o"]),
           jnp.asarray(st["d"]), jnp.asarray(st["throughput"]),
           jnp.asarray(st["ray_id"].astype(np.uint32)), jnp.int32(5),
           jnp.zeros((8, 4), jnp.float32), jnp.int32(0),
           jnp.asarray(st["prev_pdf"]))
    return out + ((jnp.asarray(st["acc"]),) if pend else ())


def _torch_state(st, pend):
    out = {k: torch.from_numpy(st[k]) for k in
           ("item", "bounce", "o", "d", "throughput", "ray_id", "prev_pdf")}
    out["next_work"] = torch.tensor(5)
    if pend:
        out["acc"] = torch.from_numpy(st["acc"])
    return out


def test_morton3_matches_reference():
    rs = np.random.default_rng(3)
    x, y, z = (rs.integers(0, 64, 4096) for _ in range(3))
    want = np.asarray(JP._morton3(*(jnp.asarray(a, jnp.uint32)
                                    for a in (x, y, z))))
    got = S.morton3(*(torch.from_numpy(a) for a in (x, y, z)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() < 2 ** 18


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("pend", [False, True], ids=["b2", "pend"])
def test_sorter_matches_reference(cornell, monkeypatch, dynamic, pend):
    js, ts = cornell
    monkeypatch.setenv("MRT_SORT_DYN", "1" if dynamic else "0")
    st = _state(js.world_bounds())
    want = JP._make_sorter(js, TOTAL)(_jax_state(st, pend))
    got = TP.make_sorter(ts, TOTAL)(_torch_state(st, pend))
    names_ = ["item", "bounce", "o", "d", "throughput", "ray_id",
              "next_work", None, None, "prev_pdf"] + (["acc"] if pend else [])
    for name, w in zip(names_, want):
        if name is None:
            continue
        g = got[name].numpy()
        w = np.asarray(w).astype(g.dtype)
        assert g.tobytes() == w.tobytes(), name
    assert set(got) == set(_torch_state(st, pend))
    # The order is by key, idle lanes last; a real permutation.
    assert (got["item"].numpy()[-(st["item"] == TOTAL).sum():] == TOTAL).all()
    assert not np.array_equal(got["o"].numpy(), st["o"])


def test_keys_hold_with_xla_rsqrt(cornell, monkeypatch):
    # XLA's rsqrt is not correctly rounded: it differs from the port's on
    # many of these lanes, yet no lane's direction cell moves with it.
    js, ts = cornell
    st = _torch_state(_state(js.world_bounds()), False)
    d = st["d"]
    s = torch.clamp((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                    + d[:, 2] * d[:, 2], min=1e-20)
    ours = S.rsqrt(s).numpy()
    xla = np.asarray(jax.lax.rsqrt(jnp.asarray(s.numpy())))
    differ = (ours != xla) & ~np.isnan(ours)
    assert differ.sum() > LANES // 20
    box = S.origin_box(*ts.world_bounds())
    keys = S.sort_keys(st["item"], st["o"], d, TOTAL, box)
    monkeypatch.setattr(S, "rsqrt", lambda x: torch.from_numpy(np.array(
        jax.lax.rsqrt(jnp.asarray(x.numpy(), jnp.float32)))))
    assert torch.equal(S.sort_keys(st["item"], st["o"], d, TOTAL, box), keys)
    assert (keys[st["item"] >= TOTAL] == S.IDLE_KEY).all()
    assert (keys[st["item"] < TOTAL] < 2 ** 30).all()


def test_origin_box_divides_by_a_tensor():
    # 63 / ext is the true quotient on every lane, not 63 * (1 / ext).
    rs = np.random.default_rng(5)
    ext = torch.from_numpy(rs.uniform(1e-3, 1e3, 3 * 4096).astype(np.float32))
    box = S.origin_box(torch.zeros_like(ext), ext)
    want = (np.float64(63.0) / ext.numpy().astype(np.float64)).astype(
        np.float32)
    np.testing.assert_array_equal(box[ext.numel():].numpy(), want)


def test_wrappers_check_their_inputs():
    st = _torch_state(_state(([0.0] * 3, [1.0] * 3)), True)
    box = S.origin_box(torch.zeros(3), torch.ones(3))
    with pytest.raises(TypeError, match="item"):
        S.sort_keys(st["item"].int(), st["o"], st["d"], TOTAL, box)
    with pytest.raises(ValueError, match="box"):
        S.sort_keys(st["item"], st["o"], st["d"], TOTAL, box[:3])
    with pytest.raises(ValueError, match="no kernel"):
        S.sort_keys(*(st[k].to("meta") for k in ("item", "o", "d")), TOTAL,
                    box.to("meta"))
    perm = torch.randperm(LANES, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="contiguous"):
        S.permute_lanes(perm, dict(st, o=st["o"].t().contiguous().t()))
    with pytest.raises(ValueError, match="acc"):
        S.permute_lanes(perm, dict(st, acc=st["acc"][:, :3]))
    with pytest.raises(ValueError, match="no kernel"):
        S.permute_lanes(perm.to("meta"), {
            k: v.to("meta") for k, v in st.items()})
    # On the CPU the wrappers are their plain versions, which count no
    # launch; next_work is carried as it is.
    counts = profiling.launch_counts
    launches = counts["S1"], counts["S2"]
    out = S.permute_lanes(perm, st)
    assert out["next_work"] is st["next_work"]
    for k in S.COLUMNS + ("acc",):
        assert out[k].numpy().tobytes() == st[k][perm].numpy().tobytes()
    S.sort_keys(st["item"], st["o"], st["d"], TOTAL, box)
    assert (counts["S1"], counts["S2"]) == launches


def _many_instances(builder, materials, sky, cube, n, **kw):
    """A TLAS of n unit cubes on a grid."""
    mat = materials()
    row = mat.lambertian((0.5, 0.5, 0.5))
    sb = builder(mat, sky.create())
    mesh = sb.add_mesh(cube(size=1.0))
    for i in range(n):
        sb.add_instance(mesh, translation=(i % 64 * 2.0, 0.0, i // 64 * 2.0),
                        material=row)
    return sb.build(**kw)


def _rule(scene, budget):
    return (scene.prefers_sorted_rays(), scene.sort_cadence(),
            None if scene.tlas is None
            else budget.tlas_tables_bytes(scene.tlas))


def test_auto_rule_matches_reference(monkeypatch):
    scenes = {name: (jget(name)().generate()[0],
                     tget(name)().generate(device="cpu")[0])
              for name in names()}
    assert len(scenes) == 7
    scenes["4096 instances"] = (
        _many_instances(JBuilder, JMaterials, JSky, jcube, 4096),
        _many_instances(TBuilder, TMaterials, TSky, tcube, 4096,
                        device="cpu"))
    # Unpatched on the CPU, the port's rule never sorts.
    assert not any(ts.prefers_sorted_rays() for _, ts in scenes.values())
    monkeypatch.setattr(jspheres, "_use_pallas", lambda *a, **k: True)
    monkeypatch.setattr(tscene, "sorts_on_device", lambda scene: True)
    got = {name: _rule(ts, tbudget) for name, (_, ts) in scenes.items()}
    want = {name: _rule(js, jbudget) for name, (js, _) in scenes.items()}
    assert got == want
    sorted_ = {name for name, r in got.items() if r[0]}
    assert sorted_ == {"eve", "lucy", "sphere_grid", "4096 instances"}
    assert got["lucy"][1] == got["4096 instances"][1] == 1
    assert got["eve"][1] == got["sphere_grid"][1] == 4
    assert not tbudget.fits(got["4096 instances"][2])
