"""Kernel M1's route through L3 shading, on the CPU (no card needed).

``materials.shade.shade_hit`` takes M1's wrapper (``ops.shade.shade_lanes``)
for a table with no atlas and no Mix rows when autograd does not record
through shading; everywhere else its eager composition runs.  On CPU
tensors the wrapper runs M1's plain version.  Here each call of the
wrapper is counted as a launch, as on the card: the persistent pass
shades every step through it with the films equal to the eager pass's,
while atlas and Mix scenes and the differentiable trace's forward and
checkpoint recompute stay eager.  The wrapper equals its plain version
on CPU tensors and raises on what it does not take.  The synthetic
wavefront of ``tests/torch_shade_cases.py`` reaches each edge it was
built for.  Imports no JAX.
"""

import pytest
import torch

import torch_grad_scenes as G
import torch_shade_cases as cases
from mrt_torch import inverse
from mrt_torch.geometry.scene import Scene
from mrt_torch.materials import background as bg
from mrt_torch.materials import shade
from mrt_torch.math.rng import Sampler
from mrt_torch.ops import shade as M1
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass_persistent
from mrt_torch.scenes import get
from mrt_torch.utils import profiling

torch.set_num_threads(2)

W, H = 24, 16


@pytest.fixture
def routes(monkeypatch):
    """M1's route on the CPU, counted: {"m1": calls of M1's wrapper, each
    counted as a launch of M1, "eager": calls of the eager composition
    outside it}."""
    calls = {"m1": 0, "eager": 0}
    wrapper, eager, inside = shade.shade_lanes, shade.shade_rows, []

    def m1(*args):
        calls["m1"] += 1
        profiling.launch_counts["M1"] += 1
        inside.append(True)  # on the CPU the wrapper runs shade_rows
        try:
            return wrapper(*args)
        finally:
            inside.pop()

    def counted_eager(*args):
        calls["eager"] += not inside
        return eager(*args)

    monkeypatch.setattr(shade, "shade_lanes", m1)
    monkeypatch.setattr(shade, "shade_rows", counted_eager)
    counts = profiling.launch_counts
    monkeypatch.setitem(counts, "M1", counts["M1"])
    return calls


def _pass(scene, camera, samples=2, **kw):
    return render_pass_persistent(
        scene, camera, Film.create(W, H, device="cpu"), 1, 0, width=W,
        height=H, max_depth=8, samples=samples, pool=128, **kw)


@pytest.mark.parametrize("name", ["rtiow", "sphere_grid", "cornell"])
def test_a_pass_shades_every_step_through_m1(routes, monkeypatch, name):
    # The pass record counts one M1 launch a step; the film and the
    # bounce counts equal the eager pass's bit for bit.
    scene, camera = get(name)(nee=name == "cornell").generate(device="cpu")
    m1_film = _pass(scene, camera)
    rec = profiling.snapshot()["pass"][-1]
    assert routes["eager"] == 0 and routes["m1"] == rec["steps"] > 0
    assert rec["shade_launches"] == rec["steps"]
    monkeypatch.setattr(shade, "shades_on_card", lambda *args: False)
    eager_film = _pass(scene, camera)
    assert routes["eager"] == profiling.snapshot()["pass"][-1]["steps"]
    assert profiling.snapshot()["pass"][-1]["shade_launches"] == 0
    assert torch.equal(m1_film.sum, eager_film.sum)
    assert torch.equal(m1_film.depth_sum, eager_film.depth_sum)


def _hits_of(args):
    normal, front, rows, hit, _, _ = args
    return type("Lanes", (), dict(normal=normal, front_face=front,
                                  material=rows, hit=hit, uv=None))()


def _scene_of(tab, **kw):
    return Scene(materials=tab, background=bg.SkyBackground.create(), **kw)


@pytest.mark.parametrize("kind, want", [
    ("plain", True),
    ("meta tensors", True),  # the wrapper, not the rule, asks the device
    ("atlas", False),
    ("mix", False),
    ("grad: d_in", False),
    ("grad: normal", False),
    ("grad: albedo", False),
    ("grad: fuzz", False),
    ("grad: ior", False),
    ("grad: emit", False),
    ("grad, under no_grad", True),
])
def test_the_routing_rule(monkeypatch, kind, want):
    tab, args, _ = cases.wavefront("cpu")
    if kind == "meta tensors":
        tab, args = tab.to("meta"), tuple(
            x.to("meta") if torch.is_tensor(x) else x for x in args)
    normal, _, _, _, d_in, _ = args
    scene = _scene_of(tab, has_mix=False)
    if kind == "atlas":
        scene.atlas = object()
    if kind == "mix":
        scene.has_mix = True
    if kind.startswith("grad"):
        col = kind.split(": ")[-1] if ": " in kind else "albedo"
        if col in ("d_in", "normal"):
            x = (d_in if col == "d_in" else normal).requires_grad_(True)
        else:
            getattr(tab, col).requires_grad_(True)
    hits = _hits_of(args)
    if kind == "grad, under no_grad":
        with torch.no_grad():
            assert shade.shades_on_card(scene, hits, d_in) is want
    else:
        assert shade.shades_on_card(scene, hits, d_in) is want


def _scene_with(kind):
    if kind == "atlas":
        import torch_golden_scenes

        return torch_golden_scenes.textured("cpu")
    # A Mix row over RTIOW's table.
    scene, camera = get("rtiow")().generate(device="cpu")
    m = scene.materials
    last = m.mtype.shape[0] - 1
    m.mtype[last] = shade.T.MIX
    m.mix_left[last], m.mix_right[last], m.mix_ratio[last] = 0, 1, 0.5
    m.mix_depth = 1
    scene.has_mix = True
    return scene, camera


@pytest.mark.parametrize("kind", ["atlas", "mix"])
def test_atlas_and_mix_scenes_stay_eager(routes, kind):
    scene, camera = _scene_with(kind)
    _pass(scene, camera, samples=1)
    assert routes["m1"] == 0
    assert profiling.snapshot()["pass"][-1]["shade_launches"] == 0
    if kind == "atlas":
        assert routes["eager"] > 0  # the Mix route resolves rows first


@pytest.mark.parametrize("case", ["albedo", "emission", "fuzz", "center"])
def test_the_differentiable_trace_stays_eager(routes, case):
    # Forward and the checkpoint's recompute: every bounce shades through
    # the eager composition.  The same render with grad off takes M1.
    c, camera = G.CASES[case], G.torch_camera()

    def loss(p):
        scene = G.torch_scene(case, p)
        scene.has_mix = False  # its table has no Mix row
        return torch.mean(inverse.render_image(
            scene, camera, G.SIZE, G.SIZE, spp=c["spp"], seed=c["seed"],
            max_depth=c["max_depth"]))

    p = torch.tensor(c["init"], requires_grad=True)
    value = loss(p)
    forward = dict(routes)
    assert forward["m1"] == 0 and forward["eager"] > 0
    value.backward()
    assert routes["m1"] == 0
    assert routes["eager"] == 2 * forward["eager"]
    assert p.grad is not None and torch.isfinite(p.grad).all()
    with torch.no_grad():
        again = loss(p)
    assert routes["m1"] == forward["eager"]
    assert routes["eager"] == 2 * forward["eager"]
    assert torch.equal(again, value.detach())


def _wrapper_args(fault):
    """shade_lanes' arguments on the CPU with one fault."""
    tab, (normal, front, rows, hit, d_in, u), _ = cases.wavefront("cpu")
    u = list(u)
    if fault == "dtype":
        rows = rows.to(torch.int64)
    elif fault == "table dtype":
        tab.mtype = tab.mtype.to(torch.int64)
    elif fault == "non-contiguous":
        normal = torch.cat([normal, normal], dim=1)[:, :3]
    elif fault == "non-contiguous draw":
        u[2] = torch.stack([u[2], u[2]], dim=1)[:, 0]
    elif fault == "shape":
        hit = hit[1:]
    elif fault == "three draws":
        u = u[:3]
    elif fault == "meta tensors":
        tab, (normal, front, rows, hit, d_in) = tab.to("meta"), (
            x.to("meta") for x in (normal, front, rows, hit, d_in))
        u = [x.to("meta") for x in u]
    return tab, normal, front, rows, hit, d_in, tuple(u)


@pytest.mark.parametrize("fault, error, match", [
    ("none: a CPU tensor", None, None),
    ("meta tensors", ValueError, "no kernel for device meta"),
    ("dtype", TypeError, "material is torch.int64"),
    ("table dtype", TypeError, "mtype is torch.int64"),
    ("non-contiguous", ValueError, "normal is not contiguous"),
    ("non-contiguous draw", ValueError, "u3 is not contiguous"),
    ("shape", ValueError, "hit"),
    ("three draws", ValueError, "3 uniforms"),
])
def test_the_wrapper_raises_on_what_it_does_not_take(fault, error, match):
    # On CPU tensors the wrapper is its plain version, bit for bit.
    before = profiling.launch_counts["M1"]
    args = _wrapper_args(fault)
    if error is None:
        for g, w in zip(M1.shade_lanes(*args), M1.shade_lanes_plain(*args)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    else:
        with pytest.raises(error, match=match):
            M1.shade_lanes(*args)
    assert profiling.launch_counts["M1"] == before


@pytest.mark.parametrize("case", cases.CASES)
def test_the_synthetic_wavefront_reaches_its_edges(case):
    # On the eager composition, as the card's tests compare M1 with it.
    tab, args, parts = cases.wavefront("cpu")
    out = M1.shade_lanes_plain(tab, *args)
    cases.check_edge(case, tab, args, out, parts[case])


def test_the_plain_version_is_shade_hits_eager_composition():
    # shade_lanes_plain with the scatter sampler's draws equals shade_hit
    # (eager) with that sampler, on every output.
    tab, args, _ = cases.wavefront("cpu")
    normal, front, rows, hit, d_in, _ = args
    n = d_in.shape[0]
    ray_id = torch.arange(n, dtype=torch.int64) * 7919
    sc = Sampler(5, ray_id, salt=4)
    sc.skip(shade.T.MAX_MIX_DEPTH)
    u = sc.next4()
    hits = _hits_of(args)
    want = shade.shade_hit(_scene_of(tab, has_mix=False), hits, d_in,
                           Sampler(5, ray_id, salt=3),
                           Sampler(5, ray_id, salt=4))
    got = M1.shade_lanes_plain(tab, normal, front, rows, hit, d_in, u)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
