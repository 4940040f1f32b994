"""Kernel H1's route through L2 intersection, on the CPU (no card needed).

``Scene.intersect`` takes H1's wrapper (``ops.hits.hit_record``) where a
scene's sets are only spheres and instances, no normal maps are asked
for and autograd does not record through the rays or the spheres
(``geometry.scene.records_on_card``); everywhere else the eager chain
(``Hits.none``, ``make_hits``/``expand_winner``, ``closer_of``) runs.  On
CPU tensors the wrapper runs H1's plain version, which equals that eager
chain bit for bit on every column and lane: on the calls a persistent
pass makes (primary rays, bounces, NEE's shadow rays with a per-lane
t_max), on rays that miss every set, and where two sets tie.  Here each
call of the wrapper is counted as a launch, as on the card: the pass
record counts one a step (two with NEE's shadow ray) with films equal to
the eager pass's, while voxel, volume and atlas scenes and the
differentiable trace stay eager.  The wrapper raises on what it does not
take and checks a scene's tables once until one changes.  Imports no
JAX.
"""

import pytest
import torch

import torch_grad_scenes as G
import torch_hit_cases as cases
from mrt_torch import inverse
from mrt_torch.geometry import scene as scene_mod
from mrt_torch.geometry import spheres as sphere_mod
from mrt_torch.geometry.hit import Hits
from mrt_torch.geometry.instance import expand_winner
from mrt_torch.ops import hits as H1
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass_persistent
from mrt_torch.utils import profiling

torch.set_num_threads(2)

W, H = 24, 16
POOL = 128


@pytest.fixture
def routes(monkeypatch):
    """H1's route on the CPU, counted: {"h1": calls of H1's wrapper, each
    counted as a launch of H1}."""
    calls = {"h1": 0}
    wrapper = H1.hit_record

    def h1(*args):
        calls["h1"] += 1
        profiling.launch_counts["H1"] += 1
        return wrapper(*args)

    monkeypatch.setattr(H1, "hit_record", h1)
    counts = profiling.launch_counts
    monkeypatch.setitem(counts, "H1", counts["H1"])
    return calls


@pytest.fixture(scope="module")
def recorded():
    """{scene: (scene, {call: (o, d, t_min, t_max, shading_aux)})}: the
    first calls of a 24x16 pass of each scene, pool 128 (with NEE every
    odd call is a shadow ray)."""
    out = {}
    for name in cases.SCENES:
        scene, camera = cases.build(name, "cpu")
        out[name] = scene, cases.recorded_calls(
            scene, camera, (0, 1, 2, 3, 12, 13), W, H, POOL, steps=16)
    return out


def _eager(monkeypatch, scene, o, d, t_min, t_max, shading_aux=True):
    with monkeypatch.context() as m:
        m.setattr(scene_mod, "records_on_card", lambda *args: False)
        return scene._intersect_once(o, d, t_min, t_max, None, shading_aux)


def _same(got, want, what):
    assert not cases.differing(got, want), (what, cases.differing(got, want))


@pytest.mark.parametrize("name, call", [
    ("rtiow", 0), ("rtiow", 12), ("rtiow", "misses"),
    ("sphere_grid", 0), ("sphere_grid", 12), ("sphere_grid", "misses"),
    ("cornell_nee", 0), ("cornell_nee", 1), ("cornell_nee", 12),
    ("cornell_nee", 13), ("cornell_nee", "misses"),
])
def test_the_plain_version_equals_the_eager_chain(monkeypatch, recorded,
                                                  name, call):
    # Every column on every lane, bit for bit: the recorded call through
    # H1's route (the wrapper, on the CPU its plain version), the plain
    # version on the call's winners, and the eager chain.
    scene, calls = recorded[name]
    o, d, t_min, t_max, aux = calls[12 if call == "misses" else call]
    if call == "misses":
        o, d = cases.missing(scene, o, d)
    if name == "cornell_nee" and call in (1, 13):
        assert not aux and torch.is_tensor(t_max)  # a shadow ray
        assert (t_max <= 1e-3).any() and (t_max > 1e-3).any()
    assert scene_mod.records_on_card(scene, o, d, aux)
    want = _eager(monkeypatch, scene, o, d, t_min, t_max, aux)
    sph, inst = scene.winners(o, d, t_min, t_max)
    plain = H1.hit_record_plain(o, d, scene.spheres, sph, scene.tlas, inst)
    _same(plain, want, "plain")
    _same(scene._intersect_once(o, d, t_min, t_max, None, aux), want,
          "route")
    if call == "misses":
        assert not want.hit.any()
        _same(want, Hits.none(o.shape[0]), "all-miss lanes")
    else:
        assert want.hit.any()


@pytest.mark.parametrize("name", ["sphere_grid", "cornell_nee"])
def test_ties_keep_the_earlier_set(recorded, name):
    # On equal t the spheres keep the lane; one ulp below, the instances
    # take it; hit is either set's.
    scene, calls = recorded[name]
    o, d, t_min, t_max, _ = calls[12]
    sph, inst, tie, ulp = cases.tied(*scene.winners(o, d, t_min, t_max))
    assert len(tie) > 0 and len(ulp) > 0
    got = H1.hit_record(o, d, scene.spheres, sph, scene.tlas, inst)
    _same(got, H1.hit_record_plain(o, d, scene.spheres, sph, scene.tlas,
                                   inst), "wrapper")
    spheres = sphere_mod.make_hits(scene.spheres, o, d, *sph, t_min)
    instances = expand_winner(scene.tlas, o, d, *inst)
    for lanes, winner in ((tie, spheres), (ulp, instances)):
        for field in cases.FIELDS:
            g, w = getattr(got, field)[lanes], getattr(winner, field)[lanes]
            assert torch.equal(cases.bits(g), cases.bits(w)), field
    assert got.hit[tie].all() and got.hit[ulp].all()


def _stand_in(kind):
    """A cornell NEE scene with one property of `kind`, and the
    intersect call's (o, d, shading_aux)."""
    scene, _ = cases.build("cornell_nee", "cpu")
    o = torch.zeros((8, 3))
    d = torch.ones((8, 3))
    aux = True
    if kind == "triangle set":
        scene.triangles = object()
    elif kind == "voxels":
        scene.voxels = [object()]
    elif kind == "volumes":
        scene.volumes = object()
    elif kind == "mesh volumes":
        scene.mesh_volumes = [object()]
    elif kind.startswith("atlas"):
        scene.atlas = object()
        aux = kind == "atlas, shading"
    elif kind.startswith("grad"):
        what = kind.split(": ")[1]
        x = scene.spheres.center if what == "center" else (
            scene.spheres.radius if what == "radius" else
            o if what == "o" else d)
        x.requires_grad_(True)
    return scene, o, d, aux


@pytest.mark.parametrize("kind, want", [
    ("spheres and instances", True),
    ("triangle set", False),
    ("voxels", False),
    ("volumes", False),
    ("mesh volumes", False),
    ("atlas, shading", False),
    ("atlas, occlusion", True),  # shadow rays ask for no normal maps
    ("grad: center", False),
    ("grad: radius", False),
    ("grad: o", False),
    ("grad: d", False),
    ("grad, under no_grad", True),
    ("flat route", False),
    ("flat parts", True),
])
def test_the_routing_rule(monkeypatch, kind, want):
    scene, o, d, aux = _stand_in(
        "grad: center" if kind == "grad, under no_grad" else kind)
    if kind in ("flat route", "flat parts"):
        # The routes' builds are opt-in; the rule asks only whether the
        # dispatch would take them.
        from mrt_torch.geometry import instance

        flat = kind == "flat route"
        monkeypatch.setattr(instance, "wants_flat", lambda *a: flat)
        monkeypatch.setattr(instance, "wants_flat_parts", lambda *a: True)
    if kind == "grad, under no_grad":
        with torch.no_grad():
            assert scene_mod.records_on_card(scene, o, d, aux) is want
    else:
        assert scene_mod.records_on_card(scene, o, d, aux) is want


def _pass(scene, camera, samples=2, **kw):
    device = scene.materials.mtype.device
    return render_pass_persistent(
        scene, camera, Film.create(W, H, device=device), 1, 0, width=W,
        height=H, max_depth=8, samples=samples, pool=POOL, **kw)


@pytest.mark.parametrize("name", cases.SCENES)
def test_a_pass_writes_every_record_through_h1(routes, monkeypatch, name):
    # The pass record counts one H1 launch a step, two with NEE (the
    # shadow ray's); the film and the bounce counts equal the eager
    # pass's bit for bit.
    scene, camera = cases.build(name, "cpu")
    h1_film = _pass(scene, camera)
    rec = profiling.snapshot()["pass"][-1]
    per_step = 2 if name == "cornell_nee" else 1
    assert routes["h1"] == rec["hit_launches"] == per_step * rec["steps"] > 0
    monkeypatch.setattr(scene_mod, "records_on_card", lambda *args: False)
    eager_film = _pass(scene, camera)
    assert profiling.snapshot()["pass"][-1]["hit_launches"] == 0
    assert routes["h1"] == per_step * rec["steps"]
    assert torch.equal(h1_film.sum, eager_film.sum)
    assert torch.equal(h1_film.depth_sum, eager_film.depth_sum)


@pytest.mark.parametrize("name", ["volume", "menger2_voxel", "textured"])
def test_voxel_volume_and_atlas_scenes_stay_eager(routes, name):
    # textured has an atlas: its camera and bounce rays ask for normal
    # maps, so every call stays eager (it takes no light sample).
    import torch_golden_scenes

    scene, camera = torch_golden_scenes.FACTORIES[name]("cpu")
    _pass(scene, camera, samples=1)
    assert routes["h1"] == 0
    assert profiling.snapshot()["pass"][-1]["hit_launches"] == 0


def test_the_differentiable_trace_stays_eager(routes):
    # Forward and the checkpoint's recompute, with the spheres' centres
    # recording: every bounce's record is the eager chain's (winner_t
    # gives t its derivative).  The same render with grad off takes H1.
    c, camera = G.CASES["center"], G.torch_camera()

    def loss(p):
        return torch.mean(inverse.render_image(
            G.torch_scene("center", p), camera, G.SIZE, G.SIZE,
            spp=c["spp"], seed=c["seed"], max_depth=c["max_depth"]))

    p = torch.tensor(c["init"], requires_grad=True)
    value = loss(p)
    assert routes["h1"] == 0
    value.backward()
    assert routes["h1"] == 0
    assert p.grad is not None and torch.isfinite(p.grad).all()
    with torch.no_grad():
        again = loss(p)
    assert routes["h1"] > 0
    assert torch.equal(again, value.detach())


def _wrapper_args(fault):
    """hit_record's arguments on cornell NEE's recorded call with one
    fault; a fresh scene, so its tables are checked."""
    scene, camera = cases.build("cornell_nee", "cpu")
    o, d, t_min, t_max, _ = cases.recorded_calls(scene, camera, (2,), W, H,
                                                 POOL, steps=4)[2]
    sph, inst = scene.winners(o, d, t_min, t_max)
    spheres, tlas = scene.spheres, scene.tlas
    if fault == "dtype":
        sph = (sph[0], sph[1].to(torch.int64))
    elif fault == "table dtype":
        spheres = spheres.replace(material=spheres.material.to(torch.int64))
    elif fault == "table shape":
        tlas.override = tlas.override[1:]
    elif fault == "non-contiguous":
        o = torch.cat([o, o], dim=1)[:, :3]
    elif fault == "shape":
        inst = (inst[0], inst[1][1:], *inst[2:])
    elif fault == "winners without their set":
        spheres = None
    elif fault == "meta tensors":
        scene = scene.to("meta")
        spheres, tlas = scene.spheres, scene.tlas
        o, d = o.to("meta"), d.to("meta")
        sph = tuple(x.to("meta") for x in sph)
        inst = tuple(x.to("meta") for x in inst)
    return o, d, spheres, sph, tlas, inst


@pytest.mark.parametrize("fault, error, match", [
    ("none: a CPU tensor", None, None),
    ("meta tensors", ValueError, "no kernel for device meta"),
    ("dtype", TypeError, "sphere index is torch.int64"),
    ("table dtype", TypeError, "material is torch.int64"),
    ("table shape", ValueError, "override"),
    ("non-contiguous", ValueError, "o is not contiguous"),
    ("shape", ValueError, "instance"),
    ("winners without their set", ValueError, "winners come with"),
])
def test_the_wrapper_raises_on_what_it_does_not_take(fault, error, match):
    # On CPU tensors the wrapper is its plain version, bit for bit.
    before = profiling.launch_counts["H1"]
    args = _wrapper_args(fault)
    if error is None:
        _same(H1.hit_record(*args), H1.hit_record_plain(*args), "the CPU")
    else:
        with pytest.raises(error, match=match):
            H1.hit_record(*args)
    assert profiling.launch_counts["H1"] == before


def test_the_tables_are_checked_once_until_one_changes(monkeypatch):
    scene, camera = cases.build("cornell_nee", "cpu")
    o, d, t_min, t_max, _ = cases.recorded_calls(scene, camera, (2,), W, H,
                                                 POOL, steps=4)[2]
    sph, inst = scene.winners(o, d, t_min, t_max)
    checked = []
    check = H1._check

    def counted(args, index, device):
        checked.append(tuple(name for name, *_ in args))
        return check(args, index, device)

    monkeypatch.setattr(H1, "_check", counted)
    tables = [("center", "radius", "material"),
              ("shading", "transform", "override")]
    call = lambda spheres: H1.hit_record(o, d, spheres, sph, scene.tlas,
                                         inst)
    call(scene.spheres)  # the recorded pass checked the tables
    assert len(checked) == 1      # the per-call tensors alone
    del checked[:]
    scene.tlas.transform.mul_(1.0)  # an in-place edit: a new version
    call(scene.spheres)
    assert checked[1:] == tables[1:]
    del checked[:]
    call(scene.spheres.replace(radius=scene.spheres.radius.clone()))
    assert checked[1:] == tables[:1]
