"""The port's tracer (``mrt_torch.utils.profiling``) on the CPU, at tiny
sizes: the coarse tier's records against counts made from outside, the
fine tier's spans, the off state's cost (no profiler range, no span),
the CLI's ``--profile-dir`` files, and the benchmark's readers of the
records."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

from mrt_torch import inverse
from mrt_torch.integrator import persistent
from mrt_torch.runtime.config import RenderConfig
from mrt_torch.runtime.driver import run
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass_persistent
from mrt_torch.scenes import get
from mrt_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 16, 9
LAYER_SPANS = ("L2 intersect", "L3 shade_hit", "L3 background",
               "L4 deposit", "L4 deposit_pending", "L3n sample_direct",
               "L2v voxel DDA", "L5s lane sorter")
READERS = ("host_us_per_step.frame", "drain_step_share.frame",
           "lane_occupancy.frame", "grad_host_ms.grad",
           "host_syncs_per_step.grad", "scene_build_s.setup")


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _scene(name="rtiow"):
    kw = dict(rtiow=dict(grid=2), sphere_grid=dict(dim=3),
              cornell=dict(nee=True))[name]
    return get(name)(aspect_ratio=W / H, **kw).generate(device="cpu")


def _pass(scene, camera, sort_rays=0, pend=False, samples=2, pool=48):
    film = Film.create(W, H, device="cpu")
    return render_pass_persistent(scene, camera, film, 1, 0, width=W,
                                  height=H, max_depth=5, samples=samples,
                                  pool=pool, pend=pend, sort_rays=sort_rays)


def _optimize(steps=2):
    scene, camera = _scene()
    centre = scene.spheres.center.clone()

    def apply(c):
        return scene.replace(spheres=scene.spheres.replace(center=c))

    target = inverse.render_image(scene, camera, 8, 6, spp=1,
                                  max_depth=2).detach()
    return inverse.optimize(apply, centre + 0.01, camera, 8, 6, target,
                            steps=steps, spp=1, max_depth=2)


def _image(tmp_path, **kw):
    config = RenderConfig(scene="rtiow", width=W, height=H, max_depth=3,
                          spp=2, samples_per_pass=2, denoise=True,
                          display_mode="denoise",
                          output=str(tmp_path / "out.png"), **kw)
    return run(config, log=lambda *a, **k: None, device="cpu")


def _refuse_ranges(monkeypatch):
    """A profiler range that the program opens raises (PyTorch's own,
    such as the optimizer's, open as they are)."""
    real = torch.autograd.profiler.record_function

    def guarded(*args, **kwargs):
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if caller.startswith("mrt_torch"):
            raise AssertionError(f"{caller} opened the range {args}")
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", guarded)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", guarded)


@pytest.fixture
def no_ranges(monkeypatch):
    """A profiler range the program opens, or any span, raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered")

    _refuse_ranges(monkeypatch)
    monkeypatch.setattr(profiling._Span, "__enter__", refuse)


@pytest.mark.parametrize("path", ["frame", "grad", "image"])
def test_off_state_enters_no_range_and_records_no_span(path, no_ranges,
                                                       tmp_path):
    if path == "frame":
        _pass(*_scene())
        assert profiling.snapshot()["pass"]
    elif path == "grad":
        _optimize(steps=1)
        assert profiling.snapshot()["grad_step"]
    else:
        _image(tmp_path)
        assert profiling.snapshot()["scene_build"]


def test_tracing_without_ranges_records_spans_but_no_range(monkeypatch):
    _refuse_ranges(monkeypatch)
    scene, camera = _scene()
    with profiling.tracing() as session:
        _pass(scene, camera)
    names = {s["name"] for s in session.spans}
    assert {"step", "L1 make_rays", "L2 intersect", "L3 shade_hit",
            "L3 background", "L4 deposit", "termination check"} <= names
    assert all(s["end_ns"] >= s["start_ns"] for s in session.spans)


def _counted(monkeypatch):
    """LanePool.step and .busy counted from outside; busy also keeps the
    active lanes and the queue's head each check read."""
    seen = dict(steps=0, checks=[])
    step, busy = persistent.LanePool.step, persistent.LanePool.busy

    def counted_step(self, *args, **kwargs):
        seen["steps"] += 1
        return step(self, *args, **kwargs)

    def counted_busy(self, st):
        seen["checks"].append((int((st["item"] < self.total).sum()),
                               int(st["next_work"]), seen["steps"],
                               self.total))
        return busy(self, st)

    monkeypatch.setattr(persistent.LanePool, "step", counted_step)
    monkeypatch.setattr(persistent.LanePool, "busy", counted_busy)
    return seen


@pytest.mark.parametrize("scene_name, sort_rays, pend", [
    ("rtiow", 0, False), ("rtiow", 0, True), ("sphere_grid", 4, False),
    ("sphere_grid", 1, False), ("cornell", 0, False)])
def test_pass_record_against_a_recount(monkeypatch, scene_name, sort_rays,
                                       pend):
    scene, camera = _scene(scene_name)
    seen = _counted(monkeypatch)
    syncs = profiling.snapshot()["host_syncs"].get("termination check", 0)
    _pass(scene, camera, sort_rays=sort_rays, pend=pend)
    rec = profiling.snapshot()["pass"][-1]
    checks = seen["checks"]
    # Steps: LanePool.step's calls; checks: one read each.
    assert rec["steps"] == seen["steps"] > 0
    assert rec["checks"] == len(checks) == rec["syncs"]["termination check"]
    assert (profiling.snapshot()["host_syncs"]["termination check"] - syncs
            == len(checks))
    assert rec["sorts"] == (rec["steps"] // sort_rays if sort_rays else 0)
    # Drain: the steps after the first check that found the queue empty.
    empty = [at for _, head, at, total in checks if head >= total]
    assert rec["drain_steps"] == seen["steps"] - empty[0]
    assert rec["active"] == sum(n for n, _, _, _ in checks)
    assert rec["pool"] == 48 and rec["work_items"] == W * H * 2
    assert not rec["profiled"] and rec["wall_ns"] > 0


def test_a_drain_shows_where_the_pool_outlives_the_queue():
    # Deep paths and a pool near the work: the queue empties while lanes
    # still bounce, and occupancy falls below 1.
    scene, camera = _scene("sphere_grid")
    film = Film.create(W, H, device="cpu")
    render_pass_persistent(scene, camera, film, 1, 0, width=W, height=H,
                           max_depth=50, samples=1, pool=W * H)
    rec = profiling.snapshot()["pass"][-1]
    assert 0 < rec["drain_steps"] <= rec["steps"]
    assert 0 < rec["active"] / (rec["pool"] * rec["checks"]) < 1


def test_grad_step_record_counts_its_syncs():
    _, losses = _optimize(steps=2)
    recs = profiling.snapshot()["grad_step"]
    assert [r["step"] for r in recs] == [0, 1]
    for rec in recs:
        # The loss, and B1's group build's copies of centres and radii.
        assert rec["syncs"] == {"grad loss": 1, "B1 group build": 2}
        assert rec["parts"]["B1 group build"] > 0
        assert 0 <= sum(rec["sync_ns"].values()) <= rec["wall_ns"]
        assert rec["gc_collections"] >= 0 and "device_allocs" not in rec
    assert len(losses) == 2


def test_to_host_counts_reads_by_site():
    x = torch.arange(3)
    assert torch.equal(profiling.to_host(x, "here"), x)
    profiling.to_host(x, "here")
    snap = profiling.snapshot()
    assert snap["host_syncs"] == {"here": 2}
    assert snap["host_sync_ns"]["here"] >= 0


def test_unit_keeps_a_record_only_when_its_block_ends():
    with profiling.unit("library", built=False) as rec:
        rec["extra"] = 1
        profiling.count("things", 2)
    with pytest.raises(RuntimeError):
        with profiling.unit("library"):
            raise RuntimeError
    recs = profiling.snapshot()["library"]
    assert len(recs) == 1 and recs[0]["extra"] == 1
    assert profiling.snapshot()["counters"] == {"things": 2}


def test_a_span_holds_the_profiled_op_it_wraps():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1000)
    with profiling.tracing() as session, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.add(x, 1.0)
    outer, inner = session.spans
    assert inner["parent"] == 0 and outer["parent"] is None
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::add"]
    assert starts and all(inner["start_ns"] <= s <= inner["end_ns"]
                          for s in starts)


def test_profile_dir_writes_spans_and_counters(tmp_path):
    prof = tmp_path / "prof"
    _image(tmp_path, profile_dir=str(prof), persistent=True)
    with open(prof / "spans.json") as f:
        events = json.load(f)["traceEvents"]
    with open(prof / "counters.json") as f:
        counters = json.load(f)
    with open(prof / "trace.json") as f:
        ranges = {e.get("name") for e in json.load(f)["traceEvents"]}
    names = [e["name"] for e in events]
    parent = [e["args"]["parent"] for e in events]

    def under(i, name):
        while parent[i] is not None:
            i = parent[i]
            if names[i] == name:
                return True
        return False

    layers = [i for i, n in enumerate(names) if n in LAYER_SPANS]
    assert layers and all(under(i, "step") for i in layers)
    # Camera rays: in each step, and once outside to fill the pool.
    rays = [i for i, n in enumerate(names) if n == "L1 make_rays"]
    assert sum(not under(i, "step") for i in rays) == len(
        counters["pass"]) == 1
    assert {"scene build", "AOV pre-pass", "render pass", "denoiser",
            "png_encode", "PNG write", "step"} <= set(names)
    assert {"step", "L2 intersect", "render pass"} <= ranges
    assert counters["pass"][0]["profiled"]
    assert counters["host_syncs"]["film to PNG"] == 1


def _reader(name):
    sys.path.insert(0, ROOT)
    try:
        from benchmark.harness import spec
    finally:
        sys.path.remove(ROOT)
    return spec.load([os.path.join(ROOT, "benchmark")], "metrics", name)


def test_the_benchmark_readers_read_the_records():
    from torch.profiler import ProfilerActivity, profile

    readers = {name: _reader(name) for name in READERS}
    assert all(r.read({}) is None for r in readers.values())
    scene, camera = _scene()
    _pass(scene, camera, pool=W * H)          # the unprofiled pass
    _optimize(steps=2)
    with profile(activities=[ProfilerActivity.CPU]):
        _pass(scene, camera, pool=48)         # profiled: not read
    snap = profiling.snapshot()
    p, g = snap["pass"][0], snap["grad_step"][-1]
    got = {name: r.read({}) for name, r in readers.items()}
    assert got["host_us_per_step.frame"] == pytest.approx(
        (p["wall_ns"] - p["sync_ns"]["termination check"]) / p["steps"]
        / 1e3)
    assert got["drain_step_share.frame"] == p["drain_steps"] / p["steps"]
    assert got["lane_occupancy.frame"] == p["active"] / (W * H * p["checks"])
    assert 0 < got["lane_occupancy.frame"] <= 1
    assert got["grad_host_ms.grad"] == pytest.approx(
        (g["wall_ns"] - sum(g["sync_ns"].values())) / 1e6)
    assert got["host_syncs_per_step.grad"] == 3
    assert got["scene_build_s.setup"] == snap["scene_build"][0][
        "wall_ns"] / 1e9
    assert all(v is not None and v >= 0 for v in got.values())


@pytest.mark.parametrize("records, want", [
    ((), None),                                          # no pass
    ((dict(steps=8, draw_launches=17),), 17 / 8),
    ((dict(steps=8),), None),                            # a program without R1
    ((dict(steps=0, draw_launches=0),), None),
    ((dict(steps=16, draw_launches=33), dict(steps=8, draw_launches=17,
                                              profiled=True)), 33 / 16),
])
def test_the_draw_launch_reader(records, want):
    # draw_launches_per_step.frame reads the newest unprofiled pass record.
    reader = _reader("draw_launches_per_step.frame")
    for fields in records:
        fields = dict(fields)
        profiled = fields.pop("profiled", False)
        with profiling.unit("pass", **fields) as rec:
            pass
        rec["profiled"] = profiled
    assert reader.read({}) == want


@pytest.mark.parametrize("records, want", [
    ((), None),                                          # no pass
    ((dict(steps=8, shade_launches=8),), 1.0),
    ((dict(steps=8),), None),                            # a program without M1
    ((dict(steps=8, shade_launches=0),), 0.0),           # the eager route
    ((dict(steps=0, shade_launches=0),), None),
    ((dict(steps=16, shade_launches=16), dict(steps=8, shade_launches=0,
                                              profiled=True)), 1.0),
])
def test_the_shade_launch_reader(records, want):
    # shade_launches_per_step.frame reads the newest unprofiled pass
    # record.
    reader = _reader("shade_launches_per_step.frame")
    for fields in records:
        fields = dict(fields)
        profiled = fields.pop("profiled", False)
        with profiling.unit("pass", **fields) as rec:
            pass
        rec["profiled"] = profiled
    assert reader.read({}) == want


@pytest.mark.parametrize("records, want", [
    ((), None),                                          # no pass
    ((dict(steps=8, hit_launches=16),), 2.0),            # with NEE
    ((dict(steps=8),), None),                            # a program without H1
    ((dict(steps=8, hit_launches=0),), 0.0),             # the eager chain
    ((dict(steps=0, hit_launches=0),), None),
    ((dict(steps=16, hit_launches=16), dict(steps=8, hit_launches=0,
                                            profiled=True)), 1.0),
])
def test_the_hit_launch_reader(records, want):
    # hit_launches_per_step.frame reads the newest unprofiled pass record.
    reader = _reader("hit_launches_per_step.frame")
    for fields in records:
        fields = dict(fields)
        profiled = fields.pop("profiled", False)
        with profiling.unit("pass", **fields) as rec:
            pass
        rec["profiled"] = profiled
    assert reader.read({}) == want


@pytest.mark.parametrize("scene_name, per_step", [("rtiow", 1),
                                                  ("sphere_grid", 1),
                                                  ("cornell", 2)])
def test_a_pass_record_counts_the_hit_record_launches(monkeypatch,
                                                      scene_name, per_step):
    # On the CPU H1's wrapper runs its plain version and launches nothing;
    # counting each of its calls as a launch, as on the card, the pass
    # record holds one a step (two with NEE: the shadow ray's), which the
    # reader gives, and the snapshot's kernels name H1.
    from mrt_torch.ops import hits

    scene, camera = _scene(scene_name)
    _pass(scene, camera)
    assert profiling.snapshot()["pass"][-1]["hit_launches"] == 0
    assert "H1" in profiling.snapshot()["kernels"]
    wrapper = hits.hit_record

    def counted(*args):
        profiling.launch_counts["H1"] += 1
        return wrapper(*args)

    monkeypatch.setattr(hits, "hit_record", counted)
    counts = profiling.launch_counts
    monkeypatch.setitem(counts, "H1", counts["H1"])
    _pass(scene, camera)
    rec = profiling.snapshot()["pass"][-1]
    assert rec["hit_launches"] == per_step * rec["steps"] > 0
    assert _reader("hit_launches_per_step.frame").read({}) == per_step
    assert profiling.snapshot()["kernels"]["H1"] == counts["H1"] > 0


@pytest.mark.parametrize("scene_name", ["rtiow", "sphere_grid"])
def test_a_pass_record_counts_two_draws_a_step(monkeypatch, scene_name):
    # With R1's wrapper counting each call as a launch, as on the card
    # (on the CPU it runs its plain version and launches nothing), a pass
    # draws once to fill the pool and twice a step (the camera and
    # scatter), and its film and depth equal the uncounted pass's.
    from mrt_torch.math import rng

    scene, camera = _scene(scene_name)
    plain = _pass(scene, camera, sort_rays=4 * (scene_name != "rtiow"))
    assert profiling.snapshot()["pass"][-1]["draw_launches"] == 0
    wrapper = rng.pcg4d_draw

    def counted(ray_id, seed, salt, draw):
        profiling.launch_counts["R1"] += 1
        return wrapper(ray_id, seed, salt, draw)

    monkeypatch.setattr(rng, "pcg4d_draw", counted)
    counts = profiling.launch_counts
    monkeypatch.setitem(counts, "R1", counts["R1"])
    card = _pass(scene, camera, sort_rays=4 * (scene_name != "rtiow"))
    rec = profiling.snapshot()["pass"][-1]
    assert rec["draw_launches"] == 2 * rec["steps"] + 1
    assert _reader("draw_launches_per_step.frame").read({}) == (
        2 + 1 / rec["steps"])
    assert torch.equal(plain.sum, card.sum)
    assert torch.equal(plain.depth_sum, card.depth_sum)


@pytest.mark.parametrize("scene_name", ["cornell", "rtiow"])
def test_nee_lanes_against_a_recount_of_the_light_samples(monkeypatch,
                                                          scene_name):
    # With a light table the pass record counts the lanes that took a
    # light sample over all its steps, read at the checks it already
    # makes; without one the field is absent.
    scene, camera = _scene(scene_name)
    seen = []
    real = persistent.next_event

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        if out[1] is not None:
            seen.append(int(out[1].sum()))
        return out

    monkeypatch.setattr(persistent, "next_event", counted)
    _pass(scene, camera)
    rec = profiling.snapshot()["pass"][-1]
    if scene_name == "cornell":
        assert rec["nee_lanes"] == sum(seen) > 0
        assert len(seen) == rec["steps"]
    else:
        assert "nee_lanes" not in rec and not seen
    assert rec["syncs"] == {"termination check": rec["checks"]}


def test_the_scene_build_record_holds_the_light_table():
    get("cornell")(aspect_ratio=W / H).generate(device="cpu")
    _scene("cornell")
    plain, nee = profiling.snapshot()["scene_build"][-2:]
    assert "lights" not in plain and "light table" not in plain["parts"]
    assert nee["lights"] == 12 and nee["parts"]["light table"] > 0
    assert nee["parts"]["light table"] <= nee["wall_ns"]


@pytest.mark.parametrize("record, want", [
    ({}, None),
    (dict(range_calls={"L3n sample_direct": 40}, kernel_s=0.9,
          ranges_ms={"L3n sample_direct": 12.5}), 12.5),
    (dict(range_calls={"L2 intersect": 40}, kernel_s=0.9,
          ranges_ms={"L3n sample_direct": 0.0}), None),   # no light sampled
])
def test_the_nee_ms_reader(record, want):
    assert _reader("nee_ms.frame").read(record) == want


@pytest.mark.parametrize("records, want", [
    ((), None),                                          # no pass
    ((dict(steps=8, pool=64, nee_lanes=128),), 128 / (8 * 64)),
    ((dict(steps=8, pool=64),), None),                   # no light table
    ((dict(steps=16, pool=64, nee_lanes=256),
      dict(steps=8, pool=64, nee_lanes=9, profiled=True)), 256 / (16 * 64)),
])
def test_the_nee_lane_share_reader(records, want):
    # nee_lane_share.frame reads the newest unprofiled pass record.
    reader = _reader("nee_lane_share.frame")
    for fields in records:
        fields = dict(fields)
        profiled = fields.pop("profiled", False)
        with profiling.unit("pass", **fields) as rec:
            pass
        rec["profiled"] = profiled
    assert reader.read({}) == want


def test_the_nee_lane_share_of_a_pass():
    scene, camera = _scene("cornell")
    _pass(scene, camera)
    rec = profiling.snapshot()["pass"][-1]
    share = _reader("nee_lane_share.frame").read({})
    assert share == rec["nee_lanes"] / (rec["steps"] * 48)
    # A lane takes at most one light sample a step.
    assert 0 < share < 1
