"""The reading of a profile, from a synthetic profiler table, and the
instruments put around the program's layers."""

import pytest
import torch

from benchmark.harness import trace

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"


class Event:
    """A raw profiler event: its fields behind methods, times in ns."""

    def __init__(self, name, device, start, end, corr=0):
        self._v = dict(name=name, device_type=device, start_ns=start,
                       duration_ns=end - start, correlation_id=corr)

    def __getattr__(self, key):
        return lambda: self._v[key]


def table():
    """Host: a step (0-100 ns) holding an intersect range (10-40) and a
    deposit range (60-70); a termination check (100-130); runtime calls
    launching operations 1-5 at 12, 15, 41, 65 and 101.  Device: B1
    (20-30) and an elementwise op (45-50) from the intersect range,
    another (48-55, overlapping it) from the step, B2 (75-78) from the
    deposit, a copy (128-131) from the check; the intersect range's own
    span on the device, which is not an operation."""
    return [
        Event("step", CPU, 0, 100), Event("L2 intersect", CPU, 10, 40),
        Event("L4 deposit", CPU, 60, 70),
        Event("termination check", CPU, 100, 130),
        *[Event("cudaLaunchKernel", CPU, t, t + 1, c)
          for c, t in ((1, 12), (2, 15), (3, 41), (4, 65), (5, 101))],
        Event("L2 intersect", CUDA, 20, 30),
        Event("void nearest_t_kernel<true>(...)", CUDA, 20, 30, 1),
        Event("add_kernel", CUDA, 45, 50, 2),
        Event("add_kernel", CUDA, 48, 55, 3),
        Event("void deposit_kernel<4, false, false>(...)", CUDA, 75, 78, 4),
        Event("Memcpy DtoH", CUDA, 128, 131, 5),
    ]


NAMES = ["step", "L2 intersect", "L4 deposit", "termination check"]


def test_read_places_launches_in_ranges_and_sums_busy_time():
    rec = trace.read(table(), NAMES)
    assert rec["ranges_ms"] == pytest.approx({
        "step": 25e-6, "L2 intersect": 15e-6, "L4 deposit": 3e-6,
        "termination check": 3e-6})
    assert rec["kernels_ms"] == pytest.approx({"B1": 10e-6, "B2": 3e-6})
    assert rec["launches"] == 5 and rec["unplaced"] == 0
    assert rec["kernel_s"] == pytest.approx(28e-9)  # 10 + 5 + 7 + 3 + 3
    assert rec["busy_s"] == pytest.approx(26e-9)    # the overlap once


def test_idle_gaps_go_to_the_innermost_range_at_their_middle():
    rec = trace.read(table(), NAMES)
    gaps = dict(rec["breakdown"]["idle_gaps"])
    # 0-20, before the first operation: middle 10 in the intersect range,
    # as is 30-45's 37.5; 55-75: middle 65 in the deposit range; 78-128:
    # middle 103 in the termination check.
    assert gaps == pytest.approx({"L2 intersect": 35e-9,
                                  "L4 deposit": 20e-9,
                                  "termination check": 50e-9})
    ops = rec["breakdown"]["device_ops"]
    assert ops[0][0] == "add_kernel" and ops[0][1] == pytest.approx(12e-9)


def test_the_idle_tail_after_the_last_operation_is_a_gap():
    """A job that ends on the host (an image's PNG encoder) leaves the
    device idle from its last operation to the host's last event."""
    rec = trace.read([Event("denoiser", CPU, 0, 10),
                      Event("cudaLaunchKernel", CPU, 1, 2, 1),
                      Event("png_encode", CPU, 10, 50),
                      Event("k", CUDA, 2, 6, 1)], ["denoiser", "png_encode"])
    assert rec["breakdown"]["idle_gaps"] == [["png_encode", 44e-9],
                                             ["denoiser", 2e-9]]
    assert rec["busy_s"] == pytest.approx(4e-9)


def test_an_operation_with_no_launch_is_placed_by_its_start():
    rec = trace.read([Event("L2 intersect", CPU, 0, 5),
                      Event("k", CUDA, 2, 3, 9), Event("k", CUDA, 15, 16)],
                     ["L2 intersect"])
    assert rec["unplaced"] == 2
    assert rec["ranges_ms"] == pytest.approx({"L2 intersect": 1e-6})
    # 3-15 after the range; 0-2, before the first operation, in it.
    assert rec["breakdown"]["idle_gaps"] == [["outside any range", 12e-9],
                                             ["L2 intersect", 2e-9]]


def readers():
    from benchmark.harness import spec

    return {m["name"]: spec.Spec().module("metrics", m["name"])
            for m in spec.Spec().data["per_layer"]}


def test_the_frame_readers_from_a_record():
    r = dict(kernel_s=0.15, pass_s=1.0, launches=6300, steps=10,
             ranges_ms={"L1 make_rays": 4.0, "L2 intersect": 8.0,
                        "L3 shade_hit": 10.0, "L3 background": 1.0,
                        "L4 deposit": 0.5, "L5s lane sorter": 0.0},
             range_calls={"L1 make_rays": 10, "L2 intersect": 10,
                          "L3 shade_hit": 10, "L3 background": 10,
                          "L4 deposit": 10},
             kernels_ms={"B1": 2.0}, kernel_bytes={"B1": 134_000_000},
             kind="NVIDIA H100 80GB HBM3")
    read = {name: mod.read(r) for name, mod in readers().items()}
    assert read["device_idle_share.frame"] == pytest.approx(0.85)
    assert read["launches_per_step.frame"] == 630
    assert read["steps_per_pass.frame"] == 10
    assert read["shade_ms.frame"] == 11.0
    assert read["deposit_ms.frame"] == 0.5
    # 134 MB at 3.35 TB/s is 40 µs, against 2 ms: 2%.
    assert read["b1_roofline"] == pytest.approx(2.0)
    # What the job left nothing for reads nothing, never 0.
    assert read["sort_ms.frame"] is None
    assert read["b5_roofline"] is None
    cpu = dict(r, kernel_s=0.0, kind="cpu")
    assert readers()["make_rays_ms.frame"].read(cpu) is None
    assert readers()["b1_roofline"].read(cpu) is None


def test_instruments_count_calls_and_are_removed(tiny):
    from mrt_torch.integrator import persistent
    from mrt_torch.ops import spheres

    job = tiny.module("jobs", "frame")
    state = job.setup(tiny.cell("rtiow_1080p.frame_spp8"), 5, torch.device(
        "cpu"))
    before = (persistent.LanePool.step, persistent.deposit,
              spheres.nearest_t)
    tally = {}
    with trace.instrumented(tally):
        state.render(0)
    assert (persistent.LanePool.step, persistent.deposit,
            spheres.nearest_t) == before
    calls = tally["calls"]
    assert calls["step"] == calls["L4 deposit"] == calls["L2 intersect"] > 0
    # B1's bytes: 32 a ray (o, d in, t and index out) and its tables.
    assert tally["bytes"]["B1"] > 32 * 512 * calls["step"]
