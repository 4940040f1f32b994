"""Step profile of one persistent render pass on the card.

    python -m mrt_torch.profile --scene sphere_grid
    MRT_TLAS_KERNEL=flat python -m mrt_torch.profile --scene lucy
    MRT_BG_COMPACT=1 MRT_TEX_COMPACT=1 python -m mrt_torch.profile --scene eve
    MRT_FILM_PEND=1 python -m mrt_torch.profile --scene cornell --nee
    python -m mrt_torch.profile --scene menger --steps 40

Renders one unprofiled pass to warm up, ``--passes`` more (their wall
times, the median the pass time), then one pass under
``torch.profiler`` inside the tracer's ``tracing(ranges=True)``
(``utils.profiling``), so that the program's own spans are the
profiler's ranges: each layer of the step (camera rays, intersection
with its voxel walk, shading, background, next-event estimation, film
deposit) and each lane sort (S1, torch.sort, S2; the auto rule sorts
sphere_grid, lucy and eve).  It prints the device time of each layer
(the kernels launched inside its range), of each hand kernel and of the
busiest kernels, the launches a step and the device's idle share (1 -
kernel time / unprofiled pass time), the DDA steps a wavefront step on
voxel scenes (the tracer's ``dda_steps`` counter; the steps are the
pass record's), then one JSON line with the same numbers.  --nee
attaches the scene's light table, --rr-depth turns Russian roulette on,
--sort-rays K sorts the lanes every K steps (0: never; default: the
auto rule), and --steps N
measures only the first N steps of each pass (rounded up to a multiple
of 8; for scenes whose profiled pass is too long, such as menger's voxel
walk).  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch


def _device_us(event, self_only=False):
    """Device microseconds of a profiler event (the attribute name moved
    between PyTorch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


LAYERS = (
    # (the program's span name, the module path and attribute it covers;
    # tools/pass_turns.py times the attribute from outside)
    ("L1 make_rays", "mrt_torch.integrator.persistent", "LanePool.make_rays"),
    ("L2 intersect", "mrt_torch.geometry.scene", "Scene.intersect"),
    ("L2v voxel DDA", "mrt_torch.geometry.voxels", "intersect"),
    ("L3 shade_hit", "mrt_torch.materials.shade", "shade_hit"),
    ("L3 background", "mrt_torch.geometry.scene",
     "Scene.background_eval_masked"),
    ("L3n sample_direct", "mrt_torch.materials.lights", "sample_direct"),
    ("L4 deposit", "mrt_torch.integrator.persistent", "deposit"),
    ("L4 deposit_pending", "mrt_torch.integrator.persistent",
     "deposit_pending"),
    ("L5s lane sorter", "mrt_torch.integrator.persistent", "sort_lanes"),
)
TOP = 15  # device kernels listed by device time


def one_pass(scene, camera, args):
    """One pass; with args.steps, stopped at the first termination check
    after that many steps ran (the pass record's count)."""
    from .integrator import persistent
    from .runtime.film import Film
    from .runtime.render import render_pass_persistent

    busy = persistent.LanePool.busy
    if args.steps is not None:
        persistent.LanePool.busy = lambda self, st: (
            self.record["steps"] < args.steps and busy(self, st))
    film = Film.create(args.width, args.height, device=camera.origin.device)
    try:
        return render_pass_persistent(scene, camera, film, 1, 0,
                                      width=args.width, height=args.height,
                                      max_depth=args.depth, samples=args.spp,
                                      pool=args.pool, rr_depth=args.rr_depth,
                                      sort_rays=args.sort_rays)
    finally:
        persistent.LanePool.busy = busy


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scene", default="sphere_grid")
    parser.add_argument("--nee", action="store_true",
                        help="next-event estimation (the scene's nee=True)")
    parser.add_argument("--rr-depth", type=int, default=None,
                        help="Russian roulette from this bounce on")
    parser.add_argument("--steps", type=int, default=None,
                        help="measure only the first N steps of a pass")
    parser.add_argument("--passes", type=int, default=1,
                        help="unprofiled passes timed (their median is "
                             "the pass time)")
    parser.add_argument("--sort-rays", type=int, default=None,
                        help="the lane sorter's cadence, 0 off (default: "
                             "the auto rule)")
    args = parser.parse_args(argv)
    # chip_smoke.py's main path.
    args.width, args.height, args.depth, args.spp, args.pool = (
        1920, 1080, 50, 2, 1 << 17)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from .ops._build import KERNELS
    from .scenes import get
    from .utils import profiling

    scene, camera = get(args.scene)(nee=args.nee).generate()
    one_pass(scene, camera, args)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.passes):
        t0 = time.perf_counter()
        one_pass(scene, camera, args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    dda = profiling.counters.get("dda_steps", 0)
    with profiling.tracing(ranges=True) as session, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass(scene, camera, args)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    steps = profiling.snapshot()["pass"][-1]["steps"]
    dda = profiling.counters.get("dda_steps", 0) - dda

    layer_names = {name for name, _, _ in LAYERS}
    names = layer_names | {s["name"] for s in session.spans}
    on_device = lambda e: str(e.device_type).endswith("CUDA")
    # Device-side events are the kernels and copies, and also each
    # range's span on the device timeline (gaps included), which is left
    # out.  A layer's device time is the kernels launched inside its
    # host-side range.
    device = [e for e in prof.key_averages()
              if on_device(e) and e.key not in names]
    kernel_us = sum(_device_us(e, self_only=True) for e in device)
    launches = sum(e.count for e in device)
    layers = dict.fromkeys(sorted(layer_names), 0.0)
    for e in prof.events():
        if e.name in layer_names and not on_device(e):
            layers[e.name] += _device_us(e) / 1e3
    # Summed over each kernel's template instances (B2's and B3's column
    # counts, B7's regimes).
    kernels, calls = {}, {}
    for e in device:
        for k, kernel in KERNELS.items():
            if re.search(kernel.pattern, e.key):
                kernels[k] = (kernels.get(k, 0.0)
                              + _device_us(e, self_only=True) / 1e3)
                calls[k] = calls.get(k, 0) + e.count
    out = dict(scene=args.scene, nee=args.nee, rr_depth=args.rr_depth,
               sort_rays=args.sort_rays,
               steps_limit=args.steps,
               film_pend=os.environ.get("MRT_FILM_PEND", ""),
               tlas_route=os.environ.get("MRT_TLAS_KERNEL", ""),
               compaction={k: os.environ.get(k, "") for k in (
                   "MRT_BG_COMPACT", "MRT_TEX_COMPACT")},
               width=args.width, height=args.height,
               depth=args.depth, spp=args.spp, pool=args.pool,
               device=torch.cuda.get_device_name(0),
               pass_s=wall, passes_s=walls, profiled_pass_s=profiled_wall,
               steps=steps,
               device_kernel_ms=kernel_us / 1e3,
               device_kernels_per_step=launches / max(steps, 1),
               # Kernel durations are not inflated by the profiler, the
               # host is: the unprofiled pass is the wall time to use.
               idle_share=1.0 - kernel_us / 1e6 / wall,
               layer_device_ms=layers, kernel_device_ms=kernels,
               kernel_calls=calls,
               dda_steps_per_step=dda / max(steps, 1))
    print(f"{args.scene} {args.width}x{args.height} depth {args.depth} spp "
          f"{args.spp} pool {args.pool}: pass {wall:.3f} s unprofiled ("
          + ", ".join(f"{w:.3f}" for w in walls) + "), "
          f"{profiled_wall:.3f} s profiled, {steps} steps, "
          f"{launches} device kernels, {kernel_us / 1e3:.1f} ms device time, "
          f"idle {out['idle_share']:.3f}, "
          f"{out['dda_steps_per_step']:.2f} DDA steps a step")
    for name, ms in layers.items():
        print(f"  {name}: {ms:.2f} ms")
    for name, ms in kernels.items():
        print(f"  kernel {name}: {ms:.2f} ms in {calls[name]} calls")
    top = sorted(device, key=lambda e: -_device_us(e, self_only=True))
    for e in top[:TOP]:
        us = _device_us(e, self_only=True)
        print(f"  {us / 1e3:9.2f} ms {e.count:7d} x {us / e.count:8.2f} us "
              f"{e.key[:100]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
