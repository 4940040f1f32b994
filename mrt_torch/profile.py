"""Step profile of one persistent render pass on the card.

    python -m mrt_torch.profile --scene sphere_grid
    MRT_TLAS_KERNEL=flat python -m mrt_torch.profile --scene lucy
    MRT_BG_COMPACT=1 MRT_TEX_COMPACT=1 python -m mrt_torch.profile --scene eve
    MRT_FILM_PEND=1 python -m mrt_torch.profile --scene cornell --nee
    python -m mrt_torch.profile --scene menger --steps 40

Renders one unprofiled pass to warm up, ``--passes`` more (their wall
times, the median the pass time), then one pass under
``torch.profiler`` with a ``record_function`` range around each layer of
the step (camera rays, intersection with its voxel walk, shading,
background, next-event estimation, film deposit) and around each lane
sort (S1, torch.sort, S2; the auto rule sorts sphere_grid, lucy and
eve), and prints the device time of each layer (the kernels
launched inside its range), of each hand kernel and of the busiest
kernels, the launches a step and the device's idle share (1 - kernel
time / unprofiled pass time), the DDA steps a wavefront step on voxel
scenes, then one JSON line with the same numbers.  --nee attaches the
scene's light table, --rr-depth turns Russian roulette on, --sort-rays
K sorts the lanes every K steps (0: never; default: the auto rule), and
--steps N
measures only the first N steps of each pass (rounded up to a multiple
of 8; for scenes whose profiled pass is too long, such as menger's voxel
walk).  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
    # (range name, module path, attribute)
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
# Each hand kernel's device name, a regular expression: B2 and B4 are
# instances of one template, deposit_kernel<C, drop, pend>, told apart by
# pend (demangled as the profiler shows it, or mangled).
KERNELS = {"B1": "nearest_t_kernel",
           "B2": r"deposit_kernel(<\d+, \w+, false>|ILi\d+ELb[01]ELb0E)",
           "B3": "row_gather_kernel",
           "B4": r"deposit_kernel(<4, false, true>|ILi4ELb0ELb1E)",
           "B5": "sphere_bvh_kernel", "B6": "tri_bvh_kernel",
           "B7": "tlas_kernel", "S1": "sort_key_kernel",
           "S2": "permute_lanes_kernel"}


def _wrap(name, fn):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def instrumented():
    """Install the layer ranges; restore the functions on exit."""
    import importlib

    saved = []
    for name, module, attr in LAYERS:
        owner = importlib.import_module(module)
        *path, leaf = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        saved.append((owner, leaf, getattr(owner, leaf)))
        setattr(owner, leaf, _wrap(name, getattr(owner, leaf)))
    try:
        yield
    finally:
        for owner, leaf, fn in reversed(saved):
            setattr(owner, leaf, fn)


def one_pass(scene, camera, args):
    """One pass; with args.steps, stopped once that many steps ran."""
    from .integrator import persistent
    from .runtime.film import Film
    from .runtime.render import render_pass_persistent

    busy = persistent.LanePool.busy
    if args.steps is not None:
        ran = [0]
        step = persistent.LanePool.step

        def counted(self, *a, **k):
            ran[0] += 1
            return step(self, *a, **k)

        persistent.LanePool.step = counted
        persistent.LanePool.busy = lambda self, st: (ran[0] < args.steps
                                                     and busy(self, st))
    film = Film.create(args.width, args.height, device=camera.origin.device)
    try:
        return render_pass_persistent(scene, camera, film, 1, 0,
                                      width=args.width, height=args.height,
                                      max_depth=args.depth, samples=args.spp,
                                      pool=args.pool, rr_depth=args.rr_depth,
                                      sort_rays=args.sort_rays)
    finally:
        if args.steps is not None:
            persistent.LanePool.step = step
            persistent.LanePool.busy = busy


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scene", default="sphere_grid")
    parser.add_argument("--nee", action="store_true",
                        help="next-event estimation (attach_lights)")
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

    from .geometry import voxels
    from .geometry.scene import attach_lights
    from .integrator import persistent
    from .scenes import get

    scene, camera = get(args.scene)().generate()
    if args.nee:
        scene = attach_lights(scene)
    one_pass(scene, camera, args)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.passes):
        t0 = time.perf_counter()
        one_pass(scene, camera, args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    steps = [0]
    step = persistent.LanePool.step

    def counted(self, *a, **k):
        steps[0] += 1
        return step(self, *a, **k)

    persistent.LanePool.step = counted
    voxels.counts.update(calls=0, steps=0)
    try:
        with instrumented(), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_pass(scene, camera, args)
            torch.cuda.synchronize()
            profiled_wall = time.perf_counter() - t0
    finally:
        persistent.LanePool.step = step

    names = {name for name, _, _ in LAYERS}
    on_device = lambda e: str(e.device_type).endswith("CUDA")
    # Device-side events are the kernels and copies, and also each
    # range's span on the device timeline (gaps included), which is left
    # out.  A layer's device time is the kernels launched inside its
    # host-side range.
    device = [e for e in prof.key_averages()
              if on_device(e) and e.key not in names]
    kernel_us = sum(_device_us(e, self_only=True) for e in device)
    launches = sum(e.count for e in device)
    layers = dict.fromkeys(sorted(names), 0.0)
    for e in prof.events():
        if e.name in names and not on_device(e):
            layers[e.name] += _device_us(e) / 1e3
    # Summed over each kernel's template instances (B2's and B3's column
    # counts, B7's regimes).
    kernels, calls = {}, {}
    for e in device:
        for k, v in KERNELS.items():
            if re.search(v, e.key):
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
               steps=steps[0],
               device_kernel_ms=kernel_us / 1e3,
               device_kernels_per_step=launches / max(steps[0], 1),
               # Kernel durations are not inflated by the profiler, the
               # host is: the unprofiled pass is the wall time to use.
               idle_share=1.0 - kernel_us / 1e6 / wall,
               layer_device_ms=layers, kernel_device_ms=kernels,
               kernel_calls=calls,
               dda_steps_per_step=voxels.counts["steps"] / max(steps[0], 1))
    print(f"{args.scene} {args.width}x{args.height} depth {args.depth} spp "
          f"{args.spp} pool {args.pool}: pass {wall:.3f} s unprofiled ("
          + ", ".join(f"{w:.3f}" for w in walls) + "), "
          f"{profiled_wall:.3f} s profiled, {steps[0]} steps, "
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
