#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``mrt_torch``) on one card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA device.
Each phase prints one line:

  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from mrt_torch/csrc (one nvcc a source,
     all started together), with each kernel's registers, stack frame,
     spills and static shared memory from ptxas's report;
  3. kernel B1 (sphere nearest hit, two levels: groups of 32 spheres
     culled a warp at a time) against its plain PyTorch version, bit for
     bit, x 484 spheres, on 2^17 RTIOW camera and first-bounce rays and on
     the rays of steps 2 and 64 of phase 6's pass (run after it), with the
     work a ray (pair and box tests) from its grouped walk's plain model;
  4. the card's launch floor (a one-element add_ replayed in a CUDA graph,
     as the kernels are timed); kernel B2 (film segment-add) against its
     plain version, 2^17 lanes into a 1920x1080x4 film, beside
     Tensor.index_add_, and as compaction's placer (2^17 lanes, ~70%
     masked, the first 32,768 at their prefix positions, 3 columns, the
     mask read by the kernel): bit-equal; the host time of one call of
     the B2 and B3 wrappers and of a compaction round;
  5. the rtiow_24 golden (tests/goldens) rendered through the port on
     the card, by the wavefront and the persistent integrator;
  6. the RTIOW main path: one render_pass_persistent of RTIOW at
     1920x1080, depth 50, spp 2, pool 2^17, with the kernels' launch
     counts;
  7. kernel B5 (sphere-BVH closest hit) against its plain version walking
     the same octant order, bit for bit (the escape order's winners on
     99.9% of rays), x 10,000 spheres, on 2^17 sphere_grid camera and
     first-bounce rays and on the rays of steps 2 and 64 of phase 10's
     pass (run after it), with the plain walk's work a ray and its warps'
     counts (iterations, lanes at a leaf, the lane loop's leaf steps);
  8. kernel B7 (two-level TLAS closest hit) against its plain version on
     2^17 camera and first-bounce rays each of cornell, playground, eve
     and lucy (lucy's tables in shared memory; each set of tables that
     fits also timed in the other regime), and on rays through an
     8,000-instance TLAS whose tables (1,987,552 B) are past the card's
     shared memory (global memory, B8's regime); work counted in the
     kernel's order and in the escape order;
  9. the cornell_24 golden through both integrators on the card;
 10. the slice's main path: one render_pass_persistent of sphere_grid
     (10,000 spheres under a BVH, an instanced ground cube) at 1920x1080,
     depth 50, spp 2, pool 2^17, with the kernels' launch counts;
 11. kernel B6 (triangle-BVH closest hit) against its plain version on
     2^17 playground camera and first-bounce rays through its world-
     flattened BVH (210 triangles, 15 nodes), and on 2^17 lucy rays
     through its 16 flat parts in one launch (the forest), against the
     reference's fold of one walk a part;
 12. the meshes-from-files main paths: one render_pass_persistent each of
     lucy (121 statues, SAH BVH) and playground (OBJ level, glass
     platform, posed character) at 1920x1080, depth 50, spp 2, pool
     2^17, on the two-level route (B7) and with MRT_TLAS_KERNEL=flat (B6:
     playground's flat set, lucy's flat parts, one launch a step), and
     the two routes' mean radiance held within 1% of each other on each
     scene.
 13. kernel B3 (row gather, the expand half of lane compaction) against
     its plain version at the eve fleet's compaction shapes (2^17 lanes,
     32,768 rows; 1, 2, 3, 4 and 10 columns with indices out of range on
     some lanes, and 3 and 4 columns masked as expand_rows calls it):
     bit-equal, beside Tensor.index_select with the mask;
 14. the goldens of the texture slice through both integrators on the
     card: textured_24 (atlas, bilinear, alpha re-cast), eve_ball_24 (EVE
     decode, palettes, glow, normal maps), volume_24 (sphere and mesh
     bounds) under the C2 rule, menger2_24 (cube map, TLAS) under C10's
     (ROADMAP C);
 15. the texture slice's main path: one render_pass_persistent of the eve
     fleet (37 instances, a fog volume, a sun sphere, the cube-map
     environment, EVE materials) at 1920x1080, depth 50, spp 2, pool
     2^17, once as it is (B1, B7, B2 and no other kernel) and once with
     MRT_BG_COMPACT=1 MRT_TEX_COMPACT=1 (B1, B7, B2, B3); the two films'
     bounce counts equal, their radiance within f32 reassociation;
 16. kernel B4 (the pend film mode's masked deposit) against its plain
     version, 2^17 lanes into a 1920x1080x4 film with ~1/3 of them dying,
     beside Tensor.index_add_ of the masked values, then on 2^17 - 37
     lanes (not a multiple of the block), with every lane dying and with
     none: the film within 1e-4 of its largest value, the bounce-count
     column and the rows of one deposit bit-equal;
 17. the goldens of the lights and voxels slice through both integrators
     on the card: cornell_nee_24 (NEE with MIS) under the C2 rule, also
     through the pend film mode (B4), and menger2_voxel_24 (the voxel
     DDA) under C10's;
 18. the slice's main paths at 1920x1080, depth 50, spp 2, pool 2^17:
     cornell with next-event estimation four times: on the default film
     (B1, B7, B2, no B4), with MRT_FILM_PEND=1 (B1, B7, B4, no B2), and
     both again with rr_depth=3; the film modes' bounce counts equal and
     radiance within f32 reassociation, Russian roulette's bounces no more
     than without; then menger at its defaults (level 5, voxel=True: 243^3
     cells walked by the DDA, the ground through B7, B2), with its DDA
     steps a wavefront step;
 19. the probes P1-P3 (``python -m mrt_torch.tools.probe_stream``): P1
     against its closed form bit for bit, its four pages in flight at
     once (bulk copies, an mbarrier a page) arriving in page order, with
     each page's arrival ns; P2 visiting all 1,024 chain entries through
     a paged shared-memory cache (each page one bulk copy behind an
     mbarrier; the fills it counts equal to the cache's plain model), L2
     and shared memory, with the ns of a dependent step of each; P3
     succeeding up to the card's opt-in shared memory a block and refused
     past it, its sizes asked largest first, then smallest first (its
     attribute raised once, at the first call); each kernel timed by
     CUDA-graph replay beside its plain version, P3 also as called;
 20. the gradient path (``mrt_torch.inverse``): tests/test_grad.py's
     albedo recovery (12x12, 60 Adam steps; the loss below 0.6 of the
     first, the albedo within 0.08); one forward and backward pass of the
     L2 loss of RTIOW at 1920x1080, spp 1, depth 6, with its albedo rows
     and 484 sphere centres as parameters, against a target with the
     albedos perturbed: forward and backward ms (CUDA events, wall
     clock), peak device bytes, B1's launches in the forward and in the
     checkpoint's recompute (once a bounce each, no other kernel), all
     gradients finite, the recomputed roots bit-equal to B1's t; a second
     1080p pass records the inputs of its 12 searches, and
     nearest_t_plain on the same inputs on the card must give B1's t and
     index bit for bit, the recomputed roots B1's t on every hit lane;
     the gather's backward at that shape, index_select (the path's)
     beside indexing; kernels a recovery step (torch.profiler); then the
     same camera at 256x144 with B1's winners and with nearest_t_plain's
     on the card: winners bit-equal, gradients within 1e-5 of the
     largest;
 21. the user's entry point (``mrt_torch.__main__``): ``main`` in-process
     as ``python -m mrt_torch --scene rtiow`` at 1920x1080, depth 50,
     ``--spp 8 --samples-per-pass 4 --denoise --display-mode denoise
     --checkpoint``, then resumed from that checkpoint to ``--spp 16``:
     the checkpoint and the film at 8 then 16 samples, B1 once a step and
     16 times in the AOV pre-pass, B2 once a step and no other kernel, the
     PNG equal to the film's DENOISE bytes; the five display modes
     exported and decoded by ``load_png``; the denoiser at 1080p (ms, device
     kernels, peak bytes, its output finite in [0, 1]) and on the card
     against the CPU on artifacts/denoise_buffers.npz (1e-5); png_encode at
     1080p; the AOV pre-pass of rtiow, sphere_grid and lucy at 1080p (ms,
     launches: 16 of each of its kernels), its first and last batches'
     B1, B5 and B7 winners against the plain versions on the card (B1 and
     B5 in their own order bit-equal, B5 and B7 >= 99.9% against the
     escape order), the whole frame at 256x144 against the port's CPU run
     (1e-5; the BVH walks may keep another winner on 0.1% of pixels, C15);
     ``serve`` at 320x180 in a thread (/status, /frame.png decoded, keys 2
     and e, the stop event); ``python -X importtime -m mrt_torch`` at
     320x180, spp 2, without ``--device`` as a subprocess (on the card, no
     PIL, JAX or mrt imported; without a visible card it refuses);
 22. the sharded paths (``mrt_torch.parallel``): (a) a one-process NCCL
     group, mesh (1, 1): ``render_sharded(persistent=True)`` of RTIOW at
     1920x1080, depth 50, spp 2, pool 2^17, equal to phase 6's film
     (bounce counts exact, radiance within f32 reassociation), B1 and B2
     once a step and no other kernel, the pass seconds beside phase 6's
     and the all-reduce's; ``render_pass_sharded`` (wavefront) at 256x144,
     depth 8, spp 2, against the same pass on the CPU: bit-equal with the
     CPU's sin and cos substituted on the card (ROADMAP C20, C22), and the
     pixels that differ without; (b) two ranks of a gloo group on the one
     card, two subprocesses (``chip_smoke.py shard-worker``), meshes (2, 1)
     and (1, 2): RTIOW at 1920x1080, depth 50, spp 2 against phase 6's
     film and sphere_grid at 480x270, spp 2 (B5, B7, B2) against a
     one-process pass, under the same rule.  Two ranks sharing one card
     give no multi-GPU time;
 23. the lane coherence sorter (``integrator.persistent.sort_lanes``:
     kernel S1, the key; torch.sort; kernel S2, the permutation; the auto
     rule now sorts phases 10, 12's lucy and 15): sphere_grid, lucy, eve
     and lucy with MRT_SORT_DYN=1 at 1920x1080, depth 50, spp 2, pool
     2^17, unsorted, sorted, sorted, unsorted in one process (seconds,
     steps, launches a step, mean radiance; S1 and S2 once a sort; the
     turns of one mode equal; sorted against unsorted equal on
     sphere_grid, and on lucy and eve, whose B7 walks its TLAS in its
     warp's octant (C15), at most 1% of pixels apart); S1 and S2 against
     their plain versions bit for bit on sphere_grid's step-64 lanes
     (the scene's and the live origins' box; S2 with and without a pend
     accumulator), timed by CUDA-graph replay beside the launch floor,
     torch.sort, the plain versions, S2's index_select a column and the
     whole sorter's launches; B1 (RTIOW, phase 6's step 64), B5
     (sphere_grid), B7 (lucy, eve) on step 64's lanes of an unsorted
     pass as they come and sorted (both boxes), in turns: B1's and B5's
     winners un-permuted bit-equal, B7's under compare_hits' rule.

Each main path runs with every launch count set to 0 just before it and
read just after.  Then a JSON line with each kernel's numbers (B2, B3
and B4 also with ``floor_ms``, phase 4's launch floor; B1 and B2 also
``launches_sharded``, phase 22's), and as
the last line ``{"ok": true, "device": {...}}``.  The JSON line's S1
and S2 entries replace no Pallas kernel (``replaces`` names the
reference's XLA sorter); their ``launches`` are phase 10's.  Any failure
raises and exits non-zero; so does a machine without CUDA.  Imports no
JAX.

Bounds (``bound_ms``): the larger of the bytes the function must move
(each input read once, each output written once) over 3.35 TB/s and its
FP32 operations over 67 TFLOP/s, the H100 SXM's published peaks at
700 W.  For B1, B5, B6 and B7 the operations are counted from this run's
data: B1's pair and group-box tests a ray, counted by its grouped walk's
plain model; node visits and leaf primitive tests per ray, counted by the
plain traversal on the same rays in the kernel's own visit order (the
trees' threading tables, octant orders on trees of 32 nodes or more),
times the operations of one visit or test.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
RAYS = 1 << 17
WIDTH, HEIGHT = 1920, 1080
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one step of the kernels' loops (their source,
# mrt_torch/csrc/*.cu, counted by hand; a min/max or compare counts 1):
OPS_SPHERE_PAIR = 20   # B1: one ray-sphere pair, expanded form
OPS_GROUP_BOX = 40     # B1: one padded group-box test
OPS_NODE = 26          # B5/B7: one slab test and advance
OPS_SPHERE_TEST = 32   # B5: one leaf sphere
OPS_TRI_TEST = 58      # B6/B7: one Möller–Trumbore test
OPS_ENTER = 36         # B7: warp a ray into an instance
# Rays through the 8,000-instance TLAS: its plain traversal takes
# ~1 ms a wavefront step, so it gets fewer rays than the main path.
B8_RAYS = 1 << 14
B8_INSTANCES = 8000
# B3 at the eve fleet's compaction: a round of 32,768 rows (compact.rows_for
# of the 2^17-lane pool) expanded back to the lanes.
B3_ROWS = 32768
# Phase 20: the gradient path's full size, the crop where B1's winners
# are held against the plain version's, and the albedo recovery's size.
GRAD_W, GRAD_H = WIDTH, HEIGHT
CROP_W, CROP_H = 256, 144
GRAD_RECOVER = 12
# The main path's steps whose sphere rays phases 3 and 7 also take: an
# early step and one about mid-pass (RTIOW's pass takes ~136 steps,
# sphere_grid's ~216).
CAPTURE_STEPS = (2, 64)


def check(ok, msg):
    """Fail the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(msg)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def call_ms(fn, reps):
    """Mean milliseconds per call of fn over `reps` calls, after a warm-up,
    between CUDA events: device time plus any gaps where the device waits
    for the host to launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds per call of fn: `reps` calls captured in
    one CUDA graph and replayed between CUDA events, so no host launch
    gap is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the least time for the bytes and the FP32
    operations at the card's published peaks."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return dict(bound_ms=by_bytes, bound_by="bytes")
    return dict(bound_ms=by_ops, bound_by="operations")


@contextlib.contextmanager
def tlas_route(kind):
    """MRT_TLAS_KERNEL set to `kind` (None: unset, the two-level route)
    inside the block, restored after it."""
    old = os.environ.pop("MRT_TLAS_KERNEL", None)
    if kind is not None:
        os.environ["MRT_TLAS_KERNEL"] = kind
    try:
        yield
    finally:
        os.environ.pop("MRT_TLAS_KERNEL", None)
        if old is not None:
            os.environ["MRT_TLAS_KERNEL"] = old


def path_rays(name, dev):
    """The scene `name` and RAYS of its main-path rays at 1080p: RAYS/2
    camera rays spread over the frame (spp 2) and RAYS/2 first-bounce
    rays (hit point, scattered direction; unscattered rays keep their
    camera ray)."""
    from mrt_torch.integrator.persistent import LanePool
    from mrt_torch.materials import shade
    from mrt_torch.math.rng import Sampler
    from mrt_torch.scenes import get

    scene, camera = get(name)().generate(device=dev)
    lanes = LanePool(scene, camera, WIDTH, HEIGHT, 1, 0, 2, 50)
    items = (torch.arange(RAYS, device=dev) * 7919) % lanes.total
    o, d, ray_id = lanes.make_rays(items)
    half = RAYS // 2
    ob, db, rb = o[half:], d[half:], ray_id[half:]
    # Volumes and alpha tests draw from a sampler (eve's fog).
    hits = scene.intersect(ob, db, sampler=Sampler(1, rb, 2))
    new_dir, scat = shade.shade_hit(scene, hits, db, Sampler(1, rb, 0),
                                    Sampler(1, rb, 1))[2:4]
    keep = scat[:, None]
    o = torch.cat([o[:half], torch.where(keep, hits.point, ob)])
    d = torch.cat([d[:half], torch.where(keep, new_dir, db)])
    return scene, o.contiguous(), d.contiguous()


def ray_sets(o, d, captured):
    """{name: (o, d, t_min, t_max)}: `RAYS` path rays (bounds 1e-3, inf,
    as lanes) and each captured main-path step's rays as that step
    passed them."""
    n = o.shape[0]
    out = {"path rays": (o, d, torch.full((n,), 1e-3, device=o.device),
                         torch.full((n,), float("inf"), device=o.device))}
    for step, rays in sorted(captured.items()):
        out[f"main step {step}"] = rays
    check(len(out) == 1 + len(CAPTURE_STEPS),
          f"captured steps {sorted(captured)}, not {CAPTURE_STEPS}")
    return out


def as_lanes(x, n, dev):
    """A scalar or (N,) t bound as (N,) lanes, for the plain versions."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev).expand(
        n).contiguous()


@contextlib.contextmanager
def captured_rays(kernel, out):
    """Inside the block, the rays (o, d, t_min, t_max) that the main
    path's sphere intersections number CAPTURE_STEPS (from 0) pass to B1
    (`kernel` "B1": ``geometry.spheres.nearest_t``) or B5 ("B5":
    ``geometry.bvh.intersect_bvh_spheres``) are copied into out[step]."""
    from mrt_torch.geometry import bvh, spheres

    module, name = ((spheres, "nearest_t") if kernel == "B1"
                    else (bvh, "intersect_bvh_spheres"))
    fn = getattr(module, name)
    calls = [0]

    def spy(*args):
        if calls[0] in CAPTURE_STEPS:
            out[calls[0]] = tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in args[-4:])
        calls[0] += 1
        return fn(*args)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def captured_state(out):
    """Inside the block, the lane state that the persistent pass's step
    number CAPTURE_STEPS[-1] (from 0) takes is copied into out["state"],
    with the pass's work items in out["total"]."""
    from mrt_torch.integrator import persistent

    fn = persistent.LanePool.step
    step, calls = CAPTURE_STEPS[-1], [0]

    def spy(self, st, film):
        if calls[0] == step:
            out.update(state={k: v.clone() for k, v in st.items()},
                       total=self.total)
        calls[0] += 1
        return fn(self, st, film)

    persistent.LanePool.step = spy
    try:
        yield
    finally:
        persistent.LanePool.step = fn


@contextlib.contextmanager
def contexts(*managers):
    """All the context managers at once."""
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def phase_b1(dev, captured):
    from mrt_torch.ops import spheres as B1

    scene, o, d = path_rays("rtiow", dev)
    sp = scene.spheres
    c, r = sp.center, sp.radius
    check(c.shape == (484, 3), f"RTIOW has {c.shape[0]} spheres, not 484")
    sets, table_bytes = {}, sum(x.numel() * 4 for x in sp.groups[:4])
    for name, (so, sd, lo, hi) in ray_sets(o, d, captured).items():
        n = so.shape[0]
        t_k, i_k = B1.nearest_t(c, r, so, sd, lo, hi, groups=sp.groups)
        lanes = (as_lanes(lo, n, dev), as_lanes(hi, n, dev))
        plain = lambda: B1.nearest_t_plain(c, r, so, sd, *lanes)
        t_p, i_p = plain()
        work = {}
        t_g, i_g = B1.nearest_t_grouped_plain(sp.groups, so, sd, *lanes,
                                              counts=work)
        torch.cuda.synchronize()
        check(torch.equal(t_k, t_p) and torch.equal(i_k, i_p),
              f"B1 on {name}: not bit-equal to its plain version "
              f"({(i_k != i_p).sum().item()} indices differ)")
        check(torch.equal(t_g, t_p) and torch.equal(i_g, i_p),
              f"B1's grouped model on {name} differs from the brute force")
        wrapper = lambda: B1.nearest_t(c, r, so, sd, lo, hi, groups=sp.groups)
        ops = work["pairs"] * OPS_SPHERE_PAIR + work["boxes"] * OPS_GROUP_BOX
        plain_ms = graph_ms(plain, 3)
        sets[name] = dict(
            ms=graph_ms(wrapper, 50), plain_ms=plain_ms,
            call_ms=call_ms(wrapper, 50),
            hit_share=torch.isfinite(t_p).float().mean().item(),
            pairs_per_ray=work["pairs"] / n,
            warp_pairs_per_ray=work["warp_pairs"] / n,
            boxes_per_ray=work["boxes"] / n,
            groups_entered_per_warp=work["entered"] / ((n + 31) // 32),
            **bound(n * 40 + table_bytes, ops))
        v = sets[name]
        log(3, f"B1 {n} rays x 484 spheres, {name}: bit-equal (t, index), "
               f"hit share {v['hit_share']:.4f}; per ray "
               f"{v['pairs_per_ray']:.2f} pair tests needed, "
               f"{v['warp_pairs_per_ray']:.2f} run by its warp, and "
               f"{v['boxes_per_ray']:.0f} box tests (brute force: 484 "
               f"pairs), {v['groups_entered_per_warp']:.2f} of "
               f"{sp.g_boxes.shape[0]} groups entered a warp; device time a "
               f"call (CUDA graph): kernel {v['ms']:.4f} ms, plain "
               f"{plain_ms:.4f} ms; call time (CUDA "
               f"events): wrapper {v['call_ms']:.4f} ms; bound "
               f"{v['bound_ms']:.5f} ms ({v['bound_by']})")
    main = sets["path rays"]
    return dict(max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=None, bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], ray_sets=sets)


def b2_lanes(dev):
    """2^17 lanes as the main path makes them: two lanes per pixel
    (spp 2, claimed pixel-major), some idle (-1), a few repeats."""
    npix = WIDTH * HEIGHT
    lane = torch.arange(RAYS, device=dev)
    idx = (lane // 2 + 12345) % npix
    idx = torch.where(lane % 11 == 0, -1, idx)
    idx = torch.where(lane % 17 == 0, idx[0:1].expand_as(idx), idx)
    g = torch.Generator(device=dev).manual_seed(7)
    vals = torch.rand((RAYS, 4), device=dev, generator=g)
    vals[:, 3] = (vals[:, 3] < 0.6).float()  # bounce counts
    return idx.to(torch.int32).contiguous(), vals.contiguous()


def host_us(fn, calls=1000):
    """Mean host microseconds a call of fn over `calls` calls, on the host
    clock without a device sync between them (what issuing the call
    costs; the device keeps up with these small kernels)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def floor_ms(dev):
    """The card's launch floor: the device time a call of a one-element
    add_, replayed in a CUDA graph as the kernels are timed."""
    x = torch.zeros((1,), device=dev)
    return graph_ms(lambda: x.add_(1.0), 50)


def compaction_lanes(dev, cols, seed):
    """One compaction round at the eve fleet's shapes: RAYS lanes, ~70%
    masked (the first B3_ROWS of them in range of the round's rows), their
    prefix positions, and rows of `cols` floats with exponents from -20
    to 20, NaN and inf in unmasked rows (never read)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand((RAYS,), device=dev, generator=g) < 0.7
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    x = (torch.randn((RAYS, cols), device=dev, generator=g)
         * 10.0 ** torch.randint(-20, 20, (RAYS, cols), device=dev,
                                 generator=g))
    x[~mask] = float("nan")
    x[~mask & (torch.arange(RAYS, device=dev) % 2 == 0)] = float("inf")
    return mask.contiguous(), pos.contiguous(), x.contiguous()


def phase_b2(dev):
    from mrt_torch.ops import compact
    from mrt_torch.ops import deposit as B2
    from mrt_torch.ops import gather as B3

    floor = floor_ms(dev)
    log(4, f"launch floor: a one-element add_ replayed in a CUDA graph, "
           f"{floor:.5f} ms a call")
    idx, vals = b2_lanes(dev)
    shape = (WIDTH * HEIGHT, 4)
    film_k = B2.deposit(torch.zeros(shape, device=dev), idx, vals)
    film_p = B2.deposit_plain(torch.zeros(shape, device=dev), idx, vals)
    torch.cuda.synchronize()
    err = (film_k - film_p).abs().max().item()
    scale = film_p.abs().max().item()
    check(err <= 1e-4 * scale, f"B2 err {err} (scale {scale})")
    check(torch.equal(film_k[:, 3], film_p[:, 3]), "B2 depth column")
    film = torch.zeros(shape, device=dev)
    kernel = lambda: B2.deposit(film, idx, vals)
    plain = lambda: B2.deposit_plain(film, idx, vals)
    # The library call: one index_add_ of the lanes that land in the
    # film (the dropped ones masked to exact zeros beforehand).
    keep = (idx >= 0) & (idx < shape[0])
    rows = torch.where(keep, idx, 0).to(torch.int64)
    v = torch.where(keep[:, None], vals, 0.0)
    library = lambda: film.index_add_(0, rows, v)
    ms, plain_ms = graph_ms(kernel, 50), graph_ms(plain, 20)
    library_ms = graph_ms(library, 20)
    # Bytes: lane indices and values read once, each touched film row
    # read and written once.
    touched = int(torch.unique(idx[keep]).numel())
    moved = RAYS * (4 + 16) + touched * 16 * 2
    log(4, f"B2 {RAYS} lanes into {shape}: max abs err {err:.3g} "
           f"(max {scale:.3g}), depth column exact; device time a call "
           f"(CUDA graph): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
           f"index_add_ {library_ms:.4f} ms, floor {floor:.5f} ms; call "
           f"time (CUDA events): wrapper {call_ms(kernel, 50):.4f} ms, plain "
           f"{call_ms(plain, 20):.4f} ms; {touched} film rows touched")

    # The placer: compact_rows' call at the eve fleet's compaction shapes.
    mask, pos, x = compaction_lanes(dev, 3, 19)
    xc = torch.zeros((B3_ROWS, 3), device=dev)
    got = B2.deposit(xc.clone(), pos, x, mask=mask)
    want = B2.deposit_plain(xc.clone(), pos, x, mask=mask)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "B2 as the placer: not bit-equal to its plain version")
    placed = mask & (pos < B3_ROWS)
    check(torch.equal(got, x[placed]), "B2 as the placer: rows misplaced")
    p_rows = torch.where(placed, pos, 0).to(torch.int64)
    p_vals = torch.where(placed[:, None], x, 0.0)
    n_placed = int(placed.sum())
    placer = dict(
        max_abs_err=0.0, lanes=RAYS, rows=B3_ROWS, cols=3, placed=n_placed,
        ms=graph_ms(lambda: B2.deposit(xc, pos, x, mask=mask), 50),
        plain_ms=graph_ms(lambda: B2.deposit_plain(xc, pos, x, mask=mask), 20),
        library_ms=graph_ms(lambda: xc.index_add_(0, p_rows, p_vals), 20),
        # Index and mask byte a lane; the placed rows read, and their rows
        # of the buffer read and written.
        **bound(RAYS * 5 + n_placed * 12 * 3, n_placed * 3))
    log(4, f"B2 as compaction's placer, {RAYS} lanes ({n_placed} placed) "
           f"into ({B3_ROWS}, 3): bit-equal; device time a call (CUDA "
           f"graph): kernel {placer['ms']:.4f} ms, plain "
           f"{placer['plain_ms']:.4f} ms, index_add_ "
           f"{placer['library_ms']:.4f} ms; bound {placer['bound_ms']:.5f} "
           f"ms (bytes)")

    # What a wrapper call costs the host: B2 on the film, B3 at the atlas's
    # 4 columns, and one compaction round (4 rounds a call at 2^17 lanes).
    table = torch.randn((B3_ROWS, 4), device=dev)
    rounds = -(-RAYS // B3_ROWS)
    host = dict(
        deposit=host_us(kernel), gather=host_us(lambda: B3.gather(table, pos)),
        compact_round=host_us(lambda: compact.compact_apply(
            lambda r: r, mask, x, B3_ROWS), 250) / rounds)
    log(4, "host time a wrapper call (host clock, mean of 1000 calls, no "
           "sync): " + ", ".join(f"{k} {v:.2f} us" for k, v in host.items())
        + f" (compact_round: a compact_apply round, {rounds} a call)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, floor_ms=floor, placer=placer,
                wrapper_host_us=host, **bound(moved, RAYS * 4))


def phase_golden(phase, name, dev, build=None, max_outside=None, **kw):
    """The <name>_24 golden (24x24, spp 8, depth 6, seed 5) through both
    integrators on the card: at most 1% of pixels with another bounce
    count, every other pixel within 5e-4.  build(device) makes the scene
    (default: the registered scene `name` with **kw); max_outside, if
    given, replaces that rule by a cap on the pixels outside it (C10)."""
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render, render_pass_persistent
    from mrt_torch.scenes import get

    gold = np.load(os.path.join(GOLDENS, f"{name}_24.npz"))
    if build is None:
        build = get(name)(aspect_ratio=1.0, **kw).generate
    scene, camera = build(dev)
    films = {
        "wavefront": render(scene, camera, 24, 24, spp=8, max_depth=6,
                            seed=5),
        "persistent": render_pass_persistent(
            scene, camera, Film.create(24, 24, device=dev), 5, 0, width=24,
            height=24, max_depth=6, samples=8, pool=1024),
    }
    parts = []
    for kind, film in films.items():
        s = film.sum.cpu().numpy()
        depth = film.depth_sum.cpu().numpy()
        flipped = depth != gold["depth"]
        check(depth.sum() > 0 and np.isfinite(s).all(), f"{kind}: empty")
        off = ~np.isclose(s, gold["sum"], rtol=5e-4, atol=5e-4).all(-1)
        outside = int((flipped | off).sum())
        if max_outside is None:
            check(flipped.mean() <= 0.01, f"{kind}: {flipped.sum()} flipped")
            check(not (off & ~flipped).any(),
                  f"{kind}: {(off & ~flipped).sum()} px outside 5e-4")
        else:
            check(outside <= max_outside, f"{kind}: {outside} px outside "
                                          "the C2 rule")
        bad = ~np.isclose(s, gold["sum"], rtol=1e-4, atol=1e-4).all(-1)
        parts.append(f"{kind} {flipped.sum()} px with another depth, "
                     f"{outside} outside the C2 rule, {bad.sum()} px "
                     "outside 1e-4")
    rule = ("<= 1% depth, others within 5e-4" if max_outside is None
            else f"<= {max_outside} px outside that rule (C10)")
    log(phase, f"{name}_24 golden on the card: " + "; ".join(parts)
        + f" (of 576; allowed: {rule})")


def _wrappers():
    from mrt_torch.ops import bvh, deposit, gather, sort, spheres
    from mrt_torch.tools import probe_stream

    return {"B1": spheres.nearest_t, "B2": deposit.deposit,
            "B3": gather.gather, "B4": deposit.deposit_pending,
            "B5": bvh.sphere_bvh_hit, "B6": bvh.tri_bvh_hit,
            "B7": bvh.tlas_hit, "P1": probe_stream.probe_a,
            "P2": probe_stream.probe_b, "P3": probe_stream.probe_c,
            "S1": sort.sort_keys, "S2": sort.permute_lanes}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in _wrappers().items()}


@contextlib.contextmanager
def counting_steps():
    """Yields a dict whose "steps" counts LanePool.step calls and "dda"
    the voxel walk's steps inside the block."""
    from mrt_torch.geometry import voxels
    from mrt_torch.integrator import persistent

    out = {"steps": 0}
    step = persistent.LanePool.step

    def counted(self, *a, **k):
        out["steps"] += 1
        return step(self, *a, **k)

    persistent.LanePool.step = counted
    voxels.counts.update(calls=0, steps=0)
    try:
        yield out
    finally:
        persistent.LanePool.step = step
        out["dda"] = voxels.counts["steps"]


@contextlib.contextmanager
def environ(**values):
    """os.environ updated with `values` inside the block, restored after
    it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_main(phase, name, dev, kernels, route=None, film_out=None,
               nee=False, rr_depth=None, absent=(),
               during=contextlib.nullcontext()):
    """One render_pass_persistent of scene `name` at 1080p, depth 50,
    spp 2, pool 2^17, with MRT_TLAS_KERNEL=`route` (None: unset), the
    scene's light table if `nee`, Russian roulette from `rr_depth`, launch
    counts set to 0 just before; each kernel in `kernels`, and neither B3,
    B4, a BVH kernel, a sorter kernel (S1, S2: the auto rule sorts
    sphere_grid, lucy and eve) nor one in `absent` outside it, must have
    launched.
    The pass runs inside the context manager `during`.  Returns
    (launches, mean radiance); the film, the seconds, the steps and the
    DDA steps go into film_out if given."""
    from mrt_torch.geometry.scene import attach_lights
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    with tlas_route(route):
        scene, camera = get(name)().generate(device=dev)
        if nee:
            scene = attach_lights(scene)
        film = Film.create(WIDTH, HEIGHT, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        with counting_steps() as steps, during:
            t0 = time.perf_counter()
            film = render_pass_persistent(scene, camera, film, 1, 0,
                                          width=WIDTH, height=HEIGHT,
                                          max_depth=50, samples=2, pool=RAYS,
                                          rr_depth=rr_depth)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    launches = read_launches()
    check(all(launches[k] > 0 for k in kernels)
          and all(launches[k] == 0 for k in ("B3", "B4", "B5", "B6", "B7",
                                             "S1", "S2")
                  + tuple(absent) if k not in kernels),
          f"{name}: the path's kernels {kernels} did not launch alone: "
          f"{launches}")
    check(film.sum.shape == (HEIGHT, WIDTH, 3) and film.samples == 2,
          f"film shape {tuple(film.sum.shape)}, samples {film.samples}")
    check(torch.isfinite(film.sum).all(), "non-finite film")
    depth_sum = int(film.depth_sum.sum())
    check(depth_sum > 0, "no bounce was counted")
    mean = film.mean().mean().item()
    check(0.01 < mean < 2.0, f"implausible mean radiance {mean}")
    rays = WIDTH * HEIGHT * 2
    where = f" (MRT_TLAS_KERNEL={route})" if route else ""
    flags = " ".join(f"{k}={os.environ[k]}" for k in (
        "MRT_BG_COMPACT", "MRT_TEX_COMPACT", "MRT_FILM_PEND")
        if k in os.environ)
    flags += (" NEE" if nee else "") + (f" rr_depth={rr_depth}"
                                        if rr_depth is not None else "")
    n = max(steps["steps"], 1)
    per_step = {k: round(v / n, 3) for k, v in launches.items() if v}
    dda = f", {steps['dda'] / n:.2f} DDA steps a step" if steps["dda"] else ""
    log(phase, f"main path: {name}{where} {flags} {WIDTH}x{HEIGHT} depth 50 "
               f"spp 2 pool {RAYS}: {seconds:.3f} s, {rays / seconds:.1f} "
               f"camera rays/s, bounces {depth_sum} ({depth_sum / rays:.3f} "
               f"per camera ray), mean radiance {mean:.6f}, {n} steps"
               f"{dda}, launches {launches}, a step {per_step}")
    if film_out is not None:
        film_out.update(film=film, seconds=seconds, steps=n,
                        dda_per_step=steps["dda"] / n)
    return launches, mean


def phase_b5(dev, captured):
    from mrt_torch.ops import bvh as K

    scene, o, d = path_rays("sphere_grid", dev)
    tree = scene.sphere_bvh
    sph = scene.spheres.krows
    check(sph.shape == (10_000, 4) and tree.n_nodes == 1023,
          f"sphere_grid: {sph.shape[0]} spheres, {tree.n_nodes} nodes")
    card = (tree.knodes, tree.order)
    sets = {}
    for name, (so, sd, lo, hi) in ray_sets(o, d, captured).items():
        n = so.shape[0]
        t_k, i_k = K.sphere_bvh_hit(tree.nodes, tree.meta, sph, so, sd, lo, hi,
                                    card=card)
        lanes = (as_lanes(lo, n, dev), as_lanes(hi, n, dev))
        work, escape = {}, {}
        (t_p, i_p), plain_ms = events_ms(lambda: K.sphere_bvh_plain(
            tree.nodes, tree.meta, sph, so, sd, *lanes, order=tree.order))
        K.sphere_bvh_plain(tree.nodes, tree.meta, sph, so, sd, *lanes,
                           counts=work, order=tree.order)
        t_e, i_e = K.sphere_bvh_plain(tree.nodes, tree.meta, sph, so, sd,
                                      *lanes, counts=escape)
        torch.cuda.synchronize()
        check(torch.equal(t_k, t_p) and torch.equal(i_k, i_p),
              f"B5 on {name}: not bit-equal to its plain version in octant "
              f"order ({(i_k != i_p).sum().item()} indices differ)")
        err, rel, agree = compare_hits(f"B5 on {name} (escape order)", t_k,
                                       i_k, t_e, i_e)
        kernel = lambda: K.sphere_bvh_hit(tree.nodes, tree.meta, sph, so, sd,
                                          lo, hi, card=card)
        ops = work["nodes"] * OPS_NODE + work["prims"] * OPS_SPHERE_TEST
        moved = n * 40 + tree.n_nodes * (32 + 64) + sph.shape[0] * 16
        warps = work["warps"]
        sets[name] = dict(
            ms=graph_ms(kernel, 20), plain_ms=plain_ms,
            hit_share=torch.isfinite(t_p).float().mean().item(),
            escape_agree=agree, escape_max_abs_err=err,
            visits_per_ray=work["nodes"] / n, tests_per_ray=work["prims"] / n,
            escape_visits_per_ray=escape["nodes"] / n,
            escape_tests_per_ray=escape["prims"] / n,
            warp_iters=work["warp_iters"] / warps,
            warp_iters_p99=work["warp_iters_p99"],
            leaf_steps_per_warp=work["leaf_steps"] / warps,
            leaf_lanes_per_warp=work["leaf_lanes"] / warps,
            **bound(moved, ops))
        v = sets[name]
        log(7, f"B5 {n} rays x 10000 spheres, 1023 nodes, {name}: bit-equal "
               f"to the octant-order walk, escape-order agreement "
               f"{agree:.6f}, hit share {v['hit_share']:.4f}; per ray "
               f"{v['visits_per_ray']:.2f} node visits, "
               f"{v['tests_per_ray']:.2f} sphere tests (escape order "
               f"{v['escape_visits_per_ray']:.2f}, "
               f"{v['escape_tests_per_ray']:.2f}); a warp "
               f"{v['warp_iters']:.2f} iterations (p99 "
               f"{v['warp_iters_p99']:.0f}), {v['leaf_steps_per_warp']:.2f} "
               f"lane-loop leaf steps, {v['leaf_lanes_per_warp']:.2f} lanes "
               f"at a leaf; device time "
               f"a call: kernel {v['ms']:.4f} ms "
               f"(CUDA graph), plain {plain_ms:.2f} ms (CUDA events: it syncs "
               f"on its loop); bound {v['bound_ms']:.5f} ms ({v['bound_by']})")
    main = sets["path rays"]
    return dict(max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=None, bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], ray_sets=sets)


def compare_hits(name, t_k, i_k, t_p, i_p, uv=()):
    """Index (or (instance, triangle)) agreement >= 99.9%, t within
    rtol 1e-5 and u, v within 1e-5 on lanes that agree.  Returns (max
    |dt|, max rel dt, agreement)."""
    same = i_k == i_p
    agree = same.float().mean().item()
    check(agree >= 0.999, f"{name} index agreement {agree}")
    fin = torch.isfinite(t_p) & same
    check(torch.equal(torch.isfinite(t_k) & same, fin),
          f"{name} hit/miss differs on lanes with equal indices")
    if not fin.any():
        return 0.0, 0.0, agree
    rel = ((t_k[fin] - t_p[fin]).abs() / t_p[fin].abs()).max().item()
    check(rel <= 1e-5, f"{name} t rel err {rel}")
    for a, b in uv:
        e = (a[fin] - b[fin]).abs().max().item()
        check(e <= 1e-5, f"{name} u/v err {e}")
    return (t_k[fin] - t_p[fin]).abs().max().item(), rel, agree


def many_instances(n_inst, dev, seed=0):
    """tests/test_stream.py's registry (cubes and coarse sphere meshes at
    random transforms) with n_inst instances."""
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
    return reg.build().to(dev)


def events_ms(fn):
    """(fn's result, its milliseconds between CUDA events): one call of a
    plain traversal, which syncs on its loop."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def forced_regime(K, regime):
    """B7's regime (``K.tlas_regime``) forced inside the block, through
    the size limits it reads."""
    saved = K.SHARED_MIN_BYTES, K.smem_optin
    if regime == "shared":
        K.SHARED_MIN_BYTES = 0
    else:
        K.smem_optin = lambda device: 0
    try:
        yield
    finally:
        K.SHARED_MIN_BYTES, K.smem_optin = saved


def b7_case(tl, o, d, dev):
    """Kernel against plain on one TLAS; returns the kernel's numbers.
    The plain walk in the kernel's order gives the comparison,
    the plain time and the work behind the bound; the escape order's
    work is counted beside it.  Tables that fit shared memory are timed
    in both regimes."""
    from mrt_torch.ops import bvh as K

    n = o.shape[0]
    lo = torch.full((n,), 1e-3, device=dev)
    hi = torch.full((n,), float("inf"), device=dev)
    k = K.tlas_hit(tl, o, d, lo, hi)
    counts, escape = {}, {}
    p, plain_ms = events_ms(lambda: K.tlas_plain(tl, o, d, lo, hi,
                                                 counts=counts, ordered=True))
    q = K.tlas_plain(tl, o, d, lo, hi, counts=escape)
    # One id for (instance, triangle): agreement of the pair.
    pair = lambda w: w[1].to(torch.int64) * (1 << 31) + w[2]
    err, rel, agree = compare_hits("B7", k[0], pair(k), p[0], pair(p),
                                   uv=((k[3], p[3]), (k[4], p[4])))
    compare_hits("B7 (escape order)", k[0], pair(k), q[0], pair(q),
                 uv=((k[3], q[3]), (k[4], q[4])))
    ms = graph_ms(lambda: K.tlas_hit(tl, o, d, lo, hi), 20)
    regime = K.tlas_regime(tl)
    other, other_ms = None, None
    if K.tlas_table_bytes(tl) <= K.smem_optin(dev):
        # Tables that fit run in either regime: the same walk, timed in
        # the regime the wrapper did not pick too.
        other = "global" if regime == "shared" else "shared"
        with forced_regime(K, other):
            check(K.tlas_regime(tl) == other, f"B7 not forced {other}")
            w = K.tlas_hit(tl, o, d, lo, hi)
            check(all(torch.equal(a, b) for a, b in zip(w, k)),
                  f"B7 {other} differs from B7 {regime}")
            other_ms = graph_ms(lambda: K.tlas_hit(tl, o, d, lo, hi), 20)
    ops = ((counts.get("tlas_nodes", 0) + counts.get("blas_nodes", 0))
           * OPS_NODE + counts.get("enters", 0) * OPS_ENTER
           + counts.get("prims", 0) * OPS_TRI_TEST)
    per_ray = lambda c: {key: v / n for key, v in c.items()}
    return dict(max_abs_err=err, rel=rel, agree=agree, ms=ms,
                plain_ms=plain_ms, per_ray=per_ray(counts),
                per_ray_escape=per_ray(escape), regime=regime,
                other_regime=other, other_ms=other_ms, table_bytes=K.tlas_table_bytes(tl),
                hit_share=torch.isfinite(p[0]).float().mean().item(),
                **bound(n * 52 + K.tlas_table_bytes(tl), ops))


def phase_b7(dev):
    cases = {}
    for name in ("cornell", "playground", "eve", "lucy"):
        scene, o, d = path_rays(name, dev)
        cases[name] = (RAYS, b7_case(scene.tlas, o, d, dev))
    check(cases["lucy"][1]["regime"] == "shared",
          f"lucy's B7 tables ran {cases['lucy'][1]['regime']}")
    tl = many_instances(B8_INSTANCES, dev)
    g = torch.Generator(device=dev).manual_seed(11)
    ob = torch.rand((B8_RAYS, 3), device=dev, generator=g) * 20 - 10
    db = torch.randn((B8_RAYS, 3), device=dev, generator=g)
    big = b7_case(tl, ob, db, dev)
    check(big["regime"] == "global",
          f"{B8_INSTANCES} instances' B7 tables ran {big['regime']}")
    cases[f"{B8_INSTANCES} instances"] = (B8_RAYS, big)
    work = lambda c: ", ".join(f"{v:.2f} {k}" for k, v in c.items())
    for what, (rays, r) in cases.items():
        other = ("" if r["other_ms"] is None else
                 f", {r['other_regime']} {r['other_ms']:.4f} ms")
        log(8, f"B7 {rays} rays, {what} ({r['table_bytes']} B of kernel "
               f"tables, {r['regime']} memory{other}): (instance, triangle) "
               f"agreement {r['agree']:.6f}, hit share {r['hit_share']:.4f}, "
               f"max |dt| {r['max_abs_err']:.3g} (rel {r['rel']:.3g}); per "
               f"ray in the kernel's order {work(r['per_ray'])}; in escape "
               f"order {work(r['per_ray_escape'])}; device time a call: "
               f"kernel "
               f"{r['ms']:.4f} ms (CUDA graph), plain {r['plain_ms']:.2f} ms "
               f"(CUDA events); bound {r['bound_ms']:.5f} ms "
               f"({r['bound_by']})")
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "agree",
            "regime", "table_bytes", "other_regime", "other_ms")
    main = cases["cornell"][1]
    entry = {k: main[k] for k in keep}
    for name in ("playground", "eve", "lucy"):
        entry[name] = {k: cases[name][1][k] for k in keep}
    entry["b8_regime"] = dict(rays=B8_RAYS, instances=B8_INSTANCES,
                              **{k: big[k] for k in keep})
    return dict(entry, library_ms=None)


def b6_numbers(n, kernel, plain_ms, counts, escape, nodes, tris, agree):
    """B6's numbers: kernel time, bound from the work in the kernel's
    order (its tables: packed nodes, threading, packed rows)."""
    err, rel, agree = agree
    ops = counts["nodes"] * OPS_NODE + counts.get("prims", 0) * OPS_TRI_TEST
    moved = n * 48 + nodes * (32 + 64) + tris * 48
    per_ray = lambda c: (c["nodes"] / n, c.get("prims", 0) / n)
    return dict(max_abs_err=err, rel=rel, agree=agree,
                ms=graph_ms(kernel, 20), plain_ms=plain_ms, nodes=nodes,
                tris=tris, per_ray=per_ray(counts),
                per_ray_escape=per_ray(escape), **bound(moved, ops))


def phase_b6(dev):
    from mrt_torch.ops import bvh as K

    lo = torch.full((RAYS,), 1e-3, device=dev)
    hi = torch.full((RAYS,), float("inf"), device=dev)
    scene, o, d = path_rays("playground", dev)
    tl = scene.tlas
    tree, tris = tl.flat_bvh, tl.flat_tris
    check(tris.count == 210 and tree.n_nodes == 15,
          f"playground flat set: {tris.count} triangles, {tree.n_nodes} "
          "nodes")
    card = (tree.knodes, tree.order, tris.krows)
    k = K.tri_bvh_hit(tree.nodes, tree.meta, tris.rows, o, d, lo, hi,
                      card=card)
    counts, escape = {}, {}
    p, plain_ms = events_ms(lambda: K.tri_bvh_plain(
        tree.nodes, tree.meta, tris.rows, o, d, lo, hi, counts=counts,
        order=tree.order))
    q = K.tri_bvh_plain(tree.nodes, tree.meta, tris.rows, o, d, lo, hi,
                        counts=escape)
    agree = compare_hits("B6", k[0], k[1], p[0], p[1],
                         uv=((k[2], p[2]), (k[3], p[3])))
    compare_hits("B6 (escape order)", k[0], k[1], q[0], q[1])
    pg = b6_numbers(RAYS, lambda: K.tri_bvh_hit(
        tree.nodes, tree.meta, tris.rows, o, d, lo, hi, card=card), plain_ms,
        counts, escape, tree.n_nodes, tris.count, agree)
    pg["hit_share"] = torch.isfinite(p[0]).float().mean().item()

    with tlas_route("flat"):
        scene, o, d = path_rays("lucy", dev)
    parts = scene.tlas.flat_parts
    check(parts is not None and len(parts) == 16,
          f"lucy has {0 if parts is None else len(parts)} flat parts, not 16")
    forest = parts.forest
    rows = torch.cat([part.rows for part in parts])
    k = K.tri_bvh_parts_hit(parts, o, d, lo, hi)
    counts, escape = {}, {}
    # The reference's fold: one escape-order walk a part.
    p, plain_ms = events_ms(lambda: K.tri_bvh_parts_plain(
        parts, o, d, lo, hi, counts=escape))
    # The kernel's own walk: the forest in octant order.
    q = K.tri_bvh_plain(forest.nodes, forest.meta, rows, o, d, lo, hi,
                        counts=counts, order=forest.order)
    agree = compare_hits("B6 fused", k[0], k[1], p[0], p[1],
                         uv=((k[2], p[2]), (k[3], p[3])))
    compare_hits("B6 fused (forest walk)", k[0], k[1], q[0], q[1],
                 uv=((k[2], q[2]), (k[3], q[3])))
    lucy = b6_numbers(RAYS, lambda: K.tri_bvh_parts_hit(parts, o, d, lo, hi),
                      plain_ms, counts, escape, forest.n_nodes,
                      rows.shape[0], agree)
    lucy["hit_share"] = torch.isfinite(p[0]).float().mean().item()
    for what, r, ways in (
            ("playground flat set", pg, ("the kernel's order",
                                         "escape order")),
            ("lucy's 16 flat parts in one launch", lucy,
             ("the forest's octant order", "16 escape-order walks"))):
        log(11, f"B6 {RAYS} rays, {what} ({r['tris']} triangles, "
                f"{r['nodes']} nodes): triangle agreement {r['agree']:.6f}, "
                f"hit share {r['hit_share']:.4f}, max |dt| "
                f"{r['max_abs_err']:.3g} (rel {r['rel']:.3g}); per ray "
                f"{r['per_ray'][0]:.2f} node visits, {r['per_ray'][1]:.2f} "
                f"triangle tests in {ways[0]}, {r['per_ray_escape'][0]:.2f} "
                f"and {r['per_ray_escape'][1]:.2f} in {ways[1]}; device time "
                f"a call: kernel {r['ms']:.4f} ms (CUDA graph), plain "
                f"{r['plain_ms']:.2f} ms (CUDA events); bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "agree")
    return dict({k: lucy[k] for k in keep}, library_ms=None,
                playground={k: pg[k] for k in keep})


def phase_meshes(dev):
    """Lucy and playground main paths on both routes; each scene's two
    mean radiances within 1% of each other."""
    runs = {}
    for name, extra in (("lucy", ("B1", "S1", "S2")), ("playground", ())):
        two, two_mean = phase_main(12, name, dev, ("B2", "B7") + extra)
        out = {}
        flat, flat_mean = phase_main(12, name, dev, ("B2", "B6") + extra,
                                     route="flat", film_out=out)
        check(flat["B6"] == out["steps"],
              f"{name} flat: {flat['B6']} B6 launches in {out['steps']} "
              "steps, not one a step")
        gap = abs(flat_mean - two_mean) / two_mean
        check(gap <= 0.01, f"{name}: mean radiance {flat_mean} on the flat "
                           f"route, {two_mean} on the two-level route")
        log(12, f"{name}: mean radiance two-level {two_mean:.6f}, flat "
                f"{flat_mean:.6f}, relative gap {gap:.3g} (allowed 0.01); "
                f"flat: {flat['B6']} B6 launches in {out['steps']} steps")
        runs[name] = (two, flat)
    return runs


def phase_b3(dev, floor):
    """B3 against its plain version at the eve fleet's compaction shapes,
    bit for bit, beside index_select with the mask (the library call):
    unmasked at 1, 2, 3, 4 and 10 columns, and masked as expand_rows calls
    it (prefix positions and the mask) at 3 and 4."""
    from mrt_torch.ops import compact
    from mrt_torch.ops import gather as B3

    check(compact.rows_for(RAYS) == B3_ROWS,
          f"rows_for({RAYS}) = {compact.rows_for(RAYS)}")
    g = torch.Generator(device=dev).manual_seed(13)
    # The lanes of one compaction round: ~70% masked in lane order, the
    # first B3_ROWS of them at their prefix positions, the rest -1; a few
    # lanes past the table on both sides.
    mask, pos, _ = compaction_lanes(dev, 1, 13)
    idx = torch.where(mask & (pos < B3_ROWS), pos, -1)
    idx[::4099] = B3_ROWS + 3
    idx[1::4099] = -7
    idx = idx.contiguous()
    out = {}
    for cols, masked in ((1, False), (2, False), (3, False), (4, False),
                         (10, False), (3, True), (4, True)):
        table = (torch.randn((B3_ROWS, cols), device=dev, generator=g)
                 * 10.0 ** torch.randint(-20, 20, (B3_ROWS, cols), device=dev,
                                         generator=g)).contiguous()
        lanes, m = (pos, mask) if masked else (idx, None)
        got = B3.gather(table, lanes, mask=m)
        want = B3.gather_plain(table, lanes, mask=m)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        what = f"C={cols}" + (" masked" if masked else "")
        check(same, f"B3 {what}: not bit-equal to its plain version")
        err = (got - want).abs().max().item()
        kernel = lambda: B3.gather(table, lanes, mask=m)
        plain = lambda: B3.gather_plain(table, lanes, mask=m)
        valid = (lanes >= 0) & (lanes < B3_ROWS)
        if masked:
            valid = valid & mask
        rows = torch.clamp(lanes, 0, B3_ROWS - 1)
        library = lambda: torch.where(valid[:, None],
                                      table.index_select(0, rows), 0.0)
        check(torch.equal(library(), want), "index_select differs")
        ms, plain_ms = graph_ms(kernel, 50), graph_ms(plain, 20)
        library_ms = graph_ms(library, 20)
        n_valid = int(valid.sum())
        # Index (and mask byte) a lane, each output row written, each valid
        # lane's table row read.
        moved = (RAYS * (5 if masked else 4) + RAYS * cols * 4
                 + min(n_valid, B3_ROWS) * cols * 4)
        out[what] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, floor_ms=floor,
                         **bound(moved, 0))
        log(13, f"B3 {RAYS} lanes from ({B3_ROWS}, {cols})"
                f"{', masked as expand_rows calls it' if masked else ''}: "
                f"bit-equal, {n_valid} lanes valid; device time a call (CUDA "
                f"graph): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"index_select + mask {library_ms:.4f} ms; bound "
                f"{out[what]['bound_ms']:.5f} ms (bytes), floor "
                f"{floor:.5f} ms")
    # The entry: C = 4 (the atlas's RGBA, three of a step's four calls);
    # C = 3 (the background) and the masked forms beside it.
    main = out.pop("C=4")
    return dict(main, background_c3=out.pop("C=3"), masked_c3=out["C=3 masked"],
                masked_c4=out["C=4 masked"],
                other_cols={k: out[k]["ms"] for k in ("C=1", "C=2", "C=10")})


def films_agree(what, a, b):
    """Equal bounce counts; radiance within f32 reassociation of the
    film's atomic adds.  Returns the largest radiance difference."""
    check(torch.equal(a.depth_sum, b.depth_sum), f"{what}: bounce counts "
                                                 "differ")
    diff = (a.sum - b.sum).abs().max().item()
    scale = a.sum.abs().max().item()
    check(diff <= 1e-5 * scale, f"{what}: radiance differs by {diff} (max "
                                f"{scale})")
    return diff, scale


def phase_eve(dev):
    """The eve fleet twice: as it is, then with the background and texel
    fetches compacted (B3).  Equal bounce counts; radiance within f32
    reassociation of the film's atomic adds."""
    runs = {}
    for key, kernels, flags in (
            ("plain", ("B1", "B2", "B7", "S1", "S2"), {}),
            ("compact", ("B1", "B2", "B3", "B7", "S1", "S2"),
             dict(MRT_BG_COMPACT="1", MRT_TEX_COMPACT="1"))):
        runs[key] = {}
        with environ(**flags):
            launches, mean = phase_main(15, "eve", dev, kernels,
                                        film_out=runs[key])
        runs[key].update(launches=launches, mean=mean)
    a, b = runs["plain"]["film"], runs["compact"]["film"]
    diff, scale = films_agree("eve with compaction", a, b)
    secs = [runs[k]["seconds"] for k in ("plain", "compact")]
    log(15, f"eve: depth sums equal ({int(a.depth_sum.sum())}), max radiance "
            f"difference {diff:.3g} of {scale:.3g}; pass {secs[0]:.3f} s "
            f"as it is, {secs[1]:.3f} s compacted; B3 "
            f"launches {runs['compact']['launches']['B3']}, B2 launches "
            f"{runs['plain']['launches']['B2']} and "
            f"{runs['compact']['launches']['B2']}")
    return runs


def phase_texture_goldens(dev):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_golden_scenes as TG

    for name in ("textured", "eve_ball", "volume"):
        phase_golden(14, name, dev, build=TG.FACTORIES[name])
    # C10: the greedy-meshed sponge is sensitive to the last bit (24 of
    # 576 pixels outside the C2 rule on the CPU, each equal to the
    # op-by-op JAX render).
    phase_golden(14, "menger2", dev, build=TG.FACTORIES["menger2"],
                 max_outside=40)


def b4_lanes(dev):
    """Phase 16's B4 inputs, as the pend film mode makes them: b2_lanes'
    slots and values with small-integer bounce counts in column 3, ~35% of
    the lanes dying, and every 13th lane's values all zero."""
    idx, vals = b2_lanes(dev)
    g = torch.Generator(device=dev).manual_seed(17)
    die = (torch.rand((RAYS,), device=dev, generator=g) < 0.35).contiguous()
    # The pending column 3 sums bounce counts: small integers.
    vals[:, 3] = torch.randint(0, 8, (RAYS,), device=dev, generator=g).float()
    vals[::13] = 0.0  # dying lanes with nothing to add
    return idx, vals.contiguous(), die


def b4_case(what, dest_shape, idx, vals, die):
    """B4 against its plain version on one set of lanes: the film within
    1e-4 of its largest value, the bounce-count column and every row that
    one lane deposits into bit-equal.  Returns (max abs err, largest
    value, depositing lanes, rows touched)."""
    from mrt_torch.ops import deposit as B4

    dev = idx.device
    film_k = B4.deposit_pending(torch.zeros(dest_shape, device=dev), idx,
                                vals, die)
    film_p = B4.deposit_pending_plain(torch.zeros(dest_shape, device=dev),
                                      idx, vals, die)
    torch.cuda.synchronize()
    err = (film_k - film_p).abs().max().item()
    scale = film_p.abs().max().item()
    check(err <= 1e-4 * scale, f"B4 {what}: err {err} (scale {scale})")
    check(torch.equal(film_k[:, 3], film_p[:, 3]), f"B4 {what}: depth column")
    keep = die & (vals != 0).any(1) & (idx >= 0) & (idx < dest_shape[0])
    hits = torch.bincount(idx[keep].to(torch.int64), minlength=dest_shape[0])
    once = hits == 1
    check(torch.equal(film_k[once].view(torch.int32),
                      film_p[once].view(torch.int32)),
          f"B4 {what}: a row of one deposit differs")
    untouched = hits == 0
    check(torch.equal(film_k[untouched].view(torch.int32),
                      torch.zeros_like(film_k[untouched]).view(torch.int32)),
          f"B4 {what}: a row no lane deposits into changed")
    return err, scale, int(keep.sum()), int((hits > 0).sum())


def phase_b4(dev, floor):
    """B4 against its plain version at the main path's shapes, beside
    index_add_ of the masked values (the same library call as B2's); then
    on a lane count that is not a multiple of the block, with every lane
    dying, and with none."""
    from mrt_torch.ops import deposit as B4

    idx, vals, die = b4_lanes(dev)
    shape = (WIDTH * HEIGHT, 4)
    err, scale, depositing, touched = b4_case("main path", shape, idx, vals,
                                              die)
    film = torch.zeros(shape, device=dev)
    kernel = lambda: B4.deposit_pending(film, idx, vals, die)
    plain = lambda: B4.deposit_pending_plain(film, idx, vals, die)
    keep = (die & (vals != 0).any(1) & (idx >= 0) & (idx < shape[0]))
    rows = torch.where(keep, idx, 0).to(torch.int64)
    v = torch.where(keep[:, None], vals, 0.0)
    library = lambda: film.index_add_(0, rows, v)
    ms, plain_ms = graph_ms(kernel, 50), graph_ms(plain, 20)
    library_ms = graph_ms(library, 20)
    # Bytes, in the kernel's order: each lane's die flag; each dying lane's
    # slot, and its values where the slot is in range (read before the
    # all-zero test); each film row a depositing lane touches, read and
    # written.
    dying = int(die.sum())
    in_range = int((die & (idx >= 0) & (idx < shape[0])).sum())
    moved = RAYS + dying * 4 + in_range * 16 + touched * 16 * 2
    log(16, f"B4 {RAYS} lanes into {shape}, {dying} dying, "
            f"{depositing} depositing onto {touched} rows: max abs err "
            f"{err:.3g} (max {scale:.3g}), depth column and rows of one "
            f"deposit exact; device time a call (CUDA graph): kernel "
            f"{ms:.5f} ms, plain {plain_ms:.4f} ms, index_add_ of the masked "
            f"values {library_ms:.4f} ms, floor {floor:.5f} ms; call time "
            f"(CUDA events): wrapper {call_ms(kernel, 50):.4f} ms")
    odd = RAYS - 37  # not a multiple of the 256-lane block
    cases = {
        f"{odd} lanes": (idx[:odd].contiguous(), vals[:odd].contiguous(),
                         die[:odd].contiguous()),
        "every lane dying": (idx, vals, torch.ones_like(die)),
        "no lane dying": (idx, vals, torch.zeros_like(die)),
    }
    extra = {}
    for what, lanes in cases.items():
        e, sc, dep, rows_hit = b4_case(what, shape, *lanes)
        extra[what] = dict(max_abs_err=e, scale=sc, depositing=dep,
                           rows=rows_hit)
    check(extra["no lane dying"]["depositing"] == 0, "B4: no lane dying")
    log(16, "B4 " + "; ".join(
        f"{k}: {x['depositing']} depositing onto {x['rows']} rows, max abs "
        f"err {x['max_abs_err']:.3g} (max {x['scale']:.3g})"
        for k, x in extra.items())
        + ": depth column and rows of one deposit exact")
    return dict(max_abs_err=max([err] + [x["max_abs_err"]
                                         for x in extra.values()]),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                floor_ms=floor, cases=extra,
                **bound(moved, depositing * 4))


def phase_light_goldens(dev):
    """cornell_nee_24 on both integrators and through the pend film mode
    (B4 launched, B2 not), menger2_voxel_24 under C10's rule."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_golden_scenes as TG

    phase_golden(17, "cornell_nee", dev, build=TG.FACTORIES["cornell_nee"])
    reset_launches()
    with environ(MRT_FILM_PEND="1"):
        phase_golden(17, "cornell_nee", dev, build=TG.FACTORIES["cornell_nee"])
    launches = read_launches()
    check(launches["B4"] > 0 and launches["B2"] == 0,
          f"cornell_nee_24 with MRT_FILM_PEND=1: launches {launches}")
    log(17, f"cornell_nee_24 with MRT_FILM_PEND=1: B4 launched "
            f"{launches['B4']} times, B2 {launches['B2']}")
    phase_golden(17, "menger2_voxel", dev, build=TG.FACTORIES["menger2_voxel"],
                 max_outside=40)


def phase_nee(dev):
    """cornell with NEE on both film modes, without and with Russian
    roulette."""
    runs = {}
    for rr in (None, 3):
        for pend in (False, True):
            key = (rr, pend)
            runs[key] = {}
            kernels = ("B1", "B7") + (("B4",) if pend else ("B2",))
            with environ(MRT_FILM_PEND="1" if pend else "0"):
                launches, mean = phase_main(
                    18, "cornell", dev, kernels, nee=True, rr_depth=rr,
                    film_out=runs[key], absent=("B2",) if pend else ())
            runs[key].update(launches=launches, mean=mean)
        a, b = runs[(rr, False)]["film"], runs[(rr, True)]["film"]
        diff, scale = films_agree(f"cornell NEE rr_depth={rr}", a, b)
        log(18, f"cornell NEE rr_depth={rr}: the B2 and B4 films' bounce "
                f"counts equal ({int(a.depth_sum.sum())}), max radiance "
                f"difference {diff:.3g} of {scale:.3g}")
    full = int(runs[(None, False)]["film"].depth_sum.sum())
    rr = int(runs[(3, False)]["film"].depth_sum.sum())
    check(rr <= full, f"Russian roulette added bounces: {rr} > {full}")
    log(18, f"cornell NEE: {rr} bounces with rr_depth=3, {full} without")
    for run in runs.values():
        run.pop("film")
    return runs


def phase_menger(dev):
    run = {}
    launches, mean = phase_main(18, "menger", dev, ("B2", "B7"),
                                film_out=run, absent=("B1",))
    check(run["dda_per_step"] > 0, "menger: the voxel walk did not run")
    run.pop("film")
    return dict(run, launches=launches, mean=mean)


def phase_probes(dev):
    """P1-P3 through the probe entry point (launch counts set to 0 just
    before), then each kernel timed beside its plain version."""
    from mrt_torch.ops import _build
    from mrt_torch.tools import probe_stream as P

    reset_launches()
    res = P.run(dev)
    launches = read_launches()
    check(all(launches[k] > 0 for k in ("P1", "P2", "P3")),
          f"probes: launches {launches}")
    f, i = P.tables(dev)
    out = torch.empty((1,), device=dev)
    cyc = torch.empty((4,), dtype=torch.int64, device=dev)
    chain = torch.from_numpy(P.chain()).to(dev)
    visited = torch.empty((1,), dtype=torch.int32, device=dev)
    fills = torch.empty((1,), dtype=torch.int32, device=dev)
    x = torch.ones((1,), device=dev)
    codes = torch.zeros((2,), dtype=torch.int32)
    kb = max(k for k in P.P3_KB if k * 1024 <= res["smem_optin_bytes"])
    # name: (the kernel's launch, its plain version, bytes moved, the
    # kernel's result as left by the last replay).
    kernels = {
        "P1": (lambda: _build.launch("mrt_probe_a", dev, f, i, out, cyc),
               lambda: P.probe_a_plain(f, i), 4 * 10 * P.PAGE * 4 + 4,
               lambda: out),
        "P2": (lambda: _build.launch("mrt_probe_b", dev, chain, P.CHAIN, 0,
                                     visited, fills, cyc),
               None, P.CHAIN * 4 + 4, lambda: visited),
        "P3": (lambda: _build.launch("mrt_probe_c", dev, x, out, kb * 1024,
                                     codes),
               lambda: P.probe_c_plain(x), 8, lambda: out),
    }
    rows = {}
    for name, (kernel, plain, moved, result) in kernels.items():
        ms = graph_ms(kernel, 20)
        got = result().item()
        if plain is None:  # the Python walk syncs: host time of one call
            t0 = time.perf_counter()
            want = P.probe_b_plain(chain).item()
            plain_ms = (time.perf_counter() - t0) * 1e3
        else:
            want = plain().item()
            plain_ms = graph_ms(plain, 20)
        err = abs(got - want)
        check(err == 0.0, f"{name} replayed: {got}, plain {want}")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=None, launches=launches[name],
                          **bound(moved, 0))
    # P3 also as called: CUDA events around 20 host calls, the host's
    # launch gaps in, beside graph replay's device time.
    rows["P3"]["ms_as_called"] = call_ms(kernels["P3"][0], 20)
    p1, p2 = res["p1"], res["p2"]
    check(p1["value"] == P.closed_form() == 7208.0,
          f"P1: {p1['value']}, not 7208.0")
    rows["P1"]["page_arrival_ns"] = p1["page_arrival_ns"]
    rows["P2"]["ns_per_step"] = {k: v["ns_per_step"] for k, v in p2.items()}
    rows["P2"]["page_fills"] = p2["paged"]["fills"]
    rows["P3"].update(sizes=res["p3"], smem_optin_bytes=res["smem_optin_bytes"])
    log(19, f"P1 {p1['value']} (closed form {p1['closed_form']}), pages "
            "arrive (all four in flight, bulk copies) after "
            + ", ".join(f"{c:.0f} ns" for c in p1["page_arrival_ns"])
            + f" at {res['clock_khz']} kHz; kernel {rows['P1']['ms']:.4f} ms "
            f"a call, plain {rows['P1']['plain_ms']:.4f} ms")
    log(19, "P2 1024 visited on each walk; a dependent step: "
            + ", ".join(f"{k} {v['ns_per_step']:.1f} ns "
                        f"({v['cycles_per_step']:.1f} cycles)"
                        for k, v in p2.items())
            + f"; {p2['paged']['fills']} page fills (bulk copies) counted "
            f"by the paged walk, as the cache's plain model; paged kernel "
            f"{rows['P2']['ms']:.4f} ms a call, Python walk "
            f"{rows['P2']['plain_ms']:.3f} ms")
    log(19, "P3, largest size first, then smallest first: "
            + ", ".join(f"{k} KB: {v}" for k, v in res["p3"].items())
            + f"; opt-in limit {res['smem_optin_bytes']} B; kernel "
            f"{rows['P3']['ms']:.5f} ms a call ({kb} KB, CUDA-graph replay), "
            f"{rows['P3']['ms_as_called']:.5f} ms as called (CUDA events), "
            f"plain {rows['P3']['plain_ms']:.5f} ms")
    return rows


def events_wall_ms(fn):
    """(fn's result, its milliseconds between CUDA events, its wall-clock
    milliseconds), timed from a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ms = events_ms(fn)
    return out, ms, (time.perf_counter() - t0) * 1e3


def recover_albedo(dev, steps=60):
    """tests/test_grad.py's albedo recovery on the card: 60 Adam steps at
    12x12, spp 4, depth 4 from (0.3, 0.5, 0.5) towards (0.7, 0.2, 0.4).
    Returns (final albedo, losses)."""
    from mrt_torch import inverse
    from mrt_torch.core.camera import Camera
    from mrt_torch.geometry.scene import Scene
    from mrt_torch.geometry.spheres import Spheres
    from mrt_torch.materials.background import SkyBackground
    from mrt_torch.materials.table import MaterialBuilder

    b = MaterialBuilder()
    ground, free = b.lambertian((0.5, 0.5, 0.5)), b.lambertian((1, 1, 1))
    table = b.build().to(dev)
    spheres = Spheres(torch.tensor([[0.0, -100.5, -2.0], [0.0, 0.0, -2.0]]),
                      torch.tensor([100.0, 0.5]),
                      torch.tensor([ground, free], dtype=torch.int32)).to(dev)
    sky = SkyBackground.create().to(dev)

    def apply(albedo):
        rows = table.albedo.clone()
        rows[free, :3] = albedo
        return Scene(materials=table.replace(albedo=rows), background=sky,
                     spheres=spheres)

    camera = Camera.create(60.0, (0, 0, 0), (0, 0, -1), (0, 1, 0),
                           aspect_ratio=1.0).to(dev)
    with torch.no_grad():
        target = inverse.render_image(
            apply(torch.tensor([0.7, 0.2, 0.4], device=dev)), camera,
            GRAD_RECOVER, GRAD_RECOVER, spp=8, seed=11, max_depth=4)
    return inverse.optimize(apply, torch.tensor([0.3, 0.5, 0.5], device=dev),
                            camera, GRAD_RECOVER, GRAD_RECOVER, target,
                            steps=steps, learning_rate=0.05, spp=4,
                            max_depth=4,
                            seed=100)


def rtiow_grad(dev):
    """RTIOW as the main path renders it (484 spheres through B1) with its
    material table's albedo rows and its sphere centres as parameters:
    (apply(params) -> Scene, the starting params, the camera, the target
    params: the albedo rows perturbed by up to +-20%)."""
    from mrt_torch.scenes import get

    scene, camera = get("rtiow")().generate(device=dev)
    albedo, center = scene.materials.albedo, scene.spheres.center
    check(center.shape == (484, 3), f"RTIOW has {center.shape[0]} spheres")

    def apply(params):
        a, c = params
        return scene.replace(materials=scene.materials.replace(albedo=a),
                             spheres=scene.spheres.replace(center=c))

    rs = np.random.default_rng(20)
    scale = torch.from_numpy(rs.uniform(0.8, 1.2, tuple(albedo.shape))
                             .astype(np.float32)).to(dev)
    target = (torch.clamp(albedo * scale, 0.0, 1.0), center)
    return apply, (albedo, center), camera, target


def grad_pass(apply, params, camera, width, height, target_img):
    """One forward and backward pass of the L2 loss of a spp-1, depth-6
    render_image against `target_img`, the launch counts set to 0 before
    the forward and again before the backward.  Returns a dict: loss,
    grads, both passes' event and wall ms, their launches, the peak
    device bytes (reset before the forward)."""
    from mrt_torch import inverse

    leaves = [x.detach().clone().requires_grad_(True) for x in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss, fwd_ms, fwd_wall = events_wall_ms(lambda: inverse.l2_loss(
        inverse.render_image(apply(leaves), camera, width, height, spp=1,
                             seed=0, max_depth=6), target_img))
    fwd = read_launches()
    reset_launches()
    _, bwd_ms, bwd_wall = events_wall_ms(loss.backward)
    bwd = read_launches()
    return dict(loss=loss.item(), grads=[x.grad for x in leaves],
                fwd_ms=fwd_ms, fwd_wall_ms=fwd_wall, bwd_ms=bwd_ms,
                bwd_wall_ms=bwd_wall, fwd_launches=fwd, bwd_launches=bwd,
                peak_bytes=torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def b1_winners(out, plain=False):
    """Inside the block, every winner search of the sphere route appends
    to `out` a dict of its inputs (center, radius, o, d, t_min, t_max)
    and its winners (t, index); with `plain`, the search is
    nearest_t_plain on the same (CUDA) tensors instead of B1."""
    from mrt_torch.ops import spheres as B1

    fn = B1.nearest_t
    keep = lambda x: x.detach().clone() if torch.is_tensor(x) else x

    def spy(center, radius, o, d, t_min, t_max, groups=None):
        if plain:
            n = o.shape[0]
            check(o.is_cuda, "the plain winners must run on the card")
            with torch.no_grad():
                t, i = B1.nearest_t_plain(center, radius, o, d,
                                          as_lanes(t_min, n, o.device),
                                          as_lanes(t_max, n, o.device))
        else:
            t, i = fn(center, radius, o, d, t_min, t_max, groups=groups)
        out.append(dict(center=keep(center), radius=keep(radius), o=keep(o),
                        d=keep(d), t_min=keep(t_min), t_max=keep(t_max),
                        t=t.clone(), index=i.clone()))
        return t, i

    B1.nearest_t = spy
    try:
        yield
    finally:
        B1.nearest_t = fn


def phase_grad(dev):
    """Phase 20: the gradient path (``mrt_torch.inverse``)."""
    from mrt_torch import inverse
    from mrt_torch.geometry import spheres as S
    from mrt_torch.ops import spheres as B1

    # test_grad's albedo recovery, on the card.
    reset_launches()
    (albedo, losses), rec_ms, rec_wall = events_wall_ms(
        lambda: recover_albedo(dev))
    rec_launches = read_launches()
    err = (albedo - torch.tensor([0.7, 0.2, 0.4], device=dev)).abs().max()
    check(losses[-1] < 0.6 * losses[0] and err.item() < 0.08,
          f"albedo recovery: losses {losses[0]:.6f} -> {losses[-1]:.6f}, "
          f"albedo {albedo.tolist()}")
    check(rec_launches["B1"] > 0, f"recovery launched {rec_launches}")
    # Kernels a recovery step: three steps less one (the target's render
    # drops out), halved, under torch.profiler.
    from torch.profiler import ProfilerActivity, profile

    counted = []
    for steps in (1, 3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            recover_albedo(dev, steps=steps)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        counted.append((sum(e.count for e in ka
                            if e.device_type.name == "CUDA"),
                        sum(e.self_device_time_total for e in ka) / 1e3))
    step_kernels = (counted[1][0] - counted[0][0]) / 2
    step_device_ms = (counted[1][1] - counted[0][1]) / 2
    log(20, f"albedo recovery {GRAD_RECOVER}x{GRAD_RECOVER}, 60 Adam steps: "
            f"loss {losses[0]:.6f} -> {losses[-1]:.6f}, albedo "
            f"{[round(v, 4) for v in albedo.tolist()]} (truth 0.7, 0.2, "
            f"0.4), {rec_wall:.0f} ms ({rec_wall / 60:.1f} ms a step), B1 "
            f"{rec_launches['B1']} launches; a step: {step_kernels:.0f} "
            f"device kernels, {step_device_ms:.1f} device ms (torch.profiler)")

    # RTIOW at full size: one forward and backward pass.
    apply, params, camera, target = rtiow_grad(dev)
    with torch.no_grad():
        target_img = inverse.render_image(apply(target), camera, GRAD_W,
                                          GRAD_H, spp=1, seed=0, max_depth=6)
    apply_ms = []
    for _ in range(3):
        _, _, wall = events_wall_ms(lambda: apply(
            [x.detach().clone().requires_grad_(True) for x in params]))
        apply_ms.append(wall)
    run = grad_pass(apply, params, camera, GRAD_W, GRAD_H, target_img)
    fwd, bwd = run["fwd_launches"], run["bwd_launches"]
    check(fwd["B1"] == 6 and bwd["B1"] == 6
          and all(v == 0 for run_ in (fwd, bwd) for k, v in run_.items()
                  if k != "B1"),
          f"gradient pass: B1 should launch once a bounce in the forward "
          f"and once in the recompute: {fwd}, {bwd}")
    for name, g in zip(("albedo", "centre"), run["grads"]):
        check(g is not None and torch.isfinite(g).all().item()
              and (g != 0).any().item(),
              f"{name} gradient: {(~torch.isfinite(g)).sum().item()} "
              f"entries not finite, {(g != 0).sum().item()} non-zero")
    check(np.isfinite(run["loss"]) and run["loss"] > 0,
          f"loss {run['loss']}")
    # The recomputed root against B1's t on the camera rays.
    sc = apply(params)
    o, d = camera.rays(*torch.rand((4, RAYS), device=dev,
                                   generator=torch.Generator(dev)
                                   .manual_seed(20)))
    t, i = B1.nearest_t(sc.spheres.center, sc.spheres.radius, o, d, 1e-3,
                        float("inf"), groups=sc.spheres.groups)
    hit = torch.isfinite(t)
    k = i.to(torch.int64)
    root = S.winner_root(sc.spheres.center[k], sc.spheres.radius[k], o, d,
                         hit, 1e-3)
    check(torch.equal(root[hit], t[hit]),
          f"recomputed roots differ from B1's t on "
          f"{(root[hit] != t[hit]).sum().item()} of {hit.sum().item()} lanes")
    log(20, f"RTIOW {GRAD_W}x{GRAD_H} spp 1 depth 6, albedo rows "
            f"{tuple(params[0].shape)} and 484 centres: loss "
            f"{run['loss']:.6f}; forward {run['fwd_ms']:.1f} ms (events), "
            f"{run['fwd_wall_ms']:.1f} ms (wall); backward "
            f"{run['bwd_ms']:.1f} ms (events), {run['bwd_wall_ms']:.1f} ms "
            f"(wall); peak {run['peak_bytes'] / 2**30:.3f} GiB; B1 launches "
            f"{fwd['B1']} forward, {bwd['B1']} in the recompute; apply "
            f"(scene rebuild, B1's groups on the host) "
            f"{[round(v, 2) for v in apply_ms]} ms; gradients finite; "
            f"recomputed roots equal B1's t on {hit.sum().item()} hit lanes")

    # B1 at this path's own shape: a second 1080p pass records each
    # search's inputs and winners (forward and recompute), and
    # nearest_t_plain on the same inputs on the card must give the same
    # t and index bit for bit.
    searches = []
    with b1_winners(searches):
        grad_pass(apply, params, camera, GRAD_W, GRAD_H, target_img)
    lanes = GRAD_W * GRAD_H
    check(len(searches) == 12
          and all(x["o"].shape[0] == lanes for x in searches),
          f"the 1080p pass made {len(searches)} searches of "
          f"{[x['o'].shape[0] for x in searches]} lanes")
    full_hits = []
    for k, x in enumerate(searches):
        with torch.no_grad():
            pt, pi = B1.nearest_t_plain(
                x["center"], x["radius"], x["o"], x["d"],
                as_lanes(x["t_min"], lanes, dev),
                as_lanes(x["t_max"], lanes, dev))
        check(torch.equal(pt, x["t"]) and torch.equal(pi, x["index"]),
              f"1080p search {k}: B1 differs from nearest_t_plain on "
              f"{(pt != x['t']).sum().item()} t and "
              f"{(pi != x['index']).sum().item()} index lanes")
        hit = torch.isfinite(pt)
        w = pi.to(torch.int64)
        root = S.winner_root(x["center"][w], x["radius"][w], x["o"],
                             x["d"], hit, x["t_min"])
        check(torch.equal(root[hit], pt[hit]),
              f"1080p search {k}: recomputed roots differ from B1's t on "
              f"{(root[hit] != pt[hit]).sum().item()} lanes")
        full_hits.append(hit.sum().item())
    log(20, f"{GRAD_W}x{GRAD_H}: B1's winners bit-equal to nearest_t_plain's "
            f"on the card in all {len(searches)} searches ({lanes} lanes "
            f"each, forward and recompute; hit lanes {full_hits}), and the "
            "recomputed roots equal to B1's t on every hit lane")

    # The table-row gather's backward at this path's shape: the sphere
    # centres gathered by the camera rays' winners, as the path gathers
    # them (index_select, whose backward is index_add_), beside indexing
    # (whose backward sorts the indices).
    center = params[1].detach().clone().requires_grad_(True)
    idx = searches[0]["index"].to(torch.int64)
    del searches
    gy = torch.rand((lanes, 3), device=dev,
                    generator=torch.Generator(dev).manual_seed(21))
    gather_ms = {}
    for name, f in (("index_select", lambda x: torch.index_select(x, 0, idx)),
                    ("indexing", lambda x: x[idx])):
        f(center).backward(gy)  # warm-up
        y = f(center)
        gather_ms[name] = events_ms(lambda: y.backward(gy))[1]
    top_row = torch.bincount(idx).max().item() / lanes
    log(20, f"gather backward, (484, 3) centres by {lanes} winners "
            f"({top_row:.3f} of them on one row): index_select "
            f"{gather_ms['index_select']:.3f} ms, indexing "
            f"{gather_ms['indexing']:.3f} ms (CUDA events)")

    # B1's winners against nearest_t_plain's, on the card, at the crop.
    with torch.no_grad():
        crop_target = inverse.render_image(apply(target), camera, CROP_W,
                                           CROP_H, spp=1, seed=0, max_depth=6)
    got, want = [], []
    with b1_winners(got):
        k_run = grad_pass(apply, params, camera, CROP_W, CROP_H, crop_target)
    with b1_winners(want, plain=True):
        p_run = grad_pass(apply, params, camera, CROP_W, CROP_H, crop_target)
    check(len(got) == len(want) == 12
          and all(torch.equal(a["t"], b["t"])
                  and torch.equal(a["index"], b["index"])
                  for a, b in zip(got, want)),
          f"B1's winners differ from nearest_t_plain's ({len(got)}, "
          f"{len(want)} searches)")
    rel = []
    for gk, gp in zip(k_run["grads"], p_run["grads"]):
        scale = gp.abs().max().item()
        rel.append((gk - gp).abs().max().item() / max(scale, 1e-30))
        check(torch.allclose(gk, gp, rtol=1e-5, atol=1e-5 * scale),
              f"gradients with B1's winners differ from the plain "
              f"winners': {rel[-1]:.3e} of the largest")
    log(20, f"{CROP_W}x{CROP_H}: B1's winners bit-equal to nearest_t_plain's "
            f"on the card in all {len(got)} searches (forward and "
            f"recompute); loss {k_run['loss']:.6f} and {p_run['loss']:.6f}; "
            f"gradients within {max(rel):.2e} of the largest (albedo "
            f"{rel[0]:.2e}, centres {rel[1]:.2e}); backward "
            f"{k_run['bwd_ms']:.1f} ms with B1, {p_run['bwd_ms']:.1f} ms "
            "plain")
    return dict(recover=dict(losses=[losses[0], losses[-1]],
                             albedo=albedo.tolist(), wall_ms=rec_wall,
                             launches=rec_launches["B1"],
                             step_kernels=step_kernels,
                             step_device_ms=step_device_ms),
                loss=run["loss"], fwd_ms=run["fwd_ms"],
                fwd_wall_ms=run["fwd_wall_ms"], bwd_ms=run["bwd_ms"],
                bwd_wall_ms=run["bwd_wall_ms"], peak_bytes=run["peak_bytes"],
                launches_forward=fwd["B1"], launches_recompute=bwd["B1"],
                apply_ms=apply_ms, crop_rel=rel,
                gather_backward_ms=gather_ms)



# Phase 21: the CLI's default scene and size, its checkpoint's two runs,
# the AOV pre-pass's scenes, and the size of the viewer's and the
# subprocess's small renders.
CLI_W, CLI_H = WIDTH, HEIGHT
CLI_SPP = (8, 16)
AOV_SCENES = ("rtiow", "sphere_grid", "lucy")
AOV_CROP_W, AOV_CROP_H = CROP_W, CROP_H
VIEW_W, VIEW_H = 320, 180


@contextlib.contextmanager
def timed_calls(module, name, out):
    """Inside the block, each call of module.name appends its seconds,
    from a device sync to a device sync, to `out`."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        return result

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def first_and_last_calls(module, name, out):
    """Inside the block, the arguments of the first and of the last call
    of module.name go into out["first"] and out["last"] (tensors
    cloned)."""
    fn = getattr(module, name)
    keep = lambda x: x.detach().clone() if torch.is_tensor(x) else x

    def spy(*args, **kwargs):
        call = ([keep(a) for a in args], {k: keep(v) for k, v in
                                          kwargs.items()})
        out.setdefault("first", call)
        out["last"] = call
        out["calls"] = out.get("calls", 0) + 1
        return fn(*args, **kwargs)

    # The wrapper counts its launches on the module's attribute: the spy.
    spy.launches = fn.launches
    setattr(module, name, spy)
    try:
        yield
    finally:
        fn.launches = spy.launches
        setattr(module, name, fn)


def cli_run(dev, argv):
    """mrt_torch.__main__.main(argv) with the launch counts set to 0
    just before and read just after: (film, launches, steps, pass
    seconds, AOV pre-pass seconds, wall seconds, peak device bytes)."""
    from mrt_torch import __main__ as cli
    from mrt_torch.runtime import render as R

    passes, aovs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with counting_steps() as steps, \
            timed_calls(R, "render_pass_persistent", passes), \
            timed_calls(R, "aov_pass", aovs):
        t0 = time.perf_counter()
        film = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (film, read_launches(), steps["steps"], passes, aovs, wall,
            torch.cuda.max_memory_allocated())


def kernel_winners(name, calls, dev):
    """The first and last captured calls of kernel `name` ("B1", "B5",
    "B7") against their plain versions on the same tensors on the card:
    B1 bit-equal to nearest_t_plain; B5 bit-equal to the octant-order
    walk, B5 and B7 >= 99.9% equal to the escape order (B7 also to its
    own order).  Returns {"first"/"last": (rays, agreement)}."""
    from mrt_torch.ops import bvh as K
    from mrt_torch.ops import spheres as B1

    out = {}
    for which in ("first", "last"):
        args, kw = calls[which]
        if name == "B1":
            center, radius, o, d, lo, hi = args
            n = o.shape[0]
            t_k, i_k = B1.nearest_t(center, radius, o, d, lo, hi, **kw)
            t_p, i_p = B1.nearest_t_plain(center, radius, o, d,
                                          as_lanes(lo, n, dev),
                                          as_lanes(hi, n, dev))
            check(torch.equal(t_k, t_p) and torch.equal(i_k, i_p),
                  f"AOV pre-pass, {which} batch: B1 differs from "
                  f"nearest_t_plain on {(i_k != i_p).sum().item()} lanes")
            agree = 1.0
        elif name == "B5":
            nodes, meta, sph, o, d, lo, hi = args
            n = o.shape[0]
            lanes = (as_lanes(lo, n, dev), as_lanes(hi, n, dev))
            t_k, i_k = K.sphere_bvh_hit(nodes, meta, sph, o, d, lo, hi, **kw)
            t_p, i_p = K.sphere_bvh_plain(nodes, meta, sph, o, d, *lanes,
                                          order=kw["card"][1])
            check(torch.equal(t_k, t_p) and torch.equal(i_k, i_p),
                  f"AOV pre-pass, {which} batch: B5 differs from its "
                  f"octant-order walk on {(i_k != i_p).sum().item()} lanes")
            t_e, i_e = K.sphere_bvh_plain(nodes, meta, sph, o, d, *lanes)
            agree = compare_hits(f"AOV B5 {which} (escape order)", t_k, i_k,
                                 t_e, i_e)[2]
        else:
            tl, o, d, lo, hi = args
            n = o.shape[0]
            lanes = (as_lanes(lo, n, dev), as_lanes(hi, n, dev))
            k = K.tlas_hit(tl, o, d, lo, hi)
            pair = lambda w: w[1].to(torch.int64) * (1 << 31) + w[2]
            for ordered in (True, False):
                p = K.tlas_plain(tl, o, d, *lanes, ordered=ordered)
                agree = compare_hits(
                    f"AOV B7 {which} ({'own' if ordered else 'escape'} "
                    "order)", k[0], pair(k), p[0], pair(p),
                    uv=((k[3], p[3]), (k[4], p[4])))[2]
        out[which] = (n, agree)
    return out


def aov_scene(name, dev):
    """The AOV pre-pass of scene `name` at CLI_W x CLI_H on the card:
    its device ms (two runs, CUDA events), launches (counts set to 0
    before each), its first and last batches' winners against the plain
    versions, and the whole frame at the crop against the port's CPU
    run."""
    from mrt_torch.integrator import wavefront
    from mrt_torch.ops import bvh as K
    from mrt_torch.ops import spheres as B1
    from mrt_torch.runtime import render as R
    from mrt_torch.scenes import get

    scene, camera = get(name)().generate(device=dev)
    batches = -(-CLI_W * CLI_H // wavefront.RAY_BATCH)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_launches()
        _, ms = events_ms(lambda: R.aov_pass(scene, camera, width=CLI_W,
                                             height=CLI_H, seed=1))
        runs.append((ms, read_launches()))
    kernels = {"rtiow": ("B1",), "sphere_grid": ("B5", "B7"),
               "lucy": ("B1", "B7")}[name]
    for _, launches in runs:
        check(all(launches[k] == batches for k in kernels)
              and all(v == 0 for k, v in launches.items()
                      if k not in kernels),
              f"{name} AOV pre-pass: {launches}, not {batches} launches "
              f"of each of {kernels}")
    spots = {"B1": (B1, "nearest_t"), "B5": (K, "sphere_bvh_hit"),
             "B7": (K, "tlas_hit")}
    calls = {k: {} for k in kernels}
    with contextlib.ExitStack() as stack:
        for k in kernels:
            stack.enter_context(first_and_last_calls(*spots[k], calls[k]))
        R.aov_pass(scene, camera, width=CLI_W, height=CLI_H, seed=1)
    winners = {k: kernel_winners(k, calls[k], dev) for k in kernels}
    del calls
    # The whole frame at the crop, card against the port's CPU run.
    card = [x.cpu() for x in R.aov_pass(scene, camera, width=AOV_CROP_W,
                                        height=AOV_CROP_H, seed=1)]
    scene_c, camera_c = get(name)().generate(device="cpu")
    host = R.aov_pass(scene_c, camera_c, width=AOV_CROP_W, height=AOV_CROP_H,
                      seed=1)
    far = ((card[0] - host[0]).abs().amax(-1) > 1e-5) | (
        (card[1] - host[1]).abs().amax(-1) > 1e-5)
    share = far.float().mean().item()
    # B1 is bit-equal to the brute force; the BVH walks may keep another
    # winner on ~1 ray in 10^4 (C15).
    check(far.sum().item() == 0 if name == "rtiow" else share <= 1e-3,
          f"{name} AOV frame {AOV_CROP_W}x{AOV_CROP_H}: {far.sum().item()} "
          "pixels further than 1e-5 from the CPU run")
    err = max((a - b).abs()[~far].max().item() for a, b in zip(card, host))
    del scene, camera, scene_c, camera_c
    return dict(ms=[r[0] for r in runs], launches=runs[0][1],
                winners=winners, crop_far=far.sum().item(), crop_err=err,
                batches=batches)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def viewer_check(dev, work):
    """serve() at VIEW_W x VIEW_H in a thread: /status, /frame.png
    (decoded), key 2 (DENOISE), key e (export writes a PNG), then the
    stop event.  Returns the seconds to the first frame."""
    import threading
    import urllib.request

    from mrt_torch.runtime.config import RenderConfig
    from mrt_torch.runtime.io import decode_png, load_png
    from mrt_torch.runtime.viewer import serve

    config = RenderConfig(scene="rtiow", width=VIEW_W, height=VIEW_H, spp=64,
                          samples_per_pass=1, max_depth=8, serve=True,
                          port=free_port(),
                          output=os.path.join(work, "live.png"))
    get = lambda path: urllib.request.urlopen(
        f"http://127.0.0.1:{config.port}{path}", timeout=10).read()

    def wait(test, what, seconds=120):
        deadline = time.time() + seconds
        while time.time() < deadline:
            try:
                value = test()
                if value:
                    return value
            except OSError:
                pass
            time.sleep(0.1)
        raise RuntimeError(f"viewer: {what} not seen in {seconds} s")

    stop = threading.Event()
    thread = threading.Thread(target=serve, args=(config,),
                              kwargs=dict(log=lambda *a: None, stop=stop,
                                          device=dev),
                              daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        status = wait(lambda: (lambda s: s if s["samples"] >= 1 else None)(
            json.loads(get("/status"))), "a first pass")
        first_s = time.perf_counter() - t0
        frame = decode_png(get("/frame.png"))
        check(frame.shape == (VIEW_H, VIEW_W, 4),
              f"/frame.png decoded to {frame.shape}")
        get("/key?k=2")
        wait(lambda: json.loads(get("/status"))["mode"] == "denoise",
             "mode denoise")
        get("/key?k=e")
        wait(lambda: os.path.exists(config.output), "the exported PNG")
        check(load_png(config.output).shape == (VIEW_H, VIEW_W, 4),
              "the exported PNG has another size")
    finally:
        stop.set()
        thread.join(timeout=120)
    check(not thread.is_alive(), "the viewer's render thread did not stop")
    return dict(first_frame_s=first_s, status=status)


def cli_subprocess(work):
    """``python -m mrt_torch`` at VIEW_W x VIEW_H, spp 2, without
    --device: it renders on the card (and without a visible card it
    raises instead of falling back to the CPU), and imports no PIL, JAX
    or mrt (``-X importtime`` lists every module it imports)."""
    from mrt_torch.runtime.io import load_png

    out = os.path.join(work, "sub.png")
    args = ["-m", "mrt_torch", "--scene", "rtiow", "--width", str(VIEW_W),
            "--height", str(VIEW_H), "--spp", "2", "-o", out]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-X", "importtime"] + args,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"python -m mrt_torch failed: "
                               f"{res.stderr[-2000:]}")
    modules = [line.rsplit("|", 1)[1].strip() for line in
               res.stderr.splitlines() if line.startswith("import time:")]
    bad = sorted({m for m in modules
                  if m.split(".")[0] in ("PIL", "jax", "jaxlib", "mrt")})
    check(len(modules) > 100 and not bad,
          f"python -m mrt_torch imported {bad} ({len(modules)} modules)")
    check(load_png(out).shape == (VIEW_H, VIEW_W, 4),
          "the subprocess's PNG has another size")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    check(res.returncode != 0 and "no CUDA device" in res.stderr,
          "python -m mrt_torch without a visible card did not refuse")
    return dict(seconds=seconds, modules=len(modules))


def phase_cli(dev):
    """Phase 21: the user's entry point on the card."""
    import tempfile

    from mrt_torch.integrator import wavefront
    from mrt_torch.runtime import denoise as D
    from mrt_torch.runtime import io as IO
    from mrt_torch.runtime.config import RenderConfig
    from mrt_torch.runtime.driver import export
    from mrt_torch.runtime.film import DisplayMode, Film

    work = tempfile.mkdtemp(prefix="mrt_cli_")
    ckpt = os.path.join(work, "rtiow.npz")
    out = os.path.join(work, "rtiow.png")
    argv = ["--scene", "rtiow", "--width", str(CLI_W), "--height",
            str(CLI_H), "--max-depth", "50", "--samples-per-pass", "4",
            "--denoise", "--display-mode", "denoise", "--checkpoint", ckpt,
            "-o", out]
    runs = []
    denoiser = D.make_denoiser()
    batches = -(-CLI_W * CLI_H // wavefront.RAY_BATCH)
    for spp in CLI_SPP:
        film, launches, steps, passes, aovs, wall, peak = cli_run(
            dev, argv + ["--spp", str(spp)])
        check(film.samples == spp and Film.load_state(ckpt, device=dev)[
            0].samples == spp, f"the checkpoint holds "
                              f"{Film.load_state(ckpt, device=dev)[0].samples}"
                              f" samples, the film {film.samples}, not {spp}")
        check(launches["B1"] == steps + batches and launches["B2"] == steps
              and all(v == 0 for k, v in launches.items()
                      if k not in ("B1", "B2")),
              f"CLI run to spp {spp}: {steps} steps, launches {launches}; "
              f"B1 should launch once a step and {batches} times in the "
              "pre-pass, B2 once a step")
        shown = film.to_rgb_bytes(DisplayMode.DENOISE, denoiser=denoiser)
        check(np.array_equal((IO.load_png(out)[..., :3] * 255.0).round()
                             .astype(np.uint8), shown[::-1]),
              "the CLI's PNG differs from film.to_rgb_bytes(DENOISE)")
        runs.append(dict(spp=spp, steps=steps, launches=launches,
                         pass_s=passes, aov_s=aovs, wall_s=wall,
                         peak_bytes=peak))
        log(21, f"python -m mrt_torch (in-process main) --scene rtiow "
                f"{CLI_W}x{CLI_H} depth 50 --spp {spp} --samples-per-pass 4 "
                f"--denoise --display-mode denoise --checkpoint: "
                f"{film.samples} samples in the film and the checkpoint; "
                f"{wall:.3f} s wall; passes "
                f"{[round(x, 3) for x in passes]} s; AOV pre-pass "
                f"{[round(x, 3) for x in aovs]} s; {steps} steps; launches "
                f"B1 {launches['B1']} (steps + {batches}), B2 "
                f"{launches['B2']}; "
                f"peak {peak} B")
    # The five display modes, exported as the driver exports them.
    modes = {}
    for mode in DisplayMode:
        path = os.path.join(work, f"{mode.value}.png")
        config = RenderConfig(display_mode=mode.value, denoise=True,
                              output=path)
        t0 = time.perf_counter()
        export(film, path, config)
        modes[mode.value] = time.perf_counter() - t0
        want = film.to_rgb_bytes(mode, denoiser=denoiser)[::-1]
        got = (IO.load_png(path)[..., :3] * 255.0).round().astype(np.uint8)
        check(np.array_equal(got, want),
              f"exported {mode.value} PNG differs from to_rgb_bytes")
    rgb = film.to_float_rgb(DisplayMode.DEFAULT)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    den, den_ms = events_ms(lambda: D.denoise(rgb, film.albedo, film.normal))
    den_ms = [den_ms] + [events_ms(lambda: D.denoise(
        rgb, film.albedo, film.normal))[1] for _ in range(2)]
    den_peak = torch.cuda.max_memory_allocated() - base
    check(torch.isfinite(den).all().item() and den.min().item() >= 0.0
          and den.max().item() <= 1.0 + 1e-6,
          f"denoised frame: min {den.min().item()}, max {den.max().item()}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        D.denoise(rgb, film.albedo, film.normal)
        torch.cuda.synchronize()
    den_kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type.name == "CUDA")
    shown = film.to_rgb_bytes(DisplayMode.DEFAULT)
    png_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        png = IO.png_encode(shown)
        png_ms.append((time.perf_counter() - t0) * 1e3)
    check(np.array_equal(IO.decode_png(png)[..., :3], shown[::-1]),
          "png_encode does not round-trip")
    log(21, f"exports at {CLI_W}x{CLI_H} (to_rgb_bytes + PNG + write, s): "
            f"{ {k: round(v, 3) for k, v in modes.items()} }, each decoded "
            f"by load_png equal to to_rgb_bytes; denoiser {CLI_W}x{CLI_H}: "
            f"{[round(x, 2) for x in den_ms]} ms (CUDA events), "
            f"{den_kernels} device kernels (torch.profiler), peak {den_peak} "
            f"B over the {base} B already allocated, output finite in "
            f"[{den.min().item():.6f}, {den.max().item():.6f}]; png_encode "
            f"{[round(x, 1) for x in png_ms]} ms ({len(png)} B)")
    del den, rgb

    # The denoiser on the card against the port's CPU run.
    buffers = np.load(os.path.join(ROOT, "artifacts", "denoise_buffers.npz"))
    den_err = {}
    for name in ("rtiow", "cornell"):
        for guides in ("both", "none"):
            arrays = [buffers[f"{name}_{k}"] for k in ("low", "albedo",
                                                       "normal")]
            if guides == "none":
                arrays[1:] = [None, None]
            on = lambda d: [None if a is None else torch.from_numpy(a).to(d)
                            for a in arrays]
            err = (D.denoise(*on(dev)).cpu() - D.denoise(*on("cpu"))).abs()
            den_err[f"{name} {guides}"] = err.max().item()
            check(den_err[f"{name} {guides}"] <= 1e-5,
                  f"denoise on the card vs the CPU, {name} {guides}: "
                  f"{den_err[f'{name} {guides}']}")
    log(21, f"denoise 160x160 on the card against the port's CPU run: "
            f"max |diff| {den_err} (<= 1e-5)")

    aov = {}
    for name in AOV_SCENES:
        aov[name] = r = aov_scene(name, dev)
        wins = "; ".join(
            f"{k} first {v['first'][0]} rays {v['first'][1]:.6f}, last "
            f"{v['last'][0]} rays {v['last'][1]:.6f}"
            for k, v in r["winners"].items())
        log(21, f"AOV pre-pass {name} {CLI_W}x{CLI_H}: {r['batches']} "
                f"batches, {[round(x, 2) for x in r['ms']]} ms (CUDA events, "
                f"two runs), launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }; winners "
                f"against the plain versions on the card ({wins}); "
                f"{AOV_CROP_W}x{AOV_CROP_H} frame against the CPU run: "
                f"{r['crop_far']} pixels past 1e-5, the rest within "
                f"{r['crop_err']:.2e}")

    view = viewer_check(dev, work)
    log(21, f"serve {VIEW_W}x{VIEW_H} in a thread: first pass published in "
            f"{view['first_frame_s']:.2f} s, /status {view['status']}, "
            "/frame.png decoded, key 2 -> denoise, key e exported a PNG, "
            "stopped")
    sub = cli_subprocess(work)
    log(21, f"python -X importtime -m mrt_torch --scene rtiow {VIEW_W}x"
            f"{VIEW_H} --spp 2 (no --device): {sub['seconds']:.1f} s, "
            f"{sub['modules']} modules imported, none of PIL, jax, mrt; the "
            "PNG decoded; with CUDA_VISIBLE_DEVICES='' it refused (no "
            "CUDA device)")
    return dict(runs=runs, export_s=modes, denoise_ms=den_ms,
                denoise_kernels=den_kernels, denoise_peak_bytes=den_peak,
                denoise_cpu_err=den_err, png_encode_ms=png_ms,
                aov={k: dict(ms=v["ms"], launches={a: b for a, b in
                                                   v["launches"].items()
                                                   if b},
                             crop_far=v["crop_far"],
                             winners={a: {w: list(x) for w, x in b.items()}
                                      for a, b in v["winners"].items()})
                     for k, v in aov.items()},
                viewer_first_frame_s=view["first_frame_s"],
                subprocess_s=sub["seconds"])


SHARD_W, SHARD_H = 256, 144   # phase 22's wavefront pass
GRID_W, GRID_H = 480, 270     # phase 22's sphere_grid on two ranks
SHARD_MESHES = ((2, 1), (1, 2))


@contextlib.contextmanager
def timed_all_reduce(out):
    """Adds the seconds of each Mesh.all_reduce inside the block (the
    device synced before and after it) to out["all_reduce_s"]."""
    from mrt_torch.parallel.mesh import Mesh

    fn = Mesh.all_reduce
    out["all_reduce_s"] = 0.0

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn(self, *a, **k)
        torch.cuda.synchronize()
        out["all_reduce_s"] += time.perf_counter() - t0
        return y

    Mesh.all_reduce = timed
    try:
        yield
    finally:
        Mesh.all_reduce = fn


@contextlib.contextmanager
def cpu_trig():
    """The CPU's float32 sin and cos on every device inside the block:
    CUDA's differ from them by an ulp on some inputs (ROADMAP C22)."""
    saved = torch.sin, torch.cos
    torch.sin, torch.cos = (
        (lambda x, fn=fn: fn(x.cpu()).to(x.device)) for fn in saved)
    try:
        yield
    finally:
        torch.sin, torch.cos = saved


def shard_pass(name, dev, width, height, mesh):
    """render_sharded(persistent=True) of scene `name` at depth 50, spp 2,
    with launch counts set to 0 just before, after one all-reduce and one
    gather of a float on each axis (a backend sets up its communicators
    at a group's first collective).  Returns (film, seconds, launches,
    steps, all-reduce seconds)."""
    from mrt_torch.parallel import render_sharded
    from mrt_torch.scenes import get

    scene, camera = get(name)().generate(device=dev)
    for axis in mesh.groups:
        mesh.all_gather(mesh.all_reduce(torch.ones(1, device=dev), axis),
                        axis)
    torch.cuda.synchronize()
    reset_launches()
    out = {}
    with counting_steps() as steps, timed_all_reduce(out):
        t0 = time.perf_counter()
        film = render_sharded(scene, camera, width, height, mesh, spp=2,
                              seed=1, max_depth=50, persistent=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return film, seconds, read_launches(), steps["steps"], out["all_reduce_s"]


def shard_worker(rank, init, out):
    """One of phase 22's two ranks on the card (a subprocess): a gloo
    group, the meshes of SHARD_MESHES, RTIOW at 1080p and sphere_grid at
    GRID_W x GRID_H; rank 0 writes each gathered film, every rank its
    numbers, under `out`."""
    sys.path.insert(0, ROOT)
    from mrt_torch.ops import _build
    from mrt_torch.parallel import init_distributed, make_mesh

    dev = torch.device("cuda", 0)
    _build.library()
    init_distributed(init, num_processes=2, process_id=rank,
                     backend="gloo", device=dev, timeout=600)
    numbers = {}
    for name, w, h in (("rtiow", WIDTH, HEIGHT),
                       ("sphere_grid", GRID_W, GRID_H)):
        for tile, spp in SHARD_MESHES:
            mesh = make_mesh(tile=tile, spp=spp, device=dev)
            film, seconds, launches, steps, ar = shard_pass(name, dev, w, h,
                                                            mesh)
            key = f"{name}-{tile}x{spp}"
            numbers[key] = dict(seconds=seconds, launches=launches,
                                steps=steps, all_reduce_s=ar)
            if rank == 0:
                np.savez(os.path.join(out, key + ".npz"),
                         sum=film.sum.cpu().numpy(),
                         depth=film.depth_sum.cpu().numpy(),
                         samples=film.samples)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(numbers, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_sharded(dev, rtiow):
    """Phase 22: the sharded paths on the card.  `rtiow`: phase 6's
    film_out.  Returns the numbers of the JSON line."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from mrt_torch.parallel import make_mesh, render_pass_sharded
    from mrt_torch.parallel.mesh import Mesh
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    # (a) One process, one NCCL group, mesh (1, 1).
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(tile=1, spp=1, device=dev)
        check(mesh.groups["spp"] is not None, "no process group on (1, 1)")
        film, seconds, launches, steps, ar = shard_pass("rtiow", dev, WIDTH,
                                                        HEIGHT, mesh)
        check(launches["B1"] == launches["B2"] == steps > 0
              and not any(v for k, v in launches.items()
                          if k not in ("B1", "B2")),
              f"sharded RTIOW: B1 and B2 not once a step ({steps} steps): "
              f"{launches}")
        check(film.samples == 2, f"samples {film.samples}")
        diff, scale = films_agree("sharded RTIOW (1, 1) against phase 6",
                                  film, rtiow["film"])
        log(22, f"(a) NCCL, mesh (1, 1): render_sharded(persistent=True) of "
                f"RTIOW {WIDTH}x{HEIGHT} depth 50 spp 2 pool {RAYS}: "
                f"{seconds:.3f} s (phase 6: {rtiow['seconds']:.3f} s), "
                f"{steps} steps (phase 6: {rtiow['steps']}), all-reduce "
                f"{ar * 1e3:.3f} ms a pass, launches {launches}; bounce "
                f"counts equal phase 6's, radiance within {diff:.3g} (max "
                f"{scale:.3g})")
        a = dict(seconds=seconds, phase6_seconds=rtiow["seconds"],
                 steps=steps, all_reduce_ms=ar * 1e3, launches=launches)

        # The wavefront pass on the card against the CPU's (C20).
        passes = {}
        for where, d, trig in (("card", dev, contextlib.nullcontext),
                               ("card, CPU sin/cos", dev, cpu_trig),
                               ("cpu", torch.device("cpu"),
                                contextlib.nullcontext)):
            scene, camera = get("rtiow")().generate(device=d)
            m = mesh if d.type == "cuda" else Mesh(1, 1, d)
            with trig():
                f = render_pass_sharded(
                    scene, camera, Film.create(SHARD_W, SHARD_H, device=d),
                    1, 0, width=SHARD_W, height=SHARD_H, samples=2,
                    max_depth=8, mesh=m)
            passes[where] = (f.sum.cpu(), f.depth_sum.cpu())
        cpu_sum, cpu_depth = passes["cpu"]
        card_sum, card_depth = passes["card, CPU sin/cos"]
        check(torch.equal(card_depth, cpu_depth)
              and torch.equal(card_sum, cpu_sum) and cpu_depth.sum() > 0,
              "render_pass_sharded on the card (CPU sin/cos) is not "
              "bit-equal to the CPU's")
        raw_sum, raw_depth = passes["card"]
        raw = dict(depth_px=int((raw_depth != cpu_depth).sum()),
                   radiance_px=int((raw_sum != cpu_sum).any(-1).sum()),
                   max_abs=(raw_sum - cpu_sum).abs().max().item())
        log(22, f"(a) render_pass_sharded {SHARD_W}x{SHARD_H} depth 8 spp 2: "
                "bit-equal to the CPU's with the CPU's sin and cos on the "
                f"card; with the card's own, {raw['depth_px']} px with "
                f"another bounce count and {raw['radiance_px']} px another "
                f"radiance (max {raw['max_abs']:.3g}) of "
                f"{SHARD_W * SHARD_H} (C22)")
        a["wavefront_card_trig"] = raw
    finally:
        dist.destroy_process_group()

    # (b) Two gloo ranks on the one card, in two subprocesses.
    work = tempfile.mkdtemp(prefix="mrt_shard_")
    try:
        init = f"file://{os.path.join(work, 'store')}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "shard-worker", str(r), init, work], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, logs):
            check(p.returncode == 0, f"shard worker failed:\n{out[-3000:]}")
        wall = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(2)]
        scene, camera = get("sphere_grid")().generate(device=dev)
        grid = render_pass_persistent(
            scene, camera, Film.create(GRID_W, GRID_H, device=dev), 1, 0,
            width=GRID_W, height=GRID_H, max_depth=50, samples=2, pool=RAYS)
        b = {}
        for name, want, kernels in (("rtiow", rtiow["film"], ("B1", "B2")),
                                    ("sphere_grid", grid,
                                     ("B2", "B5", "B7"))):
            for tile, spp in SHARD_MESHES:
                key = f"{name}-{tile}x{spp}"
                z = np.load(os.path.join(work, key + ".npz"))
                got = Film(sum=torch.from_numpy(z["sum"]).to(dev),
                           depth_sum=torch.from_numpy(z["depth"]).to(dev),
                           samples=int(z["samples"]))
                check(got.samples == 2, f"{key}: samples {got.samples}")
                diff, scale = films_agree(f"two ranks, {key}", got, want)
                per = [r[key] for r in ranks]
                for r in per:
                    check(all(r["launches"][k] > 0 for k in kernels),
                          f"{key}: {kernels} did not launch: "
                          f"{r['launches']}")
                b[key] = dict(seconds=[r["seconds"] for r in per],
                              steps=[r["steps"] for r in per],
                              all_reduce_ms=[r["all_reduce_s"] * 1e3
                                             for r in per],
                              max_abs=diff)
                log(22, f"(b) gloo, two ranks on one card, mesh ({tile}, "
                        f"{spp}): {name} equal to the one-process film "
                        f"(bounce counts exact, radiance within {diff:.3g} "
                        f"of max {scale:.3g}); a rank's pass "
                        f"{b[key]['seconds'][0]:.3f}/{b[key]['seconds'][1]:.3f}"
                        f" s, steps {b[key]['steps']}, all-reduce "
                        f"{b[key]['all_reduce_ms'][0]:.3f}/"
                        f"{b[key]['all_reduce_ms'][1]:.3f} ms (no multi-GPU "
                        "time: the ranks share one card)")
        log(22, f"(b) two subprocesses, start to exit: {wall:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(one_process=a, two_ranks=b)


# Phase 23: the passes in turns (scene, environment), and S1's FP32
# operations a lane (csrc/sort.cu: |d|^2 5, the max 1, the root 1, a
# direction cell 5 and an origin cell 4 an axis).
SORT_PASSES = (("sphere_grid", {}), ("lucy", {}), ("eve", {}),
               ("lucy", {"MRT_SORT_DYN": "1"}))
TURNS = ("unsorted", "sorted", "sorted", "unsorted")
OPS_SORT_KEY = 34


def bits_equal(a, b):
    """Equal shapes and bits (a NaN equals the same NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def device_kernels(fn, calls=10):
    """(device activities a call of fn, their names): `calls` calls after
    a warm-up under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.count for e in ev) / calls, sorted(e.key for e in ev)


def film_differences(a, b):
    """(pixels with another bounce count, pixels with another radiance
    beyond f32 reassociation of the film's atomic adds (1e-5 of the
    largest value), the largest radiance difference, that value)."""
    depth = int((a.depth_sum != b.depth_sum).sum())
    scale = a.sum.abs().max().item()
    diff = (a.sum - b.sum).abs()
    return (depth, int((diff > 1e-5 * scale).any(-1).sum()),
            diff.max().item(), scale)


def sort_passes(dev, captures):
    """Phase 23's passes: each of SORT_PASSES at 1080p, depth 50, spp 2,
    pool 2^17, unsorted, sorted by the auto rule, sorted, unsorted, in one
    process; S1 and S2 once a sort.  Two turns of one mode agree in
    bounce counts and in radiance within f32 reassociation.  Sorted
    against unsorted: where every walk is a ray's own (sphere_grid: B5 in
    each ray's octant, a one-instance TLAS) the same rule, with the same
    steps and B-kernel launches; where B7 walks a TLAS in its warp's
    octant (lucy, eve), a sort regroups the warps and C15 moves a few
    winners, so at most 1% of pixels may differ (C2's bound for path
    flips), each kernel still once a step.  The first unsorted pass of
    each scene (without MRT_SORT_DYN) leaves its step-64 lane state and
    the scene in captures[name]."""
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    out = {}
    for name, flags in SORT_PASSES:
        key = " ".join([name, *(f"{k}={v}" for k, v in flags.items())])
        with environ(**flags):
            scene, camera = get(name)().generate(device=dev)
            check(scene.prefers_sorted_rays(),
                  f"{name}: the auto rule does not sort on the card")
            cadence = scene.sort_cadence()
            warp_walk = scene.tlas is not None and scene.tlas.n_instances > 1
            turns = []
            for i, mode in enumerate(TURNS):
                during = contextlib.nullcontext()
                if i == 0 and not flags:
                    captures[name] = dict(scene=scene)
                    during = captured_state(captures[name])
                film = Film.create(WIDTH, HEIGHT, device=dev)
                torch.cuda.synchronize()
                reset_launches()
                with counting_steps() as steps, during:
                    t0 = time.perf_counter()
                    film = render_pass_persistent(
                        scene, camera, film, 1, 0, width=WIDTH, height=HEIGHT,
                        max_depth=50, samples=2, pool=RAYS,
                        sort_rays=None if mode == "sorted" else False)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                turns.append(dict(mode=mode, seconds=seconds,
                                  steps=steps["steps"],
                                  launches=read_launches(), film=film,
                                  mean=film.mean().mean().item()))
        first = {m: next(t for t in turns if t["mode"] == m)
                 for m in ("unsorted", "sorted")}
        for t in turns:
            n = t["steps"]
            b = {k: v for k, v in t["launches"].items() if k[0] == "B"}
            per_step = {k: v / n for k, v in b.items()}
            check(per_step == {k: v / first["unsorted"]["steps"] for k, v in
                               first["unsorted"]["launches"].items()
                               if k[0] == "B"},
                  f"{key} {t['mode']}: B-kernel launches {b} in {n} steps "
                  f"against {first['unsorted']['launches']} in "
                  f"{first['unsorted']['steps']}")
            sorts = n // cadence if t["mode"] == "sorted" else 0
            check(t["launches"]["S1"] == t["launches"]["S2"] == sorts,
                  f"{key} {t['mode']}: S1, S2 launched "
                  f"{t['launches']['S1']}, {t['launches']['S2']} in {n} "
                  f"steps, not {sorts}")
            films_agree(f"{key} {t['mode']} turns", first[t["mode"]]["film"],
                        t["film"])
            check(t["steps"] == first[t["mode"]]["steps"],
                  f"{key}: {t['mode']} turns ran {n} and "
                  f"{first[t['mode']]['steps']} steps")
        a, b = first["unsorted"], first["sorted"]
        px_depth, px_radiance, diff, scale = film_differences(a["film"],
                                                              b["film"])
        npix = WIDTH * HEIGHT
        if warp_walk:
            check(px_depth + px_radiance <= 0.01 * npix,
                  f"{key}: sorted and unsorted films differ on {px_depth} "
                  f"pixels' bounce counts and {px_radiance} pixels' radiance")
        else:
            check(a["steps"] == b["steps"] and px_depth == px_radiance == 0,
                  f"{key}: sorted and unsorted passes differ: steps "
                  f"{a['steps']}, {b['steps']}; {px_depth} pixels' bounce "
                  f"counts, {px_radiance} pixels' radiance")
        secs = {m: [t["seconds"] for t in turns if t["mode"] == m]
                for m in ("unsorted", "sorted")}
        out[key] = dict(
            cadence=cadence, steps=[t["steps"] for t in turns], seconds=secs,
            means=[t["mean"] for t in turns],
            launches_a_step={k: round(v / b["steps"], 3) for k, v in
                             b["launches"].items() if v},
            sorts=b["launches"]["S1"], warp_walk=warp_walk,
            pixels_other_depth=px_depth, pixels_other_radiance=px_radiance,
            max_abs=diff, depth_sums=[int(t["film"].depth_sum.sum())
                                      for t in turns])
        v = out[key]
        log(23, f"passes in turns, {key} {WIDTH}x{HEIGHT} depth 50 spp 2 pool "
                f"{RAYS}, cadence {cadence}: unsorted "
                f"{secs['unsorted'][0]:.3f}/{secs['unsorted'][1]:.3f} s, "
                f"sorted {secs['sorted'][0]:.3f}/{secs['sorted'][1]:.3f} s; "
                f"steps {v['steps']}, {v['sorts']} sorts; sorted against "
                f"unsorted: {px_depth} pixels with another bounce count, "
                f"{px_radiance} with another radiance (of {npix}), max "
                f"difference {diff:.3g} of {scale:.3g}; depth sums "
                f"{v['depth_sums']}; mean radiance "
                f"{[round(m, 6) for m in v['means']]}; sorted launches a step "
                f"{v['launches_a_step']}")
    return out


def sorted_perm(scene, st, total, live=False):
    """The permutation the sorter gives the lane state st: origin cells
    over the scene's bounds, or with `live` over the active lanes'."""
    from mrt_torch.ops import sort as S

    item, o = st["item"], st["o"]
    box = (S.live_box(item, o, total) if live
           else S.origin_box(*scene.world_bounds()))
    keys = S.sort_keys(item, o, st["d"], total, box)
    return torch.sort(keys, stable=True).indices


def sorted_ray_kernels(dev, captures, rtiow_rays):
    """B1 (RTIOW), B5 (sphere_grid) and B7 (lucy, eve) on the lanes of
    step 64 of an unsorted pass, as they come and permuted by the sorter,
    in turns (as they come, sorted, sorted, as they come).  B1's and
    B5's winners un-permuted are bit-equal; B7 walks its TLAS in its
    warp's octant, so its winners follow compare_hits' rule (C15)."""
    from mrt_torch.ops import bvh as K
    from mrt_torch.ops import sort as S
    from mrt_torch.ops import spheres as B1
    from mrt_torch.scenes import get

    inf = float("inf")
    out = {}
    for kernel, name in (("B1", "rtiow"), ("B5", "sphere_grid"),
                         ("B7", "lucy"), ("B7", "eve")):
        cap = captures[name]
        st, total = cap["state"], cap["total"]
        n = st["o"].shape[0]
        if kernel == "B1":
            scene = get("rtiow")().generate(device=dev)[0]
            o, d, lo, hi = rtiow_rays[CAPTURE_STEPS[-1]]
            check(torch.equal(o, st["o"]) and torch.equal(d, st["d"]),
                  "phase 6's step-64 B1 rays are not its step-64 lanes")
            sp = scene.spheres
            fn = lambda o, d, lo, hi: B1.nearest_t(sp.center, sp.radius, o,
                                                   d, lo, hi,
                                                   groups=sp.groups)
        elif kernel == "B5":
            scene = cap["scene"]
            tree, sph = scene.sphere_bvh, scene.spheres.krows
            lo, hi = 1e-3, inf
            fn = lambda o, d, lo, hi: K.sphere_bvh_hit(
                tree.nodes, tree.meta, sph, o, d, lo, hi,
                card=(tree.knodes, tree.order))
        else:
            scene = cap["scene"]
            lo = torch.full((n,), 1e-3, device=dev)
            hi = torch.full((n,), inf, device=dev)
            fn = lambda o, d, lo, hi, tl=scene.tlas: K.tlas_hit(tl, o, d, lo,
                                                                hi)
        lanes = lambda x, p: x[p] if torch.is_tensor(x) else x
        rays = {"as they come": (st["o"], st["d"], lo, hi)}
        perms = {"sorted": sorted_perm(scene, st, total),
                 "sorted, live box": sorted_perm(scene, st, total, live=True)}
        for k, perm in perms.items():
            srt = S.permute_lanes(perm, st)
            rays[k] = (srt["o"], srt["d"], lanes(lo, perm), lanes(hi, perm))
        got = {k: fn(*r) for k, r in rays.items()}
        torch.cuda.synchronize()
        err, agree, differ = 0.0, {}, {}
        for k, perm in perms.items():
            unperm = [x[perm] for x in got["as they come"]]
            if kernel == "B7":
                pair = lambda w: w[1].to(torch.int64) * (1 << 31) + w[2]
                e, _, agree[k] = compare_hits(
                    f"B7 {name} {k}", got[k][0], pair(got[k]), unperm[0],
                    pair(unperm), uv=((got[k][3], unperm[3]),
                                      (got[k][4], unperm[4])))
                err = max(err, e)
            else:
                check(all(bits_equal(a, b) for a, b in zip(got[k], unperm)),
                      f"{kernel} {name}: the {k} rays' winners differ")
                agree[k] = 1.0
            differ[k] = int((~torch.stack([
                (a == b) | (a.isnan() & b.isnan())
                if a.dtype.is_floating_point else a == b
                for a, b in zip(got[k], unperm)]).all(0)).sum())
        ms = {k: [] for k in rays}
        for k in ("as they come", "sorted", "sorted, live box",
                  "sorted, live box", "sorted", "as they come"):
            ms[k].append(graph_ms(lambda r=rays[k]: fn(*r), 20))
        active = int((st["item"] < total).sum())
        out[f"{kernel} {name}"] = dict(ms=ms, lanes=n, active=active,
                                       rays_differ=differ, agree=agree,
                                       max_abs_err=err)
        log(23, f"{kernel} on {name}'s step-{CAPTURE_STEPS[-1]} lanes of an "
                f"unsorted pass ({n} lanes, {active} active), ms a call (CUDA "
                f"graph): " + "; ".join(
                    f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in ms.items())
                + f"; winners un-permuted: rays that differ {differ}, "
                f"agreement {agree}")
    return out


def sorter_kernels(dev, captures):
    """S1 and S2 against their plain versions on sphere_grid's step-64
    lanes (static and live-origin boxes; S2 with and without a pend
    accumulator), bit for bit; their times, torch.sort's, the plain and
    library times and the whole sorter's device kernels."""
    from mrt_torch.integrator.persistent import make_sorter
    from mrt_torch.ops import sort as S

    cap = captures["sphere_grid"]
    st, total, scene = cap["state"], cap["total"], cap["scene"]
    item, o, d = st["item"], st["o"], st["d"]
    n = item.shape[0]
    static = S.origin_box(*scene.world_bounds())
    for label, box in (("static", static),
                       ("live", S.live_box(item, o, total))):
        keys = S.sort_keys(item, o, d, total, box)
        check(bits_equal(keys, S.sort_keys_plain(item, o, d, total, box)),
              f"S1 ({label} box) differs from its plain version")
    keys = S.sort_keys(item, o, d, total, static)
    perm = torch.sort(keys, stable=True).indices
    g = torch.Generator(device=dev).manual_seed(23)
    with_acc = dict(st, acc=torch.rand((n, 4), device=dev, generator=g))
    for label, lanes in (("without acc", st), ("with acc", with_acc)):
        got = S.permute_lanes(perm, lanes)
        want = S.permute_lanes_plain(perm, lanes)
        check(got.keys() == want.keys()
              and all(bits_equal(got[k], want[k]) for k in want),
              f"S2 ({label}) differs from its plain version")
    active = int((item < total).sum())
    floor = floor_ms(dev)
    s1 = dict(ms=graph_ms(lambda: S.sort_keys(item, o, d, total, static), 50),
              ms_live_box=graph_ms(lambda: S.sort_keys(
                  item, o, d, total, S.live_box(item, o, total)), 20),
              plain_ms=graph_ms(lambda: S.sort_keys_plain(
                  item, o, d, total, static), 5),
              library_ms=None, max_abs_err=0.0, floor_ms=floor,
              lanes=n, active=active,
              **bound(active * 36 + (n - active) * 12 + 24,
                      active * OPS_SORT_KEY))
    sort_launches, sort_names = device_kernels(
        lambda: torch.sort(keys, stable=True))
    s1["torch_sort"] = dict(ms=graph_ms(lambda: torch.sort(keys, stable=True),
                                        20),
                            launches=sort_launches, kernels=sort_names,
                            **bound(n * (4 + 4 + 8), 0))
    cols = lambda lanes: [lanes[k] for k in S.COLUMNS + (
        ("acc",) if "acc" in lanes else ())]
    s2 = dict(max_abs_err=0.0, floor_ms=floor)
    for label, lanes, row in (("", st, 64), ("_acc", with_acc, 80)):
        s2["ms" + label] = graph_ms(lambda: S.permute_lanes(perm, lanes), 50)
        s2["plain_ms" + label] = graph_ms(
            lambda: S.permute_lanes_plain(perm, lanes), 5)
        s2["library_ms" + label] = graph_ms(
            lambda: [x.index_select(0, perm) for x in cols(lanes)], 20)
        b = bound(n * (8 + 2 * row), 0)
        s2["bound_ms" + label], s2["bound_by" + label] = (b["bound_ms"],
                                                          b["bound_by"])
    sorter = {}
    for label, flags in (("static", {}), ("live", {"MRT_SORT_DYN": "1"})):
        with environ(**flags):
            fn = make_sorter(scene, total)
        count, names = device_kernels(lambda: fn(st))
        sorter[label] = dict(ms=graph_ms(lambda: fn(st), 20),
                             kernels=count, names=names)
    log(23, f"S1 sort key, {n} lanes of sphere_grid's step "
            f"{CAPTURE_STEPS[-1]} ({active} active): bit-equal to its plain "
            f"version with the scene's box and the live origins' box; "
            f"{s1['ms']:.5f} ms (CUDA graph; with the live box's reductions "
            f"{s1['ms_live_box']:.5f}), plain {s1['plain_ms']:.4f}, bound "
            f"{s1['bound_ms']:.5f} ({s1['bound_by']}), floor {floor:.5f}; "
            f"torch.sort {s1['torch_sort']['ms']:.5f} ms, "
            f"{sort_launches:g} device launches a call {sort_names}")
    log(23, f"S2 lane permutation: bit-equal to its plain version without "
            f"and with the pend accumulator; {s2['ms']:.5f} / "
            f"{s2['ms_acc']:.5f} ms, plain {s2['plain_ms']:.4f} / "
            f"{s2['plain_ms_acc']:.4f}, index_select a column "
            f"{s2['library_ms']:.4f} / {s2['library_ms_acc']:.4f}, bound "
            f"{s2['bound_ms']:.5f} / {s2['bound_ms_acc']:.5f} (bytes)")
    log(23, f"the whole sorter (make_sorter): "
            + "; ".join(f"{k} box {v['ms']:.5f} ms, {v['kernels']:g} device "
                        f"launches a sort" for k, v in sorter.items()))
    return s1, s2, sorter


def phase_sort(dev, rtiow_state, rtiow_rays):
    """Phase 23: the lane sorter.  Returns the S1 and S2 entries of the
    kernels line (without launches) and the phase's numbers."""
    captures = {"rtiow": rtiow_state}
    t0 = time.perf_counter()
    passes = sort_passes(dev, captures)
    t1 = time.perf_counter()
    s1, s2, sorter = sorter_kernels(dev, captures)
    t2 = time.perf_counter()
    rays = sorted_ray_kernels(dev, captures, rtiow_rays)
    seconds = dict(passes=t1 - t0, sorter=t2 - t1,
                   sorted_rays=time.perf_counter() - t2)
    log(23, f"phase seconds: {json.dumps(seconds)}")
    return s1, s2, dict(passes=passes, sorter=sorter, sorted_rays=rays,
                        seconds=seconds)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "shard-worker":
        return shard_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mrt_torch.ops import _build  # fails outside a checkout of the repo

    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    log(1, f"card: {card_line()}")
    t0 = time.perf_counter()
    _build.library()
    log(2, f"kernels built with nvcc and loaded in "
           f"{time.perf_counter() - t0:.2f} s: {_build.library_path().name}")
    for k in _build.kernel_resources():
        log(2, f"{k['name']}: {k['registers']} registers, {k['stack']} B "
               f"stack frame, {k['spill_stores']} B spill stores, "
               f"{k['spill_loads']} B spill loads, {k['smem']} B static "
               "shared memory")

    b2 = phase_b2(dev)
    phase_golden(5, "rtiow", dev, grid=5)
    rtiow_rays, grid_rays, rtiow_film = {}, {}, {}
    rtiow_state = {}
    rtiow, _ = phase_main(6, "rtiow", dev, ("B1", "B2"), film_out=rtiow_film,
                          during=contexts(captured_rays("B1", rtiow_rays),
                                          captured_state(rtiow_state)))
    b1 = phase_b1(dev, rtiow_rays)
    b7 = phase_b7(dev)
    phase_golden(9, "cornell", dev)
    grid, _ = phase_main(10, "sphere_grid", dev,
                         ("B2", "B5", "B7", "S1", "S2"),
                         during=captured_rays("B5", grid_rays))
    b5 = phase_b5(dev, grid_rays)
    b6 = phase_b6(dev)
    meshes = phase_meshes(dev)
    b3 = phase_b3(dev, b2["floor_ms"])
    phase_texture_goldens(dev)
    eve = phase_eve(dev)
    b4 = phase_b4(dev, b2["floor_ms"])
    phase_light_goldens(dev)
    nee = phase_nee(dev)
    menger = phase_menger(dev)
    probes = phase_probes(dev)
    grad = phase_grad(dev)
    cli = phase_cli(dev)
    sharded = phase_sharded(dev, rtiow_film)
    s1, s2, sort = phase_sort(dev, rtiow_state, rtiow_rays)

    kernels = [
        dict(name="B1 sphere nearest hit", route="cuda",
             source="mrt_torch/csrc/spheres.cu",
             replaces="mrt/ops/pallas_spheres.py:43",
             launches=rtiow["B1"],
             launches_grad_forward=grad["launches_forward"],
             launches_grad_recompute=grad["launches_recompute"],
             launches_cli=cli["runs"][0]["launches"]["B1"],
             launches_cli_resume=cli["runs"][1]["launches"]["B1"],
             launches_aov=cli["aov"]["rtiow"]["launches"]["B1"],
             launches_sharded=sharded["one_process"]["launches"]["B1"],
             **b1),
        dict(name="B2 film segment-add", route="cuda",
             source="mrt_torch/csrc/deposit.cu",
             replaces="mrt/ops/pallas_onehot.py:51",
             launches=grid["B2"], launches_rtiow=rtiow["B2"],
             launches_eve_compact=eve["compact"]["launches"]["B2"],
             launches_cli=cli["runs"][0]["launches"]["B2"],
             launches_cli_resume=cli["runs"][1]["launches"]["B2"],
             launches_sharded=sharded["one_process"]["launches"]["B2"],
             **b2),
        dict(name="B3 row gather (compaction expand)", route="cuda",
             source="mrt_torch/csrc/gather.cu",
             replaces="mrt/ops/pallas_onehot.py:218",
             launches=eve["compact"]["launches"]["B3"],
             wrapper_host_us=dict(gather=b2["wrapper_host_us"]["gather"]),
             **b3),
        dict(name="B4 pending film deposit", route="cuda",
             source="mrt_torch/csrc/deposit.cu",
             replaces="mrt/ops/pallas_deposit.py:38",
             launches=nee[(None, True)]["launches"]["B4"],
             launches_rr3=nee[(3, True)]["launches"]["B4"], **b4),
        dict(name="B5 sphere-BVH closest hit", route="cuda",
             source="mrt_torch/csrc/bvh.cu",
             replaces="mrt/ops/pallas_bvh.py:79",
             launches=grid["B5"], **b5),
        dict(name="B6 triangle-BVH closest hit", route="cuda",
             source="mrt_torch/csrc/bvh.cu",
             replaces="mrt/ops/pallas_bvh.py:292",
             launches=meshes["lucy"][1]["B6"],
             launches_playground_flat=meshes["playground"][1]["B6"], **b6),
        dict(name="B7 two-level TLAS closest hit (B8 folded in)",
             route="cuda", source="mrt_torch/csrc/bvh.cu",
             replaces="mrt/ops/pallas_bvh.py:523",
             launches=grid["B7"], launches_lucy=meshes["lucy"][0]["B7"],
             launches_cornell_nee=nee[(None, False)]["launches"]["B7"],
             launches_menger=menger["launches"]["B7"], **b7),
        dict(name="P1 paged table copy probe", route="cuda",
             source="mrt_torch/csrc/probe_stream.cu",
             replaces="tools/probe_stream.py:22", **probes["P1"]),
        dict(name="P2 paged chain walk probe", route="cuda",
             source="mrt_torch/csrc/probe_stream.cu",
             replaces="tools/probe_stream.py:55", **probes["P2"]),
        dict(name="P3 shared memory size probe", route="cuda",
             source="mrt_torch/csrc/probe_stream.cu",
             replaces="tools/probe_stream.py:147", **probes["P3"]),
        dict(name="S1 lane sort key", route="cuda",
             source="mrt_torch/csrc/sort.cu",
             replaces="mrt/integrator/persistent.py:112",
             launches=grid["S1"], launches_lucy=meshes["lucy"][0]["S1"],
             launches_eve=eve["plain"]["launches"]["S1"], **s1),
        dict(name="S2 lane permutation", route="cuda",
             source="mrt_torch/csrc/sort.cu",
             replaces="mrt/integrator/persistent.py:112",
             launches=grid["S2"], launches_lucy=meshes["lucy"][0]["S2"],
             launches_eve=eve["plain"]["launches"]["S2"], **s2),
    ]
    grad.pop("recover")
    log(20, f"gradient path: {json.dumps(grad)}")
    log(21, f"entry point: {json.dumps(cli)}")
    log(22, f"sharded paths: {json.dumps(sharded)}")
    log(23, f"lane sorter: {json.dumps(sort)}")
    log(24, f"run: {time.perf_counter() - start:.1f} s from the card's "
            "line to here")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
