"""Kernels B1, B5, B6 and B7 of this checkout, or of another one, in
turns on the card at the main path's shapes.

    python -m mrt_torch.tools.bvh_turns [--escape] [--out FILE] [--turns N]
    python mrt_torch/tools/bvh_turns.py --root DIR [--out FILE] [--turns N]

The rays are 2^17 of each scene's main path at 1920x1080, spp 2
(``chip_smoke.path_rays``: camera rays spread over the frame and first
bounces) and, for B1 and B5, also the rays that steps 2 and 64 of one
1080p pass (``chip_smoke.CAPTURE_STEPS``) give the kernel, in the lane
order of the pool (``chip_smoke.captured_rays``).  Each entry is timed
as the device time of one call, by CUDA-graph replay of ``REPS`` calls
(``chip_smoke.graph_ms``; an entry named ", as called": between CUDA
events, ``chip_smoke.call_ms``, host launches in), and the entries take
turns: each once, then each again, ``--turns`` times.  One line an entry
(the time of each turn) and one JSON line at the end; ``--out`` also
writes the JSON.

Entries: B1 on RTIOW's and B5 on sphere_grid's ray sets
(``sphere_entries``: the kernel, and the wrapper as the scene's
intersection calls it; B1 also with its tables in global memory);
B6 over lucy's 16 flat parts (one launch over their forest; with an
earlier checkout, one launch a part), B6 over playground's flat set, B7
on lucy, eve, cornell and playground (in the regime the wrapper picks).
``--root DIR`` times the wrappers of the checkout at DIR (an earlier
commit; each kernel's entries follow the arguments its wrapper takes:
the reference layout and one B6 launch a part before the packed tables,
B1 and B5 without their kernel tables before the grouped and
octant-ordered kernels), to be run in the same call as this checkout,
in turns.
``--escape`` adds this checkout's kernels walking the escape order in
every tree (a threading table of node + 1 / escape in every octant),
against which the octant order of the trees of ``OCTANT_MIN_NODES``
nodes or more is held.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import types

import torch

TREE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPS = 20


def _smoke():
    """This checkout's chip_smoke.py, for its rays and timers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TREE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def escape_threading(count, escape):
    """(8, M, 2) int32 threading of the escape order in every octant
    (``geometry.bvh.escape_threads``), on count's device."""
    from mrt_torch.geometry import bvh

    table = bvh.order_table(*bvh.escape_threads(count.cpu().numpy(),
                                                escape.cpu().numpy()))
    return torch.from_numpy(table).to(count.device)


def escape_tlas(tl):
    """B7's tables of `tl` with escape-order threading."""
    keys = ("tnodes", "tmeta", "inst", "imeta", "bnodes", "bmeta", "tris",
            "k_tnodes", "k_bnodes", "k_tris")
    return types.SimpleNamespace(
        **{k: getattr(tl, k) for k in keys},
        t_order=escape_threading((tl.tmeta[:, 0] >= 0).to(torch.int32),
                                 tl.tmeta[:, 1]),
        b_order=escape_threading(tl.bmeta[:, 1], tl.bmeta[:, 2]))


def main_path_sets(smoke, name, kernel, dev):
    """The scene `name` and its ray sets for B1 or B5 (`kernel`):
    ``chip_smoke.ray_sets`` of its path rays and of the steps a 1080p
    pass captures."""
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    scene, camera = get(name)().generate(device=dev)
    captured = {}
    with smoke.captured_rays(kernel, captured):
        render_pass_persistent(
            scene, camera, Film.create(smoke.WIDTH, smoke.HEIGHT, device=dev),
            1, 0, width=smoke.WIDTH, height=smoke.HEIGHT, max_depth=50,
            samples=2, pool=smoke.RAYS)
    _, o, d = smoke.path_rays(name, dev)
    return scene, smoke.ray_sets(o, d, captured)


def takes(fn, name):
    """True if the wrapper `fn` takes the argument `name`: the kernel
    tables of this checkout's layout, which earlier checkouts lack."""
    return name in inspect.signature(fn).parameters


def sphere_entries(smoke, dev):
    """{name: fn} of B1 on RTIOW and B5 on sphere_grid, each ray set:
    the kernel ("B1 <set>"; an earlier one, whose wrapper builds its
    table and bound lanes on every call and cannot be captured in a graph
    with scalar bounds, with those built once) and the wrapper as the
    scene's intersection calls it (", as called"; timed between CUDA
    events, host launches in); this layout's B1 also with its tables in
    global memory."""
    from mrt_torch.ops import _build
    from mrt_torch.ops import bvh as K
    from mrt_torch.ops import spheres as B1

    out = {}
    rtiow, sets = main_path_sets(smoke, "rtiow", "B1", dev)
    sp = rtiow.spheres
    for key, (o, d, lo, hi) in sets.items():
        n = o.shape[0]
        if not takes(B1.nearest_t, "groups"):
            call = (lambda o=o, d=d, lo=lo, hi=hi: B1.nearest_t(
                sp.center, sp.radius, o, d, lo, hi))
            table = B1.sphere_table(sp.center, sp.radius)
            lanes = [smoke.as_lanes(x, n, dev) for x in (lo, hi)]
            res = (torch.empty((n,), device=dev),
                   torch.empty((n,), dtype=torch.int32, device=dev))
            out[f"B1 {key}"] = (
                lambda o=o, d=d, lanes=lanes, table=table, res=res, n=n:
                _build.launch("mrt_nearest_t", dev, o, d, *lanes, n, table,
                              table.shape[0], *res))
        else:
            call = (lambda o=o, d=d, lo=lo, hi=hi: B1.nearest_t(
                sp.center, sp.radius, o, d, lo, hi, groups=sp.groups))
            out[f"B1 {key}"] = call
            out[f"B1 {key}, global"] = patched(B1, "SHARED_MAX_BYTES", 0,
                                               call)
        out[f"B1 {key}, as called"] = call
    grid, sets = main_path_sets(smoke, "sphere_grid", "B5", dev)
    tree = grid.sphere_bvh
    if takes(K.sphere_bvh_hit, "card"):
        sph = grid.spheres.krows
    else:
        from mrt_torch.geometry.bvh import kernel_spheres
        sph = kernel_spheres(grid.spheres)
    for key, (o, d, lo, hi) in sets.items():
        n = o.shape[0]
        if not takes(K.sphere_bvh_hit, "card"):
            call = (lambda o=o, d=d, lo=lo, hi=hi: K.sphere_bvh_hit(
                tree.nodes, tree.meta, kernel_spheres(grid.spheres), o, d,
                lo, hi))
            lanes = [smoke.as_lanes(x, n, dev) for x in (lo, hi)]
            out[f"B5 {key}"] = (lambda o=o, d=d, lanes=lanes: K.sphere_bvh_hit(
                tree.nodes, tree.meta, sph, o, d, *lanes))
        else:
            call = (lambda o=o, d=d, lo=lo, hi=hi: K.sphere_bvh_hit(
                tree.nodes, tree.meta, sph, o, d, lo, hi,
                card=(tree.knodes, tree.order)))
            out[f"B5 {key}"] = call
        out[f"B5 {key}, as called"] = call
    return out


def patched(module, name, value, fn):
    """fn with ``module.name`` set to `value` for the call (a graph
    captures the launch as the wrapper makes it then)."""
    def call():
        saved = getattr(module, name)
        setattr(module, name, value)
        try:
            return fn()
        finally:
            setattr(module, name, saved)
    return call


def entries(smoke, dev, escape):
    """{name: fn}, each fn one call at its scene's rays."""
    from mrt_torch.ops import bvh as K

    lo = torch.full((smoke.RAYS,), 1e-3, device=dev)
    hi = torch.full((smoke.RAYS,), float("inf"), device=dev)
    out = sphere_entries(smoke, dev)
    with smoke.tlas_route("flat"):
        lucy, o, d = smoke.path_rays("lucy", dev)
        pg, po, pd = smoke.path_rays("playground", dev)
    parts = lucy.tlas.flat_parts
    tree, tris = pg.tlas.flat_bvh, pg.tlas.flat_tris
    if not takes(K.tri_bvh_hit, "card"):
        out["B6 lucy 16 launches"] = lambda: [
            K.tri_bvh_hit(p.bvh.nodes, p.bvh.meta, p.rows, o, d, lo, hi)
            for p in parts]
        out["B6 playground"] = lambda: K.tri_bvh_hit(
            tree.nodes, tree.meta, tris.rows, po, pd, lo, hi)
    else:
        out["B6 lucy forest"] = lambda: K.tri_bvh_parts_hit(parts, o, d,
                                                            lo, hi)
        card = (tree.knodes, tree.order, tris.krows)
        out["B6 playground"] = lambda: K.tri_bvh_hit(
            tree.nodes, tree.meta, tris.rows, po, pd, lo, hi, card=card)
    if escape:
        f = parts.forest
        forest = types.SimpleNamespace(
            krows=parts.krows, forest=types.SimpleNamespace(
                knodes=f.knodes, n_nodes=f.n_nodes,
                order=escape_threading(f.count, f.escape)))
        out["B6 lucy forest, escape order"] = (
            lambda: K.tri_bvh_parts_hit(forest, o, d, lo, hi))
        card = (tree.knodes, escape_threading(tree.count, tree.escape),
                tris.krows)
        out["B6 playground, escape order"] = lambda: K.tri_bvh_hit(
            tree.nodes, tree.meta, tris.rows, po, pd, lo, hi, card=card)
    for name in ("lucy", "eve", "cornell", "playground"):
        scene, so, sd = smoke.path_rays(name, dev)
        tl = scene.tlas
        out[f"B7 {name}"] = (lambda tl=tl, so=so, sd=sd:
                             K.tlas_hit(tl, so, sd, lo, hi))
        if escape:
            out[f"B7 {name}, escape order"] = (
                lambda tl=escape_tlas(tl), so=so, sd=sd:
                K.tlas_hit(tl, so, sd, lo, hi))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="time this checkout's wrappers instead")
    ap.add_argument("--escape", action="store_true",
                    help="add the kernels walking the escape order")
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if args.root and args.escape:
        ap.error("--escape times this checkout's kernels, not --root's")
    if not torch.cuda.is_available():
        print("bvh_turns: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    root = os.path.abspath(args.root or TREE)
    sys.path.insert(0, root)
    import mrt_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(
            mrt_torch.__file__))) != root:
        raise RuntimeError(f"bvh_turns: mrt_torch is not {root}'s")
    dev = torch.device("cuda", 0)
    runs = entries(smoke, dev, args.escape)
    times = {}
    for _ in range(args.turns):
        for name, fn in runs.items():
            timer = (smoke.call_ms if name.endswith(", as called")
                     else smoke.graph_ms)
            times.setdefault(name, []).append(timer(fn, REPS))
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    for key, ms in times.items():
        print(f"{key}: " + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms (min {min(ms):.4f})", flush=True)
    line = json.dumps(dict(tree=root, device=card, rays=smoke.RAYS,
                           reps=REPS, ms=times))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
