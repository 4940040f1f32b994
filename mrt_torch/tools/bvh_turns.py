"""Kernels B6 and B7 of this checkout, or of another one, in turns on the
card at the main path's shapes.

    python -m mrt_torch.tools.bvh_turns [--escape] [--out FILE] [--turns N]
    python mrt_torch/tools/bvh_turns.py --root DIR [--out FILE] [--turns N]

The rays are 2^17 of each scene's main path at 1920x1080, spp 2
(``chip_smoke.path_rays``).  Each entry is timed as the device time of
one call, by CUDA-graph replay of ``REPS`` calls (``chip_smoke.graph_ms``),
and the entries take turns: each once, then each again, ``--turns``
times.  One line an entry (the time of each turn) and one JSON line at
the end; ``--out`` also writes the JSON.

Entries: B6 over lucy's 16 flat parts (one launch over their forest;
with ``--root``, one launch a part), B6 over playground's flat set, B7
on lucy, eve, cornell and playground (in the regime the wrapper picks).
``--root DIR`` times the wrappers of the checkout at DIR (an earlier
commit, whose B6 and B7 take the reference layout), to be run in the
same call as this checkout, in turns.  ``--escape`` adds this
checkout's kernels walking the escape order in every tree (a threading
table of node + 1 / escape in every octant), against which the octant
order of the trees of ``OCTANT_MIN_NODES`` nodes or more is held.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
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


def entries(smoke, dev, earlier, escape):
    """{name: fn}, each fn one call at its scene's rays."""
    from mrt_torch.ops import bvh as K

    lo = torch.full((smoke.RAYS,), 1e-3, device=dev)
    hi = torch.full((smoke.RAYS,), float("inf"), device=dev)
    out = {}
    with smoke.tlas_route("flat"):
        lucy, o, d = smoke.path_rays("lucy", dev)
        pg, po, pd = smoke.path_rays("playground", dev)
    parts = lucy.tlas.flat_parts
    tree, tris = pg.tlas.flat_bvh, pg.tlas.flat_tris
    if earlier:
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
    runs = entries(smoke, dev, bool(args.root), args.escape)
    times = {}
    for _ in range(args.turns):
        for name, fn in runs.items():
            times.setdefault(name, []).append(smoke.graph_ms(fn, REPS))
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
