"""Whole 1080p passes of two checkouts in turns on the card, in one
process, with the host time of each layer of the step.

    python mrt_torch/tools/pass_turns.py --root DIR [--scene sphere_grid]
        [--nee] [--rounds 3] [--passes 2] [--unchanged LAYER ...]
        [--out FILE]
    python mrt_torch/tools/pass_turns.py --read FILE [FILE ...]

Loads the package of the checkout at DIR beside this checkout's (as
``mrt_torch_root``: the package imports itself only relatively), builds
each checkout's scene, renders a warm-up pass with each, then renders
``--passes`` passes with each in the order DIR, this checkout, this
checkout, DIR, ``--rounds`` times (``--nee``: the scene with its light
table; ``MRT_FILM_PEND=1`` in the environment runs both checkouts in the
pend film mode, kernel B4).  One process holds
the host's speed alike for both; between processes it varies by tens of
percent.  The passes run the main path (1920x1080, depth 50, spp 2, pool
2^17); each records its wall time and, on the host clock and without a
device sync, the time spent inside each layer of the step
(``mrt_torch.profile``'s layers, each inclusive: the voxel walk is
inside intersect), inside the whole step, inside the B1 and B5
wrappers, and inside compaction
(``compact_apply``, and the B2 and B3 calls it makes).  A pass is
host-bound, so a layer's host time is what issuing its work costs, plus
whatever wait for the device falls inside it.  Prints one line a turn,
then for each scene the median of each checkout, the pass in units of
the host time of the layers both checkouts share (``UNCHANGED``, or the
layers ``--unchanged`` names: the host's speed divided out) and, a round
at a time, this checkout's mean minus DIR's, and one JSON line at the
end (``--out`` also writes it; ``--read`` prints the summary of such
files again, without a card).  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

TREE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WRAPPERS = (
    ("step", "mrt_torch.integrator.persistent", "LanePool.step"),
    ("B1 wrapper", "mrt_torch.ops.spheres", "nearest_t"),
    ("B5 wrapper", "mrt_torch.ops.bvh", "sphere_bvh_hit"),
    ("compaction", "mrt_torch.ops.compact", "compact_apply"),
    ("B2 placer wrapper", "mrt_torch.ops.compact", "deposit"),
    ("B3 wrapper", "mrt_torch.ops.compact", "gather"),
)


def _layers():
    """This checkout's ``profile.LAYERS`` (the file is loaded alone: its
    module level needs no package)."""
    spec = importlib.util.spec_from_file_location(
        "_profile_layers", os.path.join(TREE, "mrt_torch", "profile.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.LAYERS


def _timed(name, fn, acc):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] += time.perf_counter() - t0
    return wrapped


def package(root):
    """The mrt_torch package of the checkout at `root`: this one's as
    ``mrt_torch``, another's as ``mrt_torch_root``."""
    name = "mrt_torch" if root == TREE else "mrt_torch_root"
    if name in sys.modules:
        pass
    elif root == TREE:
        sys.path.insert(0, TREE)
        import mrt_torch  # noqa: F401
    else:
        path = os.path.join(root, "mrt_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    pkg = sys.modules[name]
    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != root:
        raise RuntimeError(f"pass_turns: {name} is not {root}'s")
    return name


class Tree:
    """One checkout's scene, pass and host timers."""

    def __init__(self, root, scene_name, nee=False):
        self.root = root
        name = package(root)
        mod = lambda m: importlib.import_module(
            name + m[len("mrt_torch"):])
        scene, camera = mod("mrt_torch.scenes").get(scene_name)().generate()
        if nee:
            scene = mod("mrt_torch.geometry.scene").attach_lights(scene)
        film_mod = mod("mrt_torch.runtime.film")
        render = mod("mrt_torch.runtime.render").render_pass_persistent

        def one_pass():
            film = film_mod.Film.create(1920, 1080,
                                        device=camera.origin.device)
            render(scene, camera, film, 1, 0, width=1920, height=1080,
                   max_depth=50, samples=2, pool=1 << 17)
            torch.cuda.synchronize()

        self.one_pass = one_pass
        self.acc = {}
        self.hooks = []
        for key, module, attr in _layers() + WRAPPERS:
            owner = mod(module)
            *path, leaf = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            self.acc[key] = 0.0
            self.hooks.append((owner, leaf, getattr(owner, leaf),
                               _timed(key, getattr(owner, leaf), self.acc)))

    def run(self):
        """One pass with the host timers in: (wall s, {layer: host ms})."""
        self.acc.update(dict.fromkeys(self.acc, 0.0))
        for owner, leaf, _, timed in self.hooks:
            setattr(owner, leaf, timed)
        try:
            t0 = time.perf_counter()
            self.one_pass()
            wall = time.perf_counter() - t0
        finally:
            for owner, leaf, fn, _ in self.hooks:
                setattr(owner, leaf, fn)
        return wall, {k: v * 1e3 for k, v in self.acc.items()}


# Layers whose code two checkouts share: their host time measures the
# host's speed, which varies between processes and within one.  (With
# compaction on, shade_hit and the background run compact_apply: then
# name only make_rays with --unchanged.)
UNCHANGED = ("L1 make_rays", "L3 shade_hit")


def summary(records, unchanged=UNCHANGED):
    """Per checkout (the first record's is DIR's): the median pass and
    host times, and the pass in units of the unchanged layers' host time
    (ms a ms; its median, min and max over the passes): the pass with
    the host's speed divided out.  A round at a time: this checkout's
    mean pass and layer times minus DIR's."""
    base = records[0]["tree"]
    tree = next(r["tree"] for r in records if r["tree"] != base)
    out = dict(root=base, tree=tree, median={}, per_unchanged={},
               unchanged=list(unchanged), tree_minus_root=[])
    for root in (base, tree):
        mine = [r for r in records if r["tree"] == root]
        out["median"][root] = dict(
            pass_s=statistics.median(x for r in mine for x in r["pass_s"]),
            host_ms={k: statistics.median(x for r in mine
                                          for x in r["host_ms"][k])
                     for k in mine[0]["host_ms"]})
        ratio = [wall * 1e3 / sum(r["host_ms"][k][i] for k in unchanged)
                 for r in mine for i, wall in enumerate(r["pass_s"])]
        out["per_unchanged"][root] = (statistics.median(ratio), min(ratio),
                                      max(ratio))
    for i in range(0, len(records), 4):
        group = records[i:i + 4]
        mean = lambda key, root: statistics.mean(
            x for r in group if r["tree"] == root for x in (
                r["pass_s"] if key is None else r["host_ms"][key]))
        out["tree_minus_root"].append(dict(
            pass_s=mean(None, tree) - mean(None, base),
            host_ms={k: mean(k, tree) - mean(k, base)
                     for k in group[0]["host_ms"]}))
    return out


def report(scene, records, unchanged=UNCHANGED):
    """Print the summary of one scene's turns; return it."""
    s = summary(records, unchanged)
    for root, m in s["median"].items():
        which = "root" if root == s["root"] else "tree"
        mid, lo, hi = s["per_unchanged"][root]
        print(f"{scene} {which} median: pass {m['pass_s']:.3f} s; "
              + ", ".join(f"{k} {v:.1f}" for k, v in m["host_ms"].items())
              + f" host ms; pass a ms of unchanged layers {mid:.4f} "
              f"({lo:.4f}-{hi:.4f})", flush=True)
    for i, r in enumerate(s["tree_minus_root"]):
        print(f"{scene} round {i + 1}, tree - root: pass "
              f"{r['pass_s'] * 1e3:+.1f} ms; "
              + ", ".join(f"{k} {v:+.1f}" for k, v in r["host_ms"].items())
              + " host ms", flush=True)
    return s


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="the other checkout")
    ap.add_argument("--scene", action="append")
    ap.add_argument("--nee", action="store_true",
                    help="attach the scene's light table (next-event "
                    "estimation)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--unchanged", nargs="+", default=list(UNCHANGED),
                    help="the layers whose host time divides out the "
                    f"host's speed (default: {', '.join(UNCHANGED)})")
    ap.add_argument("--read", nargs="+", metavar="JSON",
                    help="summarise earlier runs' JSON instead (no card)")
    args = ap.parse_args()
    if args.read:
        for path in args.read:
            with open(path) as f:
                result = json.loads(f.read().strip().splitlines()[-1])
            print(f"{path}: {result['device']}")
            for scene, v in result["scenes"].items():
                report(scene, v["records"],
                       v.get("unchanged", args.unchanged))
        return 0
    if not args.root:
        ap.error("--root or --read is needed")
    if not torch.cuda.is_available():
        print("pass_turns: no CUDA device", file=sys.stderr)
        return 2
    roots = (os.path.abspath(args.root), TREE)
    result = dict(device=torch.cuda.get_device_name(0), nee=args.nee,
                  scenes={})
    for scene in args.scene or ["sphere_grid"]:
        trees = {root: Tree(root, scene, args.nee) for root in roots}
        for tree in trees.values():
            tree.one_pass()  # warm-up: kernel build, allocator
        records = []
        for _ in range(args.rounds):
            for root in (roots[0], roots[1], roots[1], roots[0]):
                r = dict(tree=root, scene=scene, pass_s=[], host_ms={})
                for _ in range(args.passes):
                    wall, host = trees[root].run()
                    r["pass_s"].append(wall)
                    for k, v in host.items():
                        r["host_ms"].setdefault(k, []).append(v)
                records.append(r)
                which = "root" if root == roots[0] else "tree"
                print(f"{scene} {which}: passes "
                      + ", ".join(f"{x:.3f}" for x in r["pass_s"]) + " s; "
                      + ", ".join(f"{k} {statistics.median(v):.1f}"
                                  for k, v in r["host_ms"].items())
                      + " host ms (median)", flush=True)
        del trees
        result["scenes"][scene] = dict(
            records=records, **report(scene, records, args.unchanged))
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
