"""The port's sharded rendering (``mrt_torch.parallel``) over gloo groups
of 2 and 4 CPU processes, against its own single-process render (the
counterparts of tests/test_parallel.py's mesh-shape tests).

Every random draw is a pure function of (seed, global pixel id, global
sample index), so every mesh shape renders the single-process film:
bounce counts exactly; radiance within the reference's tolerances (the
wavefront rtol 1e-5, atol 1e-6: the spp sum reassociates; the persistent
pass 2e-4: its film adds in lane order, and its camera multiplies by
1/width where the wavefront render divides).

One spawn of 4 ranks renders every world-4 case and one of 2 ranks every
world-2 case (tests/torch_parallel_worker.py): each rank writes the
gathered films and its row tile's shape.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from mrt_torch.runtime.render import render

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_workers(world, init, out, cases, timeout=300):
    """Run `world` worker ranks on the named case set, joined at `init`;
    a hang fails the test at `timeout` seconds instead of running out
    the suite's clock.  Returns each rank's output."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), init, str(out),
         str(cases)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return logs


def spawn(world, out, cases):
    """The named case set over `world` ranks joined through a file://
    store; returns each rank's arrays."""
    run_workers(world, f"file://{os.path.join(out, 'store')}", out, cases)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {world: spawn(world, tmp_path_factory.mktemp(f"world{world}"),
                         world) for world in (4, 2)}


@functools.lru_cache(maxsize=None)
def single(scene, samples, depth, seed):
    """The single-process wavefront render of a case's scene."""
    s, camera = W.build(scene)
    film = render(s, camera, W.SIZE, W.SIZE, spp=samples, max_depth=depth,
                  seed=seed)
    return film.sum.numpy(), film.depth_sum.numpy()


CASES = [(world, case) for world in (4, 2) for case in W.CASES[world]]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"world{w}-{c['name']}" for w, c in CASES])
def test_mesh_shapes_match_single_process(ranks, world, case):
    want_sum, want_depth = single(case["scene"], case["samples"],
                                  case["depth"], case["seed"])
    tol = (dict(rtol=1e-5, atol=1e-6) if case["integrator"] == "wavefront"
           else dict(rtol=2e-4, atol=2e-4))
    for rank in ranks[world]:
        key = case["name"]
        np.testing.assert_array_equal(rank[key + "/depth"], want_depth)
        np.testing.assert_allclose(rank[key + "/sum"], want_sum, **tol)
        assert int(rank[key + "/samples"]) == case["samples"]
    assert want_depth.sum() > 0


@pytest.mark.parametrize("world", [4, 2])
def test_film_is_row_sharded(ranks, world):
    for case in W.CASES[world]:
        rows = W.SIZE // case["tile"]
        for rank in ranks[world]:
            assert tuple(rank[case["name"] + "/shard"]) == (rows, W.SIZE, 3)
