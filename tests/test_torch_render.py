"""Port parity for the whole slice: RTIOW through the port's wavefront
``render`` and persistent ``render_pass_persistent`` at the golden
settings of tests/golden_scenes.py (24x24, spp 8, depth 6, seed 5).

Tolerances and why:
  - Against the JAX render run op by op (``jax.disable_jit``), the port
    rounds every operation the same way except cos, sin and cbrt
    (<= 2 ulp apart): the golden tolerances hold strictly, sum rtol/atol
    1e-4 and depth exact.
  - The committed golden was rendered by the compiled JAX program, where
    XLA contracts multiply-adds into FMAs (its CPU object code holds
    vfmadd).  Those last-bit differences flip a few paths: 4 of 576
    pixels change their bounce count (0.7%).  The test allows at most 1%
    of pixels (5 of 576) with a flipped path, and holds every other
    pixel to 5e-4 (near-tangent hits amplify the FMA difference on 3
    pixels to between 1e-4 and 5e-4).
  - The port's persistent pass draws the same random numbers as its
    wavefront render, but its camera multiplies by 1/width where the
    wavefront divides by width (as in the reference), and its film adds
    in another order: the same 1% / 5e-4 rule holds between the two.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import golden_scenes as G
from mrt.runtime.render import render as jrender
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render, render_pass_persistent
from mrt_torch.scenes import get

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      f"rtiow_{G.SIZE}.npz")
MAX_FLIPPED = 5  # 1% of 576 pixels


def _scene():
    return get("rtiow")(aspect_ratio=1.0, grid=5).generate(device="cpu")


def _render(**kw):
    scene, camera = _scene()
    return render(scene, camera, G.SIZE, G.SIZE, spp=G.SPP,
                  max_depth=G.DEPTH, seed=G.SEED, **kw)


def _persistent(pool=1024):
    scene, camera = _scene()
    return render_pass_persistent(scene, camera,
                                  Film.create(G.SIZE, G.SIZE, device="cpu"),
                                  G.SEED, 0, width=G.SIZE, height=G.SIZE,
                                  max_depth=G.DEPTH, samples=G.SPP, pool=pool)


def _close(film, want_sum, want_depth):
    """At most MAX_FLIPPED pixels with another bounce count; every other
    pixel's sum within 5e-4."""
    flipped = film.depth_sum.numpy() != want_depth
    assert flipped.sum() <= MAX_FLIPPED, flipped.sum()
    keep = ~flipped
    np.testing.assert_allclose(film.sum.numpy()[keep], want_sum[keep],
                               rtol=5e-4, atol=5e-4)


def _against_golden(film):
    gold = np.load(GOLDEN)
    _close(film, gold["sum"], gold["depth"])


def test_render_matches_unfused_reference():
    scene, camera = G.rtiow()
    with jax.disable_jit():
        want = jrender(scene, camera, G.SIZE, G.SIZE, spp=G.SPP,
                       max_depth=G.DEPTH, seed=G.SEED)
    got = _render()
    np.testing.assert_array_equal(got.depth_sum.numpy(),
                                  np.asarray(want.depth_sum))
    np.testing.assert_allclose(got.sum.numpy(), np.asarray(want.sum),
                               rtol=1e-4, atol=1e-4)
    assert got.samples == int(want.samples) == G.SPP


def test_render_reproduces_golden():
    _against_golden(_render())


def test_persistent_reproduces_golden():
    _against_golden(_persistent())


@pytest.mark.parametrize("pool", [64, 1024, 8192])
def test_persistent_matches_wavefront(pool):
    # Pool 64 keeps most lanes regenerating; 8192 exceeds the 4608-item
    # queue, so lanes start idle and the loop runs on an empty queue.
    want = _render()
    got = _persistent(pool)
    _close(got, want.sum.numpy(), want.depth_sum.numpy())


def test_trace_batched_matches_one_batch():
    # 576 rays in batches of 100: the last batch is padded with dead lanes.
    from mrt_torch.integrator import wavefront

    scene, camera = _scene()
    rs = np.random.default_rng(31)
    s, t, du, dv = (torch.from_numpy(x) for x in
                    rs.random((4, 576)).astype(np.float32))
    o, d = camera.rays(s, t, du, dv)
    ids = torch.arange(576)
    whole = wavefront.trace_wavefront(scene, o, d, ids, 3, max_depth=6)
    parts = wavefront.trace_batched(scene, o, d, ids, 3, max_depth=6,
                                    batch_size=100)
    for w, p in zip(whole, parts):
        np.testing.assert_array_equal(p.numpy(), w.numpy())


def test_render_in_passes_and_resume():
    whole = _render()
    scene, camera = _scene()
    seen = []
    part = render(scene, camera, G.SIZE, G.SIZE, spp=5, max_depth=G.DEPTH,
                  seed=G.SEED, samples_per_pass=2,
                  progress=lambda f: seen.append(f.samples))
    assert seen == [2, 4, 5]
    resumed = render(scene, camera, G.SIZE, G.SIZE, spp=G.SPP,
                     max_depth=G.DEPTH, seed=G.SEED, film=part)
    np.testing.assert_array_equal(resumed.sum.numpy(), whole.sum.numpy())
    np.testing.assert_array_equal(resumed.depth_sum.numpy(),
                                  whole.depth_sum.numpy())


def test_port_imports_neither_jax_nor_mrt():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import mrt_torch\n"
        "from mrt_torch import convert, ops\n"
        "import os\n"
        "from mrt_torch.geometry import bvh, instance, shapes, triangles\n"
        "from mrt_torch.loaders import load_obj, load_ply, load_stl_binary\n"
        "from mrt_torch.math import m4\n"
        "from mrt_torch.ops import budget, bvh\n"
        "from mrt_torch.runtime import assets, input, physics\n"
        "from mrt_torch.scenes import (cornell, envmaps, eve, get, lucy,\n"
        "                              menger, playground, sphere_grid)\n"
        "from mrt_torch.ops import compact, gather\n"
        "from mrt_torch.geometry import volumes, voxels\n"
        "from mrt_torch.materials import lights\n"
        "from mrt_torch.tools import device_math, probe_stream\n"
        "from mrt_torch import profile\n"
        "from mrt_torch.textures import atlas\n"
        "from mrt_torch.runtime.film import Film\n"
        "from mrt_torch.runtime.render import render, "
        "render_pass_persistent\n"
        "for name, kw, route in (('rtiow', dict(grid=2), ''),\n"
        "                        ('cornell', {}, ''),\n"
        "                        ('sphere_grid', dict(dim=4), ''),\n"
        "                        ('playground', {}, 'flat'),\n"
        "                        ('lucy', dict(grid=2), 'flat'),\n"
        "                        ('lucy', dict(grid=2), ''),\n"
        "                        ('menger', dict(level=1, voxel=False), ''),\n"
        "                        ('menger', dict(level=1), ''),\n"
        "                        ('eve', {}, 'compact'), ('eve', {}, '')):\n"
        "    flag = '1' if route == 'compact' else '0'\n"
        "    os.environ['MRT_TLAS_KERNEL'] = '' if flag == '1' else route\n"
        "    os.environ.update(MRT_BG_COMPACT=flag, MRT_TEX_COMPACT=flag)\n"
        "    scene, camera = get(name)(aspect_ratio=1.0, **kw).generate(\n"
        "        device='cpu')\n"
        "    film = render(scene, camera, 6, 4, spp=1, max_depth=3)\n"
        "    film = render_pass_persistent(scene, camera, film, 1, 1,\n"
        "                                  width=6, height=4, max_depth=3,\n"
        "                                  pool=16)\n"
        "    assert film.samples == 2 and film.depth_sum.sum() > 0, name\n"
        "    if name == 'playground':\n"
        "        assert scene.tlas.flat_tris is not None\n"
        "    if name == 'lucy' and route:\n"
        "        assert len(scene.tlas.flat_parts) > 1\n"
        "assert scene.sphere_bvh is None and scene.tlas is not None\n"
        "from mrt_torch.geometry.scene import attach_lights\n"
        "scene, camera = get('cornell')(aspect_ratio=1.0).generate(\n"
        "    device='cpu')\n"
        "film = render_pass_persistent(attach_lights(scene), camera,\n"
        "                              Film.create(6, 4, device='cpu'), 1,\n"
        "                              0, width=6, height=4, max_depth=3,\n"
        "                              pool=16, rr_depth=1, pend=True)\n"
        "assert film.depth_sum.sum() > 0\n"
        "from mrt_torch import inverse\n"
        "from mrt_torch.core import autodiff\n"
        "scene, camera = get('rtiow')(aspect_ratio=1.0, grid=2).generate(\n"
        "    device='cpu')\n"
        "a = scene.materials.albedo.clone().requires_grad_(True)\n"
        "inverse.render_image(scene.replace(materials=scene.materials\n"
        "                     .replace(albedo=a)), camera, 4, 4, spp=1,\n"
        "                     max_depth=2).sum().backward()\n"
        "assert a.grad is not None\n"
        "from mrt_torch import parallel\n"
        "from mrt_torch.parallel import make_mesh, render_sharded\n"
        "film = render_sharded(scene, camera, 6, 4, make_mesh(device='cpu'),\n"
        "                      spp=1, max_depth=2, persistent=True)\n"
        "assert film.samples == 1 and parallel.init_distributed() is None\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mrt'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["rtiow", "cornell", "sphere_grid", "lucy",
                                   "playground", "eve", "menger", "film",
                                   "load_state", "make_mesh",
                                   "init_distributed", "render_sharded"])
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    # Without a card and without device="cpu" the entry points raise;
    # they never carry on quietly on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "film.npz"
    Film.create(2, 3, device="cpu").save_state(path)
    from mrt_torch import parallel

    def sharded():
        scene, camera = get("rtiow")(aspect_ratio=1.0, grid=2).generate(
            device="cpu")
        return parallel.render_sharded(scene, camera, 2, 2, spp=1)

    # init_distributed resolves the device before it joins any group.
    build = dict(
        film=lambda: Film.create(2, 3),
        load_state=lambda: Film.load_state(path),
        make_mesh=parallel.make_mesh,
        init_distributed=lambda: parallel.init_distributed(
            "localhost:1", num_processes=2, process_id=0),
        render_sharded=sharded).get(
            entry, lambda: get(entry)(aspect_ratio=1.0).generate())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
