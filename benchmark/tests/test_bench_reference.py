"""The plain reference against itself at a tiny size, and against the
port's CPU pass (the port's CPU kernels are its plain versions)."""

import json

import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import compare, scenes, tracer

SEED = 2**31 + 977


def config(name, **size):
    conf = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    conf.update(width=40, height=24, max_depth=6, **size)
    if conf["scene"] == "sphere_grid":
        conf["scene_args"]["dim"] = 5
    return conf


@pytest.mark.parametrize("name", ["rtiow_1080p", "sphere_grid_1080p"])
def test_the_reference_is_deterministic_and_batch_invariant(name):
    conf = config(name)
    ref = scenes.build(conf, "cpu")
    pix = torch.randperm(40 * 24, generator=torch.Generator().manual_seed(3))[
        :128]
    args = (pix, 8, 2, SEED, 40, 24, 6)
    whole = tracer.film_at(ref, *args)
    pieces = tracer.film_at(ref, *args, batch=37)
    assert torch.equal(whole[1], pieces[1])
    assert torch.allclose(whole[0], pieces[0], rtol=1e-12, atol=0.0)
    assert compare.pixels_off(*whole, *pieces, 1e-4, 1e-4) == 0.0
    other = tracer.film_at(ref, pix, 8, 2, SEED + 1, 40, 24, 6)
    assert compare.pixels_off(*other, *whole, 1e-4, 1e-4) > 0.5


@pytest.mark.parametrize("name", ["rtiow_1080p", "sphere_grid_1080p"])
def test_the_reference_holds_the_ports_cpu_film(name):
    from mrt_torch.runtime.film import Film
    from mrt_torch.runtime.render import render_pass_persistent
    from mrt_torch.scenes import get

    conf = config(name)
    scene, camera = get(conf["scene"])(aspect_ratio=40 / 24,
                                       **conf["scene_args"]).generate(
        device="cpu")
    film = render_pass_persistent(scene, camera, Film.create(40, 24, "cpu"),
                                  SEED, 16, width=40, height=24, max_depth=6,
                                  samples=2, pool=384)
    pix = torch.arange(40 * 24)
    ref = tracer.film_at(scenes.build(conf, "cpu"), pix, 16, 2, SEED, 40, 24,
                         6)
    off = compare.pixels_off(film.sum.reshape(-1, 3),
                             film.depth_sum.reshape(-1), *ref, 1e-4, 1e-4)
    # C15: the BVH's slab test may cull a box that holds a nearer sphere.
    assert off <= 2 / (40 * 24)


def test_the_reference_builds_the_ports_tables():
    from mrt_torch.scenes import get

    for name in ("rtiow_1080p", "sphere_grid_1080p"):
        conf = config(name)
        scene, camera = get(conf["scene"])(aspect_ratio=40 / 24,
                                           **conf["scene_args"]).generate(
            device="cpu")
        ref = scenes.build(conf, "cpu")
        for key in ("origin", "lower_left", "horizontal", "vertical", "u",
                    "v", "lens_radius"):
            assert torch.equal(ref["camera"][key], getattr(camera, key))
        m = scene.materials
        assert torch.equal(ref["materials"]["albedo"], m.albedo[:, :3])
        assert torch.equal(ref["materials"]["mtype"], m.mtype.long())
        assert ref["spheres"]["center"].shape[0] == scene.spheres.count


def test_bfloat16_is_another_answer():
    conf = config("rtiow_1080p")
    pix = torch.arange(0, 40 * 24, 7)
    args = (pix, 0, 2, SEED, 40, 24, 6)
    ref = tracer.film_at(scenes.build(conf, "cpu"), *args)
    low = tracer.film_at(scenes.build(conf, "cpu", torch.bfloat16), *args,
                         dtype=torch.bfloat16)
    assert compare.pixels_off(*low, *ref, 1e-4, 1e-4) > 0.5


def test_pixels_off_counts_depth_radiance_and_non_finite():
    ref_r = torch.ones(4, 3, dtype=torch.float64)
    ref_d = torch.tensor([1, 2, 3, 4])
    port_r = ref_r.clone().float()
    port_r[1, 0] += 1e-3
    port_r[2, 2] = float("nan")
    port_d = ref_d.clone()
    port_d[3] += 1
    assert compare.pixels_off(port_r, port_d, ref_r, ref_d, 1e-4, 1e-4) == 0.75
    port_r[0, 1] += 1e-5  # inside the tolerance
    assert compare.pixels_off(port_r, port_d, ref_r, ref_d, 1e-4, 1e-4) == 0.75
