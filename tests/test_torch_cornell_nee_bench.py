"""The Cornell box with next-event estimation as the benchmark runs it
(``cornell_nee_1080p``), at a small size on the CPU: the port's
persistent pass against the plain NEE reference
(``benchmark/reference/recipes/cornell.py``) under the cell's own pixel
rule and limits, the reference's own soundness, and NEE asked for
through the scene factory.

Tolerances and why: the pixel rule (``pixel_rtol``, ``pixel_atol``) and
the limits (``pixels_off_share``, ``mean_radiance_gap``) are the cell's
own files; the port's CPU pass walks the TLAS with B7's plain version,
whose arithmetic the reference's brute force repeats, so its film stays
well inside them.  Tables are compared byte for byte: both sides build
them with the same NumPy operations."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from mrt_torch.geometry.scene import attach_lights
from mrt_torch.materials.lights import LightTable
from mrt_torch.runtime.config import RenderConfig
from mrt_torch.runtime.driver import render_frame, run
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass_persistent
from mrt_torch.scenes import get, names

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import compare, scenes  # noqa: E402

CELL = "cornell_nee_1080p.frame_spp8"
W, H, SPP, DEPTH = 40, 24, 2, 50
SEED = 2**31 + 977


def _json(*parts):
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


CONFIG = dict(_json("configs", "cornell_nee_1080p.json"), width=W, height=H,
              max_depth=DEPTH)
TRAFFIC = _json("traffic", "frame_spp8.json")
LIMITS = {k: v["limit"] for k, v in _json(
    "workloads", f"{CELL}.json")["checks"].items()}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recipe():
    return scenes.recipe("cornell")


def _port(nee=True, start=16):
    scene, camera = get("cornell")(aspect_ratio=W / H, nee=nee).generate(
        device="cpu")
    return render_pass_persistent(scene, camera, Film.create(W, H, "cpu"),
                                  SEED, start, width=W, height=H,
                                  max_depth=DEPTH, samples=SPP, pool=512)


def _reference(dtype=torch.float32, start=16, **kw):
    ref = scenes.build(CONFIG, "cpu", dtype)
    return _recipe().film_at(ref, torch.arange(W * H), start, SPP, SEED, W,
                             H, DEPTH, dtype, **kw)


def _readings(port_rad, port_depth, ref):
    return dict(
        pixels_off_share=compare.pixels_off(
            port_rad.reshape(-1, 3), port_depth.reshape(-1), *ref,
            TRAFFIC["pixel_rtol"], TRAFFIC["pixel_atol"]),
        mean_radiance_gap=compare.mean_radiance_gap(port_rad.reshape(-1, 3),
                                                    ref[0]))


@pytest.fixture(scope="module")
def reference():
    return _reference()


def test_the_ports_nee_pass_holds_the_reference(reference):
    film = _port()
    got = _readings(film.sum, film.depth_sum, reference)
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got
    # The room fills about half the frame (0.57 of its pixels lit at this
    # size); outside it the background is black.
    assert (reference[0].sum(dim=1) > 0).float().mean() > 0.4


@pytest.mark.parametrize("fault", ["without_nee", "bfloat16"])
def test_the_check_catches_a_pass_without_nee_and_the_control(reference,
                                                               fault):
    if fault == "without_nee":
        film = _port(nee=False)
        got = _readings(film.sum, film.depth_sum, reference)
    else:
        low = _reference(torch.bfloat16)
        got = _readings(*low, reference)
    assert got["pixels_off_share"] > LIMITS["pixels_off_share"], got


def test_the_reference_is_deterministic_and_batch_invariant(reference):
    again = _reference()
    pieces = _reference(batch=97)
    assert torch.equal(reference[0], again[0])
    assert torch.equal(reference[1], again[1])
    assert torch.equal(reference[1], pieces[1])
    assert torch.allclose(reference[0], pieces[0], rtol=1e-12, atol=0.0)
    other = _reference(start=18)
    assert compare.pixels_off(*other, *reference, 1e-4, 1e-4) > 0.5


def test_the_reference_builds_the_ports_tables():
    scene, camera = get("cornell")(aspect_ratio=W / H, nee=True).generate(
        device="cpu")
    ref = scenes.build(CONFIG, "cpu")
    for key in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
                "lens_radius"):
        assert torch.equal(ref["camera"][key], getattr(camera, key)), key
    m, rm = scene.materials, ref["materials"]
    assert torch.equal(rm["mtype"], m.mtype.long())
    assert torch.equal(rm["albedo"], m.albedo[:, :3])
    for key in ("fuzz", "ior", "emit"):
        assert torch.equal(rm[key], getattr(m, key)), key
    for key in LightTable.FIELDS:
        want = getattr(scene.lights, key).numpy()
        got = ref["lights"][key].numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), key
    # The instances' transforms, as B7 reads them.
    tl, inst = scene.tlas, ref["instances"]
    assert torch.equal(inst["fwd"], tl.transform[:, :3, :3])
    assert torch.equal(inst["inv"].reshape(-1, 9), tl.inst[:, :9])
    assert torch.equal(inst["inv_t"], tl.inst[:, 9:])
    assert torch.equal(inst["material"], tl.override.long())
    assert ref["spheres"]["center"].shape[0] == scene.spheres.count == 1


def test_the_scene_factory_attaches_the_same_light_table():
    plain, _ = get("cornell")(aspect_ratio=W / H).generate(device="cpu")
    assert plain.lights is None
    attached = attach_lights(plain)
    asked, _ = get("cornell")(aspect_ratio=W / H, nee=True).generate(
        device="cpu")
    for key in LightTable.FIELDS:
        want = getattr(attached.lights, key).numpy()
        got = getattr(asked.lights, key).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), key


@pytest.mark.parametrize("name", names())
def test_every_scene_takes_the_nee_keyword(name):
    assert get(name)().nee is False
    assert get(name)(nee=True).nee is True


def test_the_drivers_nee_film_is_unchanged(tmp_path):
    # The CLI's --nee: the light table asked of the constructor renders
    # the film that attaching it after generate rendered.
    config = RenderConfig(scene="cornell", width=12, height=8, spp=2,
                          samples_per_pass=1, max_depth=6, nee=True,
                          output=str(tmp_path / "nee.png"))
    film = run(config, log=lambda *a, **k: None, device="cpu")
    scene, camera = get("cornell")(
        aspect_ratio=config.aspect_ratio).generate(device="cpu")
    want = render_frame(attach_lights(scene), camera, config)
    assert torch.equal(film.sum, want.sum)
    assert torch.equal(film.depth_sum, want.depth_sum)
    np.testing.assert_array_less(0.0, film.sum.numpy().sum())
