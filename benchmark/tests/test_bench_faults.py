"""A whole run past the look for a card, at a tiny size on the CPU, with
the timed path broken underneath: ``correct`` has to come out false for
each fault a frame cell can have, and true without one."""

import time

import pytest
import torch

from benchmark.harness import runner

CELLS = ["rtiow_1080p.frame_spp8", "sphere_grid_1080p.frame_spp8",
         "rtiow_1080p.grad_spp1_d6", "rtiow_1080p.preview_denoise_spp4"]
PASSES = [CELLS[0], CELLS[1], CELLS[3]]


def run(tiny, name, seed=2**31 + 5):
    return runner.run_cell(tiny.cell(name), seed, 0.5, False,
                           torch.device("cpu"), time.time(), time.time)


def deposit_nothing(film, slot, vals):
    """The step's deposit left out: the film keeps its state."""


def half_the_lanes(deposit):
    def broken(film, slot, vals):
        slot = slot.clone()
        slot[1::2] = -1
        return deposit(film, slot, vals)
    return broken


def altered(deposit):
    def broken(film, slot, vals):
        vals = vals.clone()
        vals[:, :3] *= 1.01
        return deposit(film, slot, vals)
    return broken


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny, name):
    result = run(tiny, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_pass_is_not_correct(tiny, name, fault, monkeypatch):
    from mrt_torch.integrator import persistent

    real = persistent.deposit
    broken = {"unchanged": deposit_nothing, "half": half_the_lanes(real),
              "altered": altered(real)}[fault]
    monkeypatch.setattr(persistent, "deposit", broken)
    result = run(tiny, name)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def frozen(optimize):
    """Steps that return their state unchanged: the program's optimizer
    (not the reference's) steps nowhere."""
    def broken(*args, optimizer, **kwargs):
        def factory(leaves):
            opt = optimizer(leaves)
            opt.step = lambda closure=None: None
            return opt
        return optimize(*args, optimizer=factory, **kwargs)
    return broken


def half_the_pixels(img, target):
    """The loss's mean over every other pixel: half the batch left out."""
    return torch.mean(((img - target) ** 2).reshape(-1, 3)[::2])


def altered_image(render_image):
    def broken(*args, **kwargs):
        return render_image(*args, **kwargs) * 1.01
    return broken


def altered_after(render_image, n):
    """The image altered from the (n + 1)-th render on: a step that breaks
    only after set-up, as a step cached or captured on warm-up could."""
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        img = render_image(*args, **kwargs)
        return img * 1.01 if len(calls) > n else img
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "altered_in_window"])
def test_a_broken_gradient_step_is_not_correct(tiny, fault, monkeypatch):
    from mrt_torch import inverse

    if fault == "altered_in_window":
        # Set-up renders the target and its first check_steps steps.
        n = 1 + tiny.cell(CELLS[2]).traffic["check_steps"]
        monkeypatch.setattr(inverse, "render_image",
                            altered_after(inverse.render_image, n))
    elif fault == "unchanged":
        monkeypatch.setattr(inverse, "optimize", frozen(inverse.optimize))
    elif fault == "half":
        monkeypatch.setattr(inverse, "l2_loss", half_the_pixels)
    else:
        monkeypatch.setattr(inverse, "render_image",
                            altered_image(inverse.render_image))
    result = run(tiny, CELLS[2])
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    if fault == "altered_in_window":
        assert all(c["value"] <= c["limit"]
                   for name, c in result["checks"].items()
                   if not name.startswith("window_"))


@pytest.mark.parametrize("stage", ["guides", "denoiser"])
def test_a_broken_post_process_is_not_correct(tiny, stage, monkeypatch):
    """An answer altered where it is made: the pre-pass's guides, or the
    denoised image."""
    from mrt_torch.runtime import denoise, render

    if stage == "guides":
        real = render.aov_pass

        def broken(*args, **kwargs):
            albedo, normal = real(*args, **kwargs)
            return albedo * 1.01, normal
        monkeypatch.setattr(render, "aov_pass", broken)
    else:
        real = denoise.denoise
        monkeypatch.setattr(denoise, "denoise",
                            lambda *a, **k: real(*a, **k) * 0.99)
    result = run(tiny, CELLS[3])
    assert not result["correct"]
    name = {"guides": "guides_off_share",
            "denoiser": "png_bytes_off_share"}[stage]
    assert result["checks"][name]["value"] > result["checks"][name]["limit"]
