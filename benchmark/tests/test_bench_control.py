"""The control, the reference computed in bfloat16 in the program's
place, fails the check; the program's sound readings pass it.  At a tiny
size on the CPU (the cells' readings come from the card: PERF.md)."""

import io
import json

import pytest
import torch

from benchmark import control


@pytest.mark.parametrize("name", ["rtiow_1080p.frame_spp8",
                                  "sphere_grid_1080p.frame_spp8",
                                  "rtiow_1080p.preview_denoise_spp4"])
def test_the_control_fails_and_sound_runs_pass(tiny, name):
    cell = tiny.cell(name)
    out = io.StringIO()
    summary = control.readings(cell, [11, 2**31 + 12], [21, 22, 23],
                               torch.device("cpu"), out)
    limit = cell.limits["pixels_off_share"]
    assert all(summary["program"][k] <= v for k, v in cell.limits.items())
    assert summary["control"]["pixels_off_share"] > 3 * limit
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [x["kind"] for x in lines] == ["program"] * 2 + ["control"] * 3
    assert "faults" not in summary


def test_the_gradient_control_and_faults_fail(tiny):
    cell = tiny.cell("rtiow_1080p.grad_spp1_d6")
    summary = control.readings(cell, [2**31 + 4], [5], torch.device("cpu"),
                               io.StringIO())
    limits = cell.limits
    assert all(summary["program"][k] <= v for k, v in limits.items())
    assert any(summary["control"][k] > 3 * v for k, v in limits.items())
    assert set(summary["faults"]) == {"half", "altered"}
    for fault, got in summary["faults"].items():
        assert any(got[k] > v for k, v in limits.items()), fault
