"""The import guard compares whole top-level names; a run without a card
stops with no result."""

import io
import sys

import pytest

from benchmark.harness import guard


def test_whole_top_level_names():
    assert guard.forbidden_loaded(["mrt_torch", "mrt_torch.ops",
                                   "jaxtyping", "mrtx", "numpy"]) == []
    assert guard.forbidden_loaded(["mrt", "jax.numpy", "jaxlib.xla_client",
                                   "flax.linen"]) == ["flax", "jax",
                                                      "jaxlib", "mrt"]
    assert guard.forbidden_loaded(["mrt.geometry"]) == ["mrt"]


def test_the_harness_and_the_port_load_no_jax():
    import benchmark.harness.runner  # noqa: F401
    import benchmark.reference.tracer  # noqa: F401
    import mrt_torch.runtime.render  # noqa: F401

    assert guard.forbidden_loaded([m for m in sys.modules
                                   if m.startswith(("mrt_torch", "benchmark",
                                                    "torch"))]) == []


def test_no_cpu_fallback(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "environment", lambda: None)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "rtiow_1080p.frame_spp8", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code == 3
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_too_few_cards(monkeypatch, capsys):
    import torch

    from benchmark.harness import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        device.require(4)
    assert e.value.code == 3 and "needs 4 cards" in capsys.readouterr().err


def test_report_prints_checks_last(capsys):
    from benchmark.harness import runner

    result = dict(correct=True, attempted=1, failed=0, metrics={},
                  device={}, checks={"x": dict(value=0.5, limit=1.0)})
    out, err = io.StringIO(), io.StringIO()
    runner.report(result, out, err)
    assert err.getvalue().splitlines()[-1] == "check x: 0.5 (limit 1.0)"
    line = out.getvalue().splitlines()[-1]
    assert line.endswith('"checks": {"x": {"value": 0.5, "limit": 1.0}}}')
