"""Fixtures of the benchmark's CPU tests: the checkout's root on the
path, the ``gpu`` marker, and a copy of the benchmark's cells at a tiny
size in a temporary folder (every file the harness finds by name there
first, the rest in the benchmark's own folder)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(width=48, height=27, max_depth=6, pool=512)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one")


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_spec(tmp):
    """The benchmark's BENCHMARK.json and cells, their configurations cut
    to TINY (sphere_grid to a 10x10 grid, still under a BVH), in `tmp`."""
    from benchmark.harness import spec

    bench = Path(tmp) / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in data["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf.update(TINY)
        if conf["scene"] == "sphere_grid":
            conf["scene_args"]["dim"] = 5
        (Path(tmp) / c["file"]).write_text(json.dumps(conf))
    for w in data["workloads"]:
        traffic = json.loads((spec.HERE / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        traffic.update({"frame": dict(spp=2, check_pixels=96),
                        "grad": dict(block=500),
                        "image": dict(spp=2, samples_per_pass=2,
                                      check_pixels=96)}[traffic["kind"]])
        (bench / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(traffic))
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(data))
    return spec.Spec(tmp, [bench, spec.HERE])


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))  # the preview's PNG
    return tiny_spec(tmp_path)
