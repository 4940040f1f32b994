"""A short run of each cell on the card, through the one command."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec

CELLS = [w["name"] for w in spec.Spec().data["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 101), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
