"""The kernel table of ``mrt_torch/ops/_build.py`` against the CUDA
sources, and the tracer's independence of the kernels.  CPU only;
imports no JAX."""

import re
import subprocess
import sys
from pathlib import Path

from mrt_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")
ENTRY = re.compile(r'extern "C" int (mrt_\w+)\s*\(')


def _sources():
    return "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu*")))


def test_every_row_names_an_entry_and_a_kernel_of_the_sources():
    # Each row's C entry is defined in csrc, every int entry there has a
    # row (or is the helper), and the kernel name each device-name
    # pattern starts with is a __global__ function there.
    src = _sources()
    kernels, entries = set(GLOBAL.findall(src)), set(ENTRY.findall(src))
    assert entries == set(_build.ENTRIES)
    for kid, row in _build.KERNELS.items():
        assert re.match(r"\w+", row.pattern).group(0) in kernels, kid
        assert row.argtypes[-1] is _build._P, kid  # the stream, last
    assert len({row.entry for row in _build.KERNELS.values()}) == len(
        _build.KERNELS)


def test_the_tracer_loads_no_kernel_module():
    code = ("import sys, mrt_torch.utils.profiling as p; "
            "p.snapshot(); "
            "print([m for m in sys.modules if m.startswith('mrt_torch.ops')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"
