"""Run one cell of the benchmark once, in this process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the scene, the kernels' build, a warm-up of the cell's job) is
timed from the process's start; then either the measured window
(--trace 0: the cell's end-to-end metrics) or the traced job (--trace 1:
its per-layer metrics); then the check against the plain reference.
The last line of standard output is the result object, and the last
lines of standard error each number compared beside its limit.  Exits
3 without a result where the cell's cards are missing, and 4 where any
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def environment(root=ROOT):
    """Caches inside the checkout at fixed paths; nothing loads Flax.
    The kernels' own build lands in ``mrt_torch/_build/``."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    environment()
    sys.path.insert(0, str(ROOT))

    from benchmark.harness import device, guard, runner, spec

    cell = spec.Spec().cell(args.workload)
    dev = device.require(cell.chips)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             dev, T_START, time.time)
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: modules of JAX or of the JAX package loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 4
    runner.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
