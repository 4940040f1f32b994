"""The readings a cell's limits are set from: the program's on sound runs
and the control's.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23

In one process: set-up once, then for each of --seeds one job of the
cell at its own size, compared with the reference as a run compares it
(the lower reading: the largest); for each of --control-seeds the
reference computed in bfloat16, the precision below the configuration's
float32, put in the program's place (the upper reading: the smallest);
and, for a job kind that has them, the faults planted in the reference
put in the program's place, on the control seeds.  One JSON line a
reading, then a summary line.  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, control_seeds, dev, out=sys.stdout):
    """{"program": {check: largest}, "control": {check: smallest}} and,
    where the job plants faults, {fault: {check: smallest}} under
    "faults"."""
    job = cell.spec.module("jobs", cell.traffic["kind"])
    state = job.setup(cell, seeds[0], dev)
    summary = {"program": {}, "control": {}}
    runs = [("program", seeds, job.sound_reading, max),
            ("control", control_seeds, job.control_reading, min)]
    if hasattr(job, "fault_readings"):
        summary["faults"] = {}
        runs.append(("faults", control_seeds, job.fault_readings, min))
    for kind, group, fn, pick in runs:
        for seed in group:
            t0 = time.perf_counter()
            got = fn(state, seed)
            print(json.dumps(dict(cell=cell.name, kind=kind, seed=seed,
                                  seconds=time.perf_counter() - t0, **got)),
                  file=out, flush=True)
            merge(summary[kind], got, pick)
    return summary


def merge(into, got, pick):
    for name, value in got.items():
        if isinstance(value, dict):
            merge(into.setdefault(name, {}), value, pick)
        else:
            seen = into.get(name)
            into[name] = value if seen is None else pick(seen, value)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import device, spec
    from benchmark.run import environment

    environment()
    cell = spec.Spec().cell(args.workload)
    dev = device.require(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    summary = readings(cell, seeds, control, dev)
    print(json.dumps(dict(cell=cell.name, kind="summary",
                          device=device.describe(dev, cell.chips),
                          **summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
