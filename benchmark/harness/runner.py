"""One run of one cell: set-up, the measured window or the traced job,
the device's numbers, the check against the reference, and the result.

A job kind (``jobs/<kind>.py``) gives five functions:
  setup(cell, seed, dev) -> state: build and warm up every shape used
  window(state, seconds) -> dict(values, attempted, failed,
    job_seconds): the end-to-end values by metric name, from the closed
    loop, and each job's seconds
  traced(state) -> dict(record, busy_s, window_s, breakdown, attempted,
    failed): the profiled job; ``record`` is what the per-layer readers
    (``metrics/<name>.py``, ``read(record)``) take
  release(state): free the program's state, keeping its outputs
  check(state) -> {name: value}: the numbers compared with the reference,
    each held to the cell's limit (``workloads/<cell>.json``)
"""

from __future__ import annotations

import math
import sys

from . import device


def run_cell(cell, seed, seconds, trace, dev, t_start, clock):
    """The result object of one run; `t_start` is the process's start on
    `clock`."""
    job = cell.spec.module("jobs", cell.traffic["kind"])
    state = job.setup(cell, seed, dev)
    device.sync(dev)
    setup_s = clock() - t_start
    extra = {}
    if trace:
        out = job.traced(state)
        record = dict(out["record"], kind=_kind(dev))
        metrics = {}
        for m in cell.per_layer:
            value = cell.spec.module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        extra["breakdown"] = out["breakdown"]
        print(f"trace: {record['launches']} device operations, "
              f"{record['unplaced']} not placed by their launch",
              file=sys.stderr)
    else:
        out = job.window(state, seconds)
        times = out["job_seconds"]
        print(f"window: {len(times)} jobs; seconds each: "
              + ", ".join(f"{t:.4f}" for t in times), file=sys.stderr)
        values = dict(out["values"], setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    dev_info = device.describe(dev, cell.chips)
    if trace:
        dev_info.update(busy_s=out["busy_s"], window_s=out["window_s"])
    job.release(state)
    readings = job.check(state)
    checks = {name: dict(value=readings[name], limit=limit)
              for name, limit in cell.limits.items()}
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    return dict(correct=correct, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=dev_info,
                **extra, checks=checks)


def report(result, out=sys.stdout, err=sys.stderr):
    """Each number compared beside its limit as the last lines of
    standard error; the result as the last line of standard output."""
    import json

    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def _kind(dev):
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
