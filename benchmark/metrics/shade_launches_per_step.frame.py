"""Launches of the shading kernel M1 a persistent step (L3 shading): the
traced job's unprofiled pass, its ``shade_launches`` over its steps (the
program's pass record, ``mrt_torch.utils.profiling``); nothing where the
program keeps none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    passes = [p for p in snapshot().get("pass", []) if not p["profiled"]]
    if not passes or not passes[-1]["steps"]:
        return None
    p = passes[-1]
    if p.get("shade_launches") is None:
        return None
    return p["shade_launches"] / p["steps"]
