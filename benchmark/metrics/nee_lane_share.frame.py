"""The share of lane-steps that took a light sample (L3n light
sampling): the traced job's unprofiled pass, its ``nee_lanes`` (lanes
that sampled a light, summed over its steps) over its steps times its
pool (the program's pass record, ``mrt_torch.utils.profiling``);
nothing where the program keeps no such count or the scene has no light
table."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    passes = [p for p in snapshot().get("pass", []) if not p["profiled"]]
    if not passes or not passes[-1]["steps"]:
        return None
    p = passes[-1]
    if p.get("nee_lanes") is None:
        return None
    return p["nee_lanes"] / (p["steps"] * p["pool"])
