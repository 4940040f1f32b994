"""Lane occupancy of a pass (driver loop): the active lanes summed over
the termination checks of the traced job's unprofiled pass, over the
pool times the checks (the program's pass record,
``mrt_torch.utils.profiling``); nothing where the program keeps none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    passes = [p for p in snapshot().get("pass", []) if not p["profiled"]]
    if not passes or not passes[-1]["checks"]:
        return None
    p = passes[-1]
    return p["active"] / (p["pool"] * p["checks"])
