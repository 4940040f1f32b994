"""Host µs a persistent step (host dispatch): the traced job's
unprofiled pass, its wall time less the time the host was blocked in its
termination checks, over its steps (the program's pass record,
``mrt_torch.utils.profiling``); nothing where the program keeps none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    passes = [p for p in snapshot().get("pass", []) if not p["profiled"]]
    if not passes or not passes[-1]["steps"]:
        return None
    p = passes[-1]
    blocked = p["sync_ns"].get("termination check", 0)
    return (p["wall_ns"] - blocked) / p["steps"] / 1e3
