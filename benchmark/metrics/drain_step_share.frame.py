"""The drain's share of a pass's steps (driver loop): the steps the
traced job's unprofiled pass ran after its first termination check that
found the work queue empty, over all its steps (the program's pass
record, ``mrt_torch.utils.profiling``); nothing where the program keeps
none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    passes = [p for p in snapshot().get("pass", []) if not p["profiled"]]
    if not passes or not passes[-1]["steps"]:
        return None
    return passes[-1]["drain_steps"] / passes[-1]["steps"]
