"""Reads from the device in a gradient step (L6): the traced job's
newest unprofiled step (the one timed whole), its ``to_host`` calls at
every site (the program's grad step record,
``mrt_torch.utils.profiling``); nothing where the program keeps none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    steps = [s for s in snapshot().get("grad_step", []) if not s["profiled"]]
    if not steps:
        return None
    return sum(steps[-1]["syncs"].values())
