"""Host ms of a gradient step (host dispatch): the traced job's newest
unprofiled step (the one timed whole), its wall time up to its loss on
the host less the time the host was blocked in its reads from the device
(the program's grad step record, ``mrt_torch.utils.profiling``); nothing
where the program keeps none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    steps = [s for s in snapshot().get("grad_step", []) if not s["profiled"]]
    if not steps:
        return None
    s = steps[-1]
    return (s["wall_ns"] - sum(s["sync_ns"].values())) / 1e6
