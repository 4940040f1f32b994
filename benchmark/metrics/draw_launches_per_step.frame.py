"""Launches of the sampler's draw kernel a persistent step (L1 sampler
and camera): the traced job's unprofiled pass, its ``draw_launches``
over its steps (the program's pass record,
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
    if p.get("draw_launches") is None:
        return None
    return p["draw_launches"] / p["steps"]
