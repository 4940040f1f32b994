"""Launches of the hit-record kernel H1 a persistent step (L2
intersection): the traced job's unprofiled pass, its ``hit_launches``
over its steps (the program's pass record, ``mrt_torch.utils.profiling``);
nothing where the program keeps none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    passes = [p for p in snapshot().get("pass", []) if not p["profiled"]]
    if not passes or not passes[-1]["steps"]:
        return None
    p = passes[-1]
    if p.get("hit_launches") is None:
        return None
    return p["hit_launches"] / p["steps"]
