"""Seconds of the process's first scene build (set-up): its
``generate``, with the host BVH or B1 group build and the table upload
(the program's scene build record, ``mrt_torch.utils.profiling``);
nothing where the program keeps none."""


def read(record):
    try:
        from mrt_torch.utils.profiling import snapshot
    except ImportError:
        return None
    builds = snapshot().get("scene_build", [])
    if not builds:
        return None
    return builds[0]["wall_ns"] / 1e9
