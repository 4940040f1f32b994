"""The scene zoo (mirrors ``mrt.scenes``): a scene object exposes
``generate(t, frame, input, device=None) -> (Scene, Camera)``, built on
the host, returned on ``device`` (None: the CUDA card) and looked up by
name.  Each ``generate`` call is a ``scene_build`` unit of the tracer
(``utils.profiling``): its wall time, with the host BVH build, B1's
group build and the table upload as its parts."""

from __future__ import annotations

import functools

from ..utils import profiling

_REGISTRY = {}


def register(name):
    """Class decorator: register the scene class under `name`, its
    ``generate`` recorded as a scene build."""
    def deco(cls):
        generate = cls.generate

        @functools.wraps(generate)
        def recorded(self, *args, **kwargs):
            with profiling.unit("scene_build", scene=name), \
                    profiling.span("scene build"):
                return generate(self, *args, **kwargs)

        cls.generate = recorded
        _REGISTRY[name] = cls
        return cls
    return deco


def get(name):
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scene {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)


from . import (cornell, eve, lucy, menger,  # noqa: E402,F401
               playground, rtiow, sphere_grid)
