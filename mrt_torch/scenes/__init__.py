"""The scene zoo (mirrors ``mrt.scenes``): a scene object exposes
``generate(t, frame, input, device=None) -> (Scene, Camera)``, built on
the host, returned on ``device`` (None: the CUDA card) and looked up by
name."""

from __future__ import annotations

_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get(name):
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scene {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


from . import (cornell, eve, lucy, menger,  # noqa: E402,F401
               playground, rtiow, sphere_grid)
