"""The scene zoo (mirrors ``mrt.scenes``): a scene object exposes
``generate(t, frame, input, device=None) -> (Scene, Camera)``, built on
the host, returned on ``device`` (None: the CUDA card) and looked up by
name.  Every registered scene's constructor takes ``nee=False``: the one
way to ask for next-event estimation, with which ``generate`` returns
the scene with its light table attached (``attach_lights``).  Each
``generate`` call is a ``scene_build`` unit of the tracer
(``utils.profiling``): its wall time, with the host BVH build, B1's
group build, the table upload and, with ``nee``, the ``light table``
(and a ``lights`` field, the table's count) as its parts."""

from __future__ import annotations

import functools

from ..geometry.scene import attach_lights
from ..utils import profiling

_REGISTRY = {}


def register(name):
    """Class decorator: register the scene class under `name`, its
    constructor given the ``nee`` keyword and its ``generate`` recorded
    as a scene build that attaches the light table where ``nee`` is
    set."""
    def deco(cls):
        init, generate = cls.__init__, cls.generate

        @functools.wraps(init)
        def init_nee(self, *args, nee=False, **kwargs):
            init(self, *args, **kwargs)
            self.nee = bool(nee)

        @functools.wraps(generate)
        def recorded(self, *args, **kwargs):
            with profiling.unit("scene_build", scene=name) as rec, \
                    profiling.span("scene build"):
                scene, camera = generate(self, *args, **kwargs)
                if self.nee:
                    with profiling.part("light table"):
                        scene = attach_lights(scene)
                    rec["lights"] = (0 if scene.lights is None
                                     else scene.lights.count)
                return scene, camera

        cls.__init__ = init_nee
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
