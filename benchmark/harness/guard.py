"""The check that a run loaded nothing of JAX: top-level module names
(the part before the first dot) compared whole, so ``mrt_torch`` is not
``mrt``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mrt")


def forbidden_loaded(modules=None):
    """The forbidden top-level names among `modules` (default: every
    module this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
