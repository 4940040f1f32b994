"""Asset path resolution (mirrors ``mrt.runtime.assets``).

The reference loads meshes from a ``models/`` directory next to the
binary (``models/lucy.ply``).  Those assets are not in the repository,
so scenes build stand-ins when a file is missing, and a real asset takes
effect without a code change once it is dropped in.  ``resolve`` looks
a relative path up in order:

  1. absolute paths pass through;
  2. $MRT_MODELS_DIR, if set, replaces a leading ``models/`` component;
  3. the current working directory;
  4. the repository root.

The first candidate that exists wins; if none does, the path comes back
as given (callers read a missing path as "use the stand-in").
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def resolve(path: str) -> str:
    if os.path.isabs(path):
        return path
    candidates = []
    env = os.environ.get("MRT_MODELS_DIR")
    if env:
        parts = path.replace("\\", "/").split("/")
        sub = parts[1:] if parts and parts[0] == "models" else parts
        candidates.append(os.path.join(env, *sub))
    candidates.append(path)
    candidates.append(os.path.join(_REPO_ROOT, path))
    for c in candidates:
        if os.path.exists(c):
            return c
    return path
