"""Mesh loaders, host NumPy (mirrors ``mrt.loaders``): OBJ + MTL, PLY
and binary STL."""

from .obj import (FnObjBuilder, ObjBuilder, SimpleTexturedBuilder,  # noqa: F401
                  load_obj)
from .ply import load_ply  # noqa: F401
from .stl import load_stl_binary  # noqa: F401
