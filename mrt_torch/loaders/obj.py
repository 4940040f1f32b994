"""Wavefront OBJ + MTL loader, on the host (mirrors ``mrt.loaders.obj``).

The reference's line parser with a pluggable builder: v/vn/vt/f/o/g/
usemtl/mtllib, 1-based indices, triangular faces, the ``v//n`` form
(which, a quirk of the reference kept here, reads uv[0] for every
corner), group filtering, and ``SimpleTexturedBuilder``, which parses
the .mtl's newmtl/Kd rows into Lambertian materials and flips V.

Textures (``map_Kd``) need a PNG reader, which the port does not have
yet: ``SimpleTexturedBuilder`` takes a texture atlas as the reference's
does, but raises on a ``map_Kd`` row instead of dropping the texture.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class ObjContext:
    """Parser context handed to builder callbacks."""
    group: Optional[str] = None
    material: Optional[str] = None
    material_library: Optional[str] = None


class ObjBuilder:
    """Callback protocol.  Subclass and override."""

    def include_group(self, context: ObjContext) -> bool:
        return True

    def load_materials(self, context: ObjContext):
        pass

    def build_vertex(self, context, x, y, z):
        return (x, y, z)

    def build_normal(self, context, x, y, z):
        return (x, y, z)

    def build_uv(self, context, u, v):
        return (u, v)

    def build_face(self, context, a, b, c):
        """a/b/c are (vertex, normal, uv) triples."""
        raise NotImplementedError


def load_obj(path, builder: ObjBuilder):
    """Stream an OBJ file through the builder; returns the face list.

    Unknown keywords are ignored, malformed v/vn/vt/f lines raise, faces
    use their first three vertices, indices are 1-based."""
    vertexes, normals, uvs, faces = [], [], [], []
    context = ObjContext()
    include_faces = builder.include_group(context)

    def read_corner(s):
        if "//" in s:
            vi, ni = (int(x) for x in s.split("/") if x)
            if not uvs:
                return None
            # The reference's quirk: v//n corners read uvs[0].
            return (vertexes[vi - 1], normals[ni - 1], uvs[0])
        parts = s.split("/")
        vi = int(parts[0])
        uvi = int(parts[1]) if len(parts) > 1 and parts[1] else None
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else None
        if uvi is None or ni is None:
            return None  # the reference zips all three; missing -> None
        return (vertexes[vi - 1], normals[ni - 1], uvs[uvi - 1])

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kw = parts[0]
            if kw == "v":
                try:
                    x, y, z = (float(p) for p in parts[1:4])
                except (ValueError, IndexError):
                    raise ValueError(f"unable to parse vertex: {line!r}")
                vertexes.append(builder.build_vertex(context, x, y, z))
            elif kw == "vn":
                try:
                    x, y, z = (float(p) for p in parts[1:4])
                except (ValueError, IndexError):
                    raise ValueError(f"unable to parse normal: {line!r}")
                normals.append(builder.build_normal(context, x, y, z))
            elif kw == "vt":
                try:
                    u, v = float(parts[1]), float(parts[2])
                except (ValueError, IndexError):
                    raise ValueError(
                        f"unable to parse texture coord: {line!r}")
                uvs.append(builder.build_uv(context, u, v))
            elif kw == "f":
                if not include_faces:
                    continue
                corners = [read_corner(s) for s in parts[1:4]]
                if any(c is None for c in corners) or len(corners) < 3:
                    raise ValueError(f"unable to parse face: {line!r}")
                faces.append(builder.build_face(context, *corners))
            elif kw in ("o", "g"):
                if len(parts) > 1:
                    context.group = parts[1]
                    include_faces = builder.include_group(context)
            elif kw == "usemtl":
                if len(parts) > 1:
                    context.material = parts[1]
            elif kw == "mtllib":
                lib = " ".join(parts[1:])
                context.material_library = os.path.join(
                    os.path.dirname(os.path.abspath(path)), lib)
                builder.load_materials(context)
    return faces


@dataclass
class FnObjBuilder(ObjBuilder):
    """Closure-based builder."""
    vertex_fn: Callable = lambda x, y, z: (x, y, z)
    normal_fn: Callable = lambda x, y, z: (x, y, z)
    uv_fn: Callable = lambda u, v: (u, v)
    face_fn: Callable = lambda a, b, c: (a, b, c)
    group_filter: Optional[Callable[[Optional[str]], bool]] = None

    def include_group(self, context):
        if self.group_filter is None:
            return True
        return self.group_filter(context.group)

    def build_vertex(self, context, x, y, z):
        return self.vertex_fn(x, y, z)

    def build_normal(self, context, x, y, z):
        return self.normal_fn(x, y, z)

    def build_uv(self, context, u, v):
        return self.uv_fn(u, v)

    def build_face(self, context, a, b, c):
        return self.face_fn(a, b, c)


class SimpleTexturedBuilder(ObjBuilder):
    """Collects corner tuples and a Lambertian material row per .mtl
    material; ``finish()`` assembles a host Triangles set.

    Args:
      materials: a MaterialBuilder (rows added per .mtl material).
      atlas: an AtlasBuilder for ``map_Kd`` textures, or None.  The port
        has no PNG reader yet, so a ``map_Kd`` row raises either way.
      filtered_groups: group names to exclude.
      wrap: the atlas wrap mode of ``map_Kd`` textures (None: REPEAT).
    """

    def __init__(self, materials, atlas=None, filtered_groups=(), wrap=None):
        from ..textures.atlas import REPEAT

        self.materials = materials
        self.atlas = atlas
        self.wrap = REPEAT if wrap is None else wrap
        self.filtered = set(filtered_groups)
        self._mtl_rows = {}     # material name -> row id
        self._faces = []        # (corner_a, corner_b, corner_c, row)

    def include_group(self, context):
        if context.group is None:
            return True
        return context.group not in self.filtered

    def load_materials(self, context):
        path = context.material_library
        try:
            self._parse_mtl(path)
        except OSError as e:
            print(f"unable to load material library: {e}")

    def _parse_mtl(self, path):
        """newmtl/Kd rows; map_Kd raises (no PNG reader)."""
        current = None
        diffuse = {}
        with open(path, "r", errors="replace") as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                if parts[0] == "newmtl" and len(parts) > 1:
                    current = parts[1]
                elif parts[0] == "Kd" and current is not None:
                    try:
                        diffuse[current] = tuple(
                            float(p) for p in parts[1:4])
                    except ValueError:
                        pass
                elif parts[0] == "map_Kd" and current and len(parts) > 1:
                    raise NotImplementedError(
                        f"{path}: material {current!r} has a map_Kd "
                        f"texture; mrt_torch has no PNG reader yet")
        for name, kd in diffuse.items():
            if name not in self._mtl_rows:
                self._mtl_rows[name] = self.materials.lambertian(
                    tuple(kd) + (1.0,))

    def build_uv(self, context, u, v):
        return (u, 1.0 - v)  # the reference's V flip

    def build_face(self, context, a, b, c):
        row = self._mtl_rows.get(context.material)
        if row is None:
            raise ValueError("No material found for face")
        self._faces.append((a, b, c, row))
        return len(self._faces) - 1

    def finish(self):
        """Assemble a host Triangles set from the collected faces."""
        from ..geometry.triangles import Triangles

        if not self._faces:
            raise ValueError("no faces loaded")
        corner = lambda k, j: np.array([f[k][j] for f in self._faces],
                                       np.float32)
        mat = np.array([f[3] for f in self._faces], np.int32)
        return Triangles.from_soup(
            corner(0, 0), corner(1, 0), corner(2, 0),
            normals=(corner(0, 1), corner(1, 1), corner(2, 1)),
            uvs=(corner(0, 2), corner(1, 2), corner(2, 2)), material=mat)
