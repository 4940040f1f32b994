"""PLY mesh loader, ascii and binary in both byte orders, on the host
(mirrors ``mrt.loaders.ply``).

The reference's header parser and element reader: format ascii /
binary_little_endian / binary_big_endian 1.0, any elements with scalar
properties of all 8 types and list properties, comments skipped,
unknown properties read and dropped.  Vertices (x, y, z) and triangular
``vertex_indices`` faces come back as arrays, and stream through
callbacks if given.

A NumPy fast path reads the common binary layout (fixed-stride
vertices; uchar count + int32 index faces), so scans of millions of
triangles load in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_SCALARS = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class _Property:
    name: str
    dtype: str                       # numpy dtype code
    list_count_dtype: Optional[str] = None  # set for list properties


@dataclass
class _Element:
    name: str
    count: int
    properties: List[_Property] = field(default_factory=list)


def _parse_header(f):
    """Returns (format, elements)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        parts = line.decode("ascii", "replace").split()
        if not parts:
            continue
        kw = parts[0]
        if kw == "comment":
            continue
        if kw == "format":
            if parts[2] != "1.0":
                raise ValueError(f"unsupported PLY version {parts[2]}")
            fmt = parts[1]
            if fmt not in ("ascii", "binary_little_endian",
                           "binary_big_endian"):
                raise ValueError(f"unsupported PLY format {fmt}")
        elif kw == "element":
            elements.append(_Element(parts[1], int(parts[2])))
        elif kw == "property":
            if not elements:
                raise ValueError("property before element")
            if parts[1] == "list":
                elements[-1].properties.append(_Property(
                    parts[4], _SCALARS[parts[3]],
                    list_count_dtype=_SCALARS[parts[2]]))
            else:
                elements[-1].properties.append(
                    _Property(parts[2], _SCALARS[parts[1]]))
        elif kw == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return fmt, elements


def load_ply(path, vertex_fn=None, face_fn=None):
    """Read vertices and triangular faces; stream them through the
    callbacks too, if given.

    Returns (vertices (V,3) float32, faces (F,3) int64) of whatever was
    parsed (also passed through the callbacks if given).
    """
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = ">" if fmt == "binary_big_endian" else "<"

        vertices = None
        faces = []

        for elem in elements:
            is_vertex = elem.name == "vertex"
            is_face = elem.name == "face"

            if fmt == "ascii":
                rows = []
                for _ in range(elem.count):
                    tokens = f.readline().split()
                    vals, ti = [], 0
                    for prop in elem.properties:
                        if prop.list_count_dtype is not None:
                            cnt = int(tokens[ti]); ti += 1
                            items = [float(tokens[ti + j])
                                     for j in range(cnt)]
                            ti += cnt
                            vals.append(items)
                        else:
                            vals.append(float(tokens[ti])); ti += 1
                    rows.append(vals)
                if is_vertex:
                    names = [p.name for p in elem.properties]
                    ix, iy, iz = (names.index(c) for c in "xyz")
                    vertices = np.array(
                        [[r[ix], r[iy], r[iz]] for r in rows], np.float32)
                elif is_face:
                    li = next(i for i, p in enumerate(elem.properties)
                              if p.list_count_dtype is not None)
                    for r in rows:
                        idx = [int(v) for v in r[li]]
                        if len(idx) == 3:
                            faces.append(idx)
                continue

            # Binary: numpy fast path when all properties are scalars.
            if all(p.list_count_dtype is None for p in elem.properties):
                dt = np.dtype([(p.name, endian + p.dtype)
                               for p in elem.properties])
                buf = f.read(dt.itemsize * elem.count)
                arr = np.frombuffer(buf, dtype=dt, count=elem.count)
                if is_vertex:
                    vertices = np.stack(
                        [arr["x"], arr["y"], arr["z"]],
                        axis=-1).astype(np.float32)
                continue

            # Binary list properties: uniform-arity fast path for the
            # canonical face layout, else per-row loop.
            if (is_face and len(elem.properties) == 1
                    and elem.properties[0].list_count_dtype is not None):
                prop = elem.properties[0]
                cdt = np.dtype(endian + prop.list_count_dtype)
                idt = np.dtype(endian + prop.dtype)
                pos = f.tell()
                first_cnt = int(np.frombuffer(
                    f.read(cdt.itemsize), cdt)[0])
                f.seek(pos)
                stride = cdt.itemsize + first_cnt * idt.itemsize
                buf = f.read(stride * elem.count)
                if len(buf) == stride * elem.count and first_cnt == 3:
                    raw = np.frombuffer(buf, np.uint8).reshape(
                        elem.count, stride)
                    counts = raw[:, :cdt.itemsize].copy().view(cdt)[:, 0]
                    if np.all(counts == 3):  # uniform triangles
                        idx = raw[:, cdt.itemsize:].copy().view(idt)
                        faces = idx.reshape(elem.count, 3).astype(
                            np.int64)
                        continue
                # Non-uniform: reparse row by row.
                mv = memoryview(buf)
                off = 0
                faces = []
                for _ in range(elem.count):
                    cnt = int(np.frombuffer(
                        mv[off:off + cdt.itemsize], cdt)[0])
                    off += cdt.itemsize
                    idx = np.frombuffer(
                        mv[off:off + cnt * idt.itemsize], idt)
                    off += cnt * idt.itemsize
                    if cnt == 3:
                        faces.append(idx.astype(np.int64))
                continue

            # General mixed scalar+list element: slow per-row parse.
            for _ in range(elem.count):
                for prop in elem.properties:
                    if prop.list_count_dtype is None:
                        f.read(np.dtype(prop.dtype).itemsize)
                    else:
                        cdt = np.dtype(endian + prop.list_count_dtype)
                        cnt = int(np.frombuffer(
                            f.read(cdt.itemsize), cdt)[0])
                        f.read(cnt * np.dtype(prop.dtype).itemsize)

        faces = (np.asarray(faces, np.int64) if len(faces)
                 else np.zeros((0, 3), np.int64))
        if vertices is None:
            vertices = np.zeros((0, 3), np.float32)
        if vertex_fn is not None:
            for v in vertices:
                vertex_fn(float(v[0]), float(v[1]), float(v[2]))
        if face_fn is not None:
            for a, b, c in faces:
                face_fn(int(a), int(b), int(c))
        return vertices, faces
