"""Binary STL loader, on the host (mirrors ``mrt.loaders.stl``).

An 80-byte header, a u32 triangle count, then per triangle a normal
(3 x f32, skipped), 9 vertex floats and a u16 attribute (skipped).
"""

from __future__ import annotations

import numpy as np


def load_stl_binary(path, vertex_fn=None, face_fn=None):
    """Returns (vertices (3T, 3) float32, faces (T, 3) int64); streams
    them through the callbacks too, if given."""
    with open(path, "rb") as f:
        f.read(80)  # header
        (count,) = np.frombuffer(f.read(4), "<u4")
        raw = np.frombuffer(f.read(int(count) * 50), np.uint8)
        if raw.size != count * 50:
            raise ValueError("truncated STL body")
    rec = raw.reshape(int(count), 50)
    # 12 bytes normal skipped, 36 bytes vertices, 2 bytes attribute.
    verts = rec[:, 12:48].copy().view("<f4").reshape(int(count), 3, 3)
    vertices = verts.reshape(-1, 3).astype(np.float32)
    faces = np.arange(int(count) * 3, dtype=np.int64).reshape(-1, 3)
    if vertex_fn is not None:
        for v in vertices:
            vertex_fn(float(v[0]), float(v[1]), float(v[2]))
    if face_fn is not None:
        for a, b, c in faces:
            face_fn(int(a), int(b), int(c))
    return vertices, faces
