"""Procedural mesh builders (host-side).

The reference ships a `cube.ply` asset and instances it into walls,
boxes and sponge cells (reference: scenes/cornell.rs:20-100,
scenes/menger.rs:68-124); these builders generate the same primitive
meshes procedurally so scenes carry no file dependencies.
"""

from __future__ import annotations

import numpy as np

from .triangles import Triangles


def quad(origin, edge_u, edge_v, material=0):
    """Two-triangle quad: origin, origin+edge_u, origin+edge_u+edge_v,
    origin+edge_v, with UVs spanning [0,1]^2."""
    o = np.asarray(origin, np.float32)
    eu = np.asarray(edge_u, np.float32)
    ev = np.asarray(edge_v, np.float32)
    verts = np.stack([o, o + eu, o + eu + ev, o + ev])
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    return Triangles.build(verts, faces, uvs=uvs, material=material)


def cube(center=(0, 0, 0), size=1.0, material=0):
    """Axis-aligned cube, 12 triangles, outward flat normals, per-face
    UVs spanning [0,1]^2."""
    c = np.asarray(center, np.float32)
    h = np.broadcast_to(np.asarray(size, np.float32), (3,)) / 2.0

    va, vb, vc = [], [], []
    uva, uvb, uvc = [], [], []
    # (axis, sign): +x,-x,+y,-y,+z,-z faces
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            face_c = c + n * h
            p00 = face_c - u * h - v * h
            p10 = face_c + u * h - v * h
            p11 = face_c + u * h + v * h
            p01 = face_c - u * h + v * h
            # Wind so the flat normal points outward (along n).
            for (a, b, d, ua, ub, ud) in (
                    (p00, p10, p11, (0, 0), (1, 0), (1, 1)),
                    (p00, p11, p01, (0, 0), (1, 1), (0, 1))):
                cross = np.cross(b - a, d - a)
                if np.dot(cross, n) < 0:
                    a, b, d = a, d, b
                    ua, ub, ud = ua, ud, ub
                va.append(a), vb.append(b), vc.append(d)
                uva.append(ua), uvb.append(ub), uvc.append(ud)

    return Triangles.from_soup(
        np.stack(va), np.stack(vb), np.stack(vc),
        uvs=(np.array(uva, np.float32), np.array(uvb, np.float32),
             np.array(uvc, np.float32)),
        material=material)


def sphere_mesh(center=(0, 0, 0), radius=1.0, lat=16, lon=32, material=0):
    """UV-sphere mesh with smooth normals (for mesh-pipeline tests)."""
    c = np.asarray(center, np.float32)
    ring_t = np.linspace(0, np.pi, lat + 1)
    ring_p = np.linspace(0, 2 * np.pi, lon + 1)
    t, p = np.meshgrid(ring_t, ring_p, indexing="ij")
    x = np.sin(t) * np.cos(p)
    y = np.cos(t)
    z = np.sin(t) * np.sin(p)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    normals = verts.copy()
    uvs = np.stack([p / (2 * np.pi), t / np.pi], axis=-1).reshape(-1, 2)
    verts = verts * radius + c

    faces = []
    stride = lon + 1
    for i in range(lat):
        for j in range(lon):
            a = i * stride + j
            b = a + 1
            d = a + stride
            e = d + 1
            if i > 0:
                faces.append([a, b, d])
            if i < lat - 1:
                faces.append([b, e, d])
    return Triangles.build(verts, np.array(faces), normals=normals,
                           uvs=uvs, material=material)
