"""Menger sponge (mirrors ``mrt.scenes.menger``).

20^level cubes in the Menger corner/edge pattern, a vast fuzzy-metal
floor and the star+nebula environment cube map; camera 15 deg from
(2680, 140, 2000).  The sponge renders through one of two equal
surfaces:
  - voxel=True (the default): one procedural voxel grid of 3^level cells
    a side under the Menger digit rule, walked by the hierarchical DDA
    (``geometry/voxels.py``);
  - voxel=False: instanced triangle meshes, `bake` levels fused into one
    greedy-meshed block and the remaining `level - bake` levels
    instanced (bake=0: one cube a cell, as the reference).
"""

from __future__ import annotations

import numpy as np

from . import register
from ..core.camera import Camera
from ..core.device import resolve
from ..geometry.scene import SceneBuilder
from ..geometry.shapes import cube
from ..geometry.triangles import Triangles
from ..materials.table import MaterialBuilder
from ..textures.atlas import AtlasBuilder
from .envmaps import environment

# The 20 of 27 sub-cells the sponge keeps.
_SIDES = [(0, 1, 1), (1, 0, 1), (1, 1, 0), (0, -1, -1), (-1, 0, -1),
          (-1, -1, 0), (0, -1, 1), (-1, 0, 1), (-1, 1, 0), (0, 1, -1),
          (1, 0, -1), (1, -1, 0), (-1, -1, 1), (-1, 1, -1), (1, -1, -1),
          (-1, 1, 1), (1, -1, 1), (1, 1, -1), (1, 1, 1), (-1, -1, -1)]


def sponge_positions(level, dims=2.0):
    """All cube centres of a level-n sponge."""
    sides = np.asarray(_SIDES, np.float64)
    pos = np.zeros((1, 3))
    for lv in range(level - 1, -1, -1):
        step = dims * (3.0 ** lv)
        pos = (pos[:, None, :] + sides[None, :, :] * step).reshape(-1, 3)
    return pos.astype(np.float32)


def sponge_occupancy(level):
    """(n, n, n) bool occupancy of a level-n sponge block, n = 3^level: a
    cell is solid unless at some base-3 digit two or more of its three
    coordinates have the digit 1."""
    n = 3 ** level
    idx = np.arange(n)
    solid = np.ones((n, n, n), bool)
    for lv in range(level):
        one = ((idx // 3 ** lv) % 3 == 1).astype(np.int8)
        solid &= ~((one[:, None, None] + one[None, :, None]
                    + one[None, None, :]) >= 2)
    return solid


def _greedy_rects(mask):
    """Greedy maximal-rectangle cover of a 2D bool mask: (i0, j0, h, w)
    tuples, scanning rows and extending each run right, then down."""
    m = mask.copy()
    out = []
    height, width = m.shape
    for i in range(height):
        j = 0
        row = m[i]
        while j < width:
            if not row[j]:
                j += 1
                continue
            w = 1
            while j + w < width and row[j + w]:
                w += 1
            h = 1
            while i + h < height and m[i + h, j:j + w].all():
                h += 1
            m[i:i + h, j:j + w] = False
            out.append((i, j, h, w))
            j += w
    return out


def sponge_block_mesh(bake, dims=2.0, material=0):
    """A level-`bake` sponge block as one greedy-meshed surface: faces
    between touching cubes culled, coplanar exposed faces merged into
    maximal rectangles; flat normals, no UVs."""
    occ = sponge_occupancy(bake)
    n = occ.shape[0]
    lo = -n * dims / 2.0
    va, vb, vc = [], [], []
    for axis in range(3):
        occ_a = np.moveaxis(occ, axis, 0)          # (slice, u, v)
        pad = np.zeros((n + 2, n, n), bool)
        pad[1:-1] = occ_a
        for sign, exposed in ((-1.0, occ_a & ~pad[:-2]),
                              (1.0, occ_a & ~pad[2:])):
            for sl in range(n):
                plane = lo + (sl + (sign > 0)) * dims
                for (i0, j0, h, w) in _greedy_rects(exposed[sl]):
                    u0, u1 = lo + i0 * dims, lo + (i0 + h) * dims
                    v0, v1 = lo + j0 * dims, lo + (j0 + w) * dims
                    corner = np.zeros((4, 3), np.float32)
                    corner[:, axis] = plane
                    corner[:, (axis + 1) % 3] = (u0, u1, u1, u0)
                    corner[:, (axis + 2) % 3] = (v0, v0, v1, v1)
                    # Wind so that the flat normal points out.
                    a, b, c, d = (corner if sign > 0
                                  else corner[[0, 3, 2, 1]])
                    va += [a, a]
                    vb += [b, c]
                    vc += [c, d]
    return Triangles.from_soup(np.stack(va), np.stack(vb), np.stack(vc),
                               material=material)


@register("menger")
class Menger:
    def __init__(self, aspect_ratio=16.0 / 9.0, level=5, bake=2,
                 voxel=True):
        self.aspect_ratio = aspect_ratio
        self.level = level
        self.bake = min(bake, level)
        self.voxel = voxel

    def generate(self, t=0.0, frame=0, input=None, device=None):
        device = resolve(device)
        mat = MaterialBuilder()
        atlas = AtlasBuilder()
        white = mat.lambertian((1.0, 1.0, 1.0))
        foggy = mat.metal(0.7, (0.5, 0.5, 0.5))

        background = environment(atlas, "j02", rotation=(0.4, 0.2, 0.1))
        sb = SceneBuilder(mat, background, atlas=atlas.build())
        if self.voxel:
            half = 2.0 * 3.0 ** self.level / 2.0
            sb.add_voxel_grid(origin=(-half, -half, -half), cell=2.0,
                              levels=self.level, material=white)
        elif self.bake > 0:
            block = sb.add_mesh(sponge_block_mesh(self.bake, dims=2.0))
            for p in sponge_positions(self.level - self.bake,
                                      dims=2.0 * 3.0 ** self.bake):
                sb.add_instance(block, tuple(p), material=white)
        mesh = sb.add_mesh(cube(size=2.0))
        if not self.voxel and self.bake == 0:
            for p in sponge_positions(self.level):
                sb.add_instance(mesh, tuple(p), material=white)
        sb.add_instance(mesh, (0.0, -244.0, 0.0),
                        scale=(500000.0, 1.0, 500000.0), material=foggy)

        look_from = (2680.0, 140.0, 2000.0)
        camera = Camera.create(
            15.0, look_from, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
            self.aspect_ratio, aperture=0.0,
            focus_distance=float(np.linalg.norm(look_from)))
        return sb.build(device), camera.to(device)
