"""Hex-packed sphere grid (mirrors ``mrt.scenes.sphere_grid``; the same
arrays).  The default ``dim=50`` is the reference's 100x100 grid:
10,000 spheres under a sphere BVH.

Center sphere emissive, its hex ring dielectric (ior 1.8), everything
else mirror metal with random colors; a white cube ground; black
background; camera 40 deg from (6, 8, 5).
"""

from __future__ import annotations

import numpy as np

from . import register
from ..core.camera import Camera
from ..core.device import resolve
from ..geometry.scene import SceneBuilder
from ..geometry.shapes import cube
from ..materials.background import SolidBackground
from ..materials.table import MaterialBuilder


@register("sphere_grid")
class SphereGrid:
    def __init__(self, aspect_ratio=16.0 / 9.0, dim=50, seed=1):
        self.aspect_ratio = aspect_ratio
        self.dim = dim
        self.seed = seed

    def generate(self, t=0.0, frame=0, input=None, device=None):
        device = resolve(device)
        rng = np.random.default_rng(self.seed)
        mat = MaterialBuilder()
        white = mat.lambertian((1.0, 1.0, 1.0))
        light = mat.diffuse_light((3.0, 3.0, 3.0))
        glass = mat.dielectric(1.8)

        sb = SceneBuilder(mat, SolidBackground.create((0, 0, 0)))
        ground = sb.add_mesh(cube(size=2.0))
        sb.add_instance(ground, (0.0, -1000.0, 0.0), scale=1000.0,
                        material=white)

        # Hex packing: row pitch a = sqrt(3) r.
        r = 1.0
        d = 2.0 * r
        a = np.sqrt(d * d - r * r)
        ring = {(-1, 0), (1, 0), (1, -1), (0, -1), (1, 1), (0, 1)}
        for i in range(-self.dim, self.dim):
            for j in range(-self.dim, self.dim):
                off = r if j % 2 == 0 else 0.0
                center = (i * d + off, r, j * a)
                if (i, j) == (0, 0):
                    sb.add_sphere(center, r - 0.05, light)
                elif (i, j) in ring:
                    sb.add_sphere(center, r - 0.05, glass)
                else:
                    color = tuple(rng.random(3))
                    sb.add_sphere(center, r - 0.05, mat.metal(0.0, color))

        camera = Camera.create(
            40.0, (6.0, 8.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
            self.aspect_ratio, aperture=0.0,
            focus_distance=float(np.linalg.norm([6.0, 8.0, 5.0])))
        return sb.build(device), camera.to(device)
