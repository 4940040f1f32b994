"""The "Ray Tracing in One Weekend" final scene (mirrors
``mrt.scenes.rtiow``; the same seed builds byte-identical arrays).

A ground sphere, a jittered grid of random diffuse/metal/glass spheres
and three feature spheres under the sky gradient.  ``generate`` builds
on the host and returns the scene and camera on ``device`` (None: the
CUDA card).
"""

from __future__ import annotations

import numpy as np

from . import register
from ..core.camera import Camera
from ..core.device import resolve
from ..geometry.scene import Scene
from ..geometry.spheres import Spheres
from ..materials.background import SkyBackground
from ..materials.table import MaterialBuilder


@register("rtiow")
class RtiowFinal:
    """Deterministic (seeded) RTIOW final scene."""

    def __init__(self, aspect_ratio=16.0 / 9.0, seed=1, grid=11):
        self.aspect_ratio = aspect_ratio
        self.seed = seed
        self.grid = grid  # half-extent: spheres span [-grid, grid)^2

    def generate(self, t=0.0, frame=0, input=None, device=None):
        device = resolve(device)
        rng = np.random.default_rng(self.seed)
        mat = MaterialBuilder()
        centers, radii, mats = [], [], []

        def add(center, radius, mid):
            centers.append(center)
            radii.append(radius)
            mats.append(mid)

        add((0.0, -1000.0, 0.0), 1000.0, mat.lambertian((0.5, 0.5, 0.5)))

        g = self.grid
        for a in range(-g, g):
            for b in range(-g, g):
                center = (a + 0.9 * rng.random(), 0.2,
                          b + 0.9 * rng.random())
                if np.linalg.norm(np.subtract(center, (4, 0.2, 0))) <= 0.9:
                    continue
                choose = rng.random()
                if choose < 0.8:
                    albedo = rng.random(3) * rng.random(3)
                    add(center, 0.2, mat.lambertian(tuple(albedo)))
                elif choose < 0.95:
                    albedo = 0.5 + 0.5 * rng.random(3)
                    fuzz = 0.5 * rng.random()
                    add(center, 0.2, mat.metal(fuzz, tuple(albedo)))
                else:
                    add(center, 0.2, mat.dielectric(1.5))

        add((0.0, 1.0, 0.0), 1.0, mat.dielectric(1.5))
        add((-4.0, 1.0, 0.0), 1.0, mat.lambertian((0.4, 0.2, 0.1)))
        add((4.0, 1.0, 0.0), 1.0, mat.metal(0.0, (0.7, 0.6, 0.5)))

        scene = Scene(
            materials=mat.build(),
            background=SkyBackground.create(),
            has_mix=False,
            spheres=Spheres(
                center=np.array(centers, np.float32),
                radius=np.array(radii, np.float32),
                material=np.array(mats, np.int32),
            ),
        )
        camera = Camera.create(
            vertical_fov_deg=20.0,
            look_from=(13.0, 2.0, 3.0),
            look_at=(0.0, 0.0, 0.0),
            view_up=(0.0, 1.0, 0.0),
            aspect_ratio=self.aspect_ratio,
            aperture=0.1,
            focus_distance=10.0,
        )
        return scene.to(device), camera.to(device)
