"""Cornell box (mirrors ``mrt.scenes.cornell``; the same arrays).

Five 10x10x10 cube walls (red left, green right, white top/back/floor),
a squashed-cube area light at the ceiling, a rotated white box and a
dielectric (ior 1.3) sphere, under a black background; camera 37 deg
from (0, 5, 20).
"""

from __future__ import annotations

from . import register
from ..core.camera import Camera
from ..core.device import resolve
from ..geometry.scene import SceneBuilder
from ..geometry.shapes import cube
from ..materials.background import SolidBackground
from ..materials.table import MaterialBuilder


@register("cornell")
class CornellBox:
    def __init__(self, aspect_ratio=16.0 / 9.0):
        self.aspect_ratio = aspect_ratio

    def generate(self, t=0.0, frame=0, input=None, device=None):
        device = resolve(device)
        mat = MaterialBuilder()
        red = mat.lambertian((1.0, 0.0, 0.0))
        green = mat.lambertian((0.0, 1.0, 0.0))
        white = mat.lambertian((1.0, 1.0, 1.0))
        light = mat.diffuse_light((8.0, 8.0, 8.0))
        glass = mat.dielectric(1.3)

        sb = SceneBuilder(mat, SolidBackground.create((0, 0, 0)))
        # The reference's cube.ply spans [-1, 1]^3: cube(size=2).
        mesh = sb.add_mesh(cube(size=2.0))

        sb.add_instance(mesh, (-10.0, 5.0, 0.0), scale=5.0, material=red)
        sb.add_instance(mesh, (10.0, 5.0, 0.0), scale=5.0, material=green)
        sb.add_instance(mesh, (0.0, 15.0, 0.0), scale=5.0, material=white)
        sb.add_instance(mesh, (0.0, 5.0, -10.0), scale=5.0, material=white)
        sb.add_instance(mesh, (0.0, -5.0, 0.0), scale=5.0, material=white)

        sb.add_sphere((1.75, 2.0, 2.25), 2.0, glass)

        sb.add_instance(mesh, (0.0, 10.0 - 0.00011, 0.0),
                        scale=(1.0, 0.0001, 1.0), material=light)
        sb.add_instance(mesh, (-2.0, 3.0, -1.0), rotation=(0.0, -0.05, 0.0),
                        scale=(1.75, 3.1, 1.75), material=white)

        camera = Camera.create(
            37.0, (0.0, 5.0, 20.0), (0.0, 5.0, 0.0), (0.0, 1.0, 0.0),
            self.aspect_ratio, aperture=0.0, focus_distance=20.0)
        return sb.build(device), camera.to(device)
