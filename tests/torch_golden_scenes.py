"""The port's builds of the golden scenes of tests/golden_scenes.py that
the texture slice reaches (textured, eve_ball, volume, menger2) and the
lights and voxels slice (cornell_nee, menger2_voxel): the same builder
calls, through mrt_torch, so the port renders them from its own
factories.  Imports no JAX."""

import numpy as np

from mrt_torch.core.camera import Camera
from mrt_torch.geometry.scene import SceneBuilder, attach_lights
from mrt_torch.geometry.shapes import cube, quad, sphere_mesh
from mrt_torch.materials.background import SkyBackground, SolidBackground
from mrt_torch.materials.table import MaterialBuilder
from mrt_torch.scenes import get
from mrt_torch.scenes.eve import GLOW, PALETTES, _synth_packed_textures
from mrt_torch.textures.atlas import REPEAT, AtlasBuilder

NAMES = ("textured", "eve_ball", "volume", "menger2", "cornell_nee",
         "menger2_voxel")


def textured(device):
    mat = MaterialBuilder()
    atlas = AtlasBuilder()
    # A checkerboard with an alpha hole: bilinear and the alpha re-cast.
    tex = np.zeros((16, 16, 4), np.float32)
    yy, xx = np.mgrid[0:16, 0:16]
    checker = ((yy // 4 + xx // 4) % 2).astype(np.float32)
    tex[..., 0] = 0.2 + 0.7 * checker
    tex[..., 1] = 0.5
    tex[..., 2] = 0.9 - 0.7 * checker
    tex[..., 3] = 1.0
    tex[4:8, 4:8, 3] = 0.0
    tid = atlas.add_raw(tex, wrap=REPEAT)
    textured_row = mat.lambertian(tex=tid)
    back = mat.lambertian((0.9, 0.6, 0.3))
    sb = SceneBuilder(mat, SkyBackground.create())
    sb.add_triangles(quad((-1.5, -1.5, -2.0), (3, 0, 0), (0, 3, 0),
                          material=textured_row))
    sb.add_triangles(quad((-3, -3, -4.0), (6, 0, 0), (0, 6, 0),
                          material=back))
    scene = sb.build(device)
    # As the reference's golden: the atlas attached after the build, the
    # alpha rounds switched on, mat_tex_raw left False.
    scene.atlas = atlas.build().to(device)
    scene.needs_alpha = True
    camera = Camera.create(60.0, (0, 0, 2.5), (0, 0, -2), (0, 1, 0), 1.0,
                           focus_distance=4.5)
    return scene, camera.to(device)


def eve_ball(device):
    mat = MaterialBuilder()
    atlas = AtlasBuilder()
    no, ar, pmdg = _synth_packed_textures(atlas, np.random.default_rng(7))
    row = mat.eve(ar, no, pmdg, PALETTES["caldari"], glow=GLOW)
    sun = mat.diffuse_light((30.0, 30.0, 33.0))
    sb = SceneBuilder(mat, SolidBackground.create((0.01, 0.01, 0.02)))
    sb.add_model(sphere_mesh((0, 0, 0), 1.0, lat=12, lon=20, material=row))
    sb.add_sphere((30.0, 20.0, 20.0), 8.0, sun)
    scene = sb.build(device)
    scene.atlas = atlas.build().to(device)
    camera = Camera.create(45.0, (0, 0.6, 3), (0, 0, 0), (0, 1, 0), 1.0,
                           focus_distance=3.0)
    return scene, camera.to(device)


def volume(device):
    mat = MaterialBuilder()
    light = mat.diffuse_light((18.0, 16.0, 14.0))
    sb = SceneBuilder(mat, SolidBackground.create((0, 0, 0)))
    sb.add_volume_sphere((0.0, 0.0, 0.0), 1.2, 1.2, (0.7, 0.7, 0.75))
    sb.add_volume_mesh(cube(size=2.0), 2.0, (0.8, 0.5, 0.4),
                       translation=(2.2, 0.0, 0.0))
    sb.add_sphere((0.0, 4.0, 2.0), 1.0, light)
    camera = Camera.create(55.0, (1, 0.5, 5), (1, 0, 0), (0, 1, 0), 1.0,
                           focus_distance=5.0)
    return sb.build(device), camera.to(device)


def menger2(device):
    return get("menger")(aspect_ratio=1.0, level=2, bake=1,
                         voxel=False).generate(device=device)


def cornell_nee(device):
    scene, camera = get("cornell")(aspect_ratio=1.0).generate(device=device)
    return attach_lights(scene), camera


def menger2_voxel(device):
    return get("menger")(aspect_ratio=1.0, level=2).generate(device=device)


FACTORIES = dict(textured=textured, eve_ball=eve_ball, volume=volume,
                 menger2=menger2, cornell_nee=cornell_nee,
                 menger2_voxel=menger2_voxel)
