"""EVE ship assets and the fleet scene (mirrors ``mrt.scenes.eve``).

  - ``EVE_KEEP_GROUPS``: the OBJ groups the reference's filter keeps;
  - ``PALETTES``: the faction palettes test/caldari/ore/soe;
  - ``HULLS``: ten hulls, each an OBJ and three packed textures;
  - ``load_ship``: a hull's mesh with the packed-PBR EVE material;
  - ``Eve``: the fleet scene (wormhole environment, a fog volume around
    the flagship, a sun, a 6x6 instanced fleet, a defocus camera).

The CCP game assets are not in the repository: when a hull's files are
absent, a procedural stand-in ship and synthetic packed textures take
their place (the same draws as the JAX package, seeded by a CRC of the
hull's name).  Loading the real hulls needs a PNG reader, which the
port does not have yet (``AtlasBuilder.add_png`` raises).
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np

from . import register
from ..core.camera import Camera
from ..core.device import resolve
from ..geometry.scene import SceneBuilder, with_atlas
from ..geometry.shapes import cube, sphere_mesh
from ..geometry.triangles import Triangles, concatenate
from ..materials.table import MaterialBuilder
from ..runtime import assets
from ..textures.atlas import REPEAT, AtlasBuilder
from .envmaps import environment

EVE_KEEP_GROUPS = ("Hull", "hull", "Glass", "glass", "DarkHull",
                   "exhaust", "Exhaust")

GLOW = (0.5, 0.85, 2.0)

PALETTES = {
    "test": [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
             (1.0, 0.0, 1.0)],
    "caldari": [(0.02, 0.02, 0.02), (0.1, 0.1, 0.1), (0.03, 0.05, 0.1),
                (0.08, 0.08, 0.08)],
    "ore": [(0.02, 0.02, 0.02), (0.1, 0.1, 0.1), (0.15, 0.26, 0.39),
            (0.85, 0.62, 0.2)],
    "soe": [(0.02, 0.02, 0.02), (0.2, 0.2, 0.2), (1.0, 1.0, 1.0),
            (0.5, 0.0, 0.0)],
}

# name -> (asset dir, texture prefix, obj filename, palette)
HULLS = {
    "venture": ("models/oref1_t1", "oref1_t1", "OreF1_TShape1.obj", "ore"),
    "raven": ("models/cb1_t1", "cb1_t1", "CB1_TShape1.obj", "caldari"),
    "avatar": ("models/at1_t1", "at1_t1", "AT1_TShape1.obj", "ore"),
    "buzzard": ("models/cf3_t2", "cf3_t2", "CF3_TShape2.obj", "caldari"),
    "rifter": ("models/mf4_t1", "mf4_t1", "MF4_TShape1.obj", "ore"),
    "astero": ("models/soef1_t1", "soef1_t1", "SoEF1_TShape1.obj", "soe"),
    "stratios": ("models/soec1_t1", "soec1_t1", "SoEC1_TShape1.obj",
                 "soe"),
    "nestor": ("models/soeb1_t1", "soeb1_t1", "SoEB1_TShape2.obj", "soe"),
    "orca": ("models/orefr1_t1", "orefr1_t1", "OreFr1_TShape1.obj",
             "ore"),
    "crow": ("models/cf2_t2a", "cf2_t2a", "CF2_T2aShape.obj", "ore"),
}

# The raven's navy pmdg variant.
_PMDG_SUFFIX = {"raven": "_navy_pmdg"}


def eve_group_filter(group):
    """The keep-list of OBJ groups."""
    return group is not None and group in EVE_KEEP_GROUPS


def _synth_packed_textures(atlas: AtlasBuilder, rng, size=64):
    """Synthetic no/ar/pmdg texture triple; returns their atlas ids."""
    # normal+occlusion: G/A hold tangent XY (centred), B = occlusion.
    no = np.full((size, size, 4), 0.5, np.float32)
    no[..., 1] = 0.5 + 0.2 * (rng.random((size, size)) - 0.5)
    no[..., 3] = 0.5 + 0.2 * (rng.random((size, size)) - 0.5)
    no[..., 2] = 0.8 + 0.2 * rng.random((size, size))
    # albedo+roughness: grey hull plates, varying roughness.
    ar = np.zeros((size, size, 4), np.float32)
    plate = 0.35 + 0.3 * rng.random((size // 8, size // 8))
    ar[..., :3] = np.kron(plate, np.ones((8, 8)))[..., None]
    ar[..., 3] = np.kron(rng.random((size // 8, size // 8)),
                         np.ones((8, 8)))
    # paint / material / dirt / glow masks.
    pmdg = np.zeros((size, size, 4), np.float32)
    pmdg[..., 0] = (rng.random((size, size)) > 0.7)
    pmdg[..., 1] = rng.random((size, size))
    pmdg[..., 2] = 0.2 * rng.random((size, size))
    glow = np.zeros((size, size))
    glow[size // 2 - 2:size // 2 + 2, ::8] = 1.0              # windows
    pmdg[..., 3] = glow
    return (atlas.add_raw(no, wrap=REPEAT),
            atlas.add_raw(ar, wrap=REPEAT),
            atlas.add_raw(pmdg, wrap=REPEAT))


def _standin_ship(material):
    """A procedural winged hull with UVs and smooth normals (host
    NumPy): a stretched sphere mesh, a wing slab and a tail fin."""
    body = sphere_mesh((0, 0, 0), 1.0, lat=6, lon=10, material=material)
    stretch = np.asarray([[3.0, 0.6, 1.0]], np.float32)
    body = dataclasses.replace(body, va=body.va * stretch,
                               e_ab=body.e_ab * stretch,
                               e_ac=body.e_ac * stretch)
    wing = cube((0.0, 0.0, 0.0), (1.2, 0.1, 4.0), material=material)
    tail = cube((-2.2, 0.4, 0.0), (1.4, 0.8, 0.3), material=material)
    return concatenate([body, wing, tail])


def load_ship(sb: SceneBuilder, mats: MaterialBuilder, atlas: AtlasBuilder,
              hull: str, seed=0):
    """Register a hull's mesh; returns (mesh id, material row)."""
    asset_dir, prefix, obj_name, palette = HULLS[hull]
    pmdg_suffix = _PMDG_SUFFIX.get(hull, "_pmdg")
    asset_dir = assets.resolve(asset_dir)
    obj_path = os.path.join(asset_dir, obj_name)
    # A stable hash of the name (Python's hash() changes per process).
    rng = np.random.default_rng(seed + zlib.crc32(hull.encode()) % (1 << 16))

    if os.path.exists(obj_path):
        no = atlas.add_png(os.path.join(asset_dir, f"{prefix}_no.png"),
                           wrap=REPEAT)
        ar = atlas.add_png(os.path.join(asset_dir, f"{prefix}_ar.png"),
                           wrap=REPEAT)
        pmdg = atlas.add_png(
            os.path.join(asset_dir, f"{prefix}{pmdg_suffix}.png"),
            wrap=REPEAT)
        row = mats.eve(ar, no, pmdg, PALETTES[palette], glow=GLOW)

        from ..loaders import FnObjBuilder, load_obj
        corners = []
        load_obj(obj_path, FnObjBuilder(
            uv_fn=lambda u, v: (u, v),
            face_fn=lambda a, b, c: corners.append((a, b, c)),
            group_filter=eve_group_filter))
        corner = lambda i, k: np.array([f[i][k] for f in corners], np.float32)
        tris = Triangles.from_soup(
            corner(0, 0), corner(1, 0), corner(2, 0),
            normals=tuple(corner(i, 1) for i in range(3)),
            uvs=tuple(corner(i, 2) for i in range(3)), material=row)
    else:
        no, ar, pmdg = _synth_packed_textures(atlas, rng)
        row = mats.eve(ar, no, pmdg, PALETTES[palette], glow=GLOW)
        tris = _standin_ship(row)

    return sb.add_mesh(tris), row


@register("eve")
class Eve:
    """The fleet scene."""

    def __init__(self, aspect_ratio=16.0 / 9.0, seed=1):
        self.aspect_ratio = aspect_ratio
        self.seed = seed

    def generate(self, t=0.0, frame=0, input=None, device=None):
        device = resolve(device)
        rng = np.random.default_rng(self.seed)
        mats = MaterialBuilder()
        atlas = AtlasBuilder()
        background = environment(atlas, "wormhole_class_05",
                                 rotation=(0.0, 0.0, 0.0))

        sb = SceneBuilder(mats, background)
        flagship_mesh, _ = load_ship(sb, mats, atlas, "nestor",
                                     seed=self.seed)
        fighter_mesh, _ = load_ship(sb, mats, atlas, "stratios",
                                    seed=self.seed + 1)

        orca_pos = (-1250.0, 5.0, 0.0)
        # The flagship scaled up so the stand-in reads as capital-class.
        sb.add_instance(flagship_mesh, orca_pos,
                        rotation=tuple((rng.random(3) - 0.5) / 60.0),
                        scale=120.0)
        sb.add_volume_sphere(orca_pos, 1700.0, 0.0006, (0.4, 0.4, 0.4))

        sun = mats.diffuse_light((40.0, 40.0, 50.0))
        sb.add_sphere((10000.0, -4000.0, 4800.0), 1500.0, sun)

        look_from = np.array([0.0, -20.0, 500.0])
        rotation = np.array([-0.03, 0.0, 0.0])
        for x in range(6):
            for z in range(6):
                pos = np.array([(x - 3.0) * 190.0,
                                (rng.random() * 2.0 - 1.0) * 150.0,
                                (z - 3.0) * 190.0])
                if np.linalg.norm(pos - look_from) > 50.0:
                    sb.add_instance(
                        fighter_mesh, tuple(pos),
                        rotation=tuple(rotation
                                       + (rng.random(3) - 0.5) / 30.5),
                        scale=0.2 * 100.0)  # the stand-in spans ~6 units

        # The atlas last: load_ship added the ships' textures.
        scene = with_atlas(sb.build(device), atlas.build())
        camera = Camera.create(
            50.0, tuple(look_from), orca_pos, (0.0, 1.0, 0.0),
            self.aspect_ratio, aperture=0.2,
            focus_distance=float(np.linalg.norm(look_from
                                                - np.asarray(orca_pos))))
        return scene, camera.to(device)
