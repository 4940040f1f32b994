"""Interactive dynamic scene (mirrors ``mrt.scenes.playground``; the
same arrays for the same frame and input).

A level mesh loaded from ``assets/level/playground_level.obj`` through
the OBJ loader with its .mtl materials, used both for rendering and as
the collision soup; a capsule character controller
(``runtime/physics.py``) ticked once a frame from an
``InputCollection``; the character's posed mesh rebuilt every frame
(limbs swing with the run cycle, the body yaws along the velocity); an
oscillating, rotating glass platform that is also a moving collision
surface; a follow camera.  ``assets/playground_input.bin`` holds a
150-frame input recording (``runtime.input.InputReplay``).

The scene object keeps the character's state: each ``generate`` ticks
the physics once before it builds the frame.
"""

from __future__ import annotations

import os

import numpy as np

from . import register
from ..core.camera import Camera
from ..core.device import resolve
from ..geometry.scene import SceneBuilder
from ..geometry.shapes import cube
from ..geometry.triangles import Triangles, concatenate
from ..loaders import SimpleTexturedBuilder, load_obj
from ..materials.background import SkyBackground
from ..materials.table import MaterialBuilder
from ..runtime import physics
from ..runtime.physics import CharacterState, CollisionMesh

LEVEL_OBJ = os.path.join(os.path.dirname(__file__), "..", "..",
                         "assets", "level", "playground_level.obj")

SPAWN = (0.0, physics.RADIUS + 0.2, 2.0)

# The platform's size; its path is platform_state's.
PLATFORM_SCALE = (2.0, 0.2, 2.0)


def platform_state(frame):
    """(position, yaw_turns, velocity) of the glass platform."""
    f = float(frame)
    x = -3.0 + 2.5 * np.sin(f / 40.0)
    y = 1.1 + 0.6 * np.sin(f / 25.0)
    pos = np.array([x, y, -5.0])
    yaw = f / 380.0
    vel = np.array([2.5 * np.cos(f / 40.0) / 40.0,
                    0.6 * np.cos(f / 25.0) / 25.0, 0.0]) / physics.DT
    return pos, yaw, vel


def _trs(translation, yaw_turns, scale):
    a = 2.0 * np.pi * yaw_turns
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    m[:3, :3] *= np.asarray(scale)[None, :]
    m[:3, 3] = translation
    return m


def player_mesh(state: CharacterState, material):
    """The character's posed mesh: torso, head and limbs as boxes, the
    limbs swinging with the run phase, the body yawed along the
    velocity heading."""
    vel = state.vel
    speed = float(np.hypot(vel[0], vel[2]))
    yaw = float(np.arctan2(vel[0], vel[2])) if speed > 0.3 else 0.0
    swing = 0.7 * np.sin(state.phase * 2.0 * np.pi) * min(speed / 4, 1.0)

    parts = []

    def limb(offset, size, pitch):
        t = cube((0.0, -size[1] / 2.0, 0.0), size, material=material)
        va = np.asarray(t.va)
        vb = va + np.asarray(t.e_ab)
        vc = va + np.asarray(t.e_ac)
        c, s = np.cos(pitch), np.sin(pitch)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        out = [v @ rot.T + np.asarray(offset) for v in (va, vb, vc)]
        parts.append(Triangles.from_soup(*out, material=material))

    def piece(center, size):
        parts.append(cube(center, size, material=material))

    piece((0.0, 0.95, 0.0), (0.5, 0.7, 0.3))            # torso
    piece((0.0, 1.45, 0.0), (0.32, 0.32, 0.32))         # head
    limb((-0.18, 0.6, 0.0), (0.16, 0.6, 0.16), swing)   # left leg
    limb((0.18, 0.6, 0.0), (0.16, 0.6, 0.16), -swing)   # right leg
    limb((-0.35, 1.25, 0.0), (0.14, 0.5, 0.14), -swing)  # left arm
    limb((0.35, 1.25, 0.0), (0.14, 0.5, 0.14), swing)    # right arm

    soup = concatenate(parts)
    # Yaw the whole figure, then move it to the capsule's foot.
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    foot = state.pos - np.array([0.0, physics.RADIUS, 0.0])
    va = np.asarray(soup.va) @ rot.T + foot
    vb = (np.asarray(soup.va) + np.asarray(soup.e_ab)) @ rot.T + foot
    vc = (np.asarray(soup.va) + np.asarray(soup.e_ac)) @ rot.T + foot
    return Triangles.from_soup(va.astype(np.float32),
                               vb.astype(np.float32),
                               vc.astype(np.float32), material=material)


def _level(path, materials):
    builder = SimpleTexturedBuilder(materials)
    load_obj(path, builder)
    return builder.finish()


@register("playground")
class Playground:
    def __init__(self, aspect_ratio=16.0 / 9.0, level=LEVEL_OBJ):
        self.aspect_ratio = aspect_ratio
        self.level_path = level
        self.state = CharacterState.spawn(SPAWN)
        self._level_collision = None
        self._platform_collision = None

    def _collision(self):
        if self._level_collision is None:
            self._level_collision = CollisionMesh.from_triangles(
                _level(self.level_path, MaterialBuilder()))
            self._platform_collision = CollisionMesh.from_triangles(
                cube(size=2.0))
        return self._level_collision, self._platform_collision

    def tick(self, frame, input):
        """Advance the physics one frame."""
        level, plat = self._collision()
        pos, yaw, vel = platform_state(frame)
        # cube(size=2) spans +-1: scale by PLATFORM_SCALE / 2.
        plat_world = plat.transformed(
            _trs(pos, yaw, np.asarray(PLATFORM_SCALE) / 2.0))
        self.state = physics.tick(self.state, input,
                                  level.concat(plat_world),
                                  platform_velocity=vel)
        return self.state

    def generate(self, t=0.0, frame=0, input=None, device=None):
        device = resolve(device)
        self.tick(frame, input)

        mat = MaterialBuilder()
        sb = SceneBuilder(mat, SkyBackground.create())
        sb.add_model(_level(self.level_path, mat))

        glass = mat.dielectric(1.7)
        pos, yaw, _ = platform_state(frame)
        pmesh = sb.add_mesh(cube(size=2.0))
        sb.add_instance(pmesh, tuple(pos), rotation=(0.0, yaw, 0.0),
                        scale=tuple(np.asarray(PLATFORM_SCALE) / 2.0),
                        material=glass)

        player = mat.metal(0.25, (0.85, 0.25, 0.2))
        sb.add_model(player_mesh(self.state, player))

        # The camera follows: it looks at the character from behind and
        # above, yawed by the camera stick.
        look_at = self.state.pos + np.array([0.0, 0.8, 0.0])
        cam_yaw = (input.cam_x if input is not None else 0.0) * np.pi
        eye = look_at + np.array([7.0 * np.sin(cam_yaw + 0.35), 4.0,
                                  9.0 * np.cos(cam_yaw + 0.35)])
        camera = Camera.create(
            50.0, tuple(eye), tuple(look_at), (0.0, 1.0, 0.0),
            self.aspect_ratio, aperture=0.0,
            focus_distance=float(np.linalg.norm(eye - look_at)))
        return sb.build(device), camera.to(device)
