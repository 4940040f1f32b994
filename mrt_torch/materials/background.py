"""Environment backgrounds: what escaped rays see (mirrors
``mrt.materials.background``).

Each background has a batched ``eval(directions, atlas=None) -> rgb``.
The texture-backed ones (``SkySphere``, ``CubeMap``) hold texture ids;
the scene passes its texture atlas in at eval time.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.autodiff import Replace
from ..math import vec


class SolidBackground(Replace, nn.Module):
    def __init__(self, color):
        super().__init__()
        self.register_buffer("color",
                             torch.as_tensor(color, dtype=torch.float32))

    @classmethod
    def create(cls, color):
        return cls(color)

    def eval(self, directions, atlas=None):
        return torch.broadcast_to(self.color, directions.shape)


class SkyBackground(Replace, nn.Module):
    """White-to-blue vertical gradient."""

    def __init__(self):
        super().__init__()
        self.register_buffer("blue", torch.tensor([0.5, 0.7, 1.0]))

    @classmethod
    def create(cls):
        return cls()

    def eval(self, directions, atlas=None):
        u = vec.unit(directions)
        t = 0.5 * (u[..., 1] + 1.0)
        return (1.0 - t)[..., None] + self.blue * t[..., None]


class SkySphere(nn.Module):
    """Equirectangular environment map: one texture id."""

    def __init__(self, tex):
        super().__init__()
        self.register_buffer("tex", torch.as_tensor(tex, dtype=torch.int32))

    @classmethod
    def create(cls, tex_id):
        return cls(tex_id)

    def eval(self, directions, atlas=None):
        p = vec.unit(directions)
        theta = torch.arccos(vec.clamp(p[..., 1], -1.0, 1.0))
        phi = torch.atan2(-p[..., 2], p[..., 0]) + math.pi
        uv = torch.stack([phi / (2.0 * math.pi), theta / math.pi], dim=-1)
        rgba = atlas.sample(self.tex.expand(phi.shape), uv)
        return rgba[..., :3]


class CubeMap(nn.Module):
    """Six-face environment map with a rotation.

    ``faces`` (6,) int32 holds texture ids in constructor order [x_pos,
    x_neg, y_pos, y_neg, z_pos, z_neg], and the dominant axis picks the
    same face index as the reference, including its quirk of index 3
    (the y_neg texture) for +y directions and index 2 for -y.
    ``transform`` (4, 4) rotates the direction first.  ``faces_raw``:
    every face is a RAW atlas row (one texel lookup a sample)."""

    def __init__(self, faces, transform, faces_raw=False):
        super().__init__()
        self.register_buffer("faces",
                             torch.as_tensor(faces, dtype=torch.int32))
        self.register_buffer("transform",
                             torch.as_tensor(transform, dtype=torch.float32))
        self.faces_raw = bool(faces_raw)

    @classmethod
    def create(cls, x_pos, x_neg, y_pos, y_neg, z_pos, z_neg,
               transform=None, faces_raw=False):
        if transform is None:
            transform = torch.eye(4)
        return cls([x_pos, x_neg, y_pos, y_neg, z_pos, z_neg], transform,
                   faces_raw)

    def eval(self, directions, atlas=None):
        r = self.transform[:3, :3]
        p = (directions[..., 0:1] * r[:, 0] + directions[..., 1:2] * r[:, 1]
             + directions[..., 2:3] * r[:, 2])
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        ax, ay, az = torch.abs(px), torch.abs(py), torch.abs(pz)
        is_x = (ax >= ay) & (ax >= az)
        is_y = ~is_x & (ay >= ax) & (ay >= az)

        w = torch.where
        index = w(is_x, w(px > 0, 0, 1),
                  w(is_y, w(py > 0, 3, 2), w(pz > 0, 4, 5)))
        u = w(is_x, w(px > 0, -pz, pz), w(is_y, px, w(pz > 0, px, -px)))
        v = w(is_x, py, w(is_y, w(py > 0, -pz, pz), py))
        max_axis = w(is_x, ax, w(is_y, ay, az))
        uv = torch.stack([0.5 * (u / max_axis + 1.0),
                          0.5 * (v / max_axis + 1.0)], dim=-1)
        rgba = atlas.sample(self.faces[index], uv, raw=self.faces_raw)
        return rgba[..., :3]
