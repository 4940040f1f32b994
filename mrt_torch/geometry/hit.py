"""SoA hit records for a wavefront of rays (mirrors ``mrt.geometry.hit``).

A wavefront of N rays produces parallel tensors; materials are integer
rows into the scene's MaterialTable.  Primitives without UVs (spheres,
volumes) carry zero texture coordinates and a zero tangent frame.  The
``prim_area`` is the light-pdf geometry of the hit primitive for
next-event estimation (``materials/lights.py``): the world triangle area
(> 0), minus the sphere radius (< 0), or 0 (volumes, voxels, misses).
"""

from __future__ import annotations

import dataclasses

import torch

from ..math.vec import dot

INF = float("inf")


@dataclasses.dataclass
class Hits:
    t: torch.Tensor           # (N,)  +inf on miss
    point: torch.Tensor       # (N,3)
    normal: torch.Tensor      # (N,3) front-faced (flipped against the ray)
    front_face: torch.Tensor  # (N,)  bool
    uv: torch.Tensor          # (N,2) zeros when the primitive has no UVs
    material: torch.Tensor    # (N,)  int32 MaterialTable row
    hit: torch.Tensor         # (N,)  bool
    tangent: torch.Tensor     # (N,3) tangent frame for normal mapping
    bitangent: torch.Tensor   # (N,3)
    prim_area: torch.Tensor = None  # (N,)  zeros when not given

    def __post_init__(self):
        if self.prim_area is None:
            self.prim_area = torch.zeros_like(self.t)

    @classmethod
    def none(cls, n, device=None):
        """All-miss record for n rays."""
        return cls(
            t=torch.full((n,), INF, device=device),
            point=torch.zeros((n, 3), device=device),
            normal=torch.zeros((n, 3), device=device),
            front_face=torch.zeros((n,), dtype=torch.bool, device=device),
            uv=torch.zeros((n, 2), device=device),
            material=torch.zeros((n,), dtype=torch.int32, device=device),
            hit=torch.zeros((n,), dtype=torch.bool, device=device),
            tangent=torch.zeros((n, 3), device=device),
            bitangent=torch.zeros((n, 3), device=device),
            prim_area=torch.zeros((n,), device=device),
        )

    @property
    def outward_normal(self):
        """The geometric normal before it was flipped against the ray."""
        return torch.where(self.front_face[:, None], self.normal,
                           -self.normal)

    def closer_of(self, other: "Hits") -> "Hits":
        """Per-ray select whichever of two hit records is nearer."""
        out = self.select(other.t < self.t, other)
        out.hit = self.hit | other.hit
        return out

    def select(self, take, other: "Hits") -> "Hits":
        """Per-ray `other` where `take` (N,) else self, field by field."""
        pick = lambda a, b: torch.where(
            take.reshape(take.shape + (1,) * (a.dim() - 1)), b, a)
        return Hits(**{f.name: pick(getattr(self, f.name),
                                    getattr(other, f.name))
                       for f in dataclasses.fields(self)})


def set_face_normal(d, outward_normal):
    """Flip the outward normal against the ray.  Returns (normal,
    front_face)."""
    front_face = dot(d, outward_normal) < 0.0
    normal = torch.where(front_face[..., None], outward_normal,
                         -outward_normal)
    return normal, front_face
