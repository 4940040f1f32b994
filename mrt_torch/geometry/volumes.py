"""Homogeneous participating media bounded by spheres or by an instanced
mesh (mirrors ``mrt.geometry.volumes``).

A volume samples an exponential free-flight distance between the
boundary's entry and exit:
  entry = the first boundary hit with t_min = -inf; exit = the next hit
  after entry + 1e-4; entry clamped to the caller's t_min, then to 0;
  exit clamped to t_max; no event when entry >= exit; free flight =
  ln(u) * (-1 / density), no event when it overshoots the inside
  distance.  The event's normal is the reference's arbitrary (1, 0, 0)
  with front_face true, and its material an Isotropic row.

``VolumeSpheres`` is the analytic form for sphere bounds; a
``MeshVolume`` walks its single-instance TLAS twice through kernel B7
(entry, then exit past a per-lane t_min).  Volumes are evaluated against
the full t_max and min-folded with the other hits afterwards, which the
exponential's memorylessness makes equal in distribution to the
reference's shrinking closest-so-far.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.autodiff import refuse_grad
from ..math.vec import clamp, dot, sqrt
from ..ops import bvh as kernel
from .hit import INF, Hits


class VolumeSpheres(nn.Module):
    """center (V, 3), radius (V,), neg_inv_density (V,) = -1/density
    float32; material (V,) int32 Isotropic rows."""

    def __init__(self, center, radius, neg_inv_density, material):
        super().__init__()
        f32 = torch.float32
        self.register_buffer("center", torch.as_tensor(center, dtype=f32))
        self.register_buffer("radius", torch.as_tensor(radius, dtype=f32))
        self.register_buffer("neg_inv_density",
                             torch.as_tensor(neg_inv_density, dtype=f32))
        self.register_buffer("material",
                             torch.as_tensor(material, dtype=torch.int32))

    @property
    def count(self):
        return self.center.shape[0]


def _event_hits(o, d, t, material):
    """Hits for volume events at t (N,), +inf where there is none."""
    n = o.shape[0]
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 0.0)
    zeros = torch.zeros((n, 3), device=o.device)
    normal = zeros.clone()
    normal[:, 0] = 1.0
    return Hits(t=torch.where(hit, t, INF), point=o + d * t_safe[:, None],
                normal=normal,
                front_face=torch.ones((n,), dtype=torch.bool, device=o.device),
                uv=zeros[:, :2], material=material, hit=hit, tangent=zeros,
                bitangent=zeros)


def _maximum(x, lo):
    """max(x, lo) for a float or tensor bound (a float makes no host to
    device copy)."""
    return torch.maximum(x, lo) if torch.is_tensor(lo) else clamp(x, lo)


def _minimum(x, hi):
    return torch.minimum(x, hi) if torch.is_tensor(hi) else clamp(x, hi=hi)


def intersect(vols: VolumeSpheres, o, d, t_min, t_max, u) -> Hits:
    """The nearest scatter event over all sphere volumes; u (N, V)
    uniforms, one a (ray, volume)."""
    oc = o[None, :, :] - vols.center[:, None, :]            # (V, N, 3)
    a = dot(d, d)[None, :]                                  # (1, N)
    half_b = dot(oc, d[None, :, :])                         # (V, N)
    cterm = dot(oc, oc) - (vols.radius * vols.radius)[:, None]
    disc = half_b * half_b - a * cterm
    sq = sqrt(clamp(disc, 0.0))
    t0 = (-half_b - sq) / a                                 # entry
    t1 = (-half_b + sq) / a
    has_exit = (disc >= 0.0) & (t1 >= t0 + 1e-4)

    enter = _maximum(t0, t_min)
    exit_ = _minimum(t1, t_max)
    ok = has_exit & (enter < exit_)
    enter = clamp(enter, 0.0)

    ray_len = sqrt(a)
    dist_inside = (exit_ - enter) * ray_len
    hit_dist = torch.log(u.T) * vols.neg_inv_density[:, None]
    ok = ok & (hit_dist <= dist_inside)
    t = torch.where(ok, enter + hit_dist / ray_len, INF)    # (V, N)
    best, which = torch.min(t, dim=0)
    return _event_hits(o, d, best, vols.material[which])


class MeshVolume(nn.Module):
    """A medium bounded by one instanced mesh: tlas (a single-instance
    TLAS), neg_inv_density () float32, material () int32."""

    def __init__(self, tlas, neg_inv_density, material):
        super().__init__()
        self.tlas = tlas
        self.register_buffer("neg_inv_density", torch.as_tensor(
            neg_inv_density, dtype=torch.float32))
        self.register_buffer("material",
                             torch.as_tensor(material, dtype=torch.int32))


def intersect_mesh(vol: MeshVolume, o, d, t_min, t_max, u) -> Hits:
    """The scatter event in a mesh-bounded volume; u (N,) uniforms.
    Raises ValueError where o, d or the volume require grad."""
    refuse_grad("mesh volume (B7)", o, d, vol)
    t0 = kernel.tlas_hit(vol.tlas, o, d, -INF, INF)[0]       # +inf: miss
    entered = torch.isfinite(t0)
    t1 = kernel.tlas_hit(vol.tlas, o, d,
                         torch.where(entered, t0 + 1e-4, 0.0), INF)[0]
    has_exit = entered & torch.isfinite(t1)

    enter = _maximum(torch.where(entered, t0, 0.0), t_min)
    exit_ = _minimum(torch.where(has_exit, t1, 0.0), t_max)
    ok = has_exit & (enter < exit_)
    enter = clamp(enter, 0.0)

    ray_len = sqrt(dot(d, d))
    dist_inside = (exit_ - enter) * ray_len
    hit_dist = torch.log(clamp(u, 1e-38)) * vol.neg_inv_density
    ok = ok & (hit_dist <= dist_inside)
    t = torch.where(ok, enter + hit_dist / ray_len, INF)
    return _event_hits(o, d, t, vol.material.expand(o.shape[0]))
