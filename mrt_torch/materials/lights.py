"""Explicit light sampling: next-event estimation with multiple
importance sampling (mirrors ``mrt.materials.lights``).

Opt-in (``SceneBuilder.build(nee=True)`` or ``attach_lights``): a table
of the scene's emissive triangles (world space, every instance's baked
in) and spheres.  At every vertex that scattered through a cosine lobe
or the isotropic phase, one light is picked uniformly and sampled (a
triangle by area with the geometry term, a sphere by its subtended
cone), a shadow ray tests it, and the power heuristic (beta = 2) weighs
the light sample against the BSDF continuation, whose emission the next
step weighs by ``mis_bsdf_weight``.  The same expectation as pure BSDF
sampling, with less variance; renders with a light table are a
different estimator, so goldens without one do not apply.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..math.vec import clamp, cross, div, dot, length, sqrt
from . import table as T

SPHERE = 0
TRI = 1

TAU = 2.0 * math.pi


class LightTable(nn.Module):
    """kind (L,) int32 SPHERE | TRI; p0 (L, 3) sphere centre or triangle
    vertex a; e1, e2 (L, 3) triangle edges ab, ac (zeros for spheres);
    radius (L,) sphere radius; emission (L, 3); area (L,) triangle
    area."""

    FIELDS = {"kind": torch.int32, "p0": torch.float32, "e1": torch.float32,
              "e2": torch.float32, "radius": torch.float32,
              "emission": torch.float32, "area": torch.float32}

    def __init__(self, **arrays):
        super().__init__()
        for name, dtype in self.FIELDS.items():
            self.register_buffer(name, torch.as_tensor(
                np.asarray(arrays[name]), dtype=dtype))

    @property
    def count(self):
        return self.kind.shape[0]


def collect_lights(scene):
    """Host NumPy: the scene's emissive spheres, brute-force triangles
    and every instance's emissive triangles (baked to world space), as a
    LightTable on the scene's device, or None when there are none."""
    host = lambda x: x.detach().cpu().numpy()
    mtype = host(scene.materials.mtype)
    emit = host(scene.materials.emit)
    kinds, p0s, e1s, e2s, radii, ems, areas = [], [], [], [], [], [], []

    def is_light(rows):
        return mtype[rows] == T.DIFFUSE_LIGHT

    if scene.spheres is not None:
        rows = host(scene.spheres.material)
        mask = is_light(rows)
        for c, r, m in zip(host(scene.spheres.center)[mask],
                           host(scene.spheres.radius)[mask], rows[mask]):
            kinds.append(SPHERE)
            p0s.append(c)
            e1s.append(np.zeros(3))
            e2s.append(np.zeros(3))
            radii.append(r)
            ems.append(emit[m])
            areas.append(0.0)

    def add_tris(va, e1, e2, rows):
        mask = is_light(rows)
        for a, b, c, m in zip(va[mask], e1[mask], e2[mask], rows[mask]):
            kinds.append(TRI)
            p0s.append(a)
            e1s.append(b)
            e2s.append(c)
            radii.append(0.0)
            ems.append(emit[m])
            areas.append(0.5 * np.linalg.norm(np.cross(b, c)))

    def tri_rows(table):
        """(va, e_ab, e_ac) of a (T, 9) triangle row table."""
        r = host(table)
        return r[:, 0:3], r[:, 3:6], r[:, 6:9]

    if scene.triangles is not None:
        tr = scene.triangles
        material = np.round(host(tr.shading[:, 16])).astype(np.int32)
        add_tris(*tri_rows(tr.rows), material)

    if scene.tlas is not None:
        tl = scene.tlas
        va, e1, e2 = tri_rows(tl.tris)
        tri_mat = np.round(host(tl.shading[:, 16])).astype(np.int32)
        fwd = host(tl.transform)
        override = host(tl.override)
        imeta, bmeta = host(tl.imeta), host(tl.bmeta)
        for inst in range(fwd.shape[0]):
            # The instance's triangles: the leaves between its mesh's
            # BLAS root and end.
            lo, hi = imeta[inst]
            firsts, counts = bmeta[lo:hi, 0], bmeta[lo:hi, 1]
            leaf = counts > 0
            if not leaf.any():
                continue
            idx = np.concatenate([np.arange(a, a + b) for a, b in
                                  zip(firsts[leaf], counts[leaf])])
            rows = (np.full(idx.shape, override[inst], np.int64)
                    if override[inst] >= 0 else tri_mat[idx])
            mask = is_light(rows)
            if not mask.any():
                continue
            m3 = fwd[inst, :3, :3]
            t3 = fwd[inst, :3, 3]
            add_tris(va[idx][mask] @ m3.T + t3, e1[idx][mask] @ m3.T,
                     e2[idx][mask] @ m3.T, rows[mask])

    if not kinds:
        return None
    table = LightTable(
        kind=np.array(kinds, np.int32), p0=np.array(p0s, np.float32),
        e1=np.array(e1s, np.float32), e2=np.array(e2s, np.float32),
        radius=np.array(radii, np.float32),
        emission=np.array(ems, np.float32),
        area=np.array(areas, np.float32))
    return table.to(scene.materials.mtype.device)


def _unit(x):
    """x / max(|x|, 1e-20) over the trailing axis."""
    return x / clamp(length(x), 1e-20)[..., None]


def bsdf_pdf(lobe, n_unit, w):
    """Solid-angle pdf of the scatter lobe for direction w: cos/pi over
    the hemisphere for lobe 1, 1/(4 pi) for lobe 2, else 0."""
    pdf_cos = clamp(dot(w, n_unit), 0.0) / math.pi
    return torch.where(lobe == 1, pdf_cos,
                       torch.where(lobe == 2, 1.0 / (2.0 * TAU), 0.0))


def sample_direct(scene, hits, sampler, lobe):
    """One-sample MIS-weighted NEE at NEE-capable vertices.

    Returns (direct (N, 3), did_nee (N,) bool): the radiance to multiply
    by the path throughput and the vertex albedo, with the lobe's f term,
    the light's pdf, the pick probability and the MIS weight in it.  The
    shadow ray draws from `sampler` after its next4(), so volume and
    alpha draws continue the same stream."""
    lights = scene.lights
    n_lights = lights.count
    capable = hits.hit & (lobe > 0)

    u_pick, u1, u2, _ = sampler.next4()
    li = torch.clamp((u_pick * n_lights).to(torch.int64), max=n_lights - 1)
    kind = lights.kind[li]
    p0, e1, e2 = lights.p0[li], lights.e1[li], lights.e2[li]
    radius, emission, area = (lights.radius[li], lights.emission[li],
                              lights.area[li])

    p = hits.point
    n_unit = _unit(hits.normal)
    iso = lobe == 2

    # Triangle lights: uniform area sample and the geometry term.
    su = sqrt(clamp(u1, 1e-12))
    b1 = 1.0 - su
    b2 = u2 * su
    x_tri = p0 + e1 * b1[:, None] + e2 * b2[:, None]
    tri_n = _unit(cross(e1, e2))
    to_tri = x_tri - p
    dist2_tri = dot(to_tri, to_tri)
    dist_tri = sqrt(clamp(dist2_tri, 1e-12))
    w_tri = to_tri / dist_tri[:, None]
    cos_p_tri = dot(w_tri, n_unit)
    cos_l_tri = torch.abs(dot(w_tri, tri_n))
    f_tri = torch.where(iso, 1.0 / (2.0 * TAU), cos_p_tri / math.pi)
    weight_tri = (f_tri * cos_l_tri * area
                  / clamp(dist2_tri, 1e-12))
    psa_tri = dist2_tri / clamp(cos_l_tri * area, 1e-12)

    # Sphere lights: cone sampling (solid-angle pdf).
    to_c = p0 - p
    dist_c = sqrt(clamp(dot(to_c, to_c), 1e-12))
    sin_max = clamp(radius / dist_c, 0.0, 1.0)
    cos_max = sqrt(clamp(1.0 - sin_max * sin_max, 0.0))
    axis = to_c / dist_c[:, None]
    h = torch.zeros_like(axis)
    far_x = torch.abs(axis[:, 0]) > 0.9
    h[:, 0] = torch.where(far_x, 0.0, 1.0)
    h[:, 1] = torch.where(far_x, 1.0, 0.0)
    t1 = _unit(cross(axis, h))
    t2 = cross(axis, t1)
    cos_theta = 1.0 - u1 * (1.0 - cos_max)
    sin_theta = sqrt(clamp(1.0 - cos_theta * cos_theta, 0.0))
    phi = TAU * u2
    w_sph = (axis * cos_theta[:, None]
             + t1 * (sin_theta * torch.cos(phi))[:, None]
             + t2 * (sin_theta * torch.sin(phi))[:, None])
    cos_p_sph = dot(w_sph, n_unit)
    solid_angle = TAU * (1.0 - cos_max)
    f_sph = torch.where(iso, 1.0 / (2.0 * TAU), cos_p_sph / math.pi)
    weight_sph = f_sph * solid_angle
    psa_sph = 1.0 / clamp(solid_angle, 1e-12)
    # The near root along the sample direction clips the shadow ray.
    b_q = dot(w_sph, -to_c)
    c_q = dot(to_c, to_c) - radius * radius
    disc_q = clamp(b_q * b_q - c_q, 0.0)
    dist_sph = clamp(-b_q - sqrt(disc_q), 1e-3)

    is_tri = kind == TRI
    w = torch.where(is_tri[:, None], w_tri, w_sph)
    weight = torch.where(is_tri, weight_tri, weight_sph)
    dist = torch.where(is_tri, dist_tri, dist_sph)
    valid = capable & (weight > 0.0)

    p_light = div(torch.where(is_tri, psa_tri, psa_sph), n_lights)
    p_b = bsdf_pdf(lobe, n_unit, w)
    w_mis = (p_light * p_light
             / clamp(p_light * p_light + p_b * p_b, 1e-20))
    weight = weight * w_mis

    # Shadow ray: any blocker strictly before the light point?
    shadow = scene.intersect(p, w, t_min=1e-3,
                             t_max=torch.where(valid, dist - 1e-3, 1e-3),
                             sampler=sampler, shading_aux=False)
    lit = (valid & ~shadow.hit).to(torch.float32)
    direct = emission * (weight * float(n_lights))[:, None] * lit[:, None]
    return direct, valid


def mis_bsdf_weight(scene, hits, o, d, prev_pdf):
    """Power-heuristic weight of emission found by the BSDF continuation
    (o, d) of an NEE vertex whose lobe chose d with solid-angle pdf
    prev_pdf: the light pdf is rebuilt from the hit (``prim_area``: the
    world triangle area, or minus the sphere radius)."""
    n_lights = float(scene.lights.count)
    d_len = clamp(length(d), 1e-20)
    w = d / d_len[:, None]
    t_safe = torch.where(hits.hit, hits.t, 1.0)
    dist = t_safe * d_len
    out_unit = _unit(hits.outward_normal)

    cos_l = torch.abs(dot(w, out_unit))
    area = clamp(hits.prim_area, 0.0)
    psa_tri = dist * dist / clamp(cos_l * area, 1e-12)

    r = clamp(-hits.prim_area, 0.0)
    center = hits.point - out_unit * r[:, None]
    to_c = center - o
    dist_c = clamp(length(to_c), 1e-12)
    sin_max = clamp(r / dist_c, 0.0, 1.0)
    cos_max = sqrt(clamp(1.0 - sin_max * sin_max, 0.0))
    solid = TAU * (1.0 - cos_max)
    psa_sph = 1.0 / clamp(solid, 1e-12)

    p_light = div(torch.where(hits.prim_area > 0.0, psa_tri,
                              torch.where(hits.prim_area < 0.0, psa_sph,
                                          0.0)), n_lights)
    return (prev_pdf * prev_pdf
            / clamp(prev_pdf * prev_pdf + p_light * p_light, 1e-20))
