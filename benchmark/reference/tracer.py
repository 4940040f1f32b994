"""A plain path tracer: the film sums that a pass of the port must give
at chosen pixels.

It traces each (pixel, sample) path on its own, bounce by bounce, with a
brute-force nearest hit over every sphere and over the ground cube's 12
triangles, and sums each path's contributions and scatter events into
its pixel.  The estimator is the port's persistent pass's (frozen copies
of ``mrt_torch/math/rng.py``'s PCG4D draws, ``math/sampling.py``,
``math/vec.py``, the camera, ``materials/shade.py``'s Lambertian, Metal,
Dielectric and DiffuseLight rows and the sky and solid backgrounds),
written out in the same order of operations, so that on the same device
the same path takes the same turns.  Every draw is the same pure
function of (seed, pixel, sample, bounce) as in the port.  The film of a
pass adds the same terms in another order (an atomic add a step), so
sums agree to rounding; a path whose hit flips on a rounding (ROADMAP
C2, C15) takes another way and its pixel differs.

``dtype`` computes every float in another precision (the control's
bfloat16); the draws stay float32 and are rounded to it.
"""

from __future__ import annotations

import math

import torch

from .scenes import DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN, METAL

MASK = 0xFFFFFFFF
T_MIN = 1e-3
DET_EPS = 1e-6
NEAR_ZERO_EPS = 1e-5
TAU = 2.0 * math.pi
INF = float("inf")
# Draws a Mix resolution takes; the scenes have no Mix rows, but every
# shading call still advances its streams by this many.
MIX_DRAWS = 4


# -- PCG4D (Jarzynski and Olano 2020) on int64 carriers of uint32 ----------

def mul32(a, b):
    if not torch.is_tensor(b):
        b = int(b) & MASK
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK


def _mix(x, y, z, w):
    x = (x + mul32(y, w)) & MASK
    y = (y + mul32(z, x)) & MASK
    z = (z + mul32(x, y)) & MASK
    w = (w + mul32(y, z)) & MASK
    return x, y, z, w


def pcg4d(x, y, z, w):
    x, y, z, w = ((mul32(v, 1664525) + 1013904223) & MASK
                  for v in (x, y, z, w))
    x, y, z, w = _mix(x, y, z, w)
    x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    return _mix(x, y, z, w)


def draw4(seed, ids, salt, draw):
    """Four uniforms in [0, 1), float32: the draw-th of the stream
    (seed, ids, salt)."""
    seed = int(seed) & MASK
    salt = salt & MASK if torch.is_tensor(salt) else int(salt) & MASK
    ids = ids & MASK
    y = (salt + ((0x9E3779B9 * draw) & MASK)) & MASK
    y = y.expand_as(ids) if torch.is_tensor(y) else torch.full_like(ids, y)
    z = torch.full_like(ids, seed)
    w = torch.full_like(ids, ((seed << 8) & MASK) ^ draw)
    return tuple((v >> 8).to(torch.float32) * (1.0 / 16777216.0)
                 for v in pcg4d(ids, y, z, w))


# -- vectors ----------------------------------------------------------------

def sqrt(x):
    """Correctly rounded: the CPU's vectorised root may miss by an ulp,
    so it is taken there in float64 and rounded once."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def unit(a):
    return a / sqrt(dot(a, a))[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def reflect(v, n):
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(uv, n, ratio):
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    perp = (uv + n * cos_theta[..., None]) * ratio[..., None]
    k = torch.abs(1.0 - dot(perp, perp))
    safe = sqrt(torch.where(k > 0.0, k, 1.0))
    return perp + n * -torch.where(k > 0.0, safe, 0.0)[..., None]


def unit_vector(u1, u2):
    z = 1.0 - 2.0 * u1
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TAU * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_sphere(u1, u2, u3):
    u = torch.clamp(u3, min=2.0 ** -25)
    r = torch.pow(u.to(torch.float64), 1.0 / 3.0).to(u1.dtype)
    return unit_vector(u1, u2) * r[..., None]


def in_unit_disk(u1, u2):
    r = sqrt(u1)
    phi = TAU * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)


# -- camera, hits, shading --------------------------------------------------

def camera_rays(scene, pixel, sample, seed, width, height, dt):
    """Origins, directions and ray ids of (pixel, sample) pairs (int64),
    as the persistent pass makes them."""
    sample = sample & MASK
    px = (pixel % width).to(torch.float32)
    py = (pixel // width).to(torch.float32)
    jx, jy, du, dv = (x.to(dt) for x in draw4(
        seed, (pixel + mul32(sample, 0x9E3779B9)) & MASK, 0xC0FFEE, 0))
    # 1/width and 1/height rounded to float32, then multiplied.
    inv_w = float(1.0 / torch.tensor(float(width)))
    inv_h = float(1.0 / torch.tensor(float(height)))
    s = (px.to(dt) + jx) * inv_w
    t = (py.to(dt) + jy) * inv_h
    o, d = lens(scene["camera"], s, t, du, dv)
    return o, d, pixel ^ mul32(sample, 0x85EBCA6B)


def lens(cam, s, t, du, dv):
    """Rays through viewport coordinates s, t (t up), the lens sampled
    at du, dv: (origins, unnormalised directions)."""
    blur = in_unit_disk(du, dv) * cam["lens_radius"]
    offset = cam["u"] * blur[..., 0:1] + cam["v"] * blur[..., 1:2]
    o = cam["origin"] + offset
    d = (cam["lower_left"] + cam["horizontal"] * s[..., None]
         + cam["vertical"] * t[..., None] - cam["origin"] - offset)
    return o, d


def nearest_sphere(sph, form, o, d, chunk=256):
    """(t, index) of the nearest sphere root at or past T_MIN, the lowest
    index among equal roots; t is +inf on a miss."""
    n = o.shape[0]
    a = dot(d, d)
    inv_a = 1.0 / a
    od, oo = dot(o, d), dot(o, o)
    best_t = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for b0 in range(0, sph["radius"].shape[0], chunk):
        c = sph["center"][b0:b0 + chunk]
        r = sph["radius"][b0:b0 + chunk]
        if form == "expanded":
            # B1's scan: the products of o and d with the centres.
            cd = dot(c[:, None, :], d[None, :, :])
            co = dot(c[:, None, :], o[None, :, :])
            half_b = od[None, :] - cd
            c_term = (oo[None, :] - 2.0 * co) + (dot(c, c) - r * r)[:, None]
            disc = half_b * half_b - a[None, :] * c_term
            ok = (disc >= 0.0) & (r != 0.0)[:, None]
        else:
            # B5's leaf test: from the offset o - c.
            oc = o[None, :, :] - c[:, None, :]
            half_b = dot(oc, d[None, :, :])
            c_term = dot(oc, oc) - (r * r)[:, None]
            disc = half_b * half_b - a[None, :] * c_term
            ok = disc >= 0.0
        sq = sqrt(torch.where(ok, torch.clamp(disc, min=0.0), 1.0))
        root0 = (-half_b - sq) * inv_a[None, :]
        root1 = (-half_b + sq) * inv_a[None, :]
        lim = best_t[None, :]
        ok0 = ok & (root0 >= T_MIN) & (root0 <= lim)
        ok1 = ok & (root1 >= T_MIN) & (root1 <= lim)
        root = torch.where(ok0, root0, torch.where(ok1, root1, INF))
        ct, ci = torch.min(root, dim=0)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, ci + b0, best_i)
    return best_t, best_i


def face(d, outward):
    front = dot(d, outward) < 0.0
    return torch.where(front[:, None], outward, -outward), front


def sphere_hits(scene, o, d):
    sph = scene["spheres"]
    t, i = nearest_sphere(sph, scene["root"], o, d)
    hit = torch.isfinite(t)
    c, r = sph["center"][i], sph["radius"][i]
    point = o + d * torch.where(hit, t, 0.0)[:, None]
    normal, front = face(d, (point - c) / r[:, None])
    return dict(t=t, hit=hit, point=point, normal=normal, front=front,
                material=sph["material"][i])


def ground_hits(g, o, d):
    """The cube instance by brute force over its 12 triangles in object
    space (the ray taken there by the inverse transform)."""
    def warp(v, translate):
        m = g["inv"]
        out = [(m[k, 0] * v[:, 0] + m[k, 1] * v[:, 1]) + m[k, 2] * v[:, 2]
               for k in range(3)]
        if translate:
            out = [x + g["inv_t"][k] for k, x in enumerate(out)]
        return torch.stack(out, dim=1)

    ol, dl = warp(o, True)[:, None, :], warp(d, False)[:, None, :]
    va, ab, ac = g["va"][None], g["e_ab"][None], g["e_ac"][None]
    p = cross(dl, ac)
    det = dot(ab, p)
    det_ok = torch.abs(det) >= DET_EPS
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tv = ol - va
    u = dot(tv, p) * inv_det
    q = cross(tv, ab)
    v = dot(dl, q) * inv_det
    t = dot(ac, q) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= T_MIN))
    t, j = torch.min(torch.where(ok, t, INF), dim=1)
    hit = torch.isfinite(t)
    pick = lambda x: torch.gather(x, 1, j[:, None])[:, 0]
    u, v = pick(u), pick(v)
    nl = g["normal"][j]
    w = (1.0 - u - v)[:, None]
    nl = nl * w + nl * u[:, None] + nl * v[:, None]
    lin = g["fwd"]
    nw = torch.stack([(lin[k, 0] * nl[:, 0] + lin[k, 1] * nl[:, 1])
                      + lin[k, 2] * nl[:, 2] for k in range(3)], dim=1)
    nw = nw / torch.clamp(sqrt(dot(nw, nw)), min=1e-20)[:, None]
    point = o + d * torch.where(hit, t, 0.0)[:, None]
    normal, front = face(d, nw)
    return dict(t=t, hit=hit, point=point, normal=normal, front=front,
                material=torch.full_like(j, g["material"]))


def intersect(scene, o, d):
    hits = sphere_hits(scene, o, d)
    if "ground" in scene:
        other = ground_hits(scene["ground"], o, d)
        take = other["t"] < hits["t"]
        hits = {k: torch.where(take.reshape(-1, *[1] * (v.dim() - 1)),
                               other[k], v) for k, v in hits.items()}
        hits["hit"] = hits["hit"] | other["hit"]
    return hits


def background(scene, d):
    kind, color = scene["background"]
    if kind == "solid":
        return color.expand_as(d)
    t = 0.5 * (unit(d)[:, 1] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - t)[:, None] + blue * t[:, None]


def schlick(cos_theta, ratio):
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def scatter(scene, hits, d, u):
    """(attenuation, new direction, scattered) of each hit."""
    m = scene["materials"]
    rows = hits["material"]
    mtype = m["mtype"][rows]
    albedo, fuzz, ior = m["albedo"][rows], m["fuzz"][rows], m["ior"][rows]
    normal, u1, u2, u3, uf = hits["normal"], *u
    unit_d = unit(d)

    lam = normal + unit_vector(u1, u2)
    near_zero = torch.all(torch.abs(lam) <= NEAR_ZERO_EPS, dim=-1)
    lam = torch.where(near_zero[:, None], normal, lam)

    metal = reflect(unit_d, normal) + in_unit_sphere(u1, u2, u3) * fuzz[:, None]
    metal_ok = dot(metal, normal) > 0.0

    ratio = torch.where(hits["front"], 1.0 / ior, ior)
    cos_theta = torch.clamp(dot(-unit_d, normal), max=1.0)
    sin_theta = sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    reflects = (ratio * sin_theta > 1.0) | (schlick(cos_theta, ratio) > uf)
    glass = torch.where(reflects[:, None], reflect(unit_d, normal),
                        refract(unit_d, normal, ratio))

    is_ = lambda k: (mtype == k)[:, None]
    new_dir = torch.where(is_(LAMBERTIAN), lam,
                          torch.where(is_(METAL), metal,
                                      torch.where(is_(DIELECTRIC), glass,
                                                  normal)))
    atten = torch.where(is_(LAMBERTIAN) | is_(METAL), albedo,
                        torch.ones_like(albedo))
    scattered = hits["hit"] & ((mtype == LAMBERTIAN) | (mtype == DIELECTRIC)
                               | ((mtype == METAL) & metal_ok))
    return atten, new_dir, scattered


def trace(scene, pixel, sample, seed, width, height, max_depth, dt):
    """Radiance (N, 3) and scatter events (N,) of each (pixel, sample)
    path, traced to `max_depth` bounces."""
    o, d, ray_id = camera_rays(scene, pixel, sample, seed, width, height, dt)
    n = o.shape[0]
    radiance = torch.zeros((n, 3), dtype=torch.float64, device=o.device)
    events = torch.zeros((n,), dtype=torch.int64, device=o.device)
    throughput = torch.ones_like(o)
    lane = torch.arange(n, device=o.device)
    m = scene["materials"]
    for b in range(max_depth):
        if lane.numel() == 0:
            break
        hits = intersect(scene, o, d)
        hit = hits["hit"]
        rows = hits["material"]
        light = (m["mtype"][rows] == DIFFUSE_LIGHT).to(dt)[:, None]
        emitted = torch.where(hit[:, None], m["emit"][rows] * light, 0.0)
        add = (torch.where(~hit[:, None], background(scene, d), 0.0)
               + torch.where(hit[:, None], emitted, 0.0))
        radiance[lane] += (throughput * add).to(torch.float64)
        # The scatter stream: salt 3b + 1, after the Mix draws.
        u = tuple(x.to(dt) for x in draw4(seed, ray_id, 3 * b + 1,
                                          MIX_DRAWS))
        atten, new_dir, scat = scatter(scene, hits, d, u)
        events[lane] += scat.to(torch.int64)
        keep = scat & (b + 1 < max_depth)
        lane, ray_id = lane[keep], ray_id[keep]
        o, d = hits["point"][keep], new_dir[keep]
        throughput = (throughput * atten)[keep]
    return radiance, events


def film_at(scene, pixel, sample_start, samples, seed, width, height,
            max_depth, dtype=torch.float32, batch=1 << 15):
    """The film sums at `pixel` (K,) int64 of a pass of `samples` spp
    from sample `sample_start`: radiance (K, 3) float64 and bounce
    counts (K,) int64."""
    k = pixel.shape[0]
    pix = pixel.repeat_interleave(samples)
    smp = (sample_start + torch.arange(samples, device=pixel.device)).repeat(k)
    rad, ev = [], []
    for s in range(0, pix.shape[0], batch):
        r, e = trace(scene, pix[s:s + batch], smp[s:s + batch], seed, width,
                     height, max_depth, dtype)
        rad.append(r)
        ev.append(e)
    rad = torch.cat(rad).reshape(k, samples, 3).sum(dim=1)
    return rad, torch.cat(ev).reshape(k, samples).sum(dim=1)
