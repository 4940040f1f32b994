"""Recipe ``cornell``: the Cornell box of nickmass/mass-raytrace
(``src/scenes/cornell.rs:20-100``) with next-event estimation, and its
own plain path tracer.

The scene is a frozen copy of ``mrt_torch/scenes/cornell.py``: five
10x10x10 cube walls (red left, green right, white top, back and floor),
a squashed-cube area light under the ceiling, a rotated white box, a
dielectric (ior 1.3) sphere, a black background, the camera 37 degrees
from (0, 5, 20).  Its five walls, light and box are instances of one
12-triangle cube placed by translation, rotation (in turns) and scale,
composed as the port composes them (a frozen copy of ``math/m4.py``'s
``trs_batch_np`` and ``trs_inverse_batch_np``: ``reference/scenes.py``'s
``cube_instance`` places a cube without rotation).

The estimator is one-sample next-event estimation with multiple
importance sampling by the power heuristic (Veach 1997, ch. 9), as the
JAX package's ``mrt/materials/lights.py`` defines it and the port's
``materials/lights.py`` ports it (frozen copies of ``sample_direct``,
``bsdf_pdf`` and ``mis_bsdf_weight``, written out in the same order of
operations): at every vertex whose scatter came from the cosine lobe,
one of the light table's triangles is picked uniformly and sampled by
area, a shadow ray tests it, and the power heuristic weighs the light
sample against the BSDF continuation, whose emission the next bounce
weighs by the continuation's pdf (``prev_pdf``, carried per path, zero
on a camera ray and after a dielectric).  Draws follow the port's
streams: bounce b's emission 3b (its Mix draws skipped), scatter 3b + 1
(after the Mix draws), volume 3b + 2 (nothing drawn: no volumes), and
the light sample 2^30 + 3b, whose shadow ray would continue that stream
after its one ``next4`` (it draws nothing: no volumes, no alpha test).

Departures from the port, each with its reason:
  - Nearest hits by brute force: the sphere by ``tracer``'s scan, the
    seven instances over all 84 object-space triangles at once (the port
    walks a TLAS with kernel B7, whose slab tests may cull a box that
    holds a nearer hit, ROADMAP C15); on equal t the lower instance, then
    the lower triangle wins, as B7's fold.
  - Only triangle lights are sampled, and ``mis_bsdf_weight`` rebuilds
    only a triangle's light pdf: this scene has no sphere light.
  - Radiance is summed per path in float64 (the port adds float32 terms
    into its film with atomics, in another order).
``dtype`` computes every float in another precision (the control's
bfloat16); the draws stay float32 and are rounded to it.
"""

import math

import numpy as np
import torch

from benchmark.reference import tracer
from benchmark.reference.scenes import (DIFFUSE_LIGHT, LAMBERTIAN,
                                        Materials, _cube_tris, camera,
                                        spheres)
from benchmark.reference.tracer import (INF, MIX_DRAWS, T_MIN, cross, dot,
                                        draw4, sqrt)

# A float32 product on the card may run in TF32 unless told not to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TAU = 2.0 * math.pi
TRI = 1  # the light table's kind of a triangle (the port's LightTable)
# A salt past every 3b + k bounce salt: the light sample's stream.
NEE_SALT = 1 << 30


# -- the scene --------------------------------------------------------------

def _rot(turns, axis):
    """Batched rotations about `axis` by `turns`, (I, 4, 4) float32."""
    a = np.asarray(turns, np.float32) * (2.0 * np.pi)
    c, s = np.cos(a), np.sin(a)
    m = np.tile(np.eye(4, dtype=np.float32), (a.shape[0], 1, 1))
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[:, i, i] = c
    m[:, j, j] = c
    if axis == 1:  # y: +s above the diagonal
        m[:, i, j] = s
        m[:, j, i] = -s
    else:
        m[:, i, j] = -s
        m[:, j, i] = s
    return m


def trs(translation, rotation, scale):
    """(forward T @ Rx @ Ry @ Rz @ S, inverse composed from the negated
    components), each (I, 4, 4) float32, rotation in turns."""
    t = np.asarray(translation, np.float32)
    r = np.asarray(rotation, np.float32)
    s = np.asarray(scale, np.float32)
    fwd = _rot(r[:, 0], 0) @ _rot(r[:, 1], 1) @ _rot(r[:, 2], 2)
    fwd[:, :3, :3] *= s[:, None, :]
    fwd[:, :3, 3] = t
    inv = _rot(-r[:, 2], 2) @ _rot(-r[:, 1], 1) @ _rot(-r[:, 0], 0)
    inv[:, :3, :3] /= s[:, :, None]
    inv[:, :3, 3] = -np.einsum("nij,nj->ni", inv[:, :3, :3], t)
    return fwd, inv


def light_table(va, ab, ac, fwd, emit):
    """The light triangles of one instance of the cube whose material is
    a light, in world space, as the port's ``collect_lights`` bakes
    them: kind, p0, e1, e2, radius, emission, area."""
    m3, t3 = fwd[:3, :3], fwd[:3, 3]
    p0, e1, e2 = va @ m3.T + t3, ab @ m3.T, ac @ m3.T
    area = [0.5 * np.linalg.norm(np.cross(b, c)) for b, c in zip(e1, e2)]
    n = va.shape[0]
    as_t = lambda x, dt: torch.tensor(np.array(x, dt))
    return dict(kind=as_t(np.full(n, TRI), np.int32),
                p0=as_t(p0, np.float32), e1=as_t(e1, np.float32),
                e2=as_t(e2, np.float32), radius=as_t(np.zeros(n), np.float32),
                emission=as_t([emit] * n, np.float32),
                area=as_t(area, np.float32))


def scene(aspect, nee=True):
    mat = Materials()
    red = mat.lambertian((1.0, 0.0, 0.0))
    green = mat.lambertian((0.0, 1.0, 0.0))
    white = mat.lambertian((1.0, 1.0, 1.0))
    light_emit = (8.0, 8.0, 8.0)
    light = mat.diffuse_light(light_emit)
    glass = mat.dielectric(1.3)
    # (translation, rotation in turns, scale, material), in the order the
    # port adds the instances; the cube spans [-1, 1]^3 (size 2).
    placed = [((-10.0, 5.0, 0.0), 0.0, 5.0, red),
              ((10.0, 5.0, 0.0), 0.0, 5.0, green),
              ((0.0, 15.0, 0.0), 0.0, 5.0, white),
              ((0.0, 5.0, -10.0), 0.0, 5.0, white),
              ((0.0, -5.0, 0.0), 0.0, 5.0, white),
              ((0.0, 10.0 - 0.00011, 0.0), 0.0, (1.0, 0.0001, 1.0), light),
              ((-2.0, 3.0, -1.0), (0.0, -0.05, 0.0), (1.75, 3.1, 1.75),
               white)]
    fwd, inv = trs(*(np.stack([np.broadcast_to(np.asarray(p[k], np.float32),
                                               (3,)) for p in placed])
                     for k in range(3)))
    va, ab, ac, normal = _cube_tris(2.0)
    as_t = lambda x: torch.tensor(np.ascontiguousarray(x, np.float32))
    out = dict(
        spheres=spheres([(1.75, 2.0, 2.25)], [2.0], [glass]),
        instances=dict(va=as_t(va), e_ab=as_t(ab), e_ac=as_t(ac),
                       normal=as_t(normal), fwd=as_t(fwd[:, :3, :3]),
                       inv=as_t(inv[:, :3, :3]), inv_t=as_t(inv[:, :3, 3]),
                       material=torch.tensor([p[3] for p in placed])),
        materials=mat.tables(),
        background=("solid", torch.zeros(3)),
        camera=camera(37.0, (0.0, 5.0, 20.0), (0.0, 5.0, 0.0),
                      (0.0, 1.0, 0.0), aspect, 0.0, 20.0),
        # One sphere: the port's brute force (B1) and its plain scan.
        root="expanded")
    if nee:
        i = [p[3] for p in placed].index(light)
        out["lights"] = light_table(va, ab, ac, fwd[i], light_emit)
    return out


# -- hits -------------------------------------------------------------------

def _lin(m, v):
    """(N, 3, 3) linear parts applied to v (N, 3), ((m0 x + m1 y) + m2 z)
    a row."""
    return torch.stack([(m[:, k, 0] * v[:, 0] + m[:, k, 1] * v[:, 1])
                        + m[:, k, 2] * v[:, 2] for k in range(3)], dim=1)


def _candidates(inst, o, d):
    """Every ray against every instance's triangles in object space (the
    ray taken there by the instance's inverse transform, as B7 warps
    it): (ok, t, u, v), each (N, I * 12), instance-major."""
    m, mt = inst["inv"][None], inst["inv_t"][None]

    def warp(x, translate):
        out = [(m[..., k, 0] * x[:, None, 0] + m[..., k, 1] * x[:, None, 1])
               + m[..., k, 2] * x[:, None, 2] for k in range(3)]
        if translate:
            out = [y + mt[..., k] for k, y in enumerate(out)]
        return torch.stack(out, dim=-1)[:, :, None, :]    # (N, I, 1, 3)

    ol, dl = warp(o, True), warp(d, False)
    va, ab, ac = inst["va"], inst["e_ab"], inst["e_ac"]
    p = cross(dl, ac)
    det = dot(ab, p)
    det_ok = torch.abs(det) >= tracer.DET_EPS
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tv = ol - va
    u = dot(tv, p) * inv_det
    q = cross(tv, ab)
    v = dot(dl, q) * inv_det
    t = dot(ac, q) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= T_MIN))
    flat = lambda x: x.reshape(x.shape[0], -1)
    return flat(ok), flat(t), flat(u), flat(v)


def instance_hits(inst, o, d):
    """The nearest instanced triangle of each ray: the world point, the
    object normal taken by the forward linear part and renormalised, the
    world triangle area (the light pdf's), the instance's material."""
    ok, t, u, v = _candidates(inst, o, d)
    t, j = torch.min(torch.where(ok, t, INF), dim=1)
    hit = torch.isfinite(t)
    pick = lambda x: torch.gather(x, 1, j[:, None])[:, 0]
    u, v = pick(u), pick(v)
    n_tris = inst["va"].shape[0]
    k, tri = j // n_tris, j % n_tris
    nl = inst["normal"][tri]
    w = (1.0 - u - v)[:, None]
    nl = nl * w + nl * u[:, None] + nl * v[:, None]
    lin = inst["fwd"][k]
    nw = _lin(lin, nl)
    nw = nw / torch.clamp(sqrt(dot(nw, nw)), min=1e-20)[:, None]
    point = o + d * torch.where(hit, t, 0.0)[:, None]
    normal, front = tracer.face(d, nw)
    ea, eb = _lin(lin, inst["e_ab"][tri]), _lin(lin, inst["e_ac"][tri])
    c = cross(ea, eb)
    area = 0.5 * sqrt(dot(c, c))
    return dict(t=torch.where(hit, t, INF), hit=hit, point=point,
                normal=normal, front=front, material=inst["material"][k],
                area=torch.where(hit, area, 0.0))


def intersect(scene, o, d):
    """The sphere's hits, then the instances' where strictly nearer (on
    equal t the sphere set keeps the hit, as the port folds its sets)."""
    hits = tracer.sphere_hits(scene, o, d)
    # No sphere is a light, so no sphere's light pdf is rebuilt.
    hits["area"] = torch.zeros_like(hits["t"])
    other = instance_hits(scene["instances"], o, d)
    take = other["t"] < hits["t"]
    out = {key: torch.where(take.reshape(-1, *[1] * (x.dim() - 1)),
                            other[key], x) for key, x in hits.items()}
    out["hit"] = hits["hit"] | other["hit"]
    return out


def blocked(scene, o, d, t_max):
    """Whether anything lies at t in [T_MIN, t_max] along each shadow
    ray (the port's shadow ray starts at 1e-3 too): the sphere's roots
    (the expanded form of the port's scan) and every instanced
    triangle."""
    sph = scene["spheres"]
    c, r = sph["center"][:, None, :], sph["radius"]
    a = dot(d, d)
    inv_a = 1.0 / a
    half_b = dot(o, d)[None, :] - dot(c, d[None, :, :])
    c_term = ((dot(o, o)[None, :] - 2.0 * dot(c, o[None, :, :]))
              + (dot(sph["center"], sph["center"]) - r * r)[:, None])
    disc = half_b * half_b - a[None, :] * c_term
    ok = (disc >= 0.0) & (r != 0.0)[:, None]
    sq = sqrt(torch.where(ok, torch.clamp(disc, min=0.0), 1.0))
    lim = t_max[None, :]
    root0 = (-half_b - sq) * inv_a[None, :]
    root1 = (-half_b + sq) * inv_a[None, :]
    ok0 = ok & (root0 >= T_MIN) & (root0 <= lim)
    ok1 = ok & (root1 >= T_MIN) & (root1 <= lim)
    sphere = (ok0 | ok1).any(dim=0)
    tri_ok, t, _, _ = _candidates(scene["instances"], o, d)
    tris = (tri_ok & (t <= t_max[:, None])).any(dim=1)
    return sphere | tris


# -- next-event estimation --------------------------------------------------

def _unit(x):
    """x / max(|x|, 1e-20) over the trailing axis."""
    return x / torch.clamp(sqrt(dot(x, x)), min=1e-20)[..., None]


def _div(x, s):
    """x / s, a Python number divided as a 0-dim tensor (the port's
    ``vec.div``)."""
    return x / x.new_full((), float(s))


def bsdf_pdf(lobe, n_unit, w):
    pdf_cos = torch.clamp(dot(w, n_unit), min=0.0) / math.pi
    return torch.where(lobe == 1, pdf_cos,
                       torch.where(lobe == 2, 1.0 / (2.0 * TAU), 0.0))


def sample_direct(scene, hits, lobe, u):
    """(direct radiance (N, 3) to weigh by throughput * attenuation, the
    lanes that took a light sample) of one uniformly picked light
    triangle, sampled by area, MIS-weighted, behind its shadow ray."""
    lights = scene["lights"]
    n_lights = lights["kind"].shape[0]
    capable = hits["hit"] & (lobe > 0)
    u_pick, u1, u2, _ = u
    li = torch.clamp((u_pick * n_lights).to(torch.int64), max=n_lights - 1)
    p0, e1, e2 = lights["p0"][li], lights["e1"][li], lights["e2"][li]
    emission, area = lights["emission"][li], lights["area"][li]
    p = hits["point"]
    n_unit = _unit(hits["normal"])
    su = sqrt(torch.clamp(u1, min=1e-12))
    b1 = 1.0 - su
    b2 = u2 * su
    x_tri = p0 + e1 * b1[:, None] + e2 * b2[:, None]
    tri_n = _unit(cross(e1, e2))
    to_tri = x_tri - p
    dist2 = dot(to_tri, to_tri)
    dist = sqrt(torch.clamp(dist2, min=1e-12))
    w = to_tri / dist[:, None]
    cos_p = dot(w, n_unit)
    cos_l = torch.abs(dot(w, tri_n))
    f = torch.where(lobe == 2, 1.0 / (2.0 * TAU), cos_p / math.pi)
    weight = f * cos_l * area / torch.clamp(dist2, min=1e-12)
    psa = dist2 / torch.clamp(cos_l * area, min=1e-12)
    valid = capable & (weight > 0.0)
    p_light = _div(psa, n_lights)
    p_b = bsdf_pdf(lobe, n_unit, w)
    w_mis = (p_light * p_light
             / torch.clamp(p_light * p_light + p_b * p_b, min=1e-20))
    weight = weight * w_mis
    shadow = blocked(scene, p, w,
                     torch.where(valid, dist - 1e-3, 1e-3))
    lit = (valid & ~shadow).to(torch.float32)
    direct = emission * (weight * float(n_lights))[:, None] * lit[:, None]
    return direct, valid


def mis_bsdf_weight(scene, hits, o, d, prev_pdf):
    """Power-heuristic weight of a light triangle's emission found by the
    BSDF continuation (o, d) chosen with solid-angle pdf prev_pdf."""
    n_lights = float(scene["lights"]["kind"].shape[0])
    d_len = torch.clamp(sqrt(dot(d, d)), min=1e-20)
    w = d / d_len[:, None]
    dist = torch.where(hits["hit"], hits["t"], 1.0) * d_len
    outward = torch.where(hits["front"][:, None], hits["normal"],
                          -hits["normal"])
    cos_l = torch.abs(dot(w, _unit(outward)))
    area = torch.clamp(hits["area"], min=0.0)
    psa = dist * dist / torch.clamp(cos_l * area, min=1e-12)
    p_light = _div(torch.where(hits["area"] > 0.0, psa, 0.0), n_lights)
    return (prev_pdf * prev_pdf
            / torch.clamp(prev_pdf * prev_pdf + p_light * p_light,
                          min=1e-20))


# -- the paths --------------------------------------------------------------

def trace(scene, pixel, sample, seed, width, height, max_depth, dt):
    """Radiance (N, 3) and scatter events (N,) of each (pixel, sample)
    path, traced to `max_depth` bounces; with the scene's light table,
    by next-event estimation with MIS."""
    o, d, ray_id = tracer.camera_rays(scene, pixel, sample, seed, width,
                                      height, dt)
    n = o.shape[0]
    radiance = torch.zeros((n, 3), dtype=torch.float64, device=o.device)
    events = torch.zeros((n,), dtype=torch.int64, device=o.device)
    throughput = torch.ones_like(o)
    prev_pdf = torch.zeros((n,), dtype=o.dtype, device=o.device)
    lane = torch.arange(n, device=o.device)
    m = scene["materials"]
    nee = "lights" in scene
    for b in range(max_depth):
        if lane.numel() == 0:
            break
        hits = intersect(scene, o, d)
        hit = hits["hit"]
        mtype = m["mtype"][hits["material"]]
        is_light = mtype == DIFFUSE_LIGHT
        emitted = torch.where(hit[:, None],
                              m["emit"][hits["material"]]
                              * is_light.to(dt)[:, None], 0.0)
        if nee:
            w_b = mis_bsdf_weight(scene, hits, o, d, prev_pdf)
            emitted = emitted * torch.where(is_light & (prev_pdf > 0.0),
                                            w_b, 1.0)[:, None]
        add = (torch.where(~hit[:, None], tracer.background(scene, d), 0.0)
               + torch.where(hit[:, None], emitted, 0.0))
        add = throughput * add
        u = tuple(x.to(dt) for x in draw4(seed, ray_id, 3 * b + 1,
                                          MIX_DRAWS))
        atten, new_dir, scat = tracer.scatter(scene, hits, d, u)
        if nee:
            lobe = ((mtype == LAMBERTIAN) & scat).to(torch.int32)
            u_nee = tuple(x.to(dt) for x in draw4(seed, ray_id,
                                                  NEE_SALT + 3 * b, 0))
            direct, did_nee = sample_direct(scene, hits, lobe, u_nee)
            add = add + torch.where(did_nee[:, None],
                                    throughput * atten * direct, 0.0)
            prev_pdf = bsdf_pdf(lobe, tracer.unit(hits["normal"]),
                                tracer.unit(new_dir))
        radiance[lane] += add.to(torch.float64)
        events[lane] += scat.to(torch.int64)
        keep = scat & (b + 1 < max_depth)
        lane, ray_id = lane[keep], ray_id[keep]
        o, d = hits["point"][keep], new_dir[keep]
        throughput = (throughput * atten)[keep]
        prev_pdf = prev_pdf[keep]
    return radiance, events


def film_at(scene, pixel, sample_start, samples, seed, width, height,
            max_depth, dtype=torch.float32, batch=1 << 15):
    """The film sums at `pixel` (K,) int64 of a pass of `samples` spp
    from sample `sample_start`: radiance (K, 3) float64 and bounce
    counts (K,) int64 (``tracer.film_at``'s, through this tracer)."""
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
