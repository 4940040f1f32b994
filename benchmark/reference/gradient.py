"""A plain autograd of the gradient cell's loss, and its Adam steps.

The image is the port's ``inverse.render_image`` estimator (frozen
copy): spp 1, each pixel's camera ray from draw 0 of its own stream, a
fixed number of bounces of the wavefront integrator, the mean radiance;
the loss is the mean squared distance to a target image.  Sphere
winners are found without a graph (``tracer.nearest_sphere``) and their
root recomputed under autograd in the scan's expression (the port's
``winner_root``), so the value is the search's and the derivative the
root's.  Parameters: the material table's albedo rows (M, 4) and the
sphere centres (S, 3).  The image is computed in blocks of pixels whose
losses are back-propagated one by one, so that memory stays bounded.
"""

from __future__ import annotations

import torch

from . import tracer
from .tracer import INF, T_MIN, dot, draw4, sqrt


def winner_t(c, r, o, d, t, hit):
    """The search's t, with the derivative of the winning root."""
    od, oo, a = dot(o, d), dot(o, o), dot(d, d)
    half_b = od - dot(c, d)
    c_term = (oo - 2.0 * dot(c, o)) + (dot(c, c) - r * r)
    disc = half_b * half_b - a * c_term
    ok = hit & (disc > 0.0) & (r != 0.0)
    sq = torch.where(ok, sqrt(torch.where(ok, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    root0 = (-half_b - sq) * inv_a
    root1 = (-half_b + sq) * inv_a
    t_r = torch.where(hit, torch.where(root0 >= T_MIN, root0, root1), 0.0)
    return t + (t_r - t_r.detach())


def sphere_hits(scene, o, d):
    sph = scene["spheres"]
    with torch.no_grad():
        t, i = tracer.nearest_sphere(sph, scene["root"], o.detach(),
                                     d.detach())
    hit = torch.isfinite(t)
    c = sph["center"].index_select(0, i)
    r = sph["radius"].index_select(0, i)
    t = winner_t(c, r, o, d, t, hit)
    point = o + d * torch.where(hit, t, 0.0)[:, None]
    normal, front = tracer.face(d, (point - c) / r[:, None])
    return dict(t=torch.where(hit, t, INF), hit=hit, point=point,
                normal=normal, front=front, material=sph["material"][i])


def radiance(scene, pixel, seed, width, height, max_depth, dt):
    """Radiance (N, 3) of each pixel's spp-1 path (sample 0)."""
    px = (pixel % width).to(torch.float32)
    py = (pixel // width).to(torch.float32)
    jx, jy, du, dv = (x.to(dt) for x in draw4(seed, pixel, 0xC0FFEE, 0))
    s = (px.to(dt) + jx) / torch.tensor(float(width), dtype=dt,
                                        device=pixel.device)
    t = (py.to(dt) + jy) / torch.tensor(float(height), dtype=dt,
                                        device=pixel.device)
    o, d = tracer.lens(scene["camera"], s, t, du, dv)
    throughput = torch.ones_like(o)
    rad = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    m = scene["materials"]
    for b in range(max_depth):
        hits = sphere_hits(scene, o, d)
        u = tuple(x.to(dt) for x in draw4(seed, pixel, 3 * b + 1,
                                          tracer.MIX_DRAWS))
        atten, new_dir, scattered = tracer.scatter(scene, hits, d, u)
        rows = hits["material"]
        light = (m["mtype"][rows] == tracer.DIFFUSE_LIGHT).to(dt)[:, None]
        emitted = torch.where(hits["hit"][:, None], m["emit"][rows] * light,
                              0.0)
        hit = hits["hit"] & alive
        miss = ~hits["hit"] & alive
        contrib = (torch.where(miss[:, None], tracer.background(scene, d), 0.0)
                   + torch.where(hit[:, None], emitted, 0.0))
        rad = rad + throughput * contrib
        cont = hit & scattered
        c3 = cont[:, None]
        throughput = torch.where(c3, throughput * atten, throughput)
        o = torch.where(c3, hits["point"], o)
        d = torch.where(c3, new_dir, d)
        alive = cont
    return rad


def with_params(scene, albedo, centre):
    m = dict(scene["materials"], albedo=albedo[:, :3])
    return dict(scene, materials=m, spheres=dict(scene["spheres"],
                                                 center=centre))


def loss_and_grad(scene, leaves, target, seed, width, height, max_depth, dt,
                  block, fault=None):
    """The loss (a float) and, accumulated in the leaves' .grad, its
    gradient; `target` (H * W, 3).  `fault` plants one for the control's
    readings: "half" leaves out every other pixel (the mean taken over
    the rest), "altered" scales the image by 1.01 where it is made."""
    pixel = torch.arange(width * height, device=target.device)
    if fault == "half":
        pixel = pixel[::2]
    n = pixel.shape[0]
    total = 0.0
    for s in range(0, n, block):
        sc = with_params(scene, *leaves)
        at = pixel[s:s + block]
        img = radiance(sc, at, seed, width, height, max_depth, dt)
        if fault == "altered":
            img = img * 1.01
        part = ((img - target[at]) ** 2).sum() / (3 * n)
        part.backward()
        total += float(part.detach().to(torch.float64))
    return total


def target_image(scene, seed, width, height, max_depth, dt, block):
    pixel = torch.arange(width * height, device=scene["camera"]["u"].device)
    with torch.no_grad():
        return torch.cat([radiance(scene, pixel[s:s + block], seed, width,
                                   height, max_depth, dt)
                          for s in range(0, pixel.shape[0], block)])


def adam_steps(scene, init, target, seed, steps, lr, width, height,
               max_depth, dt=torch.float32, block=1 << 18, fault=None,
               adam=None):
    """`steps` Adam steps from `init` (albedo, centre) and, where given,
    Adam's state `adam` (a state dict's "state": moments and step count
    by leaf), step i at render seed ``seed + i``: each step's loss, the
    first step's gradient of each leaf, and each leaf's change after the
    steps."""
    leaves = [x.detach().clone().to(dt).requires_grad_(True) for x in init]
    opt = torch.optim.Adam(leaves, lr=lr)
    if adam:
        state = opt.state_dict()
        state["state"] = {j: {k: v.clone() for k, v in s.items()}
                          for j, s in adam.items()}
        opt.load_state_dict(state)  # the moments cast to the leaves' dt
    losses, first = [], None
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        losses.append(loss_and_grad(scene, leaves, target, seed + i, width,
                                    height, max_depth, dt, block, fault))
        if first is None:
            first = [x.grad.detach().clone() for x in leaves]
        opt.step()
    change = [(x.detach() - x0.to(dt)) for x, x0 in zip(leaves, init)]
    return dict(losses=losses, grads=first, changes=change)
