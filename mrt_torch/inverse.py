"""Inverse rendering: gradients of renders w.r.t. scene parameters
(mirrors ``mrt.inverse``).

``render_image`` traces the wavefront integrator's differentiable mode
(``trace_wavefront(differentiable=True)``: a fixed number of
checkpointed bounces), so autograd reaches the scene's tensors through
hit geometry, attenuation, emission, textures and backgrounds; discrete
path decisions (hit selection, Fresnel and Mix branches, the random
draws) are constants.  On the card the sphere winners still come from
kernel B1; their t gets its derivative from a recompute of the winning
root (``geometry.spheres.winner_t``).  Closest-hit routes the reference
walks in a while_loop (sphere and triangle BVHs, the TLAS, the voxel
DDA, mesh volumes) raise when their rays or geometry require grad.

Typical use: express the scene as a function of parameter tensors
(``Scene.replace``, ``MaterialTable.replace``, ...), render a small
image, take the gradient of a pixel loss, and descend with
``optimize``.
"""

from __future__ import annotations

import torch

from .integrator import wavefront
from .math import vec
from .math.rng import MASK, Sampler


def render_image(scene, camera, width, height, spp=4, seed=0, max_depth=6):
    """Differentiable mean-radiance image (H, W, 3) on the camera's
    device: `spp` samples a pixel, each its own camera draw, traced
    through `max_depth` bounces.  A fixed seed makes the loss a
    deterministic function of the parameters."""
    device = camera.origin.device
    n = width * height
    ray_id = torch.arange(n, dtype=torch.int64, device=device)
    px = (ray_id % width).to(torch.float32)
    py = (ray_id // width).to(torch.float32)

    acc = torch.zeros((n, 3), device=device)
    for s in range(spp):
        cam = Sampler(seed, (ray_id + ((0x9E3779B9 * s) & MASK)) & MASK,
                      salt=0xC0FFEE)
        jx, jy, du, dv = cam.next4()
        sx = vec.div(px + jx, width)
        ty = vec.div(py + jy, height)
        o, d = camera.rays(sx, ty, du, dv)
        salt = (s * 0x85EBCA6B) & MASK
        radiance, _ = wavefront.trace_wavefront(
            scene, o, d, ray_id ^ salt, seed, max_depth=max_depth,
            differentiable=True)
        acc = acc + radiance
    return vec.div(acc, spp).reshape(height, width, 3)


def l2_loss(img, target):
    return torch.mean((img - target) ** 2)


def make_loss(apply_fn, camera, width, height, target, spp=4, seed=0,
              max_depth=6):
    """loss(params): render apply_fn(params) (a Scene) and its L2
    distance to `target`."""
    def loss(params):
        img = render_image(apply_fn(params), camera, width, height, spp=spp,
                           seed=seed, max_depth=max_depth)
        return l2_loss(img, target)
    return loss


def _leaves(params):
    """The tensors of a tensor, or a tuple, list or dict of tensors, in
    a fixed order."""
    if torch.is_tensor(params):
        return [params]
    if isinstance(params, dict):
        return [params[k] for k in sorted(params)]
    return list(params)


def _rebuild(params, leaves):
    """`params`' structure around `leaves`."""
    if torch.is_tensor(params):
        return leaves[0]
    if isinstance(params, dict):
        return dict(zip(sorted(params), leaves))
    return type(params)(leaves)


def optimize(apply_fn, init_params, camera, width, height, target, *,
             steps=100, learning_rate=0.05, spp=4, seed=0, max_depth=6,
             optimizer=None, callback=None):
    """Gradient-descend scene parameters towards a target image.

    apply_fn: params -> Scene; init_params: a tensor, or a tuple, list or
    dict of tensors (copied: the caller's stay as they are); optimizer:
    a factory ``list of tensors -> torch.optim.Optimizer`` (None: Adam at
    `learning_rate`, whose defaults are optax.adam's: betas 0.9, 0.999,
    eps 1e-8); callback(i, params, loss) after each step.  Step i renders
    with seed `seed + i`, so the Monte Carlo gradient is unbiased across
    the trajectory.

    Returns (params, losses): the final parameters (detached, in
    init_params' structure) and each step's loss before its update."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in _leaves(init_params)]
    params = _rebuild(init_params, leaves)
    opt = (optimizer(leaves) if optimizer is not None
           else torch.optim.Adam(leaves, lr=learning_rate))
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        img = render_image(apply_fn(params), camera, width, height, spp=spp,
                           seed=seed + i, max_depth=max_depth)
        value = l2_loss(img, target)
        value.backward()
        opt.step()
        losses.append(float(value.detach()))
        if callback is not None:
            callback(i, _rebuild(init_params, [x.detach() for x in leaves]),
                     losses[-1])
    return _rebuild(init_params, [x.detach() for x in leaves]), losses
