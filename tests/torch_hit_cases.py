"""Lanes for kernel H1's tests (L2's hit record: ``ops.hits``), on the
CPU (tests/test_torch_hit_kernel.py) and on the card
(tests/test_torch_gpu.py): the calls of ``Scene.intersect`` that a
persistent pass makes, recorded with their rays and bounds, and records
built from them where the sets tie, where the instances win by one ulp,
and where nothing is hit.  Imports no JAX."""

import contextlib
import dataclasses

import torch

from mrt_torch.geometry import scene as scene_mod
from mrt_torch.geometry.hit import Hits
from mrt_torch.integrator import persistent
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass_persistent
from mrt_torch.scenes import get

SCENES = ("rtiow", "sphere_grid", "cornell_nee")
FIELDS = tuple(f.name for f in dataclasses.fields(Hits))


def build(name, device):
    """(scene, camera) of `name`: a registered scene, "cornell_nee" the
    Cornell box with its light table."""
    nee = name == "cornell_nee"
    return get("cornell" if nee else name)(nee=nee).generate(device=device)


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


@contextlib.contextmanager
def recording(calls, keep):
    """Inside the block, Scene._intersect_once's k-th call (from 0) for
    each k in `keep` puts (o, d, t_min, t_max, shading_aux), cloned, into
    `calls`[k]."""
    real, count = scene_mod.Scene._intersect_once, [0]

    def spy(self, o, d, t_min, t_max, sampler, shading_aux):
        if count[0] in keep:
            calls[count[0]] = tuple(map(_clone, (o, d, t_min, t_max,
                                                 shading_aux)))
        count[0] += 1
        return real(self, o, d, t_min, t_max, sampler, shading_aux)

    scene_mod.Scene._intersect_once = spy
    try:
        yield calls
    finally:
        scene_mod.Scene._intersect_once = real


def recorded_calls(scene, camera, keep, width, height, pool, steps,
                   samples=1, max_depth=50):
    """{k: (o, d, t_min, t_max, shading_aux)} of the calls `keep` of a
    persistent pass over `scene` (stopped at the check after `steps`
    steps)."""
    busy = persistent.LanePool.busy
    device = scene.materials.mtype.device
    persistent.LanePool.busy = lambda self, st: (
        self.record["steps"] < steps and busy(self, st))
    try:
        with recording({}, set(keep)) as calls:
            render_pass_persistent(
                scene, camera, Film.create(width, height, device=device), 1,
                0, width=width, height=height, max_depth=max_depth,
                samples=samples, pool=pool)
    finally:
        persistent.LanePool.busy = busy
    assert sorted(calls) == sorted(keep), sorted(calls)
    return calls


def missing(scene, o, d):
    """Rays from outside the scene's bounds pointing away from it: no set
    hits them."""
    lo, hi = scene.world_bounds()
    away = torch.abs(d) + 0.25
    return (hi + 1.0 + torch.abs(o - lo)).contiguous(), away.contiguous()


def tied(sph, inst):
    """The winners with the instances' t set to the spheres' on half the
    lanes both sets hit (a tie: the spheres keep the lane) and one ulp
    below it on the other half (the instances take it).  Returns (the
    sphere winners, the instance winners, tie lanes, ulp lanes)."""
    t_s, t_i = sph[0], inst[0].clone()
    both = torch.nonzero(torch.isfinite(t_s) & torch.isfinite(t_i))[:, 0]
    tie, ulp = both[0::2], both[1::2]
    t_i[tie] = t_s[tie]
    t_i[ulp] = torch.nextafter(t_s[ulp], torch.full_like(t_s[ulp],
                                                         -float("inf")))
    return sph, (t_i, *inst[1:]), tie, ulp


def bits(x):
    """A float tensor's bits as int32 (so -0.0 and NaN compare exactly);
    any other tensor as it is."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def differing(got, want):
    """The record fields in which two Hits differ: dtype, shape or any
    bit on any lane."""
    out = []
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if (g.dtype != w.dtype or g.shape != w.shape
                or not torch.equal(bits(g), bits(w))):
            out.append(name)
    return out
