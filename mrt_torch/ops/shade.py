"""Kernel M1, L3 shading (``csrc/shade.cu``): emission and scatter of a
wavefront on a material table with no texture atlas and no Mix rows, in
one launch.

``shade_lanes(table, normal, front_face, material, hit, d_in, u)``
returns what ``materials.shade.shade_hit`` returns for such a table,
(emitted (N,3), attenuation (N,3), new_direction (N,3), scattered (N,)
bool, lobe (N,) int32), bit for bit, given the four uniforms `u` of the
scatter sampler's ``next4``.  On CPU tensors it runs its plain version
``shade_lanes_plain``, that eager composition with the kernel's
arguments; on CUDA tensors it launches the kernel; it raises on any
other device.  ``shade_hit`` runs its eager composition where M1 does
not apply.

table: a ``MaterialTable`` whose columns ``mtype`` (M,) int32, ``albedo``
(M, 4), ``fuzz`` and ``ior`` (M,), ``emit`` (M, 3) float32 are read as
they are; the hits' ``normal`` (N, 3) float32, ``front_face`` and
``hit`` (N,) bool and ``material`` (N,) int32; d_in (N, 3) float32; u:
four (N,) float32.  Every tensor contiguous, on one device.  M1 replaces
no Pallas kernel (the reference shades in XLA).
"""

from __future__ import annotations

import types

import torch

from . import _build


def _refuse(name, x, dtype, shape, device):
    """Raise for an argument that fails shade_lanes' check."""
    if x.dtype != dtype:
        raise TypeError(f"shade_lanes: {name} is {x.dtype}, not {dtype}")
    if x.shape != shape or x.device != device:
        raise ValueError(f"shade_lanes: {name} {tuple(x.shape)} on "
                         f"{x.device}, expected {tuple(shape)} on {device}")
    raise ValueError(f"shade_lanes: {name} is not contiguous")


def shade_lanes(table, normal, front_face, material, hit, d_in, u):
    """M1: (emitted, attenuation, new_direction, scattered, lobe).
    Raises on an argument it does not take (TypeError on a dtype,
    ValueError on a shape, device or layout), then on a device with no
    kernel."""
    n, rows = d_in.shape[0], table.mtype.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    if len(u) != 4:
        raise ValueError(f"shade_lanes: {len(u)} uniforms, not 4")
    # The checks run every step: one expression a tensor on the way
    # through, the reason found only for a refusal.
    index = d_in.get_device()
    for name, x, dtype, shape in (
            ("mtype", table.mtype, i32, (rows,)),
            ("albedo", table.albedo, f32, (rows, 4)),
            ("fuzz", table.fuzz, f32, (rows,)),
            ("ior", table.ior, f32, (rows,)),
            ("emit", table.emit, f32, (rows, 3)),
            ("normal", normal, f32, (n, 3)),
            ("front_face", front_face, b8, (n,)),
            ("material", material, i32, (n,)),
            ("hit", hit, b8, (n,)),
            ("d_in", d_in, f32, (n, 3)),
            ("u1", u[0], f32, (n,)), ("u2", u[1], f32, (n,)),
            ("u3", u[2], f32, (n,)), ("u4", u[3], f32, (n,))):
        if not (x.dtype is dtype and x.shape == shape
                and x.get_device() == index and x.is_contiguous()):
            _refuse(name, x, dtype, shape, d_in.device)
    device = d_in.device
    if device.type == "cpu":
        return shade_lanes_plain(table, normal, front_face, material, hit,
                                 d_in, u)
    if device.type != "cuda":
        raise ValueError(f"shade_lanes: no kernel for device {device}")
    emitted, atten, new_dir = torch.empty((3, n, 3), dtype=f32,
                                          device=device).unbind(0)
    scattered = torch.empty((n,), dtype=torch.bool, device=device)
    lobe = torch.empty((n,), dtype=torch.int32, device=device)
    _build.launch("mrt_shade", device, table.mtype, table.albedo, table.fuzz,
                  table.ior, table.emit, rows, normal, front_face, material,
                  hit, d_in, *u, n, emitted, atten, new_dir, scattered, lobe)
    return emitted, atten, new_dir, scattered, lobe


class _Drawn:
    """A sampler whose next4 returns uniforms already drawn."""

    def __init__(self, u):
        self.u = tuple(u)

    def next4(self):
        return self.u


def shade_lanes_plain(table, normal, front_face, material, hit, d_in, u):
    """Plain PyTorch version of M1, on any device: ``shade_hit``'s eager
    composition for a table with no atlas and no Mix rows
    (``materials.shade.shade_rows``), its scatter drawing `u`."""
    from ..materials import shade

    scene = types.SimpleNamespace(materials=table, atlas=None)
    hits = types.SimpleNamespace(normal=normal, front_face=front_face,
                                 material=material, hit=hit)
    return shade.shade_rows(scene, hits, d_in, _Drawn(u))
