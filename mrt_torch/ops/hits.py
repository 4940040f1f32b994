"""Kernel H1, L2 intersection (``csrc/hits.cu``): a scene's whole hit
record from its primitive sets' winners, in one launch.

``hit_record(o, d, spheres, sphere_hits, tlas, instance_hits)`` returns
what ``Scene.intersect``'s eager chain returns for a scene whose sets are
a sphere set and instanced meshes: ``Hits.none``, then the spheres'
record (``geometry.spheres.make_hits`` of `sphere_hits`, B1's or B5's
(t, index)), then the instances' (``geometry.instance.expand_winner`` of
`instance_hits`, B7's or the flat parts' (t, instance, triangle, u, v)),
each merged by ``Hits.closer_of``; bit for bit, every column on every
lane.  Either set may be None.  On CPU tensors it runs its plain version
``hit_record_plain``, that eager chain with the kernel's arguments; on
CUDA tensors it launches the kernel; it raises on any other device.
Neither records an autograd graph: ``Scene.intersect`` takes the eager
chain where autograd records through the rays or the spheres.

o, d: (N, 3) float32; sphere_hits: t (N,) float32, index (N,) int32;
instance_hits: t, u, v (N,) float32, instance, triangle (N,) int32; every
one contiguous, on one device.  The tables read are the sphere set's
``center`` (S, 3), ``radius`` (S,) float32 and ``material`` (S,) int32,
and the TLAS's ``shading`` (T, 29), ``transform`` (I, 4, 4) float32 and
``override`` (I,) int32, contiguous, on the rays' device; they are
checked once until one of them changes (its data pointer or its version
counter: a ``replace``, a move or an in-place edit).  The record's
columns are contiguous, in three allocations (floats, flags, materials).
H1 replaces no Pallas kernel (the reference builds its records in XLA).
"""

from __future__ import annotations

import torch

from . import _build

F32, I32 = torch.float32, torch.int32
# The record's float columns in their one allocation, by rows of n:
# point, normal, tangent and bitangent (3 each), uv (2), t, prim_area.
_FLOAT_ROWS = 16


def _refuse(name, x, dtype, shape, device):
    """Raise for an argument that fails hit_record's check."""
    if x.dtype != dtype:
        raise TypeError(f"hit_record: {name} is {x.dtype}, not {dtype}")
    if x.shape != shape or x.device != device:
        raise ValueError(f"hit_record: {name} {tuple(x.shape)} on "
                         f"{x.device}, expected {tuple(shape)} on {device}")
    raise ValueError(f"hit_record: {name} is not contiguous")


def _check(args, index, device):
    """Raise unless each (name, tensor, dtype, shape) is contiguous, of
    its dtype and shape, on the device whose index is `index`."""
    for name, x, dtype, shape in args:
        if not (x.dtype is dtype and x.shape == shape
                and x.get_device() == index and x.is_contiguous()):
            _refuse(name, x, dtype, shape, device)


def _rows(x):
    return x.shape[0] if x.dim() else -1


def _sphere_tables(center, radius, material):
    s = _rows(center)
    return (("center", center, F32, (s, 3)), ("radius", radius, F32, (s,)),
            ("material", material, I32, (s,)))


def _tlas_tables(shading, transform, override):
    i = _rows(transform)
    return (("shading", shading, F32, (_rows(shading), 29)),
            ("transform", transform, F32, (i, 4, 4)),
            ("override", override, I32, (i,)))


_SPHERE_TABLES = (("center", "radius", "material"), _sphere_tables)
_TLAS_TABLES = (("shading", "transform", "override"), _tlas_tables)


def _tables(owner, kind, index, device):
    """The tables of `owner` (a sphere set or a TLAS; `kind`, their names
    and their check), checked unless they passed the check unchanged on
    this device before."""
    names, spec = kind
    tables = [getattr(owner, name) for name in names]
    key = (index, *((x.data_ptr(), x._version) for x in tables))
    if owner.__dict__.get("_hit_record_checked") != key:
        _check(spec(*tables), index, device)
        owner.__dict__["_hit_record_checked"] = key
    return tables


def hit_record(o, d, spheres=None, sphere_hits=None, tlas=None,
               instance_hits=None):
    """H1: a ``geometry.hit.Hits``.  Raises on an argument it does not
    take (TypeError on a dtype, ValueError on a shape, device or layout,
    or on winners without their set), then on a device with no kernel."""
    from ..geometry.hit import Hits

    n, device = o.shape[0], o.device
    index = o.get_device()
    lane, ray = (n,), (n, 3)
    args = [("o", o, F32, ray), ("d", d, F32, ray)]
    if (sphere_hits is None) != (spheres is None) or (
            (instance_hits is None) != (tlas is None)):
        raise ValueError("hit_record: a set's winners come with its tables "
                         "(spheres with sphere_hits, tlas with "
                         "instance_hits)")
    if sphere_hits is not None:
        args += [("sphere t", sphere_hits[0], F32, lane),
                 ("sphere index", sphere_hits[1], I32, lane)]
    if instance_hits is not None:
        args += [(name, x, dtype, lane) for name, x, dtype in zip(
            ("instance t", "instance", "triangle", "u", "v"), instance_hits,
            (F32, I32, I32, F32, F32))]
    _check(args, index, device)
    sph = (_tables(spheres, _SPHERE_TABLES, index, device)
           if spheres is not None else None)
    tl = _tables(tlas, _TLAS_TABLES, index, device) if tlas is not None \
        else None
    if device.type == "cpu":
        return hit_record_plain(o, d, spheres, sphere_hits, tlas,
                                instance_hits)
    if device.type != "cuda":
        raise ValueError(f"hit_record: no kernel for device {device}")
    floats = torch.empty((_FLOAT_ROWS, n), dtype=F32, device=device)
    point, normal, tangent, bitangent = floats[:12].view(4, n, 3).unbind(0)
    uv = floats[12:14].view(n, 2)
    t, prim_area = floats[14:].unbind(0)
    front_face, hit = torch.empty((2, n), dtype=torch.bool,
                                  device=device).unbind(0)
    material = torch.empty((n,), dtype=I32, device=device)
    sph_args = ((*sphere_hits, *sph, sph[0].shape[0]) if sph is not None
                else (None,) * 5 + (0,))
    inst_args = ((*instance_hits, tl[0], tl[0].shape[0], tl[1], tl[2],
                  tl[1].shape[0]) if tl is not None
                 else (None,) * 6 + (0, None, None, 0))
    _build.launch("mrt_hit_record", device, o, d, n, *sph_args, *inst_args,
                  t, point, normal, front_face, uv, material, hit, tangent,
                  bitangent, prim_area)
    return Hits(t=t, point=point, normal=normal, front_face=front_face,
                uv=uv, material=material, hit=hit, tangent=tangent,
                bitangent=bitangent, prim_area=prim_area)


def hit_record_plain(o, d, spheres=None, sphere_hits=None, tlas=None,
                     instance_hits=None):
    """Plain PyTorch version of H1, on any device: ``Scene.intersect``'s
    eager chain over the winners, ``Hits.none`` merged with
    ``make_hits(spheres, o, d, *sphere_hits)`` and then with
    ``expand_winner(tlas, o, d, *instance_hits)``, recording no autograd
    graph."""
    from ..geometry import instance
    from ..geometry import spheres as sphere_mod
    from ..geometry.hit import Hits

    with torch.no_grad():  # make_hits' t_min serves only its derivative
        hits = Hits.none(o.shape[0], device=o.device)
        if sphere_hits is not None:
            hits = hits.closer_of(sphere_mod.make_hits(
                spheres, o, d, *sphere_hits, t_min=0.0))
        if instance_hits is not None:
            hits = hits.closer_of(instance.expand_winner(
                tlas, o, d, *instance_hits))
    return hits
