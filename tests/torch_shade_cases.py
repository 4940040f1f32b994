"""A synthetic wavefront for L3 shading that reaches every material class
and every edge of ``materials.shade``'s eager composition, for the tests
of kernel M1 (``ops.shade``) and ``chip_smoke.py``.  Imports no JAX.

``wavefront(device)`` returns (table, args, parts): a material table of
every class M1 takes, the argument tuple of ``ops.shade.shade_lanes``
after the table (normal, front_face, material, hit, d_in, (u1, u2, u3,
u4)), and {case: slice of the lanes}.  ``check_edge(case, table, args,
out, part)`` asserts, on the eager composition's outputs `out`, that the
case's lanes reach the edge they were built for.
"""

import math

import torch

from mrt_torch.materials.table import MaterialBuilder
from mrt_torch.math import sampling, vec

LANES = 512  # a case
# The table's rows.
LAM, METAL, DIEL, LIGHT, ISO, SPEC, NULL, MIRROR, FUZZY = range(9)
EMIT = (4.0, 3.0, 2.0)


def table(device):
    b = MaterialBuilder()
    b.lambertian((0.8, 0.3, 0.2))
    b.metal(0.3, (0.7, 0.6, 0.5))
    b.dielectric(1.5)
    b.diffuse_light(EMIT)
    b.isotropic((0.5, 0.6, 0.7))
    b.specular(1.8, (0.2, 0.4, 0.9))
    b.null()
    b.metal(0.0, (0.9, 0.9, 0.9))
    b.metal(1.0, (0.6, 0.9, 0.3))
    return b.build().to(device)


def _uniforms(g, n):
    """Four (n,) uniforms on the sampler's grid (multiples of 2^-24)."""
    return [torch.randint(0, 1 << 24, (n,), generator=g).to(torch.float32)
            * 2.0 ** -24 for _ in range(4)]


def _units(g, n):
    return vec.unit(torch.randn((n, 3), generator=g))


def _rows(g, n, choices):
    pick = torch.randint(0, len(choices), (n,), generator=g)
    return torch.tensor(choices, dtype=torch.int32)[pick]


def _case(g, name, n):
    """One case's lanes on the CPU: a dict of the shading inputs."""
    u = _uniforms(g, n)
    normal = _units(g, n)
    d = _units(g, n) * (0.5 + 2.0 * torch.rand((n, 1), generator=g))
    front = torch.rand((n,), generator=g) < 0.5
    hit = torch.ones((n,), dtype=torch.bool)
    every = list(range(9))
    rows = _rows(g, n, every)
    a = 2.0 * math.pi * torch.rand((n,), generator=g)
    if name == "random":
        hit = torch.rand((n,), generator=g) < 0.9
    elif name == "lambertian_near_zero":
        # normal = -(the Lambertian's random unit vector): the sum is
        # (near) zero and the normal is taken instead.
        rows = _rows(g, n, [LAM, SPEC])
        u[3] = torch.ones((n,))  # Specular: Schlick never reflects
        front = torch.ones((n,), dtype=torch.bool)
        normal = -sampling.unit_vector(u[0], u[1])
        d = -normal
    elif name == "metal_below_horizon":
        # A grazing ray fuzzed downwards: u1 near 1 points the fuzz along
        # -z, under the normal (0, 0, 1).
        rows = _rows(g, n, [METAL, FUZZY])
        u[0] = 1.0 - torch.randint(1, 1 << 20, (n,), generator=g).to(
            torch.float32) * 2.0 ** -24
        u[2] = 0.5 + 0.5 * u[2]
        normal = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3).clone()
        d = torch.stack([torch.cos(a), torch.sin(a),
                         torch.full((n,), -0.02)], dim=-1)
    elif name == "dielectric_tir":
        # From inside (ratio = ior) at a grazing angle: total internal
        # reflection.
        rows = _rows(g, n, [DIEL, SPEC])
        front = torch.zeros((n,), dtype=torch.bool)
        normal = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3).clone()
        d = torch.stack([torch.cos(a), torch.sin(a),
                         torch.full((n,), -0.3)], dim=-1)
    elif name == "faces":
        # Near the normal from either side: refraction and Schlick's
        # reflection both occur.
        rows = _rows(g, n, [DIEL, SPEC])
        d = -normal + 0.3 * _units(g, n)
    elif name == "u3_zero":
        rows = _rows(g, n, [ISO, METAL, FUZZY])
        u[2] = torch.zeros((n,))
    elif name == "misses":
        hit = torch.zeros((n,), dtype=torch.bool)
    elif name == "null_and_light":
        rows = _rows(g, n, [NULL, LIGHT])
    else:
        raise ValueError(name)
    return dict(normal=normal, front_face=front, material=rows, hit=hit,
                d_in=d, u=u)


CASES = ("random", "lambertian_near_zero", "metal_below_horizon",
         "dielectric_tir", "faces", "u3_zero", "misses", "null_and_light")


def wavefront(device, seed=20):
    g = torch.Generator().manual_seed(seed)
    cases = [_case(g, name, LANES) for name in CASES]
    cat = lambda k: torch.cat([c[k] for c in cases]).contiguous().to(device)
    u = tuple(torch.cat([c["u"][k] for c in cases]).contiguous().to(device)
              for k in range(4))
    args = (cat("normal"), cat("front_face"), cat("material"), cat("hit"),
            cat("d_in"), u)
    parts = {name: slice(k * LANES, (k + 1) * LANES)
             for k, name in enumerate(CASES)}
    return table(device), args, parts


def check_edge(case, tab, args, out, part):
    """Assert that the case's lanes reach their edge in `out`, the eager
    composition's (emitted, attenuation, new_direction, scattered,
    lobe)."""
    normal, front, rows, hit, d_in, u = (
        a[part] if torch.is_tensor(a) else tuple(x[part] for x in a)
        for a in args)
    e, atten, new_dir, scattered, lobe = (x[part] for x in out)
    mirror = vec.reflect(vec.unit(d_in), normal)
    if case == "random":
        for row in range(9):
            assert (rows == row).any(), row
        assert (~hit).any() and hit.any()
    elif case == "lambertian_near_zero":
        lam = rows == LAM
        assert lam.any() and (rows == SPEC).any()
        assert torch.equal(new_dir, normal)
        assert (lobe == 1).all()
    elif case == "metal_below_horizon":
        assert not scattered.any()
        assert (lobe == 0).all()
    elif case == "dielectric_tir":
        assert torch.equal(new_dir, mirror)
        assert (atten == 1.0).all() and scattered.all()
    elif case == "faces":
        reflected = (new_dir == mirror).all(dim=-1)
        for face in (True, False):
            on = front == face
            assert (reflected & on).any() and (~reflected & on).any(), face
    elif case == "u3_zero":
        iso = rows == ISO
        assert iso.any()
        r = vec.length(new_dir[iso])
        assert ((r > 0.0) & (r < 0.004)).all()
    elif case == "misses":
        assert (e == 0.0).all() and not scattered.any()
        assert (lobe == 0).all()
    elif case == "null_and_light":
        light = rows == LIGHT
        assert light.any() and (rows == NULL).any()
        assert not scattered.any() and (lobe == 0).all()
        assert (atten == 1.0).all()
        want = torch.tensor(EMIT, device=e.device) * light[:, None]
        assert torch.equal(e, want)
    else:
        raise ValueError(case)
