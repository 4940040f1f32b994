"""Port parity: the AOV pre-pass (``mrt_torch.integrator.aov``, through
``runtime.render.aov_pass``) against ``mrt.integrator.aov``.

The same scenes (rtiow grid 5, cornell, sphere_grid dim 8: B1, the
TLAS, B5 and B7's plain versions on the CPU) at 24x24, seed 3, in one
batch and, with both packages' RAY_BATCH patched to 256, in three (the
port's last batch short, the reference's padded).  Cornell's cases are
in tests/test_torch_aov_cornell.py (its op-by-op JAX traversal takes
most of a file's time).

Tolerances and why:
  - Against op-by-op JAX (``jax.disable_jit``): within 1e-5 everywhere
    (measured: equal, cornell's normals within 6e-8).  Cornell's camera
    is built with XLA's tan, the one ulp of ROADMAP C8.
  - Against compiled JAX: C2's rule, at most 1% of pixels with an albedo
    or normal more than 5e-4 away.  Cornell at 24x24 puts pixel centres
    on the room's corner diagonals, where the walls tie; compiled JAX
    there picks another wall than op-by-op JAX on 11 of 576 pixels
    (1.9%), and the port agrees with op-by-op JAX.  So for cornell the
    pixels outside 5e-4 must be exactly those where compiled and op-by-op
    JAX differ (ROADMAP C19).
  - The port's batched and unbatched frames are bit-equal: a lane's
    result does not depend on its batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt.integrator import aov as JAOV
from mrt.integrator import wavefront as JW
from mrt.scenes import get as jget
from mrt_torch.integrator import wavefront as TW
from mrt_torch.runtime.render import aov_pass
from mrt_torch.scenes import get as tget

torch.set_num_threads(2)

SIZE = 24
SEED = 3
SCENES = {"rtiow": dict(grid=5), "cornell": {}, "sphere_grid": dict(dim=8)}


def _xla_tan(x):
    return torch.tensor(np.asarray(jnp.tan(jnp.asarray(x.numpy()))))


def _port_scene(name, monkeypatch):
    with monkeypatch.context() as m:
        if name == "cornell":
            m.setattr(torch, "tan", _xla_tan)
        return tget(name)(aspect_ratio=1.0, **SCENES[name]).generate(
            device="cpu")


def _jax_frame(scene, camera):
    # A new function each call, so a new trace: RAY_BATCH is read while
    # tracing.
    fn = jax.jit(lambda s, c: JAOV.albedo_normal_frame(s, c, SIZE, SIZE,
                                                       SEED))
    return tuple(np.asarray(x) for x in fn(scene, camera))


_EAGER = {}


def _jax_eager(name, scene, camera):
    if name not in _EAGER:
        with jax.disable_jit():
            _EAGER[name] = tuple(np.asarray(x) for x in
                                 JAOV.albedo_normal_frame(scene, camera, SIZE,
                                                          SIZE, seed=SEED))
    return _EAGER[name]


def _off(a, b, tol=5e-4):
    """(H, W) pixels whose albedo or normal is more than tol apart."""
    return ((np.abs(a[0] - b[0]).max(-1) > tol)
            | (np.abs(a[1] - b[1]).max(-1) > tol))


def check_aov_frame(name, batch, monkeypatch):
    """The port's frame of scene `name` (RAY_BATCH `batch`, None: the
    default) against op-by-op and compiled JAX."""
    if batch is not None:
        monkeypatch.setattr(JW, "RAY_BATCH", batch)
        monkeypatch.setattr(TW, "RAY_BATCH", batch)
    js, jc = jget(name)(aspect_ratio=1.0, **SCENES[name]).generate()
    ts, tc = _port_scene(name, monkeypatch)
    port = tuple(x.numpy() for x in aov_pass(ts, tc, width=SIZE, height=SIZE,
                                              seed=SEED))
    assert port[0].shape == port[1].shape == (SIZE, SIZE, 3)
    assert np.isfinite(port[0]).all() and np.isfinite(port[1]).all()
    # A frame that misses everything tests little.
    hit = np.abs(port[1]).sum(-1) > 0
    assert 0.05 < hit.mean() <= 1.0

    eager = _jax_eager(name, js, jc)
    for want, got in zip(eager, port):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    compiled = _jax_frame(js, jc)
    off = _off(port, compiled)
    if name == "cornell":
        np.testing.assert_array_equal(off, _off(eager, compiled))
    else:
        assert off.sum() <= SIZE * SIZE // 100, off.sum()

    if batch is not None:
        monkeypatch.setattr(TW, "RAY_BATCH", 1 << 17)
        whole = aov_pass(ts, tc, width=SIZE, height=SIZE, seed=SEED)
        for a, b in zip(whole, port):
            assert a.numpy().tobytes() == b.tobytes()


@pytest.mark.parametrize("batch", [None, 256])
@pytest.mark.parametrize("name", ["rtiow", "sphere_grid"])
def test_aov_frame_matches_reference(name, batch, monkeypatch):
    check_aov_frame(name, batch, monkeypatch)
