"""Port parity for the pending-deposit film mode and kernel B4's plain
version, and for Russian roulette (mrt_torch vs mrt).

Tolerances and why:
  - ``deposit_pending_plain`` against the TPU kernel
    ``mrt.ops.pallas_deposit.deposit_add`` in interpret mode: bit for
    bit.  The inputs make the sums exact in any order (values on a 1/8
    grid, or one lane a row), because the two add duplicate rows in
    different orders.
  - The port's pend film against its B2 film (``tests/test_deposit.py``'s
    cases; on the CPU both add in lane order): bounce counts exact, sums
    within 1e-5.  Against the JAX package's compiled pend render
    (``pend="interpret"``): C2's rule, at most 1% of pixels with another
    bounce count and every other pixel within 5e-4 (XLA contracts
    multiply-adds into FMAs; 9 of 2,048 rtiow pixels flip, cornell none).
  - Russian roulette: one bounce past rr_depth on the same rays of the
    reference's furnace (``tests/test_rr.py``) against the op-by-op JAX
    bounce (``jax.disable_jit``): survivors and bounce counts exact,
    throughputs within 1e-6.  Whole films of rtiow through each port
    integrator against the same compiled JAX integrator: C2's rule.  (In
    the furnace's 12-bounce paths, ulp-different sin and cos (C9) and the
    integrators' two camera roundings grow into flips on 1-3% of pixels
    between any two of the four integrators, JAX's two excepted; so the
    furnace is not held to C2's rule.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.integrator import wavefront as JW
from mrt.integrator.persistent import render_samples_chunked
from mrt.ops import pallas_deposit
from mrt.runtime.film import Film as JFilm
from mrt.runtime.render import render_pass as jrender_pass
from mrt.runtime.render import render_pass_persistent as jrender_persistent
from mrt.scenes import get as jget
from mrt_torch import convert
from mrt_torch.core.camera import Camera
from mrt_torch.integrator import persistent as TP
from mrt_torch.integrator import wavefront as TW
from mrt_torch.materials.table import MaterialTable
from mrt_torch.ops.deposit import deposit_pending, deposit_pending_plain
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass, render_pass_persistent
from mrt_torch.scenes import get as tget
from mrt_torch.utils import profiling
from test_rr import _camera as jfurnace_camera
from test_rr import _furnace as jfurnace

torch.set_num_threads(2)

POOL, SLOTS = 2048, 1024


def _inputs(rs, unique, pool=POOL, rate=0.35):
    """Random B4 inputs: a fraction `rate` of the `pool` lanes die, some
    dying lanes all zero, and (unless `unique`) many lanes on few rows."""
    slot = (rs.permutation(pool) % SLOTS if unique
            else rs.integers(0, 64, pool)).astype(np.int32)
    die = rs.random(pool) < rate
    if unique:
        die &= np.arange(pool) < SLOTS  # one dying lane a row
        slot[:SLOTS] = rs.permutation(SLOTS)
        val = rs.standard_normal((pool, 4)).astype(np.float32)
    else:
        val = (rs.integers(-64, 64, (pool, 4)) / 8.0).astype(np.float32)
    val[rs.random(pool) < 0.1] = 0.0
    dest = (rs.integers(-64, 64, (SLOTS, 4)) / 8.0).astype(np.float32)
    return dest, slot, val, die


@pytest.mark.parametrize("unique", [False, True])
def test_deposit_pending_plain_matches_deposit_add(unique):
    dest, slot, val, die = _inputs(np.random.default_rng(3 + unique), unique)
    want = np.asarray(pallas_deposit.deposit_add(
        jnp.asarray(dest), jnp.asarray(slot), jnp.asarray(val),
        jnp.asarray(die), interpret=True))
    got = deposit_pending_plain(torch.from_numpy(dest.copy()),
                                torch.from_numpy(slot), torch.from_numpy(val),
                                torch.from_numpy(die))
    assert got.numpy().tobytes() == want.tobytes()
    assert not np.array_equal(want, dest)
    # The wrapper takes the plain version on the CPU and checks its inputs.
    wrapped = deposit_pending(torch.from_numpy(dest.copy()),
                              torch.from_numpy(slot), torch.from_numpy(val),
                              torch.from_numpy(die))
    assert wrapped.numpy().tobytes() == want.tobytes()
    with pytest.raises(TypeError):
        deposit_pending(torch.from_numpy(dest), torch.from_numpy(slot),
                        torch.from_numpy(val), torch.from_numpy(die).int())
    with pytest.raises(ValueError, match="no kernel"):
        deposit_pending(*(torch.from_numpy(x).to("meta")
                          for x in (dest, slot, val, die)))


# (seed, death rate, pool): pools are whole multiples of the TPU
# kernel's 1,024-lane block.
RATES = [(5, 0.0, 1024), (6, 0.1, 1024), (7, 0.6, 2048), (8, 1.0, 3072),
         (9, 0.35, 4096)]


@pytest.mark.parametrize("seed,rate,pool", RATES,
                         ids=[f"seed{s}-rate{r}-pool{p}" for s, r, p in RATES])
def test_deposit_pending_plain_matches_deposit_add_at_death_rates(seed, rate,
                                                                  pool):
    dest, slot, val, die = _inputs(np.random.default_rng(seed), False, pool,
                                   rate)
    want = np.asarray(pallas_deposit.deposit_add(
        jnp.asarray(dest), jnp.asarray(slot), jnp.asarray(val),
        jnp.asarray(die), interpret=True))
    got = deposit_pending_plain(torch.from_numpy(dest.copy()),
                                torch.from_numpy(slot), torch.from_numpy(val),
                                torch.from_numpy(die))
    assert got.numpy().tobytes() == want.tobytes()
    assert np.array_equal(want, dest) == (rate == 0.0)


def test_pend_resolution(monkeypatch):
    monkeypatch.delenv("MRT_FILM_PEND", raising=False)
    assert TP.pend_enabled(None) is False
    assert TP.pend_enabled(True) and not TP.pend_enabled(False)
    monkeypatch.setenv("MRT_FILM_PEND", "1")
    assert TP.pend_enabled(None) and not TP.pend_enabled(False)
    monkeypatch.setenv("MRT_FILM_PEND", "0")
    assert not TP.pend_enabled(None)
    monkeypatch.setenv("MRT_FILM_PEND", "yes")
    assert not TP.pend_enabled(None)


CASES = [("rtiow", {}), ("cornell", {}), ("rtiow", {"rr_depth": 2})]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=["rtiow", "cornell", "rtiow-rr2"])
def test_pend_matches_scatter_and_reference(name, kw, monkeypatch):
    def make(get):
        return (get(name)(aspect_ratio=2.0) if name == "rtiow"
                else get(name)())

    ts, tc = make(tget).generate(device="cpu")
    w, h = 64, 32
    run = lambda pend: TP.render_samples_persistent(
        ts, tc, w, h, 1, 0, 2, max_depth=8, pool=POOL, pend=pend, **kw)
    # The environment resolves pend=None.
    monkeypatch.setenv("MRT_FILM_PEND", "1")
    launches = profiling.launch_counts["B4"]
    got_sum, got_depth = run(None)
    ref_sum, ref_depth = run(False)
    np.testing.assert_array_equal(got_depth.numpy(), ref_depth.numpy())
    np.testing.assert_allclose(got_sum.numpy(), ref_sum.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert profiling.launch_counts["B4"] == launches  # plain on the CPU

    js, jc = make(jget).generate()
    jsum, jdepth = render_samples_chunked(
        js, jc, w, h, seed=1, sample_start=0, samples=2, max_depth=8,
        pool=POOL, pend="interpret", **kw)
    flipped = got_depth.numpy() != np.asarray(jdepth)
    off = ~np.isclose(got_sum.numpy(), np.asarray(jsum), rtol=5e-4,
                      atol=5e-4).all(-1)
    assert flipped.mean() <= 0.01 and not (off & ~flipped).any(), (
        flipped.sum(), (off & ~flipped).sum())


def _port_furnace():
    js = jfurnace()
    scene = convert.scene_from_numpy(
        {k: np.asarray(getattr(js.spheres, k))
         for k in ("center", "radius", "material")},
        {k: np.asarray(getattr(js.materials, k))
         for k in MaterialTable.FIELDS},
        has_mix=js.has_mix, mix_depth=js.materials.mix_depth,
        background=np.asarray(js.background.color))
    jc = jfurnace_camera()
    camera = convert.camera_from_numpy(*(np.asarray(getattr(jc, k))
                                         for k in Camera.FIELDS))
    return scene, camera


def test_rr_bounce_matches_reference():
    # One bounce past rr_depth on the same rays and throughputs (spread
    # so that p_survive covers (0.05, 1]): the roulette's survivors, the
    # bounce counts and the reweighted throughputs of both packages.
    ts, _ = _port_furnace()
    js = jfurnace()
    rs = np.random.default_rng(8)
    n = 4096
    o = rs.uniform(-20, 20, (n, 3)).astype(np.float32)
    d = rs.standard_normal((n, 3)).astype(np.float32)
    tp = (rs.random((n, 3)) * 10.0 ** rs.uniform(-2, 0, (n, 1))).astype(
        np.float32)
    rid = rs.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    alive = rs.random(n) < 0.9
    state = (o, d, tp, np.zeros((n, 3), np.float32), alive,
             np.zeros(n, np.int32), np.zeros(n, np.float32))
    with jax.disable_jit():
        want = JW._bounce(js, jnp.asarray(rid), 5, jnp.int32(3),
                          tuple(map(jnp.asarray, state)), rr_depth=2)
    got = TW._bounce(ts, torch.from_numpy(rid.astype(np.int64)), 5, 3,
                     tuple(map(torch.from_numpy, state)), 2)
    w_cont, g_cont = np.asarray(want[4]), got[4].numpy()
    np.testing.assert_array_equal(g_cont, w_cont)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-7)
    # Roulette killed some scattered paths and reweighted the survivors.
    scattered_alive = alive & (np.linalg.norm(o, axis=1) < 50)
    assert (scattered_alive & ~g_cont).sum() > n // 10
    assert (got[2].numpy() > tp * 0.9 + 1e-6).any()


@pytest.mark.parametrize("integrator", ["wavefront", "persistent"])
def test_rr_films_match_reference(integrator):
    js, jc = jget("rtiow")(aspect_ratio=2.0).generate()
    ts, tc = tget("rtiow")(aspect_ratio=2.0).generate(device="cpu")
    w, h = 64, 32
    args = dict(width=w, height=h, max_depth=8, samples=2, rr_depth=2)
    if integrator == "wavefront":
        want = jrender_pass(js, jc, JFilm.create(w, h), 1, 0, **args)
        got = render_pass(ts, tc, Film.create(w, h, device="cpu"), 1, 0,
                          **args)
    else:
        want = jrender_persistent(js, jc, JFilm.create(w, h), 1, 0,
                                  pool=POOL, **args)
        got = render_pass_persistent(ts, tc, Film.create(w, h, device="cpu"),
                                     1, 0, pool=POOL, **args)
    flipped = got.depth_sum.numpy() != np.asarray(want.depth_sum)
    off = ~np.isclose(got.sum.numpy(), np.asarray(want.sum), rtol=5e-4,
                      atol=5e-4).all(-1)
    assert flipped.mean() <= 0.01 and not (off & ~flipped).any(), (
        flipped.sum(), (off & ~flipped).sum())
    # Roulette shortened the paths.
    no_rr = jrender_pass(js, jc, JFilm.create(w, h), 1, 0,
                         **dict(args, rr_depth=None))
    assert got.depth_sum.sum() < np.asarray(no_rr.depth_sum).sum()
