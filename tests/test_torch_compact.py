"""Port parity: masked lane compaction (``mrt_torch.ops.compact``, kernels
B2 and B3 through their plain versions on the CPU) against
``mrt.ops.compact``, and the compacted background and texel fetches on
the eve fleet (mrt_torch vs mrt).

Tolerances and why: compaction only moves values, and one value lands
in each row (B2 adds it to an exact zero), so every comparison is
bit-equal:
  - ``compact_rows`` against JAX's, through its one-hot Pallas kernel
    in interpret mode (``MRT_ONEHOT=interpret``) and through its XLA
    matmul path (``MRT_ONEHOT=xla``), on a table with exponents from
    1e-20 to 1e20;
  - ``compact_apply`` (ceil(P / K) rounds fixed on the host) against
    JAX's (a while loop), against an exact loop that stops when no lane
    is left, and against the uncompacted ``where(mask, fn(x), 0)``;
  - the eve fleet's film with ``MRT_BG_COMPACT`` and ``MRT_TEX_COMPACT``
    set to 1 against the film with them set to 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrt.ops import compact as JC
from mrt_torch.ops import compact as TC
from mrt_torch.runtime.film import Film
from mrt_torch.runtime.render import render_pass_persistent
from mrt_torch.scenes import get

torch.set_num_threads(2)


def _wide(rng, p, c):
    return (rng.standard_normal((p, c))
            * 10.0 ** rng.integers(-20, 20, (p, c))).astype(np.float32)


def test_compact_roundtrip_bit_exact():
    rng = np.random.default_rng(11)
    p, k = 2048, 512
    x = _wide(rng, p, 5)
    mask = rng.random(p) < 0.2
    xc, pos, count = TC.compact_rows(torch.from_numpy(mask),
                                     torch.from_numpy(x), k)
    assert int(count) == mask.sum()
    np.testing.assert_array_equal(xc.numpy()[:int(count)], x[mask])
    assert not xc.numpy()[int(count):].any()
    out = TC.expand_rows(xc, pos, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out[mask], x[mask])
    assert (out[~mask] == 0.0).all()


@pytest.mark.parametrize("onehot", ["interpret", "xla"])
def test_compact_rows_matches_reference(monkeypatch, onehot):
    monkeypatch.setenv("MRT_ONEHOT", onehot)
    rng = np.random.default_rng(12)
    p, k = 1024, 256
    x = _wide(rng, p, 3)
    x[5] = np.nan  # an unmasked NaN row cannot leak into the others
    mask = rng.random(p) < 0.2
    mask[5] = False
    pad = np.asarray([1.0, 0.0, 0.0], np.float32)
    want = JC.compact_rows(jnp.asarray(mask), jnp.asarray(x), k,
                           pad_row=jnp.asarray(pad))
    got = TC.compact_rows(torch.from_numpy(mask), torch.from_numpy(x), k,
                          pad_row=pad)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


def _fn(v):
    """Row-wise, and rounded the same way by XLA and PyTorch."""
    return v[:, 0:2] * v[:, 1:3] + 3.0


@pytest.mark.parametrize("onehot", ["interpret", "xla"])
@pytest.mark.parametrize("frac", [0.1, 0.9])
def test_compact_apply_matches_reference(monkeypatch, onehot, frac):
    # frac 0.9 overflows K: four rounds.
    monkeypatch.setenv("MRT_ONEHOT", onehot)
    rng = np.random.default_rng(3)
    p, k = 1024, 256
    x = rng.standard_normal((p, 3)).astype(np.float32)
    # A finite row whose output overflows: dropped to 0.  (A non-finite
    # INPUT row would turn JAX's whole round to 0, through the one-hot
    # matmul's 0 * inf; the port copies rows and keeps the others.)
    x[7] = (3e38, 3e38, 1.0)
    mask = rng.random(p) < frac
    mask[7] = True
    with jax.disable_jit():
        want = JC.compact_apply(
            lambda v: v[:, 0:2] * v[:, 1:3] + 3.0, jnp.asarray(mask),
            jnp.asarray(x), k, pad_row=jnp.asarray([1.0, 0.0, 0.0]))
    got = TC.compact_apply(_fn, torch.from_numpy(mask), torch.from_numpy(x),
                           k, pad_row=(1.0, 0.0, 0.0))
    assert np.asarray(want).tobytes() == got.numpy().tobytes()
    assert got.numpy()[7, 0] == 0.0 and got.numpy()[7, 1] == 3e38


def _exact_loop(fn, mask, x, k):
    """compact_apply with a while loop that asks the device whether any
    lane is left before each round."""
    out = torch.zeros((x.shape[0], 2))
    m = mask.clone()
    while bool(m.any()):
        first = m & (torch.cumsum(m.to(torch.int32), 0) <= k)
        xc, pos, _ = TC.compact_rows(first, x, k)
        y = fn(xc)
        out = out + TC.expand_rows(torch.where(torch.isfinite(y), y, 0.0),
                                   pos, first)
        m = m & ~first
    return out


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.3, 1.0])
def test_fixed_rounds_match_exact_loop(frac):
    rng = np.random.default_rng(4)
    p, k = 1000, 128  # 8 rounds fixed; the exact loop runs 0 to 8
    x = torch.from_numpy(rng.standard_normal((p, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random(p) < frac)
    got = TC.compact_apply(_fn, mask, x, k)
    assert got.numpy().tobytes() == _exact_loop(_fn, mask, x,
                                                k).numpy().tobytes()
    full = torch.where(mask[:, None], _fn(x), 0.0)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


def test_rows_for_matches_reference():
    for p in (1000, 4096, 1 << 17):
        k = max(2048, p // 4)
        assert TC.rows_for(p) == -(-k // JC.L_DEFAULT) * JC.L_DEFAULT
    assert TC.rows_for(1 << 17) == 32768


def test_eve_film_compaction_bit_identical(monkeypatch):
    # tests/test_compact.py's settings: eve at 48x48, spp 2, depth 6,
    # pool 4096 (K = 2048: two rounds a call).
    scene, camera = get("eve")(aspect_ratio=1.0).generate(device="cpu")
    films = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("MRT_BG_COMPACT", flag)
        monkeypatch.setenv("MRT_TEX_COMPACT", flag)
        films[flag] = render_pass_persistent(
            scene, camera, Film.create(48, 48, device="cpu"), 5, 0, width=48,
            height=48, max_depth=6, samples=2, pool=4096)
    f0, f1 = films["0"], films["1"]
    assert f0.depth_sum.sum() > 0 and torch.isfinite(f0.sum).all()
    np.testing.assert_array_equal(f1.depth_sum.numpy(), f0.depth_sum.numpy())
    np.testing.assert_array_equal(f1.sum.numpy(), f0.sum.numpy())
