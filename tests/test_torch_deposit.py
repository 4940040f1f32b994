"""Port parity: kernel B2 (film segment-add) against the TPU kernels
``mrt.ops.pallas_onehot.onehot_deposit`` / ``onehot_deposit_f32`` run in
interpret mode, as tests/test_film_mm.py runs them.

B2's plain version (``mrt_torch.ops.deposit.deposit_plain``, the CPU path
of the ``deposit`` wrapper) adds in lane order; the one-hot kernels sum
through a matrix product in another order.  So:
  - with dyadic values (multiples of 1/8, small), every partial sum is
    exact in f32 and the results must be bit-equal;
  - with random normal values, the sums agree to f32 reassociation:
    rtol 1e-5, atol 1e-5 (a row sums at most a few dozen values).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrt.ops import pallas_onehot
from mrt_torch.ops import deposit as B2
from mrt_torch.utils import profiling

torch.set_num_threads(2)


def _lanes(seed, p, rows, cols, dyadic):
    rs = np.random.default_rng(seed)
    idx = rs.integers(-5, rows + 5, p).astype(np.int32)
    if dyadic:
        vals = rs.integers(-64, 64, (p, cols)).astype(np.float32) / 8.0
    else:
        vals = rs.standard_normal((p, cols)).astype(np.float32)
    return idx, vals


def _port(idx, vals, rows, drop_nonfinite=False):
    film = torch.zeros((rows, vals.shape[1]), dtype=torch.float32)
    return B2.deposit(film, torch.from_numpy(idx), torch.from_numpy(vals),
                      drop_nonfinite=drop_nonfinite).numpy()


@pytest.mark.parametrize("dyadic", [True, False])
def test_b2_plain_matches_onehot_deposit(dyadic):
    rows, p = 1024, 2048
    idx, vals = _lanes(5, p, rows, 4, dyadic)
    # The one-hot kernel takes bf16 parts and needs zeros on dropped lanes.
    vals = np.array(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    vals[(idx < 0) | (idx >= rows)] = 0.0
    want = np.asarray(pallas_onehot.onehot_deposit(
        jnp.asarray(idx), jnp.asarray(vals), rows, interpret=True))
    got = _port(idx, vals, rows)
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dyadic", [True, False])
def test_b2_plain_matches_onehot_deposit_f32(dyadic):
    # The f32 kernel splits each value into three bf16 terms, drops
    # non-finite values, and returns hi/mid/lo column groups.
    rows, p, c = 512, 1024, 4
    idx, vals = _lanes(6, p, rows, c, dyadic)
    vals[3, 1] = np.nan
    vals[7, 0] = np.inf
    vals[9, 3] = -np.inf
    idx[3] = idx[7] = idx[9] = 17
    out = np.asarray(pallas_onehot.onehot_deposit_f32(
        jnp.asarray(idx), jnp.asarray(vals), rows, interpret=True))
    want = (out[:, :c] + out[:, c:2 * c]) + out[:, 2 * c:]
    got = _port(idx, vals, rows, drop_nonfinite=True)
    assert np.isfinite(got).all()
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_b2_drops_out_of_range_lanes_and_accumulates():
    film = torch.ones((4, 2))
    idx = torch.tensor([-1, 0, 3, 4, 2 ** 30, 0], dtype=torch.int32)
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    out = B2.deposit(film, idx, vals)
    assert out is film  # in place
    np.testing.assert_array_equal(
        out.numpy(), [[1 + 2 + 10, 1 + 3 + 11], [1, 1], [1, 1], [5, 6]])
    # Without the flag a NaN value is added like any other.
    vals[1, 0] = np.nan
    assert torch.isnan(B2.deposit(film, idx, vals)[0, 0])


def test_b2_wrapper_checks_arguments():
    film = torch.zeros((8, 4))
    idx = torch.zeros((5,), dtype=torch.int32)
    vals = torch.zeros((5, 4))
    with pytest.raises(TypeError):
        B2.deposit(film, idx.long(), vals)
    with pytest.raises(TypeError):
        B2.deposit(film.double(), idx, vals.double())
    with pytest.raises(ValueError):
        B2.deposit(film, idx, vals[:, :3])
    with pytest.raises(ValueError):
        B2.deposit(film, idx, torch.zeros((4, 5)).t())
    with pytest.raises(ValueError, match="no kernel"):
        B2.deposit(film.to("meta"), idx.to("meta"), vals.to("meta"))
    assert profiling.launch_counts["B2"] == 0
