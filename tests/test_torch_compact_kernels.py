"""Port parity for the plain versions of kernels B2 and B3 as lane
compaction calls them: with the compaction mask passed to the kernel
(``mask=``) instead of indices and rows masked beforehand, against the
reference's TPU kernels (``mrt.ops.pallas_onehot``, interpret mode) and
its compaction (``mrt.ops.compact`` under ``MRT_ONEHOT=interpret`` and
``xla``, as tests/test_compact.py runs it); and the wrappers' checks.

Tolerances and why: every comparison is bit for bit.
  - B3 copies rows; the reference's one-hot gather reconstructs each
    value exactly from its three bf16 terms (normal f32: exponents from
    -20 to 20 here).
  - B2 adds dyadic values (multiples of 1/8, small): every partial sum
    is exact in f32, in any order.
  - Compaction places one value a row.  A -0.0 value: ``compact_rows``
    adds it to a zero (+0.0) in both packages; the reference's Pallas
    gather sums it through a one-hot product (+0.0), while its XLA path
    and the port copy it (-0.0): ``expand_rows`` is held bit for bit to
    the XLA path and as values to the Pallas one (ROADMAP C16);
    ``compact_apply`` adds the expansion to zeros, so both agree there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrt.ops import compact as JC
from mrt.ops import pallas_onehot
from mrt_torch.ops import _build
from mrt_torch.ops import compact as TC
from mrt_torch.ops import deposit as B2
from mrt_torch.ops import gather as B3
from mrt_torch.utils import profiling

torch.set_num_threads(2)

P, K = 512, 256  # the reference kernels: K % 128 == 0, P % min(2048, P) == 0


def _wide(rng, shape):
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-20, 20, shape)).astype(np.float32)


def _lanes(seed, rows):
    """Indices in and out of range, a mask of ~60% of the lanes."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-4, rows + 4, P).astype(np.int32)
    idx[:4] = (-(2 ** 31), 2 ** 31 - 1, rows, rows - 1)
    return rng, idx, rng.random(P) < 0.6


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 10])
def test_gather_plain_with_mask_matches_onehot_gather(cols):
    rng, idx, mask = _lanes(cols, K)
    table = _wide(rng, (K, cols))
    want = np.asarray(pallas_onehot.onehot_gather(
        jnp.asarray(np.where(mask, idx, -1)), jnp.asarray(table),
        interpret=True))
    got = B3.gather_plain(torch.from_numpy(table), torch.from_numpy(idx),
                          mask=torch.from_numpy(mask))
    assert got.numpy().tobytes() == want.tobytes()
    # The wrapper takes the plain version on the CPU.
    assert B3.gather(torch.from_numpy(table), torch.from_numpy(idx),
                     mask=torch.from_numpy(mask)).numpy().tobytes() \
        == want.tobytes()
    # Without a mask: B3 as it was.
    unmasked = B3.gather_plain(torch.from_numpy(table), torch.from_numpy(idx))
    assert unmasked.numpy().tobytes() == np.asarray(pallas_onehot.onehot_gather(
        jnp.asarray(idx), jnp.asarray(table), interpret=True)).tobytes()


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 10])
def test_deposit_plain_with_mask_matches_onehot_deposit_f32(cols):
    rng, idx, mask = _lanes(10 + cols, K)
    vals = rng.integers(-64, 64, (P, cols)).astype(np.float32) / 8.0
    vals[~mask] = np.nan  # never read: unmasked lanes
    vals[np.flatnonzero(mask)[:2], 0] = (np.inf, -np.inf)  # dropped
    want = np.asarray(pallas_onehot.onehot_deposit_f32(
        jnp.asarray(np.where(mask, idx, -1)), jnp.asarray(vals), K,
        interpret=True))
    want = (want[:, :cols] + want[:, cols:2 * cols]) + want[:, 2 * cols:]
    for fn in (B2.deposit_plain, B2.deposit):
        got = fn(torch.zeros((K, cols)), torch.from_numpy(idx),
                 torch.from_numpy(vals), drop_nonfinite=True,
                 mask=torch.from_numpy(mask))
        assert got.numpy().tobytes() == want.tobytes()


def _compaction_input(seed, cols=3):
    """Rows with exponents from -20 to 20 and -0.0 values where masked;
    NaN and +-inf in unmasked rows."""
    rng = np.random.default_rng(seed)
    x = _wide(rng, (P, cols))
    mask = rng.random(P) < 0.4
    on, off = np.flatnonzero(mask), np.flatnonzero(~mask)
    x[on[0], 1] = -0.0
    x[on[3]] = -0.0
    x[off[0]], x[off[1], 0], x[off[2], 2] = np.nan, np.inf, -np.inf
    return x, mask


# k = 128: masked rows past k are dropped, as the reference's Pallas
# path drops them (its XLA path clips them onto row k - 1 and leaves
# count > k to its caller, compact_apply, which never passes it).
@pytest.mark.parametrize("onehot, k", [("interpret", K), ("xla", K),
                                       ("interpret", 128)])
def test_compact_rows_matches_reference(monkeypatch, onehot, k):
    monkeypatch.setenv("MRT_ONEHOT", onehot)
    x, mask = _compaction_input(20 + k)
    want = JC.compact_rows(jnp.asarray(mask), jnp.asarray(x), k)
    got = TC.compact_rows(torch.from_numpy(mask), torch.from_numpy(x), k)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()
    assert np.isfinite(got[0].numpy()).all()


@pytest.mark.parametrize("onehot", ["interpret", "xla"])
def test_expand_rows_matches_reference(monkeypatch, onehot):
    monkeypatch.setenv("MRT_ONEHOT", onehot)
    x, mask = _compaction_input(30)
    xc, pos, _ = TC.compact_rows(torch.from_numpy(mask), torch.from_numpy(x),
                                 K)
    y = xc.numpy().copy()
    y[0, 1] = y[2, 0] = -0.0
    want = np.asarray(JC.expand_rows(jnp.asarray(y), jnp.asarray(pos.numpy()),
                                     jnp.asarray(mask)))
    got = TC.expand_rows(torch.from_numpy(y), pos, torch.from_numpy(mask))
    got = got.numpy()
    np.testing.assert_array_equal(got, want)
    copied = np.zeros_like(want)
    copied[mask] = y[pos.numpy()[mask]]
    assert got.tobytes() == copied.tobytes()  # -0.0 kept
    if onehot == "xla":
        assert got.tobytes() == want.tobytes()
    else:  # the one-hot product sums -0.0 to +0.0 (C16)
        neg = np.signbit(got) & (got == 0.0)
        assert neg.any() and not np.signbit(want[neg]).any()
        assert np.array_equal(np.signbit(got[~neg]), np.signbit(want[~neg]))


@pytest.mark.parametrize("onehot", ["interpret", "xla"])
def test_compact_apply_matches_reference_on_wide_rows(monkeypatch, onehot):
    monkeypatch.setenv("MRT_ONEHOT", onehot)
    x, mask = _compaction_input(40)
    fn = lambda v: -v[:, 0:2] * 1.0  # -0.0 outputs from +0.0 inputs
    want = JC.compact_apply(fn, jnp.asarray(mask), jnp.asarray(x), 128,
                            pad_row=jnp.asarray([1.0, 1.0, 1.0]))
    got = TC.compact_apply(fn, torch.from_numpy(mask), torch.from_numpy(x),
                           128, pad_row=(1.0, 1.0, 1.0))
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def _bad_masks():
    return {
        "dtype": (torch.ones(P, dtype=torch.uint8), TypeError),
        "shape": (torch.ones(P - 1, dtype=torch.bool), ValueError),
        "device": (torch.ones(P, dtype=torch.bool, device="meta"), ValueError),
        "strided": (torch.ones(2 * P, dtype=torch.bool)[::2], ValueError),
    }


@pytest.mark.parametrize("kind", ["dtype", "shape", "device", "strided"])
def test_wrappers_refuse_a_bad_mask(kind):
    mask, error = _bad_masks()[kind]
    idx = torch.zeros(P, dtype=torch.int32)
    with pytest.raises(error, match="mask"):
        B3.gather(torch.zeros((K, 3)), idx, mask=mask)
    with pytest.raises(error, match="mask"):
        B2.deposit(torch.zeros((K, 3)), idx, torch.zeros((P, 3)), mask=mask)


@pytest.mark.parametrize("cols", [0, 11])
def test_wrappers_refuse_column_counts_past_the_kernels(cols):
    idx = torch.zeros(P, dtype=torch.int32)
    with pytest.raises(ValueError, match="columns"):
        B3.gather(torch.zeros((K, cols)), idx)
    with pytest.raises(ValueError, match="columns"):
        B2.deposit(torch.zeros((K, cols)), idx, torch.zeros((P, cols)))
    assert profiling.launch_counts["B3"] == profiling.launch_counts["B2"] == 0


@pytest.mark.parametrize("cols, align", [(4, 16), (2, 8)])
def test_alignment_check_refuses_a_view_offset_by_one_float(cols, align):
    base = torch.zeros(64 * cols + 1)
    assert base.data_ptr() % 64 == 0  # the CPU allocator's alignment
    good = base[:64 * cols].view(64, cols)
    _build.check_aligned("deposit", cols, film=good, vals=good)
    bad = base[1:].view(64, cols)
    with pytest.raises(ValueError, match=f"vals is not {align}-byte aligned"):
        _build.check_aligned("deposit", cols, film=good, vals=bad)
    # Scalar rows take any float pointer.
    _build.check_aligned("gather", 3, table=base[1:1 + 3 * 42].view(42, 3))
