"""The persistent pass's shard arguments (``pixel_offset``, ``n_pixels``,
``sample_stride`` of ``render_samples_persistent``), in one process.

Against the reference's ``render_samples_persistent`` with the same
arguments, on RTIOW at the golden settings of tests/golden_scenes.py:
the reference's loop is compiled, so the rule of tests/test_torch_render.py
holds (ROADMAP C2: at most 1% of pixels with another bounce count, every
other pixel within 5e-4).  Against the port's own whole-frame pass:
bounce counts exact, radiance within f32 reassociation of the film's
adds (rtol 1e-5, atol 1e-6).
"""

import numpy as np
import pytest
import torch

import golden_scenes as G
from mrt.integrator import persistent as JP
from mrt_torch.integrator.persistent import render_samples_persistent
from mrt_torch.scenes import get

torch.set_num_threads(2)

N = G.SIZE * G.SIZE
# (pixel_offset, n_pixels, sample_start, samples, sample_stride): rows
# [8, 16) at samples 1, 3, 5; the whole frame at samples 0, 2, 4, 6; a
# shard that starts mid-row.
SHARDS = [(8 * G.SIZE, 8 * G.SIZE, 1, 3, 2), (0, N, 0, 4, 2),
          (100, 300, 2, 2, 3)]


def _port(offset=0, n=None, start=0, samples=G.SPP, stride=1, pool=1024):
    scene, camera = get("rtiow")(aspect_ratio=1.0, grid=5).generate(
        device="cpu")
    return render_samples_persistent(
        scene, camera, G.SIZE, G.SIZE, G.SEED, start, samples,
        max_depth=G.DEPTH, pool=pool, pixel_offset=offset, n_pixels=n,
        sample_stride=stride)


@pytest.mark.parametrize("offset,n,start,samples,stride", SHARDS)
def test_shard_arguments_match_reference(offset, n, start, samples, stride):
    scene, camera = G.rtiow()
    want_sum, want_depth = JP.render_samples_persistent(
        scene, camera, G.SIZE, G.SIZE, G.SEED, start, samples,
        max_depth=G.DEPTH, pool=512, pixel_offset=offset, n_pixels=n,
        sample_stride=stride)
    got_sum, got_depth = _port(offset, n, start, samples, stride)
    want_sum, want_depth = np.asarray(want_sum), np.asarray(want_depth)
    assert got_sum.shape == want_sum.shape == ((n or N), 3)
    flipped = got_depth.numpy() != want_depth
    assert flipped.mean() <= 0.01, flipped.sum()
    np.testing.assert_allclose(got_sum.numpy()[~flipped],
                               want_sum[~flipped], rtol=5e-4, atol=5e-4)
    assert want_depth.sum() > 0


def test_rows_are_a_slice_of_the_whole_frame():
    whole_sum, whole_depth = _port()
    rows = slice(8 * G.SIZE, 16 * G.SIZE)
    part_sum, part_depth = _port(8 * G.SIZE, 8 * G.SIZE, pool=256)
    np.testing.assert_array_equal(part_depth.numpy(),
                                  whole_depth[rows].numpy())
    np.testing.assert_allclose(part_sum.numpy(), whole_sum[rows].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_strided_samples_sum_to_the_whole_frame():
    # Samples {0, 2, 4, 6} and {1, 3, 5, 7} together are samples 0..7.
    whole_sum, whole_depth = _port()
    even = _port(start=0, samples=4, stride=2)
    odd = _port(start=1, samples=4, stride=2)
    np.testing.assert_array_equal((even[1] + odd[1]).numpy(),
                                  whole_depth.numpy())
    np.testing.assert_allclose((even[0] + odd[0]).numpy(),
                               whole_sum.numpy(), rtol=1e-5, atol=1e-6)


def test_default_arguments_are_the_whole_frame():
    default = _port()
    explicit = _port(0, N, 0, G.SPP, 1)
    for a, b in zip(default, explicit):
        assert torch.equal(a, b)
