"""Port parity: the à-trous denoiser (``mrt_torch.runtime.denoise``) and
the film's display modes (``Film.to_float_rgb`` / ``to_rgb_bytes``)
against ``mrt.runtime.denoise`` and ``mrt.runtime.film``.

Tolerances and why:
  - ``denoise`` on the captured buffers (artifacts/denoise_buffers.npz:
    160x160 rtiow and cornell at 4 spp with their guides) within 1e-5 of
    compiled JAX, with both guides, with the albedo alone and with none
    (measured: 5.4e-6; within 7e-7 of op-by-op JAX).  XLA fuses the
    filter and contracts its multiply-adds (ROADMAP C2), the port rounds
    each op; exp differs by an ulp between the two libraries.
  - Display modes: the bytes of every mode equal JAX's, except DENOISE,
    whose floats carry the filter's 1e-5: there a byte may be one apart
    where JAX's value * 255 lies within 1e-5 * 255 of an integer (the
    truncation), and nowhere else.
  - The reference's own denoiser tests (tests/test_runtime.py
    TestDenoiser and test_denoiser_quality_on_render) run on the port
    with their thresholds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrt.runtime import denoise as JD
from mrt.runtime import film as JF
from mrt_torch.runtime import denoise as TD
from mrt_torch.runtime import film as TF
from mrt_torch.runtime.render import render
from mrt_torch.scenes import get

torch.set_num_threads(2)

BUFFERS = np.load(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "denoise_buffers.npz"))


@pytest.mark.parametrize("guides", ["both", "albedo", "none"])
@pytest.mark.parametrize("scene", ["rtiow", "cornell"])
def test_denoise_matches_reference(scene, guides):
    low = BUFFERS[f"{scene}_low"]
    albedo = BUFFERS[f"{scene}_albedo"] if guides != "none" else None
    normal = BUFFERS[f"{scene}_normal"] if guides == "both" else None
    as_j = lambda x: None if x is None else jnp.asarray(x)
    as_t = lambda x: None if x is None else torch.from_numpy(x)
    want = np.asarray(JD.denoise(as_j(low), as_j(albedo), as_j(normal)))
    got = TD.denoise(as_t(low), as_t(albedo), as_t(normal)).numpy()
    assert got.dtype == np.float32 and got.shape == (160, 160, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The filter did something.
    assert np.abs(got - low).max() > 0.05


def test_reduces_noise_preserves_edges(rng):
    h = w = 64
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, w // 2:] = 0.8          # a hard vertical edge
    albedo = clean.copy()
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    noisy = clean + rng.normal(0, 0.1, clean.shape).astype(np.float32)
    out = TD.denoise(torch.from_numpy(noisy), torch.from_numpy(albedo),
                     torch.from_numpy(normal)).numpy()
    # Noise reduced in flat regions...
    left_std = out[:, :w // 2 - 4].std()
    assert left_std < noisy[:, :w // 2 - 4].std() * 0.5
    # ...edge preserved (the albedo guide forbids cross-edge blur).
    edge_contrast = (out[:, w // 2 + 2].mean()
                     - out[:, w // 2 - 3].mean())
    assert edge_contrast > 0.6


def test_denoiser_quality_on_render():
    """The AOV-guided filter cuts the MSE against a converged render by
    at least 2x at 4 spp on the Cornell box (the persistent integrator:
    the wavefront's estimator, fewer CPU steps)."""
    scene, camera = get("cornell")(aspect_ratio=1.0).generate(device="cpu")
    w = h = 32
    ref = render(scene, camera, w, h, spp=256, max_depth=6, seed=11,
                 persistent=True).mean()
    noisy_film = render(scene, camera, w, h, spp=4, max_depth=6, seed=3,
                        with_aov=True, persistent=True)
    noisy = noisy_film.mean()
    out = TD.denoise(noisy, noisy_film.albedo, noisy_film.normal)
    mse_noisy = float(((noisy - ref) ** 2).mean())
    mse_denoised = float(((out - ref) ** 2).mean())
    assert mse_denoised < 0.5 * mse_noisy, (mse_noisy, mse_denoised)


def _films(samples, guides=True):
    rs = np.random.default_rng(9)
    h, w = 48, 40
    total = rs.random((h, w, 3)).astype(np.float32) * 3.0 * max(samples, 1)
    total[:4] = 0.0                     # black rows
    depth = rs.integers(0, 20, (h, w)).astype(np.int32)
    albedo = (rs.random((h, w, 3)) * 1.2 - 0.1).astype(np.float32)
    normal = rs.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    g = (albedo, normal) if guides else (None, None)
    jf = JF.Film(sum=jnp.asarray(total), depth_sum=jnp.asarray(depth),
                 samples=jnp.asarray(samples, jnp.int32),
                 albedo=None if g[0] is None else jnp.asarray(g[0]),
                 normal=None if g[1] is None else jnp.asarray(g[1]))
    tf = TF.Film(sum=torch.from_numpy(total),
                 depth_sum=torch.from_numpy(depth), samples=samples,
                 albedo=None if g[0] is None else torch.from_numpy(g[0]),
                 normal=None if g[1] is None else torch.from_numpy(g[1]))
    return jf, tf


@pytest.mark.parametrize("samples,guides", [(3, True), (3, False),
                                            (0, True)])
def test_display_modes_match_reference(samples, guides):
    jf, tf = _films(samples, guides)
    assert [m.value for m in TF.DisplayMode] == [m.value for m in
                                                 JF.DisplayMode]
    assert (tf.width, tf.height) == (jf.width, jf.height) == (40, 48)
    for mode in TF.DisplayMode:
        jmode = JF.DisplayMode(mode.value)
        want = jf.to_rgb_bytes(jmode)
        got = tf.to_rgb_bytes(mode)
        assert got.dtype == np.uint8 and got.shape == want.shape == (48, 40, 3)
        np.testing.assert_array_equal(got, want, err_msg=mode.value)
    # DENOISE with each package's denoiser.
    want_f = np.asarray(jf.to_float_rgb(JF.DisplayMode.DENOISE,
                                        denoiser=JD.make_denoiser()))
    got_f = tf.to_float_rgb(TF.DisplayMode.DENOISE,
                            denoiser=TD.make_denoiser()).numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-5)
    want = jf.to_rgb_bytes(JF.DisplayMode.DENOISE, denoiser=JD.make_denoiser())
    got = tf.to_rgb_bytes(TF.DisplayMode.DENOISE, denoiser=TD.make_denoiser())
    scaled = want_f * 255.0
    edge = np.abs(scaled - np.round(scaled)) <= 1e-5 * 255.0
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and not diff[~edge].any()
    if samples == 0:
        assert not got.any()


def test_film_clear_and_with_aov():
    _, tf = _films(3)
    cleared = tf.clear()
    assert cleared.samples == 0 and not cleared.sum.any()
    assert not cleared.depth_sum.any()
    assert cleared.albedo is tf.albedo and cleared.normal is tf.normal
    bare = TF.Film.create(4, 2, device="cpu")
    assert bare.albedo is None and (bare.width, bare.height) == (4, 2)
    a, n = torch.ones(2, 4, 3), torch.zeros(2, 4, 3)
    both = bare.with_aov(a, n)
    assert both.albedo is a and both.normal is n
    np.testing.assert_array_equal(both.to_rgb_bytes(TF.DisplayMode.NORMAL),
                                  127)
