"""The port's gradients against finite differences: tests/test_grad.py's
checks run on the port alone, with its tolerances (albedo, texel and
fuzz rtol 5e-2; emission rtol 1e-2; the sphere centre finite).

``mrt_torch.inverse.optimize`` against the reference's: it takes
torch.optim.Adam where the reference takes optax.adam (the same update,
rounded in another order), and its first 5 losses hold JAX's
(MRT_NO_ROWMM=1, C17) to rtol 1e-3.  The first loss is the same
function of the same parameters (rtol 1e-4 between the packages); each
update then carries the gradients' last-bit differences into the next
step's loss.
"""

import numpy as np
import torch

import torch_grad_scenes as S

torch.set_num_threads(2)


def _loss(name):
    f = S.torch_loss(name)
    return lambda p: float(f(torch.as_tensor(np.asarray(p, np.float32))))


def _central(loss, p, i, eps):
    hi, lo = p.copy(), p.copy()
    hi[i] += eps
    lo[i] -= eps
    return (loss(hi) - loss(lo)) / (2 * eps)


def test_albedo_gradient_matches_fd():
    _, g = S.torch_value_and_grad("albedo")
    assert np.isfinite(g).all()
    p, loss = S.CASES["albedo"]["init"], _loss("albedo")
    for c in range(3):
        assert np.isclose(g[c], _central(loss, p, c, 1e-2), rtol=5e-2,
                          atol=1e-4), c


def test_emission_gradient_matches_fd():
    _, g = S.torch_value_and_grad("emission")
    fd = _central(_loss("emission"), S.CASES["emission"]["init"], 0, 1e-2)
    assert np.isclose(g[0], fd, rtol=1e-2, atol=1e-5)


def test_texture_texel_gradient_matches_fd():
    _, g = S.torch_value_and_grad("texel")
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    p, loss = S.CASES["texel"]["init"], _loss("texel")
    for f in np.argsort(-np.abs(g).ravel())[:3]:
        i = np.unravel_index(f, g.shape)
        assert np.isclose(g[i], _central(loss, p, i, 1e-2), rtol=5e-2,
                          atol=1e-5), i


def test_metal_fuzz_gradient_matches_fd():
    _, g = S.torch_value_and_grad("fuzz")
    assert np.isfinite(g).all()
    fd = _central(_loss("fuzz"), S.CASES["fuzz"]["init"].reshape(1), 0, 5e-3)
    assert np.isclose(float(g), fd, rtol=5e-2, atol=1e-4)


def test_sphere_center_gradient_finite():
    _, g = S.torch_value_and_grad("center")
    assert np.isfinite(g).all()


def test_first_losses_match_optax(monkeypatch):
    import jax.numpy as jnp

    from mrt import inverse as jinv

    cam = S.jax_camera()
    monkeypatch.setenv("MRT_NO_ROWMM", "1")
    jscene = lambda p: S.jax_scene("albedo", p)
    target = jinv.render_image(jscene(jnp.asarray([0.7, 0.2, 0.4])), cam,
                               12, 12, spp=8, seed=11, max_depth=4)
    _, want = jinv.optimize(jscene, jnp.asarray([0.3, 0.5, 0.5]), cam, 12,
                            12, target, steps=5, learning_rate=0.05, spp=4,
                            max_depth=4, seed=100)
    _, got = S.torch_recovery(5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)
