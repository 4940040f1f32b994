"""Gradients through the alpha test's re-cast rounds, port against JAX.

The reference gates each re-cast round with ``lax.cond``, which reverse
mode takes, so the rounds stay differentiable on the routes that are.
The case (``torch_grad_scenes``' texel_alpha): test_grad's texel
parameter on a UV-mapped brute-force triangle, with the alpha test on
and the texture's left half at alpha 0, so rays through the cutout are
cast again and find what lies behind it.
Tolerance: rtol 1e-4 on the loss and the texel gradient against JAX's
jitted ``value_and_grad`` with MRT_NO_ROWMM=1 (C17).
"""

import numpy as np
import torch

import torch_grad_scenes as S

torch.set_num_threads(2)


def test_alpha_recast_gradient_matches_jax():
    tv, tg = S.torch_value_and_grad("texel_alpha")
    jv, jg = S.jax_value_and_grad("texel_alpha")
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=1e-4,
                               atol=1e-4 * np.abs(jg).max())
    assert np.isfinite(tg).all()
    # Column 0 (its four corners at alpha 0) is never seen; the texels
    # past it are.
    assert (tg[:, 0, :3] == 0).all() and (np.abs(tg[:, 1:, :3]) > 0).any()
    # The rounds ran: without the alpha test the cutout is opaque.
    p = torch.from_numpy(S.CASES["texel_alpha"]["init"])
    scene = S.torch_scene("texel_alpha", p)
    c, cam = S.CASES["texel_alpha"], S.torch_camera()
    from mrt_torch import inverse

    kw = dict(spp=c["spp"], seed=c["seed"], max_depth=c["max_depth"])
    opaque = inverse.render_image(scene.replace(needs_alpha=False), cam,
                                  S.SIZE, S.SIZE, **kw)
    assert abs(float(opaque.mean()) - tv) > 1e-3
