"""Inverse rendering through ``mrt_torch.inverse.optimize``:
tests/test_grad.py's albedo recovery on the port (60 Adam steps at
12x12, spp 4, depth 4; the last loss below 0.6 of the first, the albedo
within 0.08 of the truth), ``optimize``'s optimizer factory, callback
and parameter structures, and ``convert.params_from_numpy``.
"""

import numpy as np
import torch

import torch_grad_scenes as S
from mrt_torch import convert, inverse

torch.set_num_threads(2)


def test_recovers_albedo():
    seen = []
    start = torch.tensor([0.3, 0.5, 0.5])
    params, losses = S.torch_recovery(60)
    assert losses[-1] < losses[0] * 0.6
    np.testing.assert_allclose(params.numpy(), [0.7, 0.2, 0.4], atol=0.08)
    assert torch.equal(start, torch.tensor([0.3, 0.5, 0.5]))
    # A factory's optimizer and the callback.
    _, short = S.torch_recovery(
        1, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    assert short == losses[:1]
    cam = S.torch_camera()
    inverse.optimize(lambda p: S.torch_scene("albedo", p["a"]),
                     {"a": start}, cam, 4, 4, torch.zeros(4, 4, 3), steps=2,
                     spp=1, max_depth=2,
                     callback=lambda i, p, v: seen.append((i, p["a"], v)))
    assert [s[0] for s in seen] == [0, 1]
    assert not seen[1][1].requires_grad


def test_params_from_numpy():
    tree = {"albedo": np.array([0.3, 0.5, 0.5], np.float64),
            "rows": (np.zeros((2, 4), np.float32), np.int32(3))}
    got = convert.params_from_numpy(tree, device="cpu")
    a, (z, k) = got["albedo"], got["rows"]
    assert a.dtype == torch.float32 and a.requires_grad and a.is_leaf
    assert z.shape == (2, 4) and z.requires_grad
    assert k.dtype == torch.int32 and not k.requires_grad
    np.testing.assert_array_equal(a.detach().numpy(),
                                  tree["albedo"].astype(np.float32))
