"""4x4 affine transforms with the reference's *turns* angle convention
(mirrors the host NumPy builders of ``mrt.math.m4``).

An M4 is a (4, 4) float32 array in standard math orientation (a point
p maps to ``(m @ [p, 1])[:3]``), composed as
``T @ Rx @ Ry @ Rz @ S``.  Rotation angles are in **turns** (one turn
is 2*pi radians).  Scenes are built on the host, so these are NumPy and
batched: (I, 4, 4) arrays for I instances.  Their arrays are
byte-identical to ``mrt.math.m4.trs_batch_np`` / ``trs_inverse_batch_np``.
(The JAX module's scalar jnp helpers have no caller in the port.)
"""

from __future__ import annotations

import numpy as np

TAU = 2.0 * np.pi


def _rot_batch_np(turns, axis):
    a = np.asarray(turns, np.float32) * TAU
    c, s = np.cos(a), np.sin(a)
    m = np.tile(np.eye(4, dtype=np.float32), (a.shape[0], 1, 1))
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[:, i, i] = c
    m[:, j, j] = c
    if axis == 1:  # y: +s above the diagonal
        m[:, i, j] = s
        m[:, j, i] = -s
    else:
        m[:, i, j] = -s
        m[:, j, i] = s
    return m


def trs_batch_np(translation, rotation_turns, scale):
    """Batched T @ Rx @ Ry @ Rz @ S, (I, 4, 4) float32."""
    t = np.asarray(translation, np.float32)
    r = np.asarray(rotation_turns, np.float32)
    s = np.asarray(scale, np.float32)
    m = (_rot_batch_np(r[:, 0], 0) @ _rot_batch_np(r[:, 1], 1)
         @ _rot_batch_np(r[:, 2], 2))
    m[:, :3, :3] *= s[:, None, :]      # right-multiply by the scale
    m[:, :3, 3] = t                    # left-multiply by the translation
    return m


def trs_inverse_batch_np(translation, rotation_turns, scale):
    """Batched S^-1 @ Rz^-1 @ Ry^-1 @ Rx^-1 @ T^-1, composed from the
    negated components as the reference does (not a matrix inverse)."""
    t = np.asarray(translation, np.float32)
    r = np.asarray(rotation_turns, np.float32)
    s = np.asarray(scale, np.float32)
    m = (_rot_batch_np(-r[:, 2], 2) @ _rot_batch_np(-r[:, 1], 1)
         @ _rot_batch_np(-r[:, 0], 0))
    m[:, :3, :3] /= s[:, :, None]      # left-multiply by the inverse scale
    m[:, :3, 3] = -np.einsum("nij,nj->ni", m[:, :3, :3], t)
    return m
