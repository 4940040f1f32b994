"""Environment cube map (mirrors ``mrt.scenes.envmaps``).

The reference adds a shared tiling star texture to a per-face YCbCr
nebula and builds a CubeMap of the six faces.  Its PNGs are not in the
repository: ``environment`` loads them from an asset directory when one
is present and otherwise synthesises deterministic star and nebula
textures through the same pipeline (the same draws as the JAX package,
so both build the same texels).

The reference's CubeMap composes its rotation from three rotate_x calls
(one for each angle); ``environment`` keeps that transform, so renders
match the reference's actual output.
"""

from __future__ import annotations

import os

import numpy as np

from ..materials.background import CubeMap
from ..math.m4 import _rot_batch_np
from ..runtime import assets
from ..textures.atlas import REPEAT, AtlasBuilder


def _synth_stars(rng, size=256, count=400):
    """Sparse white star dots on black, tileable."""
    img = np.zeros((size, size, 4), np.float32)
    img[..., 3] = 1.0
    ys = rng.integers(0, size, count)
    xs = rng.integers(0, size, count)
    mags = rng.random(count).astype(np.float32) ** 3
    img[ys, xs, :3] = mags[:, None]
    return img


def _synth_nebula(rng, size=128):
    """Low-frequency luma and chroma noise (the nebula's YCbCr pair)."""
    def lowfreq(channels):
        small = rng.random((8, 8, channels)).astype(np.float32)
        reps = size // 8
        return np.kron(small, np.ones((reps, reps, 1), np.float32))

    luma = np.zeros((size, size, 4), np.float32)
    luma[..., 0] = lowfreq(1)[..., 0] * 0.35
    luma[..., 3] = 1.0
    chroma = np.full((size, size, 4), 0.5, np.float32)
    chroma[..., :2] = 0.4 + 0.2 * lowfreq(2)
    chroma[..., 3] = 1.0
    return luma, chroma


def environment(atlas: AtlasBuilder, name="j02", rotation=(0.4, 0.2, 0.1),
                asset_root="models/environments", seed=7):
    """Add the six star+nebula faces to `atlas`; returns the CubeMap."""
    asset_root = assets.resolve(asset_root)
    star_path = os.path.join(asset_root, "stars01_tile2.png")
    have_assets = os.path.exists(star_path)
    rng = np.random.default_rng(seed)

    if have_assets:
        stars = atlas.add_png(star_path, wrap=REPEAT)
    else:
        stars = atlas.add_raw(_synth_stars(rng), wrap=REPEAT)

    faces = []
    for index in range(6):
        if have_assets:
            luma = atlas.add_png(os.path.join(asset_root, name,
                                              f"{index}.png"), wrap=REPEAT)
            chroma = atlas.add_png(os.path.join(
                asset_root, name, f"{index}_chroma.png"), wrap=REPEAT)
        else:
            luma_px, chroma_px = _synth_nebula(rng)
            luma = atlas.add_raw(luma_px, wrap=REPEAT)
            chroma = atlas.add_raw(chroma_px, wrap=REPEAT)
        nebula = atlas.add_ycbcr(luma, chroma)
        # The reference nests two combinators (stars added to the YCbCr
        # nebula); the atlas resolves one when it samples, so the
        # addition is baked into a RAW row.
        faces.append(atlas.bake_addition(stars, nebula))

    # The reference's quirk: rotate_x of each of the three angles.
    rot = (_rot_batch_np([rotation[0]], 0)[0] @ _rot_batch_np([rotation[1]],
                                                              0)[0]
           @ _rot_batch_np([rotation[2]], 0)[0])
    # Every face is a baked RAW row: one texel lookup a sample.
    return CubeMap.create(*faces, transform=rot, faces_raw=True)
