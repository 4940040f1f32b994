"""Texture atlas: every texture's texels in one flat table, sampled a
wavefront at a time (mirrors ``mrt.textures.atlas``).

All textures' pixels live in one (P, 4) table; a texture id indexes
per-row metadata (offset, size, wrap, kind, children, blend mode,
fallback colour), and ``sample(ids, uv)`` bilinearly samples a whole
wavefront by direct indexing.  Combinators are rows too, resolved with
one level of indirection (their children must be RAW rows):

  RAW       pixels, bilinear + wrap
  BLEND     Lighten/Darken/Add/Sub of two children
  YCBCR     luma + chroma children -> BT.709 -> clamp -> gamma 2.2
  FALLBACK  alpha-composite a child over a solid colour

Bilinear as the reference: uv wrapped first, scaled by (size - 1),
floor/ceil corners, x-then-y lerp.  Wraps: Repeat (with its handling of
negative coordinates), Clamp, and Mirror (a triangle wave of period 2).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.autodiff import Replace
from ..math import vec

# Row kinds
RAW = 0
BLEND = 1
YCBCR = 2
FALLBACK = 3

# Wrap modes
REPEAT = 0
CLAMP = 1
MIRROR = 2

# Blend modes
LIGHTEN = 0
DARKEN = 1
ADDITION = 2
SUBTRACTION = 3

# BT.709 constants
_KR, _KG, _KB = 0.2126, 0.7152, 0.0722


def _host_resample(img, h, w):
    """Bilinear resample of an (H, W, 4) image to (h, w) on the host,
    scaling by size - 1 as the sampler does."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    y = np.linspace(0.0, 1.0, h) * (ih - 1)
    x = np.linspace(0.0, 1.0, w) * (iw - 1)
    y0 = np.floor(y).astype(int)
    y1 = np.ceil(y).astype(int)
    x0 = np.floor(x).astype(int)
    x1 = np.ceil(x).astype(int)
    ty = (y - y0)[:, None, None]
    tx = (x - x0)[None, :, None]
    p0 = img[y0][:, x0] * (1 - tx) + img[y0][:, x1] * tx
    p1 = img[y1][:, x0] * (1 - tx) + img[y1][:, x1] * tx
    return p1 * ty + p0 * (1 - ty)


def _ycbcr(luma, chroma):
    """BT.709 YCbCr (luma's R, chroma's R and G) to RGB, clamped, gamma
    2.2.  Returns the three channels."""
    yy = luma[..., 0]
    uu = chroma[..., 0] - 0.5
    vv = chroma[..., 1] - 0.5
    r = yy + vv * (2.0 - 2.0 * _KR)
    g = (yy + uu * (-(_KB / _KG) * (2.0 - 2.0 * _KB))
         + vv * (-(_KR / _KG) * (2.0 - 2.0 * _KR)))
    b = yy + uu * (2.0 - 2.0 * _KB)
    return r, g, b


class TextureAtlas(Replace, nn.Module):
    """Buffers: data (P, 4) float32 texels, row-major per texture;
    offset, width, height, wrap, kind, left, right, mode (T,) int32;
    fb_color (T, 4) float32.  ``all_raw``: every row is RAW.
    ``replace(data=...)`` swaps the texels, as an inverse render of
    them does (``core.autodiff.Replace``)."""

    FIELDS = {"data": torch.float32, "offset": torch.int32,
              "width": torch.int32, "height": torch.int32,
              "wrap": torch.int32, "kind": torch.int32, "left": torch.int32,
              "right": torch.int32, "mode": torch.int32,
              "fb_color": torch.float32}

    def __init__(self, **arrays):
        super().__init__()
        for name, dtype in self.FIELDS.items():
            self.register_buffer(name,
                                 torch.as_tensor(arrays[name], dtype=dtype))
        self.all_raw = bool((self.kind == RAW).all())

    @property
    def count(self):
        return self.offset.shape[0]

    @staticmethod
    def _wrap(w, x):
        """Wrap coordinates x by per-lane modes w.  ``%`` is floor-mod,
        as in the reference (``torch.remainder``, not ``fmod``)."""
        rep = torch.where(x < 0.0, 1.0 - torch.remainder(torch.abs(x), 1.0),
                          x)
        rep = torch.where(rep > 1.0, torch.remainder(rep, 1.0), rep)
        clamp = vec.clamp(x, 0.0, 1.0)
        mir = 1.0 - torch.abs(
            torch.remainder(torch.abs(x) / 2.0, 1.0) * 2.0 - 1.0)
        return torch.where(w == REPEAT, rep, torch.where(w == CLAMP, clamp,
                                                         mir))

    def _sample_raw(self, ids, uv):
        """Bilinear sample of RAW rows."""
        ids = ids.to(torch.int64)
        off = self.offset[ids].to(torch.int64)
        w, h, wm = self.width[ids], self.height[ids], self.wrap[ids]
        u = self._wrap(wm, uv[..., 0])
        v = self._wrap(wm, uv[..., 1])
        x = u * (w - 1).to(torch.float32)
        y = v * (h - 1).to(torch.float32)
        # A NaN coordinate samples texel 0 with NaN weights, as the
        # reference's float-to-int conversion (NaN -> 0) does; finite
        # wrapped coordinates lie inside the texture.
        xi = torch.nan_to_num(x, nan=0.0)
        yi = torch.nan_to_num(y, nan=0.0)
        x0, y0 = torch.floor(xi), torch.floor(yi)
        tx = (x - x0)[..., None]
        ty = (y - y0)[..., None]
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        x1 = torch.ceil(xi).to(torch.int64)
        y1 = torch.ceil(yi).to(torch.int64)
        w = w.to(torch.int64)
        # index_select: its backward adds with index_add_ (indexing's
        # sorts the indices).
        texel = lambda xx, yy: self.data.index_select(0, off + yy * w + xx)
        p0 = texel(x0, y0) * (1.0 - tx) + texel(x1, y0) * tx
        p1 = texel(x0, y1) * (1.0 - tx) + texel(x1, y1) * tx
        return p1 * ty + p0 * (1.0 - ty)

    def sample(self, ids, uv, raw=False):
        """Sample any row kind: ids (N,), uv (N, 2) -> (N, 4) RGBA.

        raw=True states that every id is a RAW row (true of the scenes'
        material textures); it samples once instead of twice and gives
        the same values."""
        if self.all_raw or raw:
            return self._sample_raw(ids, uv)
        ids = ids.to(torch.int64)
        kind = self.kind[ids][:, None]
        sl = self._sample_raw(self.left[ids], uv)
        sr = self._sample_raw(self.right[ids], uv)

        mode = self.mode[ids][:, None]
        blended = torch.where(
            mode == LIGHTEN, torch.maximum(sl, sr),
            torch.where(mode == DARKEN, torch.minimum(sl, sr),
                        torch.where(mode == ADDITION,
                                    vec.clamp(sl + sr, hi=1.0),
                                    vec.clamp(sl - sr, 0.0))))

        rgb = torch.stack(_ycbcr(sl, sr), dim=-1)
        ycbcr = torch.cat([torch.pow(vec.clamp(rgb, 0.0, 1.0), 2.2),
                           torch.ones_like(rgb[..., :1])], dim=-1)

        a = sl[..., 3:4]
        fallback = self.fb_color.index_select(0, ids) * (1.0 - a) + sl * a
        return torch.where(kind == RAW, sl,
                           torch.where(kind == BLEND, blended,
                                       torch.where(kind == YCBCR, ycbcr,
                                                   fallback)))


class AtlasBuilder:
    """Host-side accumulator producing a TextureAtlas."""

    def __init__(self):
        self._pixels = []   # flattened (H*W, 4) arrays
        self._rows = []
        self._cursor = 0

    def _add_row(self, **kw):
        row = dict(offset=0, width=1, height=1, wrap=REPEAT, kind=RAW,
                   left=len(self._rows), right=len(self._rows),
                   mode=LIGHTEN, fb_color=(0, 0, 0, 0))
        row.update(kw)
        self._rows.append(row)
        return len(self._rows) - 1

    def add_raw(self, rgba, wrap=REPEAT):
        """rgba: (H, W, 4) float32 in [0, 1], row 0 the image's top."""
        rgba = np.ascontiguousarray(np.asarray(rgba, np.float32))
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError(f"expected (H,W,4), got {rgba.shape}")
        h, w = rgba.shape[:2]
        tid = self._add_row(offset=self._cursor, width=w, height=h,
                            wrap=wrap)
        self._pixels.append(rgba.reshape(-1, 4))
        self._cursor += h * w
        return tid

    def add_png(self, path, wrap=REPEAT):
        """A RAW row of the PNG file's normalised RGBA texels."""
        from ..runtime.io import load_png
        return self.add_raw(load_png(path), wrap=wrap)

    def add_solid(self, rgba):
        """1x1 solid colour."""
        c = np.asarray(tuple(rgba) + (1.0,) * (4 - len(tuple(rgba))),
                       np.float32)
        return self.add_raw(c.reshape(1, 1, 4))

    def _check_raw(self, tid):
        if self._rows[tid]["kind"] != RAW:
            raise ValueError("combinator children must be RAW rows")

    def add_ycbcr(self, luma, chroma):
        """luma, chroma: RAW texture ids."""
        self._check_raw(luma)
        self._check_raw(chroma)
        return self._add_row(kind=YCBCR, left=luma, right=chroma)

    def add_blend(self, mode, left, right):
        self._check_raw(left)
        self._check_raw(right)
        return self._add_row(kind=BLEND, mode=mode, left=left, right=right)

    def add_fallback(self, color, inner):
        """A solid colour shown where the RAW row `inner` is transparent."""
        self._check_raw(inner)
        c = tuple(color) + (1.0,) * (4 - len(tuple(color)))
        return self._add_row(kind=FALLBACK, left=inner, fb_color=c)

    def _host_pixels(self, tid):
        """A RAW or YCBCR row evaluated to an (H, W, 4) array."""
        row = self._rows[tid]
        if row["kind"] == RAW:
            off, w, h = row["offset"], row["width"], row["height"]
            flat = np.concatenate(self._pixels, axis=0)
            return flat[off:off + w * h].reshape(h, w, 4)
        if row["kind"] == YCBCR:
            luma = self._host_pixels(row["left"])
            chroma = self._host_pixels(row["right"])
            chroma = _host_resample(chroma, luma.shape[0], luma.shape[1])
            rgb = np.clip(np.stack(_ycbcr(luma, chroma), -1), 0.0, 1.0) ** 2.2
            return np.concatenate(
                [rgb, np.ones(rgb.shape[:-1] + (1,), np.float32)], -1)
        raise NotImplementedError(f"host eval of kind {row['kind']}")

    def bake_blend(self, mode, left, right, wrap=REPEAT):
        """A blend of two host-evaluable rows baked into a RAW row at the
        finer resolution: the atlas resolves one combinator level when it
        samples, and the reference nests two (stars added to a YCbCr
        nebula)."""
        lp = self._host_pixels(left)
        rp = self._host_pixels(right)
        h = max(lp.shape[0], rp.shape[0])
        w = max(lp.shape[1], rp.shape[1])
        lp = _host_resample(lp, h, w)
        rp = _host_resample(rp, h, w)
        if mode == LIGHTEN:
            out = np.maximum(lp, rp)
        elif mode == DARKEN:
            out = np.minimum(lp, rp)
        elif mode == ADDITION:
            out = np.minimum(lp + rp, 1.0)
        else:
            out = np.maximum(lp - rp, 0.0)
        return self.add_raw(out, wrap=wrap)

    def bake_addition(self, left, right, wrap=REPEAT):
        return self.bake_blend(ADDITION, left, right, wrap=wrap)

    def build(self) -> TextureAtlas:
        """The atlas, on the CPU (``.to(device)`` moves it)."""
        if not self._pixels:
            self.add_solid((1.0, 1.0, 1.0, 1.0))
        col = lambda k, dt: np.array([r[k] for r in self._rows], dt)
        i32 = np.int32
        return TextureAtlas(
            data=np.concatenate(self._pixels, axis=0),
            offset=col("offset", i32), width=col("width", i32),
            height=col("height", i32), wrap=col("wrap", i32),
            kind=col("kind", i32), left=col("left", i32),
            right=col("right", i32), mode=col("mode", i32),
            fb_color=col("fb_color", np.float32))
