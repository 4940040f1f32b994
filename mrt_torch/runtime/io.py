"""PNG export and import with numpy and zlib (mirrors ``mrt.runtime.io``).

The reference writes and reads through PIL; the port has its own codec,
so it needs no imaging library.  Film rows run bottom-up, so
``save_png`` flips them, as the reference's export does.

``load_png`` returns what PIL's ``Image.open(path).convert("RGBA")``
gives, the reference's reading, including PIL's own mappings: 1-, 2-
and 4-bit grey scaled to 0..255; 16-bit grey clipped to 255; 16-bit
colour cut to its high byte; the low byte of a tRNS colour compared
with the mapped values; palette alphas from tRNS (255 past its end) and black past the
palette's end.  Interlaced (Adam7) files are read pass by pass, as PIL
reads them.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..utils import profiling

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples a pixel; and the bit depths each allows.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's seven passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


@profiling.spanned("png_encode")
def png_encode(rgb_bottom_up):
    """(H, W, 3) uint8 rows bottom-up -> the bytes of an 8-bit RGB PNG,
    rows top-down; every row filtered by Up (one vector subtraction)."""
    rgb = np.asarray(rgb_bottom_up)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} "
                         f"{rgb.dtype}")
    h, w = rgb.shape[:2]
    rows = rgb[::-1].reshape(h, w * 3)
    up = np.empty((h, w * 3 + 1), np.uint8)
    up[:, 0] = 2
    up[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=up[1:, 1:])
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), 6))
            + _chunk(b"IEND", b""))


@profiling.spanned("PNG write")
def save_png(path, rgb_bytes):
    """Write (H, W, 3) uint8 bottom-up rows to a top-down PNG file,
    creating its directory."""
    data = png_encode(rgb_bytes)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _chunks(data):
    """Yields (kind, payload) of each chunk, checking the CRCs."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"broken PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter_rows(ftype, x, bpp):
    """Row by row, for images whose rows use None, Sub and Up only."""
    out = np.empty_like(x)
    prev = np.zeros(x.shape[1], np.uint8)
    for r, f in enumerate(ftype):
        if f == 0:
            out[r] = x[r]
        elif f == 1:   # Sub: a running sum (mod 256) of each byte lane
            out[r] = np.cumsum(x[r].reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        else:          # Up
            np.add(x[r], prev, out=out[r])
        prev = out[r]
    return out


def _unfilter_diagonals(ftype, x, bpp):
    """Any filter types, one anti-diagonal of pixels at a time: a pixel
    depends only on its left, upper and upper-left neighbours, so the
    pixels (r, c) with r + c = k all depend on diagonals k-1 and k-2
    alone.  W + H - 1 vector steps, each row's filter type choosing its
    predictor."""
    h = x.shape[0]
    w = x.shape[1] // bpp
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    skew = np.zeros((w + h - 1, h, bpp), np.int16)
    skew[r + c, r] = x.reshape(h, w, bpp)
    # z[k + 2, r + 1] holds pixel (r, k - r); other cells stay 0, the
    # predictors' value outside the image.
    z = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    kinds = ftype.astype(np.intp)[:, None]
    zero = np.zeros((), np.int16)
    for k in range(w + h - 1):
        r0, r1 = max(0, k - w + 1), min(h - 1, k) + 1
        a = z[k + 1, r0 + 1:r1 + 1]      # left
        b = z[k + 1, r0:r1]              # up
        ul = z[k, r0:r1]                 # upper left
        pa = np.abs(b - ul)
        pb = np.abs(a - ul)
        pc = np.abs(a + b - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        pred = np.choose(kinds[r0:r1], (zero, a, b, (a + b) >> 1, paeth))
        z[k + 2, r0 + 1:r1 + 1] = (skew[k, r0:r1] + pred) & 255
    return z[r + c + 2, r + 1].astype(np.uint8).reshape(h, w * bpp)


def _unfilter(raw, h, stride, bpp):
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is short")
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    ftype, x = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {ftype.max()}")
    if np.isin(ftype, (3, 4)).any():
        return _unfilter_diagonals(ftype, x, bpp)
    return _unfilter_rows(ftype, x, bpp)


def _samples(data, w, depth, channels):
    """Unfiltered rows -> (H, W, channels) integer samples."""
    data = np.ascontiguousarray(data)
    h = data.shape[0]
    if depth == 16:
        return data.reshape(h, -1).view(">u2").reshape(
            h, w, channels).astype(np.int64)
    if depth == 8:
        return data.reshape(h, w, channels).astype(np.int64)
    bits = np.unpackbits(data, axis=1).reshape(h, -1, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (bits @ weights)[:, :w, None].astype(np.int64)


def _deinterlace(raw, w, h, depth, channels, bpp):
    """Adam7 image data -> (H, W, channels) samples: each pass is a
    sub-image with its own scanlines and filters, one after another in
    the stream (a pass with no pixels has no bytes), scattered into the
    image at its (row, column) lattice."""
    v = np.zeros((h, w, channels), np.int64)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * channels * depth + 7) // 8
        rows = _unfilter(raw[pos:], ph, stride, bpp)
        v[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
        pos += ph * (stride + 1)
    return v


def _rgba(v, ctype, depth, palette, trns):
    """Samples -> (H, W, 4) uint8 as PIL's convert("RGBA") maps them."""
    h, w = v.shape[:2]
    out = np.empty((h, w, 4), np.int64)
    out[..., 3] = 255
    if ctype == 3:
        pal = np.zeros((256, 3), np.int64)
        entries = np.frombuffer(palette, np.uint8)[:768].reshape(-1, 3)
        pal[:len(entries)] = entries
        alpha = np.full(256, 255, np.int64)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
        idx = v[..., 0]
        out[..., :3] = pal[idx]
        out[..., 3] = alpha[idx]
        return out.astype(np.uint8)
    if depth == 16:
        # PIL keeps 16-bit colour's high byte and clips 16-bit grey.
        v = np.minimum(v, 255) if ctype == 0 else v >> 8
    elif depth < 8:
        v = v * (255 // ((1 << depth) - 1))
    grey = ctype in (0, 4)
    out[..., :3] = v[..., :1] if grey else v[..., :3]
    if ctype in (4, 6):
        out[..., 3] = v[..., -1]
    elif trns is not None:
        # PIL compares the low byte of the tRNS colour (1-bit grey: 0 or
        # 255) with the mapped samples.
        key = np.asarray(struct.unpack(f">{len(trns) // 2}H", trns)[
            :1 if grey else 3], np.int64)
        key = np.where(key != 0, 255, 0) if depth == 1 else key & 255
        match = (v[..., :1] if grey else v[..., :3]) == key
        out[..., 3] = np.where(match.all(axis=-1), 0, 255)
    return out.astype(np.uint8)


def decode_png(data):
    """PNG bytes -> (H, W, 4) uint8 RGBA, rows top-down, as PIL's
    convert("RGBA") gives them."""
    header, palette, trns, idat = None, b"", None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = payload
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth}")
    if not idat:
        raise ValueError("PNG file has no IDAT")
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    raw = memoryview(zlib.decompress(b"".join(idat)))
    if interlace:
        v = _deinterlace(raw, w, h, depth, channels, bpp)
    else:
        stride = (w * channels * depth + 7) // 8
        v = _samples(_unfilter(raw, h, stride, bpp), w, depth, channels)
    return _rgba(v, ctype, depth, palette, trns)


def load_png(path):
    """Load a PNG as (H, W, 4) float32 RGBA values / 255, rows top-down
    as stored in the file."""
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.float32) / 255.0
