"""A plain PNG reader for 8-bit RGB images without interlacing, the
form the port writes: its chunks, zlib's inflate, and the None, Sub and
Up row filters (any other raises)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def decode_rgb(data):
    """(H, W, 3) uint8, rows top-down as stored."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = head
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"not 8-bit RGB without interlacing: {head}")
    stride = 3 * w
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, x = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = x.copy()
        elif f == 2:
            cur = x + prev  # uint8 wraps modulo 256
        elif f == 1:
            cur = x.copy()
            for i in range(3, stride):
                cur[i] = cur[i] + cur[i - 3]
        else:
            raise ValueError(f"PNG filter {f} not read here")
        out[y] = prev = cur
    return out.reshape(h, w, 3)
