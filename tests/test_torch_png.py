"""Port parity: the PNG codec (``mrt_torch.runtime.io``) against PIL, the
reference's reader, and the PNG users it makes reachable (the atlas's
``add_png``, the OBJ builder's ``map_Kd``, the environment's asset
branch) against the JAX package.

Decoding must be byte-equal to PIL's ``Image.open(p).convert("RGBA")``
(then / 255 as float32, as ``mrt.runtime.io.load_png`` returns it), on
the repository's previews and on small files of every colour type and
bit depth, written by PIL or by this file's own writer (which forces
each filter type and tRNS).  PIL's own mappings are pinned one by one.
"""

import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from mrt.loaders import SimpleTexturedBuilder as JBuilder
from mrt.loaders import load_obj as jload_obj
from mrt.materials.table import MaterialBuilder as JMaterialBuilder
from mrt.runtime import io as JIO
from mrt.runtime.viewer import png_bytes
from mrt.scenes import envmaps as JE
from mrt.textures import atlas as JA
from mrt_torch.loaders import SimpleTexturedBuilder as TBuilder
from mrt_torch.loaders import load_obj as tload_obj
from mrt_torch.materials.table import MaterialBuilder as TMaterialBuilder
from mrt_torch.materials.table import MaterialTable
from mrt_torch.runtime import io as TIO
from mrt_torch.scenes import envmaps as TE
from mrt_torch.textures import atlas as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREVIEWS = sorted(glob.glob(os.path.join(ROOT, "assets", "previews",
                                         "*.png")))


def _pil(path):
    return np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0


def _same(path):
    want, got = _pil(path), TIO.load_png(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return got


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filter(rows, bpp, kinds):
    """rows (H, stride) uint8 -> filtered scanlines, row r by
    kinds[r % len(kinds)]."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for r, x in enumerate(rows.astype(np.int64)):
        kind = kinds[r % len(kinds)]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = (0, a, b, (a + b) // 2,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c)))[kind]
        out.append(kind)
        out += ((x - pred) & 255).astype(np.uint8).tobytes()
        prev = x
    return bytes(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack(rows, width, depth, channels):
    """Packed rows (H, stride) uint8 -> (H, width, channels) samples."""
    h = rows.shape[0]
    if depth == 16:
        v = np.ascontiguousarray(rows).view(">u2").astype(np.int64)
    elif depth == 8:
        v = rows.astype(np.int64)
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        v = bits @ (1 << np.arange(depth - 1, -1, -1))
    return v[:, :width * channels].reshape(h, width, channels)


def _adam7(rows, width, depth, channels, bpp, kinds):
    """The seven Adam7 passes of packed rows, each filtered on its own
    (its first row against zeros), one after another; a pass with no
    pixels writes nothing."""
    v = _unpack(rows, width, depth, channels)
    out = b""
    for x0, y0, dx, dy in ADAM7:
        sub = v[y0::dy, x0::dx]
        if sub.size:
            out += _filter(_pack(sub.reshape(sub.shape[0], -1), depth), bpp,
                           kinds)
    return out


def write_png(path, rows, width, depth, ctype, kinds=(0,), plte=None,
              trns=None, interlace=0):
    """A PNG of unfiltered rows (H, stride) uint8, its IDAT split in two;
    interlace=1 writes the image as Adam7's seven passes."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, channels * depth // 8)
    data = zlib.compress(_adam7(rows, width, depth, channels, bpp, kinds)
                         if interlace else _filter(rows, bpp, kinds))
    head = struct.pack(">IIBBBBB", width, rows.shape[0], depth, ctype, 0, 0,
                       interlace)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head)
    if plte is not None:
        out += _chunk(b"PLTE", bytes(plte))
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    half = len(data) // 2
    out += (_chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(out)
    return str(path)


def _rows(rs, h, width, depth, ctype, high=None):
    """Random samples packed into (H, stride) uint8 rows."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) if high is None else high
    return _pack(rs.integers(0, top, (h, width * channels)), depth)


def _pack(v, depth):
    """(H, N) samples -> (H, stride) uint8 rows at the bit depth."""
    h = v.shape[0]
    if depth == 16:
        return v.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return v.astype(np.uint8)
    per = 8 // depth
    pad = (-v.shape[1]) % per
    v = np.concatenate([v, np.zeros((h, pad), v.dtype)], 1)
    v = v.reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (v << shifts).sum(-1).astype(np.uint8)


# Filter kinds by row: each alone, and all five cycling.
KINDS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
           (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
PLTE = [255, 0, 0, 0, 255, 0, 0, 0, 255, 9, 9, 9, 200, 100, 50]


@pytest.mark.parametrize("path", PREVIEWS, ids=os.path.basename)
def test_previews_decode_like_pil(path):
    assert len(PREVIEWS) == 11
    _same(path)


@pytest.mark.parametrize("ctype,depth", FORMATS)
def test_every_format_and_filter_decodes_like_pil(tmp_path, ctype, depth):
    rs = np.random.default_rng(ctype * 100 + depth)
    width, h = 13, 7
    high = 8 if ctype == 3 else None   # some indices past the palette
    rows = _rows(rs, h, width, depth, ctype, high)
    plte = PLTE if ctype == 3 else None
    for kinds in KINDS:
        _same(write_png(tmp_path / "a.png", rows, width, depth, ctype, kinds,
                        plte=plte))


# (width, height): under 8x8, where passes are empty, and widths that are
# not a multiple of 8.
ADAM7_SIZES = [(1, 1), (2, 3), (5, 4), (7, 9), (13, 7), (17, 11)]


@pytest.mark.parametrize("ctype,depth", FORMATS)
def test_interlaced_files_decode_like_pil(tmp_path, ctype, depth):
    rs = np.random.default_rng(ctype * 100 + depth + 1)
    high = 8 if ctype == 3 else None
    plte = PLTE if ctype == 3 else None
    for i, (width, h) in enumerate(ADAM7_SIZES):
        rows = _rows(rs, h, width, depth, ctype, high)
        path = write_png(tmp_path / "a.png", rows, width, depth, ctype,
                         KINDS[i % len(KINDS)], plte=plte, interlace=1)
        assert Image.open(path).info.get("interlace") == 1
        got = _same(path)
        # The same samples written without interlacing read the same.
        flat = write_png(tmp_path / "f.png", rows, width, depth, ctype,
                         plte=plte)
        assert TIO.load_png(flat).tobytes() == got.tobytes()


def _trns_cases(ctype, depth, rows, rs):
    """tRNS payloads to try: a sample that occurs, one that does not and,
    for palettes, simple and per-entry alphas shorter and longer than the
    palette."""
    if ctype == 3:
        return [bytes([255, 0]), bytes([0]), bytes([10, 20, 30]),
                bytes(range(7, 17)), bytes([255, 255])]
    if ctype == 0:
        seen = int(rs.integers(0, 1 << depth))
        return [struct.pack(">H", seen), struct.pack(">H", 0),
                struct.pack(">H", (1 << depth) - 1), struct.pack(">H", 255),
                struct.pack(">H", 300), struct.pack(">H", 256 + seen)]
    first = (rows[0, :6].view(">u2")[:3] if depth == 16 else rows[0, :3])
    return [struct.pack(">HHH", *map(int, first)), struct.pack(">HHH", 3, 1, 255),
            struct.pack(">HHH", 1000, 2, 3)]


@pytest.mark.parametrize("ctype,depth", [f for f in FORMATS
                                         if f[0] in (0, 2, 3)])
def test_trns_decodes_like_pil(tmp_path, ctype, depth):
    rs = np.random.default_rng(7 + ctype * 100 + depth)
    width, h = 9, 5
    rows = _rows(rs, h, width, depth, ctype, 6 if ctype == 3 else None)
    if ctype == 2 and depth == 16:
        # Pixels whose 16-bit value is small enough to equal a high byte.
        rows[1, :6] = np.asarray([3, 1, 255], ">u2").view(np.uint8)
        rows[1, 6:12] = np.asarray([0, 3, 0, 1, 0, 255], np.uint8)
    for trns in _trns_cases(ctype, depth, rows, rs):
        _same(write_png(tmp_path / "t.png", rows, width, depth, ctype, (4, 1),
                        plte=PLTE if ctype == 3 else None, trns=trns))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "P", "P+tRNS",
                                  "I;16"])
def test_pil_written_modes_decode_like_pil(tmp_path, mode):
    rs = np.random.default_rng(3)
    h, w = 37, 29
    if mode == "I;16":
        img = Image.fromarray(rs.integers(0, 65536, (h, w)).astype(np.uint16))
    elif mode.startswith("P"):
        img = Image.fromarray(rs.integers(0, 12, (h, w)).astype(np.uint8), "L")
        img = img.convert("P")
        img.putpalette(rs.integers(0, 256, 36).astype(np.uint8).tobytes())
        if mode == "P+tRNS":
            img.info["transparency"] = bytes(rs.integers(0, 256, 12)
                                             .astype(np.uint8))
    else:
        bands = {"1": 1, "L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = rs.integers(0, 256, (h, w, bands)).astype(np.uint8)
        img = Image.fromarray(arr[..., 0] if bands == 1 else arr,
                              "L" if bands == 1 else mode)
        if mode == "1":
            img = img.convert("1")
    path = str(tmp_path / "m.png")
    img.save(path, **({"transparency": img.info["transparency"]}
                      if "transparency" in img.info else {}))
    assert Image.open(path).mode == mode.split("+")[0]
    _same(path)


def test_pil_mappings_are_pinned(tmp_path):
    """PIL's odd mappings, one by one: 16-bit grey clips, 16-bit colour
    keeps its high byte, 2- and 4-bit grey scale, 1-bit grey's tRNS is 0
    or 255, palette alphas come from tRNS."""
    g16 = np.asarray([[0, 4000, 8000, 255, 256]], ">u2").view(np.uint8)
    got = TIO.load_png(write_png(tmp_path / "a.png", g16, 5, 16, 0))
    np.testing.assert_array_equal(got[0, :3, 0] * 255, [0, 255, 255])
    rgb16 = np.asarray([[1000, 300, 65535]], ">u2").view(np.uint8)
    got = TIO.decode_png(open(write_png(tmp_path / "b.png", rgb16, 1, 16, 2),
                              "rb").read())
    np.testing.assert_array_equal(got[0, 0], [3, 1, 255, 255])
    g2 = np.asarray([[0b00011011]], np.uint8)
    got = TIO.decode_png(open(write_png(tmp_path / "c.png", g2, 4, 2, 0,
                                        trns=struct.pack(">H", 1)),
                              "rb").read())
    # Scaled by 85; tRNS 1 matches no scaled value.
    np.testing.assert_array_equal(got[0, :, 0], [0, 85, 170, 255])
    np.testing.assert_array_equal(got[0, :, 3], 255)
    # tRNS is compared by its low byte: 273 makes 17 transparent.
    g16 = np.asarray([[17, 273, 4000]], ">u2").view(np.uint8)
    got = TIO.decode_png(open(write_png(tmp_path / "f.png", g16, 3, 16, 0,
                                        trns=struct.pack(">H", 273)),
                              "rb").read())
    np.testing.assert_array_equal(got[0, :, 3], [0, 255, 255])
    g1 = np.asarray([[0b10000000]], np.uint8)
    got = TIO.decode_png(open(write_png(tmp_path / "d.png", g1, 2, 1, 0,
                                        trns=struct.pack(">H", 1)),
                              "rb").read())
    np.testing.assert_array_equal(got[0, :, 3], [0, 255])
    pal = np.asarray([[0, 1, 5]], np.uint8)
    got = TIO.decode_png(open(write_png(tmp_path / "e.png", pal, 3, 8, 3,
                                        plte=PLTE[:6], trns=bytes([7])),
                              "rb").read())
    np.testing.assert_array_equal(got[0], [[255, 0, 0, 7], [0, 255, 0, 255],
                                           [0, 0, 0, 255]])
    for p in "abcdef":
        _same(str(tmp_path / f"{p}.png"))


def test_interlaced_and_broken_files_raise(tmp_path):
    # An interlaced file reads as PIL reads it; broken files raise.
    rows = _rows(np.random.default_rng(0), 4, 4, 8, 2)
    path = write_png(tmp_path / "i.png", rows, 4, 8, 2, interlace=1)
    assert Image.open(path).info.get("interlace") == 1
    _same(path)
    data = bytearray(open(write_png(tmp_path / "ok.png", rows, 4, 8, 2),
                          "rb").read())
    data[40] ^= 1   # inside IDAT: the CRC no longer holds
    with pytest.raises(ValueError, match="broken"):
        TIO.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        TIO.decode_png(b"GIF89a" + bytes(20))


def test_save_png_round_trips(tmp_path):
    rs = np.random.default_rng(1)
    rgb = rs.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    rgb[5:9] = rgb[4]   # rows Up leaves at zero
    path = str(tmp_path / "deep" / "dir" / "out.png")
    TIO.save_png(path, rgb)   # makes its directory, as mrt's does
    want_path = str(tmp_path / "ref.png")
    JIO.save_png(want_path, rgb)
    flipped = rgb[::-1]
    pil = np.asarray(Image.open(path))
    assert Image.open(path).mode == "RGB"
    np.testing.assert_array_equal(pil, flipped)
    np.testing.assert_array_equal(pil, np.asarray(Image.open(want_path)))
    got = TIO.load_png(path)
    np.testing.assert_array_equal((got[..., :3] * 255).round(), flipped)
    assert (got[..., 3] == 1.0).all()
    # The viewer's encoder: the same image as the reference's PIL bytes.
    ours = Image.open(io.BytesIO(TIO.png_encode(rgb)))
    theirs = Image.open(io.BytesIO(png_bytes(rgb)))
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    with pytest.raises(ValueError, match="uint8"):
        TIO.png_encode(rgb.astype(np.float32))


def _atlas_equal(ja, ta):
    for k in TA.TextureAtlas.FIELDS:
        want, got = np.asarray(getattr(ja, k)), getattr(ta, k).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, k
        assert want.tobytes() == got.tobytes(), k


OBJ = """\
mtllib tex.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vt 0 0
vt 1 0
vt 0 1
vt 1 1
vn 0 0 1
usemtl checker
f 1/1/1 2/2/1 3/3/1
usemtl plain
f 2/2/1 4/4/1 3/3/1
usemtl second
f 1/1/1 4/4/1 3/3/1
"""
MTL = """\
newmtl checker
Kd 0.5 0.5 0.5
map_Kd checker.png
newmtl plain
Kd 0.9 0.1 0.2
newmtl second
map_Kd sub/pal.png
"""


def test_map_kd_matches_reference(tmp_path):
    rs = np.random.default_rng(4)
    Image.fromarray(rs.integers(0, 256, (6, 5, 4)).astype(np.uint8),
                    "RGBA").save(tmp_path / "checker.png")
    os.makedirs(tmp_path / "sub")
    write_png(tmp_path / "sub" / "pal.png", _rows(rs, 3, 4, 4, 3, 5), 4, 4, 3,
              (3, 4), plte=PLTE, trns=bytes([100, 0]))
    (tmp_path / "tex.obj").write_text(OBJ)
    (tmp_path / "tex.mtl").write_text(MTL)
    path = str(tmp_path / "tex.obj")
    jm, ja = JMaterialBuilder(), JA.AtlasBuilder()
    tm, ta = TMaterialBuilder(), TA.AtlasBuilder()
    jb, tb = JBuilder(jm, ja, wrap=JA.CLAMP), TBuilder(tm, ta, wrap=TA.CLAMP)
    jload_obj(path, jb)
    tload_obj(path, tb)
    jt, tt = jb.finish(), tb.finish()
    np.testing.assert_array_equal(np.asarray(jt.material),
                                  np.asarray(tt.material))
    jtable, ttable = jm.build(), tm.build()
    for k in MaterialTable.FIELDS:
        want, got = np.asarray(getattr(jtable, k)), getattr(ttable, k).numpy()
        assert want.tobytes() == got.tobytes() and want.shape == got.shape, k
    assert len(ta._rows) == 2
    _atlas_equal(ja.build(), ta.build())


def test_environment_assets_match_reference(tmp_path):
    rs = np.random.default_rng(6)
    root = tmp_path / "environments"
    os.makedirs(root / "j02")
    Image.fromarray(rs.integers(0, 256, (8, 8, 3)).astype(np.uint8)).save(
        root / "stars01_tile2.png")
    for i in range(6):
        Image.fromarray(rs.integers(0, 256, (4, 4)).astype(np.uint8)).save(
            root / "j02" / f"{i}.png")
        Image.fromarray(rs.integers(0, 256, (4, 4, 3)).astype(np.uint8)).save(
            root / "j02" / f"{i}_chroma.png")
    ja, ta = JA.AtlasBuilder(), TA.AtlasBuilder()
    jcube = JE.environment(ja, asset_root=str(root))
    tcube = TE.environment(ta, asset_root=str(root))
    # 13 files read, 6 YCbCr rows, 6 baked faces.
    assert len(ta._rows) == 25
    _atlas_equal(ja.build(), ta.build())
    np.testing.assert_array_equal(np.asarray(jcube.faces),
                                  tcube.faces.numpy())
    # Each package composes the rotation in float32 with its own sin and
    # cos (ROADMAP C9), on either branch.
    np.testing.assert_allclose(np.asarray(jcube.transform),
                               tcube.transform.numpy(), rtol=0, atol=1e-7)
