"""Port parity: the mesh loaders, asset lookup and input record/replay
(mrt_torch vs mrt).

All of it is host code on both sides, so the outputs must be equal:
vertices, faces, Triangles arrays (byte-equal) and material rows, on
the JAX loader tests' fixtures and on the playground level.  A
``map_Kd`` row loads its PNG in both packages (tests/test_torch_png.py
holds the texels and rows against JAX's builder).
"""

import os
import struct

import numpy as np
import pytest

from mrt import loaders as JL
from mrt.materials.table import MaterialBuilder as JMaterialBuilder
from mrt.runtime import assets as JA
from mrt.runtime import input as JIN
from mrt.textures import AtlasBuilder
from mrt_torch import loaders as TL
from mrt_torch.geometry import triangles as TT
from mrt_torch.materials.table import MaterialBuilder as TMaterialBuilder
from mrt_torch.materials.table import MaterialTable
from mrt_torch.runtime import assets as TA
from mrt_torch.runtime import input as TIN
from mrt_torch.textures.atlas import AtlasBuilder as TAtlasBuilder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = os.path.join(ROOT, "assets", "level", "playground_level.obj")
INPUT = os.path.join(ROOT, "assets", "playground_input.bin")

OBJ = """\
# comment
mtllib test.mtl
o main
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 1
vn 0 0 1
vn 0 1 0
vt 0 0
vt 1 0
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
g skipme
f 1/1/1 2/2/1 4/1/2
usemtl blue
g keep
f 2/2/1 3/3/2 4/1/1
"""
MTL = """\
newmtl red
Kd 0.9 0.1 0.2
newmtl blue
Kd 0.1 0.2 0.8
"""


def _write_obj(tmp_path, mtl=MTL):
    (tmp_path / "test.obj").write_text(OBJ)
    (tmp_path / "test.mtl").write_text(mtl)
    return str(tmp_path / "test.obj")


def _equal(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, what
    assert want.tobytes() == got.tobytes(), what


def _textured(path, filtered=(), port_atlas=None):
    jm, tm = JMaterialBuilder(), TMaterialBuilder()
    jb = JL.SimpleTexturedBuilder(jm, AtlasBuilder(), filtered_groups=filtered)
    tb = TL.SimpleTexturedBuilder(tm, port_atlas, filtered_groups=filtered)
    JL.load_obj(path, jb)
    TL.load_obj(path, tb)
    return jb.finish(), tb.finish(), jm.build(), tm.build()


def _same_build(jt, tt, jtable, ttable):
    for k in TT.FIELDS:
        _equal(getattr(jt, k), getattr(tt, k), k)
    for k in MaterialTable.FIELDS:
        _equal(getattr(jtable, k), getattr(ttable, k).numpy(), k)


@pytest.mark.parametrize("filtered", [(), ("skipme",)])
def test_obj_textured_builder_matches(tmp_path, filtered):
    jt, tt, jtable, ttable = _textured(_write_obj(tmp_path), filtered)
    assert tt.count == (2 if filtered else 3)
    _same_build(jt, tt, jtable, ttable)
    np.testing.assert_allclose(tt.uva[0], [0.0, 1.0])  # the V flip


def test_playground_level_matches():
    jt, tt, jtable, ttable = _textured(LEVEL)
    assert tt.count > 100 and ttable.mtype.shape[0] == 3
    _same_build(jt, tt, jtable, ttable)
    # Kd + (1,) passes an RGBA albedo through MaterialBuilder._rgba.
    np.testing.assert_allclose(ttable.albedo.numpy()[:, 3], 1.0)


def test_map_kd_raises_instead_of_dropping_the_texture(tmp_path):
    # A map_Kd whose file is missing fails the .mtl in both packages (the
    # library's OSError is reported, then its faces find no material);
    # one given no atlas to load it into raises.  Neither drops the
    # texture.
    path = _write_obj(tmp_path, MTL + "newmtl tex\nmap_Kd checker.png\n")
    for mod, mats, atlas, error, match in (
            (JL, JMaterialBuilder, AtlasBuilder(), ValueError, "No material"),
            (TL, TMaterialBuilder, TAtlasBuilder(), ValueError, "No material"),
            (JL, JMaterialBuilder, None, AttributeError, "add_png"),
            (TL, TMaterialBuilder, None, AttributeError, "add_png")):
        with pytest.raises(error, match=match):
            mod.load_obj(path, mod.SimpleTexturedBuilder(mats(), atlas))


def test_textured_builder_takes_an_atlas(tmp_path):
    # An .mtl without map_Kd rows, built with an atlas: the material rows
    # of JAX's builder, and the atlas untouched.
    atlas = TAtlasBuilder()
    jt, tt, jtable, ttable = _textured(_write_obj(tmp_path),
                                       port_atlas=atlas)
    _same_build(jt, tt, jtable, ttable)
    assert not atlas._rows


@pytest.mark.parametrize("text", [
    OBJ,
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvt 0.5 0.25\nf 1//1 2//1 3//1\n",
])
def test_obj_fn_builder_faces_match(tmp_path, text):
    p = tmp_path / "n.obj"
    p.write_text(text)
    builder = dict(face_fn=lambda a, b, c: (a, b, c),
                   group_filter=lambda g: g != "skipme")
    want = JL.load_obj(str(p), JL.FnObjBuilder(**builder))
    got = TL.load_obj(str(p), TL.FnObjBuilder(**builder))
    assert got == want and len(got) >= 1


@pytest.mark.parametrize("text,match", [("v 1 nope 3\n", "vertex"),
                                        ("vn 1\n", "normal"),
                                        ("v 0 0 0\nf 1 1 1\n", "face")])
def test_obj_malformed_raises(tmp_path, text, match):
    p = tmp_path / "bad.obj"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        TL.load_obj(str(p), TL.FnObjBuilder())


_PLY_VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                      np.float32)
_PLY_FACES = np.array([[0, 1, 2], [1, 3, 2]], np.int64)


def _ascii_ply():
    lines = ["ply", "format ascii 1.0", "comment generated",
             "element vertex 4", "property float x", "property float y",
             "property float z", "property float confidence",
             "element face 2", "property list uchar int vertex_indices",
             "end_header"]
    lines += [f"{v[0]} {v[1]} {v[2]} 0.5" for v in _PLY_VERTS]
    lines += [f"3 {f[0]} {f[1]} {f[2]}" for f in _PLY_FACES]
    return ("\n".join(lines) + "\n").encode()


def _binary_ply(endian, quad=False):
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex 4\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar quality\nelement face 3\n"
              "property list uchar int vertex_indices\nend_header\n")
    body = b"".join(struct.pack(endian + "fffB", *v, 7) for v in _PLY_VERTS)
    body += b"".join(struct.pack(endian + "Biii", 3, *f) for f in _PLY_FACES)
    # A quad: dropped, and it sends the faces down the per-row parse.
    body += (struct.pack(endian + "Biiii", 4, 0, 1, 3, 2) if quad
             else struct.pack(endian + "Biii", 3, 0, 2, 3))
    return header.encode() + body


@pytest.mark.parametrize("kind", ["ascii", "<", ">", "<quad"])
def test_ply_matches(tmp_path, kind):
    p = tmp_path / "m.ply"
    p.write_bytes(_ascii_ply() if kind == "ascii"
                  else _binary_ply(kind[0], quad=kind == "<quad"))
    want = JL.load_ply(str(p))
    got = TL.load_ply(str(p))
    for w, g in zip(want, got):
        _equal(w, g, kind)
    np.testing.assert_array_equal(got[0], _PLY_VERTS)
    seen_v, seen_f = [], []
    TL.load_ply(str(p), vertex_fn=lambda *v: seen_v.append(v),
                face_fn=lambda *f: seen_f.append(f))
    assert len(seen_v) == 4 and len(seen_f) == len(got[1])


def test_ply_bad_magic(tmp_path):
    p = tmp_path / "x.ply"
    p.write_bytes(b"notply\n")
    with pytest.raises(ValueError, match="magic"):
        TL.load_ply(str(p))


def _stl(tris, count=None):
    body = b"H" * 80 + struct.pack("<I", len(tris) if count is None
                                   else count)
    for t in tris:
        body += struct.pack("<fff", 0, 0, 1)
        body += b"".join(struct.pack("<fff", *v) for v in t)
        body += struct.pack("<H", 0)
    return body


def test_stl_matches(tmp_path):
    rs = np.random.default_rng(2)
    p = tmp_path / "t.stl"
    p.write_bytes(_stl(rs.standard_normal((5, 3, 3)).astype(np.float32)))
    for w, g in zip(JL.load_stl_binary(str(p)), TL.load_stl_binary(str(p))):
        _equal(w, g, "stl")
    bad = tmp_path / "bad.stl"
    bad.write_bytes(_stl([], count=5) + b"xx")
    with pytest.raises(ValueError, match="truncated"):
        TL.load_stl_binary(str(bad))


def test_asset_resolve_matches(tmp_path, monkeypatch):
    (tmp_path / "lucy.ply").write_bytes(b"ply\n")
    cases = ["models/lucy.ply", "models/none.ply", "assets/level",
             str(tmp_path / "lucy.ply"), "README.md"]
    for env in (None, str(tmp_path)):
        if env is None:
            monkeypatch.delenv("MRT_MODELS_DIR", raising=False)
        else:
            monkeypatch.setenv("MRT_MODELS_DIR", env)
        for path in cases:
            assert TA.resolve(path) == JA.resolve(path), (env, path)
    assert TA.resolve("models/lucy.ply") == str(tmp_path / "lucy.ply")


def test_input_replay_and_record_match(tmp_path):
    want, got = JIN.InputReplay(INPUT), TIN.InputReplay(INPUT)
    assert len(got.frames) == len(want.frames) == 150
    for i in (0, 7, 149, 500):  # past the end: the last frame
        assert (got.frame(i).pack() == want.frame(i).pack())
    rec = TIN.InputRecorder()
    for f in got.frames:
        rec.record(f)
    rec.save(tmp_path / "again.bin")
    with open(INPUT, "rb") as f:
        assert (tmp_path / "again.bin").read_bytes() == f.read()
    (tmp_path / "empty.bin").write_bytes(b"")
    assert (TIN.InputReplay(tmp_path / "empty.bin").frame(3)
            == TIN.InputCollection())
