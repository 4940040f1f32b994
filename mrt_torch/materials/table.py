"""SoA material table (mirrors ``mrt.materials.table``).

Every material in a scene is a row of a flat table; a hit carries a row
index, and shading evaluates all classes branch-free and selects by
type.  Texture columns hold texture-atlas ids (NO_TEXTURE for none).
EVE is the packed-PBR ship material: three packed textures
(albedo+roughness in ``tex``, normal+occlusion in ``tex_no``, paint/
material/dirt/glow masks in ``tex_pmdg``), a four-colour faction
palette and a glow colour; it shades as a per-hit Mix(roughness + dirt,
Lambertian, Specular(1.8)).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.autodiff import Replace

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4
SPECULAR = 5
MIX = 6
NULL = 7
EVE = 8

# Mix nesting resolved per event; every resolution consumes this many
# draws, whatever the table's real depth.
MAX_MIX_DEPTH = 4

NO_TEXTURE = -1


class MaterialTable(Replace, nn.Module):
    """Buffers: mtype (M,) int32, albedo (M, 4), fuzz (M,), ior (M,),
    emit (M, 3), mix_ratio (M,) float32; mix_left, mix_right (M,) int32;
    tex, tex_no, tex_pmdg (M,) int32 texture ids; palette (M, 4, 3) and
    glow3 (M, 3) float32.  ``mix_depth`` is the table's actual Mix
    nesting depth.  ``replace(albedo=...)`` swaps columns, as an inverse
    render of them does (``core.autodiff.Replace``)."""

    FIELDS = {"mtype": torch.int32, "albedo": torch.float32,
              "fuzz": torch.float32, "ior": torch.float32,
              "emit": torch.float32, "mix_ratio": torch.float32,
              "mix_left": torch.int32, "mix_right": torch.int32,
              "tex": torch.int32, "tex_no": torch.int32,
              "tex_pmdg": torch.int32, "palette": torch.float32,
              "glow3": torch.float32}

    def __init__(self, mix_depth=MAX_MIX_DEPTH, **arrays):
        super().__init__()
        for name, dtype in self.FIELDS.items():
            self.register_buffer(name,
                                 torch.as_tensor(arrays[name], dtype=dtype))
        self.mix_depth = int(mix_depth)

    @property
    def params(self):
        """Packed shading parameters [albedo4, fuzz, ior, emit3], (M, 9)."""
        return torch.cat([self.albedo, self.fuzz[:, None],
                          self.ior[:, None], self.emit], dim=1)


class MaterialBuilder:
    """Host-side accumulator producing a MaterialTable.  Every add
    method returns the integer row id that geometry refers to."""

    def __init__(self):
        self._rows = []

    def _add(self, mtype, albedo=(0, 0, 0, 1), tex=NO_TEXTURE, fuzz=0.0,
             ior=1.0, emit=(0, 0, 0), mix_ratio=0.0, mix_left=0,
             mix_right=0, tex_no=NO_TEXTURE, tex_pmdg=NO_TEXTURE,
             palette=((0,) * 3,) * 4, glow3=(0, 0, 0)):
        self._rows.append(dict(
            mtype=mtype, albedo=tuple(albedo), tex=tex, fuzz=fuzz, ior=ior,
            emit=tuple(emit), mix_ratio=mix_ratio, mix_left=mix_left,
            mix_right=mix_right, tex_no=tex_no, tex_pmdg=tex_pmdg,
            palette=tuple(tuple(c) for c in palette), glow3=tuple(glow3)))
        return len(self._rows) - 1

    @staticmethod
    def _rgba(albedo):
        return tuple(albedo) + (1.0,) * (4 - len(tuple(albedo)))

    def lambertian(self, albedo=(1.0, 1.0, 1.0, 1.0), tex=NO_TEXTURE):
        return self._add(LAMBERTIAN, albedo=self._rgba(albedo), tex=tex)

    def metal(self, fuzz=0.0, albedo=(1.0, 1.0, 1.0, 1.0), tex=NO_TEXTURE):
        # Fuzz is clamped at construction, as in the reference.
        return self._add(METAL, albedo=self._rgba(albedo), tex=tex,
                         fuzz=min(fuzz, 1.0))

    def dielectric(self, refraction_index):
        return self._add(DIELECTRIC, ior=refraction_index)

    def diffuse_light(self, emit):
        return self._add(DIFFUSE_LIGHT, emit=tuple(emit))

    def isotropic(self, albedo):
        return self._add(ISOTROPIC, albedo=self._rgba(albedo))

    def specular(self, refraction_index, albedo=(1.0, 1.0, 1.0, 1.0),
                 tex=NO_TEXTURE):
        return self._add(SPECULAR, albedo=self._rgba(albedo), tex=tex,
                         ior=refraction_index)

    def mix(self, ratio, left, right):
        return self._add(MIX, mix_ratio=ratio, mix_left=left,
                         mix_right=right)

    def null(self):
        return self._add(NULL)

    def eve(self, tex_ar, tex_no, tex_pmdg, palette, glow=(0.5, 0.85, 2.0)):
        """Packed-PBR ship material: atlas ids of the albedo+roughness,
        normal+occlusion and paint/material/dirt/glow textures, four RGB
        palette colours lerped by the material mask, and the glow colour
        (emission = glow mask * glow * 10)."""
        return self._add(EVE, tex=tex_ar, ior=1.8, tex_no=tex_no,
                         tex_pmdg=tex_pmdg, palette=palette, glow3=glow)

    def has_mix(self):
        return any(r["mtype"] == MIX for r in self._rows)

    def may_alpha_test(self):
        """True if any row can fail the alpha test: a textured
        Lambertian, Metal or Specular, directly or through a Mix."""
        def can_fail(i, depth=0):
            if depth > MAX_MIX_DEPTH:
                return False
            r = self._rows[i]
            if r["mtype"] == MIX:
                return (can_fail(r["mix_left"], depth + 1)
                        or can_fail(r["mix_right"], depth + 1))
            return (r["mtype"] in (LAMBERTIAN, METAL, SPECULAR)
                    and r["tex"] != NO_TEXTURE)
        return any(can_fail(i) for i in range(len(self._rows)))

    def texture_ids(self):
        """The atlas ids that material rows refer to."""
        return {int(r[k]) for r in self._rows
                for k in ("tex", "tex_no", "tex_pmdg") if int(r[k]) >= 0}

    def _mix_depth(self):
        """The table's Mix nesting depth; raises on cycles and on nesting
        deeper than MAX_MIX_DEPTH, which shading could not resolve."""
        def depth(i, seen):
            r = self._rows[i]
            if r["mtype"] != MIX:
                return 0
            if i in seen:
                raise ValueError(
                    f"Mix material row {i} participates in a cycle")
            return 1 + max(depth(r["mix_left"], seen | {i}),
                           depth(r["mix_right"], seen | {i}))

        max_d = 0
        for i in range(len(self._rows)):
            d = depth(i, frozenset())
            if d > MAX_MIX_DEPTH:
                raise ValueError(
                    f"Mix material row {i} nests {d} deep; shading "
                    f"resolves at most MAX_MIX_DEPTH={MAX_MIX_DEPTH}")
            max_d = max(max_d, d)
        return max_d

    def build(self) -> MaterialTable:
        if not self._rows:
            self.null()
        mix_depth = self._mix_depth()
        col = lambda k, dt: np.array([r[k] for r in self._rows], dt)
        f32, i32 = np.float32, np.int32
        return MaterialTable(
            mix_depth=mix_depth,
            **{k: col(k, f32 if dt == torch.float32 else i32)
               for k, dt in MaterialTable.FIELDS.items()})
