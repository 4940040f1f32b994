"""Branch-free batched material shading (mirrors ``mrt.materials.shade``).

One call shades a whole wavefront: every class is evaluated for every
ray and the result is selected by the hit's material type.  With a
texture atlas, textured rows take their albedo from the atlas, EVE rows
decode their packed textures, and EVE hits get tangent-space normal
maps.

  Lambertian    normal + random unit vector, degenerate -> normal
  Metal         reflect(unit(d)) + fuzz * in_unit_sphere; absorbs when
                the scattered direction leaves below the surface
  Dielectric    stochastic Schlick Fresnel, reflect on TIR, attenuation 1
  DiffuseLight  no scatter, constant emission
  Isotropic     uniform-ball scatter
  Specular      Fresnel-gated mirror, else the inner Lambertian
  Mix           stochastic select of two rows, one fresh draw per level
  Null          never scatters
  EVE           per hit Mix(roughness + dirt, Lambertian(colour),
                Specular(1.8, colour)); emits glow mask * glow * 10

A table with no atlas and no Mix rows shades through kernel M1's
wrapper (``ops.shade``), unless autograd records through shading
(``shades_on_card``): on the card in one launch, bit-equal to this
composition, and on the CPU through that composition itself.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..math import sampling, vec
from ..ops import compact
from ..ops.shade import shade_lanes
from . import table as T


def sample_tex(scene, ids, uv, need=None):
    """Atlas sample for a wavefront, zero on lanes outside `need` when it
    is given.  With ``MRT_TEX_COMPACT=1`` (off by default, as in the
    reference) and `need` given, the needing lanes are packed into
    rounds of K rows (``ops.compact``: kernels B2 and B3) and only those
    rows are sampled; callers mask every consumer by `need`."""
    ids0 = torch.clamp(ids, min=0)
    if need is None or os.environ.get("MRT_TEX_COMPACT") != "1":
        s = scene.atlas.sample(ids0, uv, raw=scene.mat_tex_raw)
        return s if need is None else torch.where(need[:, None], s, 0.0)
    x = torch.cat([ids0.to(torch.float32)[:, None], uv], dim=-1)
    fn = lambda xc: scene.atlas.sample(torch.round(xc[:, 0]).to(torch.int32),
                                       xc[:, 1:3], raw=scene.mat_tex_raw)
    return compact.compact_apply(fn, need, x, compact.rows_for(ids.shape[0]),
                                 pad_row=(0.0, 0.5, 0.5))


def surface_rgba(scene, rows, uv):
    """Per-ray surface colour: the texture sample where the row has a
    texture, else the row's solid albedo."""
    m = scene.materials
    # Table rows are gathered by index_select wherever a gradient may
    # flow: its backward adds with index_add_, where indexing's sorts a
    # wavefront's indices first.
    solid = m.albedo.index_select(0, rows)
    if scene.atlas is None:
        return solid
    tex = m.tex[rows]
    sampled = scene.atlas.sample(torch.clamp(tex, min=0), uv,
                                 raw=scene.mat_tex_raw)
    return torch.where((tex >= 0)[:, None], sampled, solid)


def _surface(scene, rows, uv, hit):
    """The texel fetches shading needs for `rows` at `uv`: the sampled
    base texture (zero where the row has none or `hit` is False; `hit`
    None fetches every lane) and the EVE decode (colour, mix ratio, glow
    emission) of ``eve_surface``."""
    m = scene.materials
    tex, tex_pmdg = m.tex[rows], m.tex_pmdg[rows]
    need = lambda ids: None if hit is None else (ids >= 0) & hit
    ar = sample_tex(scene, tex, uv, need(tex))
    pmdg = sample_tex(scene, tex_pmdg, uv, need(tex_pmdg))
    albedo, roughness = ar[..., :3], ar[..., 3]
    paint, mat_mask = pmdg[..., 0:1], pmdg[..., 1]
    dirt, glow = pmdg[..., 2], pmdg[..., 3]

    # Faction palette lerped by mask * 3.
    pal = m.palette.index_select(0, rows)                    # (N, 4, 3)
    i = mat_mask * 3.0
    i0 = torch.clamp(torch.floor(i).to(torch.int64), 0, 3)
    i1 = torch.clamp(torch.ceil(i).to(torch.int64), 0, 3)
    frac = (i - i0.to(torch.float32))[..., None]
    pick = lambda k: torch.gather(pal, 1, k[:, None, None].expand(-1, 1, 3))
    mat_color = pick(i0)[:, 0] * (1.0 - frac) + pick(i1)[:, 0] * frac

    # Dirt-darkened, paint-blended albedo.
    dirt_c = vec.clamp(dirt, hi=1.0)[..., None]
    dirt_rgb = torch.stack([dirt * 0.01, dirt * 0.005, dirt * 0.0], dim=-1)
    color = ((albedo * mat_color * (1.0 - paint) + albedo * paint)
             * (1.0 - dirt_c) + dirt_rgb)
    ratio = vec.clamp(roughness + dirt, hi=1.0)
    glow_e = m.glow3.index_select(0, rows) * glow[..., None] * 10.0
    return ar, (color, ratio, glow_e)


def eve_surface(scene, rows, uv, hit=None):
    """EVE packed-PBR surface: (colour (N,3), mix ratio (N,), glow
    emission (N,3)).  `hit`: the lanes to fetch texels for (zero
    elsewhere; every consumer selects by material type)."""
    return _surface(scene, rows, uv, hit)[1]


def apply_normal_maps(scene, hits, d_in):
    """Tangent-space normal mapping for EVE hits with a normal+occlusion
    texture and a tangent frame: decode the packed XY (green, alpha),
    rebuild Z, combine in the hit's frame about the outward normal, then
    flip against the ray again."""
    from ..geometry.hit import set_face_normal

    m = scene.materials
    rows = hits.material
    tex_no = m.tex_no[rows]
    has_frame = vec.dot(hits.tangent, hits.tangent) > 0.0
    applies = (m.mtype[rows] == T.EVE) & (tex_no >= 0) & hits.hit & has_frame
    px = sample_tex(scene, tex_no, hits.uv, applies) * 2.0 - 1.0
    x = 1.0 - px[..., 1] ** 2 - px[..., 3] ** 2
    z = vec.sqrt(torch.abs(x))
    tn = vec.unit(torch.stack([px[..., 1], px[..., 3], z], dim=-1))
    mapped = (hits.tangent * tn[..., 0:1] + hits.bitangent * tn[..., 1:2]
              + hits.outward_normal * tn[..., 2:3])
    normal, front_face = set_face_normal(d_in, mapped)
    return dataclasses.replace(
        hits, normal=torch.where(applies[:, None], normal, hits.normal),
        front_face=torch.where(applies, front_face, hits.front_face))


def alpha_test(scene, rows, uv, sampler):
    """The alpha test over a wavefront: True keeps the hit.  Textured
    Lambertian, Metal and Specular rows keep it where the sampled alpha
    is not 0; every other row passes.  Mix rows re-roll."""
    rows = resolve_rows(scene, rows, sampler)
    rgba = surface_rgba(scene, rows, uv)
    mtype = scene.materials.mtype[rows]
    tests = ((mtype == T.LAMBERTIAN) | (mtype == T.METAL)
             | (mtype == T.SPECULAR))
    return ~tests | (rgba[..., 3] != 0.0)


def resolve_mix(materials: T.MaterialTable, rows, u_draws):
    """Resolve MIX rows to concrete rows with pre-drawn uniforms, one
    per nesting level; only the table's actual depth is iterated (the
    further levels would map every row to itself)."""
    for u in u_draws[:materials.mix_depth]:
        is_mix = materials.mtype[rows] == T.MIX
        pick_left = u < materials.mix_ratio[rows]
        resolved = torch.where(pick_left, materials.mix_left[rows],
                               materials.mix_right[rows])
        rows = torch.where(is_mix, resolved, rows)
    return rows


def resolve_rows(scene, rows, sampler):
    """Mix-resolve ``rows`` with draws from ``sampler``; when the scene
    has no MIX rows, skip the lookups but still advance the sampler so
    every later stream is unchanged."""
    if not scene.has_mix:
        sampler.skip(T.MAX_MIX_DEPTH)
        return rows
    u = [sampler.next1() for _ in range(T.MAX_MIX_DEPTH)]
    return resolve_mix(scene.materials, rows, u)


def emitted(scene, hits, sampler):
    """Per-ray emission; Mix rows re-roll their branch with their own
    draws.  EVE rows emit their glow."""
    rows = resolve_rows(scene, hits.material, sampler)
    m = scene.materials
    return _emitted_from(scene, rows, m.mtype[rows],
                         m.emit.index_select(0, rows), hits)


def _emitted_from(scene, rows, mtype, emit_rgb, hits, surf=None):
    is_light = mtype == T.DIFFUSE_LIGHT
    e = emit_rgb * is_light[:, None].to(torch.float32)
    if scene.atlas is not None:
        if surf is None:
            surf = _surface(scene, rows, hits.uv, hits.hit)
        e = torch.where((mtype == T.EVE)[:, None], surf[1][2], e)
    return torch.where(hits.hit[:, None], e, 0.0)


def _schlick(cos_theta, refraction_ratio):
    """Schlick reflectance.  The powers are written as the reference's
    integer powers evaluate: x^2 = x*x, x^5 = x * ((x*x) * (x*x))."""
    r0 = (1.0 - refraction_ratio) / (1.0 + refraction_ratio)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def scatter(scene, hits, d_in, sampler):
    """Batched scatter: (attenuation (N,3), new_direction (N,3),
    scattered (N,) bool, lobe (N,) int32).  Absorbed rays (metal below
    the horizon, lights, null) get scattered=False and lobe 0."""
    rows = resolve_rows(scene, hits.material, sampler)
    m = scene.materials
    return _scatter_from(scene, rows, m.mtype[rows],
                         m.params.index_select(0, rows), hits, d_in, sampler)


def _scatter_from(scene, rows, mtype, params, hits, d_in, sampler,
                  surf=None):
    normal = hits.normal

    # Shared random draws (each class consumes what it needs).
    u1, u2, u3, u_fresnel = sampler.next4()
    unit_sphere = sampling.in_unit_sphere(u1, u2, u3)
    rand_unit = sampling.unit_vector(u1, u2)
    unit_d = vec.unit(d_in)
    albedo = params[:, :3]
    textured = scene.atlas is not None
    if textured:
        if surf is None:
            surf = _surface(scene, rows, hits.uv, hits.hit)
        tex = scene.materials.tex[rows]
        albedo = torch.where(((tex >= 0) & hits.hit)[:, None],
                             surf[0][:, :3], albedo)

    # Lambertian
    lam_dir = normal + rand_unit
    lam_dir = torch.where(vec.near_zero(lam_dir)[:, None], normal, lam_dir)

    # Metal
    fuzz = params[:, 4]
    metal_dir = vec.reflect(unit_d, normal) + unit_sphere * fuzz[:, None]
    metal_ok = vec.dot(metal_dir, normal) > 0.0

    # Dielectric / Specular: shared Fresnel choice
    ior = params[:, 5]
    refraction_ratio = torch.where(hits.front_face, 1.0 / ior, ior)
    cos_theta = vec.clamp(vec.dot(-unit_d, normal), hi=1.0)
    sin_theta = vec.sqrt(vec.clamp(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = refraction_ratio * sin_theta > 1.0
    reflect_choice = cannot_refract | (
        _schlick(cos_theta, refraction_ratio) > u_fresnel)
    refl_dir = vec.reflect(unit_d, normal)
    refr_dir = vec.refract(unit_d, normal, refraction_ratio)
    rc = reflect_choice[:, None]
    diel_dir = torch.where(rc, refl_dir, refr_dir)

    # Specular: mirror with attenuation 1, else the inner Lambertian
    spec_dir = torch.where(rc, refl_dir, lam_dir)
    one = torch.ones_like(albedo)
    spec_atten = torch.where(rc, one, albedo)

    # EVE: per hit Mix(ratio, Lambertian(colour), Specular(1.8, colour));
    # the Specular arm is the Fresnel gate above (ior 1.8 in the row).
    w = torch.where
    is_eve = (mtype == T.EVE)[:, None]
    if textured:
        eve_color, eve_ratio, _ = surf[1]
        pick_lam = (sampler.next1() < eve_ratio)[:, None]
        eve_dir = w(pick_lam, lam_dir, spec_dir)
        eve_atten = w(pick_lam | ~rc, eve_color, one)
    else:
        is_eve = torch.zeros_like(is_eve)
        eve_dir, eve_atten = normal, one

    # Select by class
    is_lam = (mtype == T.LAMBERTIAN)[:, None]
    is_metal = (mtype == T.METAL)[:, None]
    is_diel = (mtype == T.DIELECTRIC)[:, None]
    is_iso = (mtype == T.ISOTROPIC)[:, None]
    is_spec = (mtype == T.SPECULAR)[:, None]
    new_dir = w(is_lam, lam_dir,
                w(is_metal, metal_dir,
                  w(is_diel, diel_dir,
                    w(is_iso, unit_sphere,
                      w(is_spec, spec_dir, w(is_eve, eve_dir, normal))))))
    atten = w(is_lam | is_metal | is_iso, albedo,
              w(is_spec, spec_atten, w(is_eve, eve_atten, one)))
    scattered = hits.hit & (
        (is_lam | is_diel | is_iso | is_spec | is_eve)[:, 0]
        | (is_metal[:, 0] & metal_ok))

    # Scatter lobe for NEE and MIS: 1 where the direction came from a
    # cosine lobe (Lambertian, and the Lambertian outcomes of Specular and
    # EVE), 2 for the isotropic phase, 0 otherwise and where nothing
    # scattered.
    cosine = is_lam | (is_spec & ~rc)
    if textured:
        cosine = cosine | (is_eve & (pick_lam | ~rc))
    lobe = torch.where(cosine[:, 0], 1, torch.where(is_iso[:, 0], 2, 0))
    lobe = torch.where(scattered, lobe, 0).to(torch.int32)
    return atten, new_dir, scattered, lobe


def shades_on_card(scene, hits, d_in):
    """Whether shade_hit takes kernel M1's wrapper (``ops.shade``): a
    table with no atlas and no Mix rows, and autograd not recording
    through shading (grad mode off, or none of d_in, the hit normals and
    the table's float columns requiring grad).  Everywhere else the
    eager composition runs."""
    if scene.atlas is not None or scene.has_mix:
        return False
    if not torch.is_grad_enabled():
        return True
    m = scene.materials
    return not any(x.requires_grad for x in (d_in, hits.normal, m.albedo,
                                             m.fuzz, m.ior, m.emit))


def shade_hit(scene, hits, d_in, em_sampler, sc_sampler):
    """Emission and scatter for a wavefront: (emitted (N,3),
    attenuation (N,3), new_direction (N,3), scattered (N,), lobe (N,)).
    Random streams are those of emitted() then scatter(); without Mix
    rows the row resolution is the identity and both share one row
    lookup.  Where ``shades_on_card`` holds, kernel M1's wrapper computes
    the eager composition's values, bit for bit: in one launch on the
    card."""
    if scene.has_mix:
        e = emitted(scene, hits, em_sampler)
        return (e, *scatter(scene, hits, d_in, sc_sampler))
    em_sampler.skip(T.MAX_MIX_DEPTH)
    sc_sampler.skip(T.MAX_MIX_DEPTH)
    if shades_on_card(scene, hits, d_in):
        return shade_lanes(scene.materials, hits.normal.contiguous(),
                           hits.front_face.contiguous(),
                           hits.material.contiguous(),
                           hits.hit.contiguous(), d_in.contiguous(),
                           sc_sampler.next4())
    return shade_rows(scene, hits, d_in, sc_sampler)


def shade_rows(scene, hits, d_in, sc_sampler):
    """shade_hit's eager composition on a table with no Mix rows, after
    the row resolution's draws were skipped."""
    rows = hits.material
    m = scene.materials
    params = m.params.index_select(0, rows)
    mtype = m.mtype[rows]
    # One set of texel fetches serves both: the rows are the same.
    surf = (None if scene.atlas is None
            else _surface(scene, rows, hits.uv, hits.hit))
    e = _emitted_from(scene, rows, mtype, params[:, 6:9], hits, surf)
    return (e, *_scatter_from(scene, rows, mtype, params, hits, d_in,
                              sc_sampler, surf))
