"""Flat light table: sampling and evaluation of every light type.

Counterpart of `vision_tpu/lights/lights.py`: every light becomes a row of
one table and `sample_wi` runs the formula of each type the table holds,
masked by the lane's light type. Static type flags (`LightTable.feats`)
gate the types a scene does not use, as in the JAX package; a table of one
type skips the masking. Conventions (as in the JAX package):

  * sample_wi returns radiance L and a solid-angle pdf that includes the
    light-selection pmf; a delta light (point, spot, projector,
    directional) returns pdf = -pmf, and the integrator skips MIS for it;
  * area: L = color * scale on the front side (both when two-sided),
    pdf = (1/total_area) r^2 / cos_light; textured emission multiplies by
    the atlas texel at the sampled uv;
  * point: color / r^2; spot: times the falloff window ^4; projector:
    color times the projected texture (constant without one) / r^2;
  * spherical (environment): a lat-long texture sampled by an alias table
    over its pixels, pdf = pmf W H / (2 pi^2 sin theta), fetched without
    the v-flip of surface textures;
  * directional: wi = -direction, L = color;
  * light selection uniform or by power; an environment takes a fixed
    share `env_prob` of the samples.

Under a hero spectrum every radiance a lane reads (env, sample, hit)
decodes to a spectrum at the lane's wavelengths as illumination (the
unbound decode times D65), after its rgb is formed, as in the JAX package.

A spot or projector light may carry an IES profile (`ies_id`, a row of
`ies_profiles`: 64 polar samples, peak 1, `lights/ies.py`) that scales
its output by the angle from its axis. A scene without a light gets the
JAX package's sentinel: one black point light.
The per-light columns a lane reads are fetched in one indexing of the
packed columns (`core/rows.py`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import warp
from ..core.math import (Inv2Pi, InvPi, Pi, TwoPi, cross, dot, normalize,
                         safe_div, spherical_phi, spherical_theta, vec3)
from ..core.rows import PackedRows
from .alias import build_alias, sample_alias
from .ies import eval_ies

L_AREA = 0
L_POINT = 1
L_SPOT = 2
L_PROJECTOR = 3
L_SPHERICAL = 4
L_DIRECTIONAL = 5
TYPE_NAMES = {L_AREA: "area", L_POINT: "point", L_SPOT: "spot",
              L_PROJECTOR: "proj", L_SPHERICAL: "env", L_DIRECTIONAL: "dir"}
_TYPE_OF = {v: k for k, v in TYPE_NAMES.items()}

# per-light columns a lane reads, packed in this order
PACKED = (("ltype", 1), ("color", 3), ("color_tex", 1), ("position", 3),
          ("direction", 3), ("cos_angle", 1), ("cos_falloff", 1),
          ("tan_xy", 2), ("w2o", 9), ("two_sided", 1), ("total_area", 1),
          ("tri_offset", 1), ("tri_count", 1), ("tri_base", 1),
          ("sel_pmf", 1), ("ies_id", 1))


@dataclass
class LightTable:
    n_lights: int
    env_index: int            # -1 without an environment light
    env_prob: float
    ltype: torch.Tensor       # [L] int32
    color: torch.Tensor       # [L, 3] radiance / intensity * scale
    color_tex: torch.Tensor   # [L] texture id (-1 const)
    position: torch.Tensor    # [L, 3]
    direction: torch.Tensor   # [L, 3]
    cos_angle: torch.Tensor   # [L] spot cone cos
    cos_falloff: torch.Tensor  # [L] spot falloff-start cos
    tan_xy: torch.Tensor      # [L, 2] projector half-tangents
    w2o: torch.Tensor         # [L, 3, 3] world -> light rotation
    two_sided: torch.Tensor   # [L] int32
    inst_id: torch.Tensor     # [L] area-light instance id
    total_area: torch.Tensor  # [L] area-light summed area
    # area-light triangle alias tables (concatenated)
    tri_offset: torch.Tensor  # [L]
    tri_count: torch.Tensor   # [L]
    a_prob: torch.Tensor      # [AT]
    a_alias: torch.Tensor     # [AT]
    a_pmf: torch.Tensor       # [AT]
    tri_base: torch.Tensor    # [L] first global-triangle id of the light's mesh
    # the environment's alias table over pixels (one env light)
    env_tex: torch.Tensor     # 0-d texture id
    env_w: int
    env_h: int
    e_prob: torch.Tensor      # [W*H]
    e_alias: torch.Tensor
    e_pmf: torch.Tensor
    # light selection over the non-env lights
    sel_prob: torch.Tensor    # [L]
    sel_alias: torch.Tensor
    sel_pmf: torch.Tensor     # [L]
    ies_id: torch.Tensor      # [L] IES profile row (-1 none)
    ies_profiles: torch.Tensor  # [P, 64]
    feats: tuple = ("area",)
    packed: PackedRows = field(default=None, repr=False)

    def __post_init__(self):
        self.packed = PackedRows(self, PACKED)

    def has(self, name):
        return name in self.feats


@dataclass
class LightSample:
    p_light: torch.Tensor  # [..., 3] sampled point (a far point for env / dir)
    wi: torch.Tensor       # [..., 3] direction from the shading point
    L: torch.Tensor        # [..., 3] radiance
    pdf: torch.Tensor      # [...] solid-angle pdf; negative = delta
    dist: torch.Tensor     # [...] distance for the occlusion test


def _decode_illum(rgb, spectrum, swl):
    if spectrum is None:
        return rgb
    return spectrum.decode_illumination(rgb, swl)


def _falloff_spot(cos_theta, cos_angle, cos_falloff):
    c = torch.minimum(torch.maximum(cos_theta, cos_angle), cos_falloff)
    return safe_div(c - cos_angle, cos_falloff - cos_angle) ** 4


def _rotate(m, v):
    """[..., 3, 3] (or [3, 3]) times [..., 3]."""
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]
            + m[..., 2] * v[..., 2:3])


def _sample_env_tex(table, atlas, uv):
    """Bilinear env fetch without the v-flip of surface textures (lat-long
    v grows downward from the +z pole, as image rows do)."""
    flip = torch.stack([uv[..., 0], 1.0 - uv[..., 1]], -1)
    return atlas.sample(table.env_tex, flip)


def _env_angles(table, world_dir):
    local = _rotate(table.w2o[table.env_index], world_dir)
    return spherical_theta(local), spherical_phi(local)


def env_radiance(table, atlas, world_dir, spectrum=None, swl=None):
    """Environment radiance on a miss ([..., S] under a hero spectrum)."""
    if table.env_index < 0:
        S = 3 if spectrum is None else spectrum.dims
        return torch.zeros(world_dir.shape[:-1] + (S,), device=world_dir.device)
    theta, phi = _env_angles(table, world_dir)
    uv = torch.stack([phi * Inv2Pi, theta * InvPi], -1)
    return _decode_illum(_sample_env_tex(table, atlas, uv)
                         * table.color[table.env_index], spectrum, swl)


def env_pdf_wi(table, world_dir):
    """Solid-angle pdf of environment sampling (for MIS on a miss), the
    selection share included."""
    if table.env_index < 0:
        return torch.zeros_like(world_dir[..., 0])
    theta, phi = _env_angles(table, world_dir)
    sin_t = torch.sin(theta)
    w, h = table.env_w, table.env_h
    x = torch.clamp((phi * Inv2Pi * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((theta * InvPi * h).to(torch.int32), 0, h - 1)
    pmf = table.e_pmf[(y * w + x).long()]
    pdf = pmf * float(w * h) / (2.0 * Pi * Pi * torch.clamp_min(sin_t, 1e-6))
    pdf = torch.where(sin_t > 1e-6, pdf, 0.0)
    return pdf * (table.env_prob if table.n_lights > 1 else 1.0)


def select_light(table, u):
    """Pick a light id: the environment with probability env_prob, else by
    the alias table. Returns (light_id int64, pmf, u_remapped)."""
    L = table.n_lights
    if L == 1:
        # single light: no alias walk, u passes through untouched
        return (torch.full(u.shape, max(table.env_index, 0), dtype=torch.int64,
                           device=u.device), torch.ones_like(u), u)
    if table.env_index < 0:
        return sample_alias(table.sel_prob, table.sel_alias, table.sel_pmf, u)
    ep = table.env_prob
    pick_env = u < ep
    u2 = torch.where(pick_env, u / ep, (u - ep) / (1.0 - ep))
    idx, pmf, u3 = sample_alias(table.sel_prob, table.sel_alias,
                                table.sel_pmf, u2)
    lid = torch.where(pick_env, table.env_index, idx)
    pmf = torch.where(pick_env, ep, pmf * (1.0 - ep))
    return lid, pmf, torch.where(pick_env, u2, u3)


def _env_split(table, lid, selp):
    """Selection pmf of `lid` with the environment's share taken out."""
    if table.env_index >= 0 and table.n_lights > 1:
        return torch.where(lid == table.env_index, table.env_prob,
                           selp * (1.0 - table.env_prob))
    return selp


def light_pmf(table, light_id):
    """PMF of having selected light_id (for hit and miss MIS)."""
    lid = torch.clamp(light_id.long(), 0, table.n_lights - 1)
    return _env_split(table, light_id, table.sel_pmf[lid])


def sample_wi(table, atlas, tri_pack, ref_pos, ref_ng, u_sel, u2,
              world_radius, spectrum=None, swl=None):
    """NEE light sample for every lane. tri_pack = [T, 32] packed triangle
    rows (p0 e1 e2 ... uv0 uv1 uv2) for area lights; `ref_ng` is unused,
    as in the JAX package. Returns LightSample."""
    lid, sel_pmf, u_sel2 = select_light(table, u_sel)
    g = table.packed.fetch(lid)

    def ies_weight(cos_theta):
        """The selected light's IES attenuation (1 without a profile)."""
        l_ies = g("ies_id").long()
        prof = table.ies_profiles[torch.clamp(
            l_ies, 0, table.ies_profiles.shape[0] - 1)]
        return torch.where(l_ies >= 0, eval_ies(prof, cos_theta), 1.0)

    lt = g("ltype")
    color = g("color")
    env = table.has("env") and table.env_index >= 0
    present = [t for t in ("area", "point", "spot", "proj", "dir")
               if table.has(t)] + (["env"] if env else [])
    single = len(present) == 1
    mask = {t: (None if single else lt == _TYPE_OF[t]) for t in present}

    def put(t, val, cur):
        """Lanes of type t take val: where-masked, or val itself when the
        table has one type."""
        if single:
            return val
        m = mask[t] if val.dim() == mask[t].dim() else mask[t][..., None]
        return torch.where(m, val, cur)

    shape = ref_pos.shape[:-1]
    zero3 = None if single else torch.zeros(shape + (3,), device=ref_pos.device)
    ones = None if single else torch.ones(shape, device=ref_pos.device)
    wi, L, p_light, pdf, dist2 = zero3, zero3, ref_pos, ones, ones

    # ---- area: a triangle by the alias table over areas, barycentrics
    if table.has("area"):
        cnt = torch.clamp_min(g("tri_count").long(), 1)
        tri_i, _, u_rem = sample_alias(table.a_prob, table.a_alias,
                                       table.a_pmf, u_sel2,
                                       g("tri_offset").long(), cnt)
        gtri = torch.clamp(g("tri_base").long() + tri_i, 0,
                           tri_pack.shape[0] - 1)
        trow = tri_pack[gtri]
        p0, e1, e2 = trow[..., 0:3], trow[..., 3:6], trow[..., 6:9]
        b = warp.square_to_triangle(torch.stack([u_rem, u2[..., 1]], dim=-1))
        p_area = p0 + b[..., 0:1] * e1 + b[..., 1:2] * e2
        ng_l = cross(e1, e2)
        area2 = torch.sqrt(torch.clamp_min(torch.sum(ng_l * ng_l, -1), 1e-20))
        ng_l = ng_l / area2[..., None]
        to_ref = ref_pos - p_area
        dist2_a = torch.clamp_min(torch.sum(to_ref * to_ref, -1), 1e-12)
        w_lr = to_ref / torch.sqrt(dist2_a)[..., None]
        front = torch.sum(w_lr * ng_l, -1)
        vis_a = (front > 0.0) | (g("two_sided") > 0)
        # pdf_pos = 1/total_area (the alias pmf folds the per-tri area back in)
        pdf_a = safe_div(safe_div(1.0, g("total_area")) * dist2_a,
                         torch.abs(front))
        L_a = color * vis_a[..., None]
        if table.has("tex") and atlas.has_textures:
            # textured emission at the sampled surface uv
            b0 = 1.0 - b[..., 0:1] - b[..., 1:2]
            uv_area = (b0 * trow[..., 18:20] + b[..., 0:1] * trow[..., 20:22]
                       + b[..., 1:2] * trow[..., 22:24])
            ctex = g("color_tex").to(torch.int32)
            tex_a = atlas.sample(ctex, uv_area)
            L_a = L_a * torch.where((ctex >= 0)[..., None], tex_a,
                                    torch.ones_like(tex_a))
        wi = put("area", normalize(p_area - ref_pos), wi)
        p_light = put("area", p_area, p_light)
        L = put("area", L_a, L)
        pdf = put("area", pdf_a, pdf)
        dist2 = put("area", dist2_a, dist2)

    # ---- point / spot / projector: delta, positional
    near = [t for t in ("point", "spot", "proj") if table.has(t)]
    if near:
        pos = g("position")
        to_light = pos - ref_pos
        d2 = torch.clamp_min(torch.sum(to_light * to_light, -1), 1e-12)
        wi_near = normalize(to_light)
        L_p = color / d2[..., None]
        for t in near:
            wi = put(t, wi_near, wi)
            p_light = put(t, pos, p_light)
            dist2 = put(t, d2, dist2)
        if table.has("point"):
            L = put("point", L_p, L)
        if table.has("spot"):
            cos_sp = torch.sum(g("direction") * -wi_near, -1)
            fall = _falloff_spot(cos_sp, g("cos_angle"), g("cos_falloff"))
            if table.has("ies"):
                fall = fall * ies_weight(cos_sp)
            L = put("spot", L_p * fall[..., None], L)
        if table.has("proj"):
            # the shading point in the projector's frame
            w2o = g("w2o").reshape(shape + (3, 3))
            pl = _rotate(w2o, ref_pos - pos)
            pxy = pl[..., :2] / torch.clamp_min(pl[..., 2:3], 1e-8)
            txy = g("tan_xy")
            uv_pr = (pxy + txy) / (2.0 * txy)
            in_frame = ((pl[..., 2] > 0.0)
                        & torch.all((uv_pr >= 0.0) & (uv_pr <= 1.0), -1))
            if atlas.has_textures:
                ctex = g("color_tex").to(torch.int32)
                tex_pr = atlas.sample(ctex, uv_pr)
                proj_col = torch.where((ctex >= 0)[..., None], tex_pr,
                                       torch.ones_like(tex_pr))
            else:
                proj_col = torch.ones(shape + (3,), device=ref_pos.device)
            L_pr = color * proj_col / d2[..., None] * in_frame[..., None]
            if table.has("ies"):
                L_pr = L_pr * ies_weight(normalize(pl)[..., 2])[..., None]
            L = put("proj", L_pr, L)

    # ---- spherical environment: the alias table over pixels
    if env:
        W, H = table.env_w, table.env_h
        n_px = max(W * H, 1)
        px, px_pmf, u_rem2 = sample_alias(table.e_prob, table.e_alias,
                                          table.e_pmf, u_sel2, 0, n_px)
        py = px // max(W, 1)
        pxx = px - py * W
        uv_e = torch.stack([(pxx.float() + u_rem2) / max(W, 1),
                            (py.float() + u2[..., 1]) / max(H, 1)], -1)
        theta = uv_e[..., 1] * Pi
        phi = uv_e[..., 0] * TwoPi
        sin_t = torch.sin(theta)
        local_dir = vec3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                         torch.cos(theta))
        o2w = g("w2o").reshape(shape + (3, 3)).transpose(-1, -2)
        pdf_e = safe_div(px_pmf * float(n_px),
                         2.0 * Pi * Pi * torch.clamp_min(sin_t, 1e-6))
        pdf_e = torch.where(sin_t > 1e-6, pdf_e, 0.0)
        wi = put("env", _rotate(o2w, local_dir), wi)
        L = put("env", _sample_env_tex(table, atlas, uv_e) * color, L)
        pdf = put("env", pdf_e, pdf)

    # ---- directional: delta; wi = -direction, L = color
    if table.has("dir"):
        wi = put("dir", -g("direction"), wi)
        L = put("dir", color, L)

    far = [t for t in ("env", "dir") if t in present]
    delta = [t for t in ("point", "spot", "proj", "dir") if t in present]
    if pdf is None:  # one delta type: its pdf is 1 before selection
        pdf = torch.ones(shape, device=ref_pos.device)
    pdf = pdf * sel_pmf
    if single:
        far_m = bool(far)
        pdf = -pdf if delta else pdf
    else:
        far_m = _any(mask, far, shape, ref_pos.device)
        pdf = torch.where(_any(mask, delta, shape, ref_pos.device), -pdf, pdf)
    if far:
        p_far = ref_pos + wi * (2.0 * world_radius)
        p_light = p_far if single else torch.where(far_m[..., None], p_far,
                                                   p_light)
    L = _decode_illum(L, spectrum, swl)
    if dist2 is None:
        dist2 = torch.ones(shape, device=ref_pos.device)
    if not far:
        dist = torch.sqrt(dist2)
    elif single:
        dist = torch.full(shape, 2.0 * world_radius, device=ref_pos.device)
    else:
        dist = torch.where(far_m, 2.0 * world_radius, torch.sqrt(dist2))
    return LightSample(p_light=p_light, wi=wi, L=L, pdf=pdf, dist=dist)


def _any(mask, types, shape, device):
    out = torch.zeros(shape, dtype=torch.bool, device=device)
    for t in types:
        out = out | mask[t]
    return out


def eval_hit_area(table, light_id, ref_pos, hit_pos, hit_ng, hit_uv=None,
                  atlas=None, spectrum=None, swl=None):
    """(L, pdf_wi) when a scatter ray hits an emissive surface; pdf
    includes the light-selection pmf. With `hit_uv` and an atlas, textured
    emission is read at the hit."""
    lid = torch.clamp(light_id.long(), 0, table.n_lights - 1)
    g = table.packed.fetch(lid)
    color = g("color")
    if (hit_uv is not None and table.has("tex") and atlas is not None
            and atlas.has_textures):
        ctex = g("color_tex").to(torch.int32)
        tex = atlas.sample(ctex, hit_uv)
        color = color * torch.where((ctex >= 0)[..., None], tex,
                                    torch.ones_like(tex))
    w = ref_pos - hit_pos
    front = dot(normalize(w), hit_ng)
    vis = (front > 0.0) | (g("two_sided") > 0)
    L = _decode_illum(color, spectrum, swl) * vis[..., None]
    pdf_wi = warp.pdf_wi_from_point(safe_div(1.0, g("total_area")), hit_ng, w)
    pdf_wi = (torch.where(torch.isfinite(pdf_wi), pdf_wi, 0.0)
              * _env_split(table, lid, g("sel_pmf")))
    ok = light_id >= 0
    return torch.where(ok[..., None], L, 0.0), torch.where(ok, pdf_wi, 0.0)


# ---------------------------------------------------------------------------
# Host-side builder
# ---------------------------------------------------------------------------

def _lum(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


class LightBuilder:
    def __init__(self, sampler_type="uniform", env_prob=0.5):
        self.rows = []
        self.area_weights = []     # per-light triangle areas
        self.env = None            # (tex_id, weights [H, W], w, h)
        self.sampler_type = sampler_type
        self.env_prob = env_prob
        self.ies_profiles = []     # [64] polar profiles

    def _default(self):
        return dict(ltype=L_POINT, color=[0, 0, 0], color_tex=-1,
                    position=[0, 0, 0], direction=[0, 0, 1],
                    cos_angle=0.0, cos_falloff=1.0, tan_xy=[1.0, 1.0],
                    w2o=np.eye(3, dtype=np.float32),
                    two_sided=0, inst_id=-1, total_area=1.0, tri_base=0,
                    power=1.0, ies_id=-1)

    def _add(self, weights=None, **kw):
        r = self._default()
        r.update(kw)
        self.rows.append(r)
        self.area_weights.append(np.ones(1) if weights is None else weights)
        return len(self.rows) - 1

    def add_area(self, color, inst_id, tri_base, tri_areas, two_sided=False,
                 tex_id=-1):
        total = float(np.sum(tri_areas))
        return self._add(
            np.asarray(tri_areas, np.float64), ltype=L_AREA,
            color=list(color), inst_id=inst_id, tri_base=tri_base,
            total_area=max(total, 1e-12), two_sided=1 if two_sided else 0,
            color_tex=tex_id,
            power=(2.0 if two_sided else 1.0) * _lum(color) * total * Pi)

    def add_point(self, color, position):
        return self._add(ltype=L_POINT, color=list(color),
                         position=list(position), power=4 * Pi * _lum(color))

    def add_ies_profile(self, profile):
        """Register a [64] polar profile; returns its id."""
        self.ies_profiles.append(np.asarray(profile, np.float32))
        return len(self.ies_profiles) - 1

    def add_spot(self, color, position, direction, angle_deg, falloff_deg,
                 ies=-1):
        angle = np.deg2rad(np.clip(angle_deg, 1.0, 89.0))
        falloff = np.deg2rad(np.clip(falloff_deg, 0.0, np.rad2deg(angle)))
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        return self._add(ltype=L_SPOT, color=list(color),
                         position=list(position), direction=list(d),
                         cos_angle=float(np.cos(angle)),
                         cos_falloff=float(np.cos(max(0.0, angle - falloff))),
                         power=2 * Pi * _lum(color), ies_id=ies)

    def add_projector(self, color, o2w, angle_deg, ratio, tex_id, ies=-1):
        tan_y = float(np.tan(np.deg2rad(angle_deg)))
        return self._add(ltype=L_PROJECTOR, color=list(color),
                         position=list(np.asarray(o2w[:3, 3], np.float64)),
                         tan_xy=[ratio * tan_y, tan_y],
                         w2o=np.linalg.inv(o2w[:3, :3]).astype(np.float32),
                         color_tex=tex_id, power=_lum(color), ies_id=ies)

    def add_spherical(self, scale_color, o2w, tex_id, image):
        h, w = image.shape[:2]
        lum = (0.212671 * image[..., 0] + 0.715160 * image[..., 1]
               + 0.072169 * image[..., 2])
        theta = (np.arange(h) + 0.5) / h * np.pi
        self.env = (tex_id, lum * np.sin(theta)[:, None], w, h)
        return self._add(ltype=L_SPHERICAL, color=list(scale_color),
                         w2o=np.linalg.inv(o2w[:3, :3]).astype(np.float32),
                         color_tex=tex_id, power=float(lum.mean()) * 4 * Pi)

    def add_directional(self, color, direction):
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        return self._add(ltype=L_DIRECTIONAL, color=list(color),
                         direction=list(d), power=_lum(color))

    def build(self, device):
        if not self.rows:
            self._add()  # the sentinel: one black point light
        rows = self.rows
        L = len(rows)
        env_index = next((i for i, r in enumerate(rows)
                          if r["ltype"] == L_SPHERICAL), -1)
        offs, cnts, probs, aliases, pmfs = [], [], [], [], []
        off = 0
        for wts in self.area_weights:
            p, a, m = build_alias(wts)
            offs.append(off)
            cnts.append(len(wts))
            probs.append(p)
            aliases.append(a)
            pmfs.append(m)
            off += len(wts)
        if self.env is not None:
            tex_id, wts2d, ew, eh = self.env
            ep, ea, em = build_alias(wts2d.reshape(-1))
        else:
            tex_id, ew, eh = 0, 1, 1
            ep, ea, em = (np.ones(1, np.float32), np.zeros(1, np.int32),
                          np.ones(1, np.float32))
        if self.sampler_type == "power":
            sw = np.array([r["power"] for r in rows], np.float64)
        else:
            sw = np.ones(L)
        if env_index >= 0:
            sw[env_index] = 0.0
        if sw.sum() <= 0:
            sw[:] = 1.0
        sp, sa, sm = build_alias(sw)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def col(key, dtype=torch.float32):
            return t([r[key] for r in rows], dtype)

        feats = tuple(sorted(TYPE_NAMES[t] for t in {r["ltype"] for r in rows}))
        if any(r["color_tex"] >= 0 and r["ltype"] != L_SPHERICAL for r in rows):
            feats += ("tex",)
        if any(r["ies_id"] >= 0 for r in rows):
            feats += ("ies",)
        return LightTable(
            feats=feats, n_lights=L, env_index=env_index,
            env_prob=float(np.clip(self.env_prob, 0.01, 0.99)),
            ltype=col("ltype", torch.int32), color=col("color"),
            color_tex=col("color_tex", torch.int32), position=col("position"),
            direction=col("direction"), cos_angle=col("cos_angle"),
            cos_falloff=col("cos_falloff"), tan_xy=col("tan_xy"),
            w2o=col("w2o"), two_sided=col("two_sided", torch.int32),
            inst_id=col("inst_id", torch.int32), total_area=col("total_area"),
            tri_offset=t(offs, torch.int32), tri_count=t(cnts, torch.int32),
            a_prob=t(np.concatenate(probs)),
            a_alias=t(np.concatenate(aliases), torch.int32),
            a_pmf=t(np.concatenate(pmfs)),
            tri_base=col("tri_base", torch.int32),
            env_tex=t(tex_id, torch.int64), env_w=int(ew), env_h=int(eh),
            e_prob=t(ep), e_alias=t(ea, torch.int32), e_pmf=t(em),
            sel_prob=t(sp), sel_alias=t(sa, torch.int32), sel_pmf=t(sm),
            ies_id=col("ies_id", torch.int32),
            ies_profiles=t(np.stack(self.ies_profiles) if self.ies_profiles
                           else np.ones((1, 64), np.float32)))
