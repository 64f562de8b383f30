"""Unified lobe-set BSDF ("uber-BSDF").

Counterpart of `vision_tpu/shading/bsdf.py`. Every material compiles into
parameters of one fixed superset of five lobes, run on every lane and
masked by weights:

  0 diffuse      (Lambert / Oren-Nayar / FresnelBlend / Disney diffuse)
  1 specular     (GGX reflection; Fresnel: dielectric / conductor /
                  Schlick / constant / F82)
  2 transmission (GGX dielectric refraction, coupled to lobe 1 by 1 - F)
  3 clearcoat    (isotropic GGX, Schlick F0 = 0.04)
  4 sheen        (the LTC lobe with the self-fit table; Burley without it)

plus the Kulla-Conty multiple-scattering lobe (`ems`) of rough conductors
and LobeSet mixtures (`mix_b`, a second full row with weights). Static
feature flags (`LobeParams.feats`, from the material table) gate the
families no material uses, as in the JAX package; in eager PyTorch a gated
family costs no launch. A table of Lambert rows only takes the short path
of the slice-1 port (`_diffuse_only`). The Fresnel modes are gated the same
way by the modes the table holds (`LobeParams.fr_modes`): a lane's mode is
always one of them, so the result does not change. Colors carry a trailing
axis of 3 (sRGB); directions are in the local shading frame (z = ns).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng, warp
from ..core.math import (InvPi, Pi, abs_cos_theta, cos_phi, cos_theta, dot,
                         normalize, reflect, refract, safe_div,
                         same_hemisphere, sin_phi, sin_theta, sqr)
from . import fresnel as fr
from . import microfacet as mf

DIFF_LAMBERT = 0        # + Oren-Nayar through sigma
DIFF_FRESNEL_BLEND = 1  # substrate (Ashikhmin-Shirley)
DIFF_DISNEY = 2         # Burley diffuse + retro-reflection

ALL_FR_MODES = (fr.FR_DIELECTRIC, fr.FR_CONDUCTOR, fr.FR_SCHLICK,
                fr.FR_CONSTANT, fr.FR_F82)


@dataclass
class LobeParams:
    """Per-lane material parameters, leading batch shape [...]; colors
    [..., 3]; `eta` [..., 1] (one IOR in the sRGB mode)."""
    kd: torch.Tensor
    sigma: torch.Tensor
    diffuse_kind: torch.Tensor
    diffuse_weight: torch.Tensor
    spec_tint: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    fr_mode: torch.Tensor
    eta: torch.Tensor
    eta3: torch.Tensor
    k3: torch.Tensor
    spec_weight: torch.Tensor
    trans_weight: torch.Tensor
    cc_weight: torch.Tensor
    cc_alpha: torch.Tensor
    sheen_weight: torch.Tensor
    sheen_tint: torch.Tensor
    flatness: torch.Tensor
    metallic: torch.Tensor
    feats: tuple = ("diff",)
    fr_modes: tuple = ALL_FR_MODES
    # GGX directional-albedo LUT for the Kulla-Conty lobe
    ems_E: torch.Tensor = None       # [Na, Nmu]
    ems_Eavg: torch.Tensor = None    # [Na]
    # self-fit LTC sheen table [32, 32, 3] over (cos_theta_o, alpha)
    sheen_ltc: torch.Tensor = None
    sheen_alpha: torch.Tensor = None
    # LobeSet mixture: the second row and the per-row weights (None unless
    # "mix2" is in feats)
    mix_b: "LobeParams" = None
    mix_wa: torch.Tensor = None
    mix_wb: torch.Tensor = None

    def has(self, name):
        return name in self.feats


@dataclass
class ScatterEval:
    f: torch.Tensor      # [..., 3] BSDF value (no cosine)
    pdf: torch.Tensor    # [...]


@dataclass
class BSDFSample:
    wi: torch.Tensor         # [..., 3] local
    ev: ScatterEval
    eta_scale: torch.Tensor  # relative ior^2 carried for RR (1 unless refracted)
    valid: torch.Tensor


def _diffuse_only(p):
    """Lambert rows only: the five-lobe weights reduce to the diffuse one."""
    return p.mix_b is None and all(f == "diff" for f in p.feats)


def _hemi_eta(p, wo):
    """Relative eta seen from wo's side: eta entering, 1/eta leaving."""
    eta0 = p.eta[..., 0]
    return torch.where(cos_theta(wo) > 0.0, eta0, safe_div(1.0, eta0))


def _eval_fresnel(p, cos_i, wo=None):
    """The lobe-1 Fresnel for |cos_i| by mode, [..., 3]; only the modes
    the table holds are computed. With `wo`, the dielectric's eta flips
    when wo leaves the surface (the Fresnel at a half vector)."""
    abs_ci = torch.abs(cos_i)
    m = p.fr_mode[..., None]
    out = torch.ones_like(p.kd)  # FR_CONSTANT, and the chain's default
    for mode in (fr.FR_F82, fr.FR_SCHLICK, fr.FR_CONDUCTOR, fr.FR_DIELECTRIC):
        if mode not in p.fr_modes:
            continue
        if mode == fr.FR_F82:
            f = fr.fresnel_f82(abs_ci, p.eta3, p.k3)
        elif mode == fr.FR_SCHLICK:
            f = fr.fresnel_schlick(p.eta3, abs_ci)
        elif mode == fr.FR_CONDUCTOR:
            f = fr.fresnel_complex(abs_ci[..., None], p.eta3, p.k3)
        else:
            f = fr.fresnel_dielectric(abs_ci[..., None],
                                      p.eta if wo is None else _eta_dir(p, wo))
        out = torch.where(m == mode, f, out)
    return out


def _eta_dir(p, wo):
    return torch.where((cos_theta(wo) > 0.0)[..., None], p.eta,
                       safe_div(1.0, p.eta))


def _dielectric_F0(p, wo):
    """Dielectric Fresnel at wo with the directed eta."""
    return fr.fresnel_dielectric(abs_cos_theta(wo)[..., None], _eta_dir(p, wo))


# ---------------------------------------------------------------------------
# Per-lobe eval
# ---------------------------------------------------------------------------

def _oren_nayar_AB(sigma):
    s2 = sqr(sigma)
    A = 1.0 - (s2 / (2.0 * (s2 + 0.33)))
    B = 0.45 * s2 / (s2 + 0.09)
    return A, B


def _eval_diffuse(p, wo, wi):
    """Diffuse lobe f [..., 3] (reflection only, same hemisphere); the
    variants run only when a material of the table uses them."""
    if _diffuse_only(p):
        f = p.kd * InvPi
        return torch.where(same_hemisphere(wo, wi)[..., None], f, 0.0)
    abs_ci, abs_co = abs_cos_theta(wi), abs_cos_theta(wo)
    if p.has("oren"):
        A, B = _oren_nayar_AB(p.sigma)
        sin_ti, sin_to = sin_theta(wi), sin_theta(wo)
        cos_dphi = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
        max_cos = torch.clamp_min(cos_dphi, 0.0)
        sin_alpha = torch.where(abs_ci > abs_co, sin_to, sin_ti)
        tan_beta = torch.where(abs_ci > abs_co, safe_div(sin_ti, abs_ci),
                               safe_div(sin_to, abs_co))
        on = A + B * max_cos * sin_alpha * tan_beta
        f = p.kd * (InvPi * torch.where(p.sigma > 0.0, on, 1.0))[..., None]
    else:
        f = p.kd * InvPi
    if p.has("blend"):
        # substrate diffuse (FresnelBlend); the Schlick F0 doubles as Rs
        w5 = ((1.0 - fr.schlick_weight(0.5 * abs_ci))
              * (1.0 - fr.schlick_weight(0.5 * abs_co)))
        f_blend = (28.0 / (23.0 * Pi)) * p.kd * (1.0 - p.eta3) * w5[..., None]
        f = torch.where((p.diffuse_kind == DIFF_FRESNEL_BLEND)[..., None],
                        f_blend, f)
    if p.has("disney"):
        # Disney diffuse + retro-reflection (Burley 2015)
        wh_n = normalize(wo + wi)
        cos_d = dot(wi, wh_n)
        fo = fr.schlick_weight(abs_co)
        fi = fr.schlick_weight(abs_ci)
        f_base = (1.0 - fo / 2.0) * (1.0 - fi / 2.0)
        roughness = torch.sqrt(torch.sqrt(torch.clamp_min(p.ax * p.ay, 1e-12)))
        rr = 2.0 * roughness * sqr(cos_d)
        f_retro = rr * (fo + fi + fo * fi * (rr - 1.0))
        f_disney = p.kd * (InvPi * (f_base + f_retro))[..., None]
        f = torch.where((p.diffuse_kind == DIFF_DISNEY)[..., None], f_disney, f)
    return torch.where(same_hemisphere(wo, wi)[..., None], f, 0.0)


def _pdf_diffuse(p, wo, wi):
    pdf = warp.cosine_hemisphere_pdf(abs_cos_theta(wi))
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _half_vector(wo, wi):
    wh = normalize(wo + wi)
    return wh * torch.sign(cos_theta(wh))[..., None]


def _eval_spec_reflect(p, wo, wi):
    """Lobe 1: GGX reflection with the material's Fresnel -> (f, pdf)."""
    valid = same_hemisphere(wo, wi)
    wh = _half_vector(wo, wi)
    F = _eval_fresnel(p, dot(wo, wh), wo)
    fr_core = mf.brdf_div_fr(wo, wh, wi, p.ax, p.ay)
    f = p.spec_tint * F * fr_core[..., None]
    if p.has("blend"):
        # substrate: the Ashikhmin max-denominator form
        abs_ci, abs_co = abs_cos_theta(wi), abs_cos_theta(wo)
        f_ash_core = safe_div(mf.D_ggx(wh, p.ax, p.ay),
                              4.0 * torch.abs(dot(wi, wh))
                              * torch.maximum(abs_ci, abs_co))
        f_sub = fr.fresnel_schlick(p.eta3, dot(wi, wh)) * f_ash_core[..., None]
        f = torch.where((p.diffuse_kind == DIFF_FRESNEL_BLEND)[..., None],
                        f_sub, f)
    pdf = mf.pdf_wi_reflection(mf.pdf_wh_ggx(wo, wh, p.ax, p.ay), wo, wh)
    ok = valid & (pdf > 0.0)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _eval_spec_transmit(p, wo, wi):
    """Lobe 2: GGX dielectric transmission -> (f, pdf); wh = normalize(wo +
    wi * eta_rel) with eta_rel the transmitted over the incident IOR seen
    from wo."""
    trans = ~same_hemisphere(wo, wi)
    eta_rel = _hemi_eta(p, wo)
    wh = normalize(wo + wi * eta_rel[..., None])
    wh = wh * torch.sign(cos_theta(wh))[..., None]
    # discard configurations where wo and wi are on one side of wh
    ok = trans & (dot(wo, wh) * dot(wi, wh) < 0.0)
    F = fr.fresnel_dielectric(torch.abs(dot(wo, wh))[..., None], _eta_dir(p, wo))
    ft = mf.btdf_div_ft(wo, wh, wi, eta_rel, p.ax, p.ay)
    f = p.spec_tint * ((1.0 - F) * ft[..., None])
    pdf = mf.pdf_wi_transmission(mf.pdf_wh_ggx(wo, wh, p.ax, p.ay), wo, wh,
                                 wi, eta_rel)
    ok = ok & (pdf > 0.0) & torch.isfinite(pdf)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _eval_clearcoat(p, wo, wi):
    """Lobe 3: isotropic GGX clearcoat, Schlick F0 = 0.04."""
    valid = same_hemisphere(wo, wi)
    wh = _half_vector(wo, wi)
    D = mf.D_ggx(wh, p.cc_alpha, p.cc_alpha)
    G = mf.G_ggx(wo, wi, p.cc_alpha, p.cc_alpha)
    F = 0.04 + 0.96 * fr.schlick_weight(dot(wo, wh))
    f_scalar = safe_div(D * G * F,
                        torch.abs(4.0 * cos_theta(wo) * cos_theta(wi)))
    pdf = mf.pdf_wi_reflection(mf.pdf_wh_ggx(wo, wh, p.cc_alpha, p.cc_alpha),
                               wo, wh)
    ok = valid & (pdf > 0.0)
    f = f_scalar[..., None].expand(p.kd.shape)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _sheen_ltc_coeffs(p, wo):
    """Bilinear (a, b, R) from the LTC sheen table over (|cos_theta_o|,
    alpha), with the JAX package's clamps and truncating casts."""
    T = p.sheen_ltc
    n = T.shape[0]
    alpha = (p.sheen_alpha if p.sheen_alpha is not None
             else torch.full(wo.shape[:-1], 0.5, device=wo.device))

    def axis(v):
        t = torch.clamp(v * n - 0.5, 0.0, n - 1.0)
        i0 = torch.clamp(t.long(), 0, n - 1)
        i1 = torch.clamp(i0 + 1, 0, n - 1)
        return i0, i1, (t - i0.float())[..., None]

    c0, c1, fc = axis(abs_cos_theta(wo))
    a0, a1, fa = axis(torch.clamp(alpha, 1e-3, 1.0))
    v = ((T[c0, a0] * (1 - fa) + T[c0, a1] * fa) * (1 - fc)
         + (T[c1, a0] * (1 - fa) + T[c1, a1] * fa) * fc)
    return v[..., 0], v[..., 1], torch.clamp(v[..., 2], 0.0, 1.0)


def _sheen_azimuth(wo):
    """cos / sin of wo's azimuth: the LTC skew axis lies in the plane of
    incidence, so wi turns into the frame where wo.y == 0."""
    r = torch.sqrt(wo[..., 0] ** 2 + wo[..., 1] ** 2)
    ok = r > 1e-8
    rr = torch.clamp_min(r, 1e-8)
    return (torch.where(ok, wo[..., 0] / rr, 1.0),
            torch.where(ok, wo[..., 1] / rr, 0.0))


def _sign_nz(x):
    s = torch.sign(x)
    return torch.where(s == 0.0, 1.0, s)


def _eval_sheen(p, wo, wi):
    """Lobe 4: the LTC sheen (f = R tint ltc / cos_i, pdf = ltc) with the
    table, the Burley Schlick-weight sheen without it."""
    valid = same_hemisphere(wo, wi)
    if p.sheen_ltc is None:
        wh = normalize(wo + wi)
        f = p.sheen_tint * fr.schlick_weight(torch.abs(dot(wi, wh)))[..., None]
        pdf = warp.cosine_hemisphere_pdf(abs_cos_theta(wi))
        return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)
    a, b, R = _sheen_ltc_coeffs(p, wo)
    ca, sa = _sheen_azimuth(wo)
    sgn = _sign_nz(cos_theta(wo))
    # wi into the incidence frame, mirrored to the upper hemisphere
    x = ca * wi[..., 0] + sa * wi[..., 1]
    y = -sa * wi[..., 0] + ca * wi[..., 1]
    z = wi[..., 2] * sgn
    # the cosine lobe pushed through M (inverse M and its Jacobian)
    xi = a * x + b * z
    yi = a * y
    l2 = xi * xi + yi * yi + z * z
    ln = torch.sqrt(torch.clamp_min(l2, 1e-12))
    cz = torch.clamp(z / ln, 0.0, 1.0)
    ltc = cz / torch.pi * (a * a) / torch.clamp_min(l2 * ln, 1e-12)
    f = (p.sheen_tint * (R * ltc)[..., None]
         / torch.clamp_min(abs_cos_theta(wi), 1e-6)[..., None])
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, ltc, 0.0)


def _sample_sheen_ltc(p, wo, u2):
    """A cosine sample pushed through M, turned back out of the incidence
    frame: its density is `_eval_sheen`'s pdf."""
    a, b, _ = _sheen_ltc_coeffs(p, wo)
    ca, sa = _sheen_azimuth(wo)
    sgn = _sign_nz(cos_theta(wo))
    v = warp.square_to_cosine_hemisphere(u2)
    x = (v[..., 0] - b * v[..., 2]) / torch.clamp_min(a, 1e-6)
    y = v[..., 1] / torch.clamp_min(a, 1e-6)
    z = v[..., 2]
    wx = ca * x - sa * y
    wy = sa * x + ca * y
    return normalize(torch.stack([wx, wy, z * sgn], -1))


def _mean_s(x):
    return torch.mean(x, dim=-1)


def _lut_E(p, alpha, mu):
    """Bilinear GGX single-scatter albedo E(alpha, mu) from the LUT (alpha
    on a squared grid)."""
    E = p.ems_E
    na, nm = E.shape
    fa = torch.sqrt(torch.clamp(alpha, 0.0, 1.0)) * (na - 1)
    fm = torch.clamp(mu, 0.0, 1.0) * (nm - 1)
    ia = torch.clamp(fa.long(), 0, na - 2)
    im = torch.clamp(fm.long(), 0, nm - 2)
    da = fa - ia
    dm = fm - im
    e = ((1 - da) * ((1 - dm) * E[ia, im] + dm * E[ia, im + 1])
         + da * ((1 - dm) * E[ia + 1, im] + dm * E[ia + 1, im + 1]))
    return torch.clamp(e, 1e-3, 1.0)


def _eval_ems(p, wo, wi):
    """Kulla-Conty multiple-scattering lobe of rough conductors and
    mirrors: f_ms = F_ms (1 - E(mu_o)) (1 - E(mu_i)) / (pi (1 - E_avg))."""
    alpha = torch.sqrt(p.ax * p.ay)
    mu_o = abs_cos_theta(wo)
    Eo = _lut_E(p, alpha, mu_o)
    Ei = _lut_E(p, alpha, abs_cos_theta(wi))
    na = p.ems_Eavg.shape[0]
    ia = torch.clamp((torch.sqrt(torch.clamp(alpha, 0.0, 1.0)) * (na - 1)).long(),
                     0, na - 1)
    E_avg = torch.clamp(p.ems_Eavg[ia], 1e-3, 1.0 - 1e-3)
    # average Fresnel: constant -> 1, the others (20 F0 + 1) / 21
    F0 = _eval_fresnel(p, torch.ones_like(mu_o))
    F_avg = torch.clamp(_mean_s((20.0 * F0 + 1.0) / 21.0), 0.0, 1.0)
    F_avg = torch.where(p.fr_mode == fr.FR_CONSTANT, 1.0, F_avg)
    F_ms = safe_div(F_avg * F_avg * E_avg, 1.0 - F_avg * (1.0 - E_avg))
    f_scalar = F_ms * safe_div((1.0 - Eo) * (1.0 - Ei), Pi * (1.0 - E_avg))
    metalish = ((p.fr_mode == fr.FR_CONSTANT) | (p.fr_mode == fr.FR_CONDUCTOR)
                | (p.fr_mode == fr.FR_F82))
    ok = same_hemisphere(wo, wi) & metalish & (alpha > 0.02)
    return p.spec_tint * torch.where(ok, f_scalar, 0.0)[..., None]


def _lobe_weights(p, wo):
    """Selection probabilities of the five lobes given wo, and their total:
    a function of (params, wo) alone, so evaluate and sample agree. The
    Lambert-only table has one lobe: (its probability, the total)."""
    if _diffuse_only(p):
        if not p.has("diff"):
            total = torch.zeros_like(p.diffuse_weight)
        else:
            total = p.diffuse_weight * torch.mean(p.kd, dim=-1)
        return safe_div(total, total), total
    zero = torch.zeros(p.kd.shape[:-1], device=p.kd.device)
    F_diel = (_dielectric_F0(p, wo) if p.has("spec") or p.has("trans")
              else None)
    w_diff = p.diffuse_weight * _mean_s(p.kd) if p.has("diff") else zero
    if p.has("spec"):
        mean_F = _mean_s(_eval_fresnel(p, wo[..., 2]))
        spec_F = torch.where(p.fr_mode == fr.FR_DIELECTRIC, _mean_s(F_diel),
                             mean_F)
        w_spec = (p.spec_weight * _mean_s(p.spec_tint)
                  * torch.clamp_min(spec_F, 0.02))
    else:
        w_spec = zero
    w_trans = (p.trans_weight * _mean_s(p.spec_tint)
               * torch.clamp_min(1.0 - _mean_s(F_diel), 0.0)
               if p.has("trans") else zero)
    w_cc = p.cc_weight * 0.25 if p.has("cc") else zero
    if p.has("sheen"):
        sheen_scale = 0.08
        if p.sheen_ltc is not None:
            sheen_scale = torch.clamp_min(_sheen_ltc_coeffs(p, wo)[2], 0.02)
        w_sheen = p.sheen_weight * _mean_s(p.sheen_tint) * sheen_scale
    else:
        w_sheen = zero
    w = torch.stack([w_diff, w_spec, w_trans, w_cc, w_sheen], dim=-1)
    total = torch.sum(w, dim=-1, keepdim=True)
    return safe_div(w, total), total[..., 0]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def evaluate(p, wo, wi):
    """Full BSDF eval at local (wo, wi): ScatterEval(f [..., 3], pdf).
    A mixture row gives f = wa f_a + wb f_b and pdf = pa pdf_a + (1 - pa)
    pdf_b with pa = wa / (wa + wb)."""
    if p.mix_b is not None:
        ev_a = _evaluate_single(p, wo, wi)
        ev_b = _evaluate_single(p.mix_b, wo, wi)
        wa, wb = p.mix_wa, p.mix_wb
        pa = safe_div(wa, wa + wb)
        return ScatterEval(f=wa[..., None] * ev_a.f + wb[..., None] * ev_b.f,
                           pdf=pa * ev_a.pdf + (1.0 - pa) * ev_b.pdf)
    return _evaluate_single(p, wo, wi)


def _evaluate_single(p, wo, wi):
    probs, total = _lobe_weights(p, wo)
    if _diffuse_only(p):
        f = torch.zeros_like(p.kd)
        pdf = torch.zeros_like(total)
        if p.has("diff"):
            f = _eval_diffuse(p, wo, wi) * p.diffuse_weight[..., None]
            pdf = probs * _pdf_diffuse(p, wo, wi)
    else:
        f = torch.zeros_like(p.kd)
        pdf = torch.zeros_like(total)
        terms = (("diff", 0, p.diffuse_weight,
                  lambda: (_eval_diffuse(p, wo, wi), _pdf_diffuse(p, wo, wi))),
                 ("spec", 1, p.spec_weight, lambda: _eval_spec_reflect(p, wo, wi)),
                 ("trans", 2, p.trans_weight, lambda: _eval_spec_transmit(p, wo, wi)),
                 ("cc", 3, p.cc_weight, lambda: _eval_clearcoat(p, wo, wi)),
                 ("sheen", 4, p.sheen_weight, lambda: _eval_sheen(p, wo, wi)))
        for name, i, weight, lobe in terms:
            if p.has(name):
                f_l, pdf_l = lobe()
                f = f + f_l * weight[..., None]
                pdf = pdf + probs[..., i] * pdf_l
        if p.has("ems") and p.ems_E is not None:
            f = f + _eval_ems(p, wo, wi) * p.spec_weight[..., None]
    valid = (total > 0.0) & (abs_cos_theta(wo) > 1e-7)
    return ScatterEval(f=torch.where(valid[..., None], f, 0.0),
                       pdf=torch.where(valid, pdf, 0.0))


def albedo(p, wo):
    """Approximate reflectance for AOVs."""
    if p.mix_b is not None:
        return torch.clamp(p.mix_wa[..., None] * _albedo_single(p, wo)
                           + p.mix_wb[..., None] * _albedo_single(p.mix_b, wo),
                           0.0, 1.0)
    return _albedo_single(p, wo)


def _albedo_single(p, wo):
    if _diffuse_only(p):
        # the other terms are zero: no spec, trans or sheen weight
        return torch.clamp(p.kd * p.diffuse_weight[..., None], 0.0, 1.0)
    F = _eval_fresnel(p, abs_cos_theta(wo))
    a = (p.kd * p.diffuse_weight[..., None]
         + p.spec_tint * (p.spec_weight * _mean_s(F))[..., None]
         + p.spec_tint * p.trans_weight[..., None]
         + p.sheen_tint * (0.08 * p.sheen_weight)[..., None])
    return torch.clamp(a, 0.0, 1.0)


def sample(p, wo, state):
    """Sample the BSDF. Returns (state, BSDFSample). Random numbers are
    drawn in the JAX package's order: a mixture's row pick first, then each
    row's lobe pick and 2D sample; the mixture is then MIS-evaluated (the
    one-sample estimator)."""
    if p.mix_b is not None:
        pa = safe_div(p.mix_wa, p.mix_wa + p.mix_wb)
        state, u_row = rng.next_1d(state)
        pick_a = u_row < pa
        state, sa = _sample_single(p, wo, state)
        state, sb = _sample_single(p.mix_b, wo, state)
        wi = torch.where(pick_a[..., None], sa.wi, sb.wi)
        ev = evaluate(p, wo, wi)
        eta_scale = torch.where(pick_a, sa.eta_scale, sb.eta_scale)
        valid = torch.where(pick_a, sa.valid, sb.valid) & (ev.pdf > 0.0)
        return state, BSDFSample(wi=wi, ev=ev, eta_scale=eta_scale,
                                 valid=valid)
    return _sample_single(p, wo, state)


def _sample_single(p, wo, state):
    probs, total = _lobe_weights(p, wo)
    state, u_sel = rng.next_1d(state)
    state, u2 = rng.next_2d(state)
    sgn = _sign_nz(cos_theta(wo))[..., None]
    # lobes 0 and 4: the cosine hemisphere on wo's side
    wi = warp.square_to_cosine_hemisphere(u2) * sgn
    lobe = None
    if not _diffuse_only(p):
        cdf = torch.cumsum(probs, dim=-1)
        lobe = torch.clamp(torch.sum((u_sel[..., None] >= cdf).to(torch.int32),
                                     dim=-1), 0, 4)
        if p.has("sheen") and p.sheen_ltc is not None:
            wi = torch.where((lobe == 4)[..., None], _sample_sheen_ltc(p, wo, u2),
                             wi)
        if p.has("spec") or p.has("trans"):
            wh = mf.sample_wh_ggx(wo, u2, p.ax, p.ay)
            wi = torch.where((lobe == 1)[..., None], reflect(wo, wh), wi)
        if p.has("trans"):
            eta_rel = _hemi_eta(p, wo)
            wh_t = wh * torch.sign(dot(wh, wo))[..., None]  # wo's side
            ref_ok, wi_trans = refract(wo, wh_t, eta_rel)
            # total internal reflection -> reflection
            wi_trans = torch.where(ref_ok[..., None], wi_trans,
                                   reflect(wo, wh_t))
            wi = torch.where((lobe == 2)[..., None], wi_trans, wi)
        if p.has("cc"):
            wh_c = mf.sample_wh_ggx(wo, u2, p.cc_alpha, p.cc_alpha)
            wi = torch.where((lobe == 3)[..., None], reflect(wo, wh_c), wi)
    wi = normalize(wi)
    ev = _evaluate_single(p, wo, wi)
    valid = ((total > 0.0) & (ev.pdf > 0.0)
             & torch.all(torch.isfinite(wi), dim=-1))
    if p.has("trans") and lobe is not None:
        # only the transmission lobe can refract (its weight is 0 elsewhere)
        refracted = (lobe == 2) & ~same_hemisphere(wo, wi)
        eta_scale = torch.where(refracted, sqr(_hemi_eta(p, wo)), 1.0)
    else:
        eta_scale = torch.ones_like(total)
    return state, BSDFSample(wi=wi, ev=ev, eta_scale=eta_scale, valid=valid)
