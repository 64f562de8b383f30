"""GGX microfacet distribution in the local shading frame.

Counterpart of `vision_tpu/shading/microfacet.py`: the anisotropic alpha
split, D, Smith Lambda/G1/G, visible-normal sampling, pdf_wh, the
reflection/transmission Jacobians and the BRDF/BTDF without Fresnel. The
Beckmann D of the JAX module is not ported: nothing on the path reaches it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import (Pi, TwoPi, abs_cos_theta, cos2_theta, cos_phi,
                         cos_theta, cross, dot, normalize, safe_div, safe_sqrt,
                         sin_phi, sqr, tan2_theta, vec3)


def roughness_to_alpha(roughness):
    return sqr(roughness)


def calculate_alpha(alpha, anisotropic):
    """Split scalar alpha into (ax, ay) by anisotropy in [-1, 1]. Takes
    numpy float32 values (the material compiler calls it on the host)."""
    ax = np.where(anisotropic < 0.0, alpha / (1.0 + anisotropic),
                  alpha * (1.0 - anisotropic))
    ay = np.where(anisotropic < 0.0, alpha * (1.0 + anisotropic),
                  alpha / (1.0 - anisotropic))
    iso = np.abs(anisotropic) <= 1e-4
    return np.where(iso, alpha, ax), np.where(iso, alpha, ay)


def D_ggx(wh, ax, ay):
    t2 = tan2_theta(wh)
    c4 = sqr(cos2_theta(wh))
    e = (sqr(cos_phi(wh) / ax) + sqr(sin_phi(wh) / ay)) * t2
    d = safe_div(1.0, Pi * ax * ay * c4 * sqr(1.0 + e))
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def lambda_ggx(w, ax, ay):
    t2 = tan2_theta(w)
    a2 = sqr(cos_phi(w) * ax) + sqr(sin_phi(w) * ay)
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + a2 * t2))
    return torch.where(torch.isfinite(t2), lam, 0.0)


def G1_ggx(w, ax, ay):
    return 1.0 / (1.0 + lambda_ggx(w, ax, ay))


def G_ggx(wo, wi, ax, ay):
    return 1.0 / (1.0 + lambda_ggx(wo, ax, ay) + lambda_ggx(wi, ax, ay))


def sample_wh_ggx(wo, u, ax, ay):
    """Visible-normal GGX sampling (Heitz 2018)."""
    sign = torch.sign(cos_theta(wo))
    sign = torch.where(sign == 0.0, 1.0, sign)
    wo_f = wo * sign[..., None]  # flip to the upper hemisphere
    vh = normalize(vec3(ax * wo_f[..., 0], ay * wo_f[..., 1], wo_f[..., 2]))
    lensq = sqr(vh[..., 0]) + sqr(vh[..., 1])
    x_axis = torch.zeros_like(vh)
    x_axis[..., 0] = 1.0
    t1 = torch.where(
        (lensq > 1e-9)[..., None],
        vec3(-vh[..., 1], vh[..., 0], torch.zeros_like(lensq))
        / torch.sqrt(torch.clamp_min(lensq, 1e-9))[..., None],
        x_axis,
    )
    t2v = cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = TwoPi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - sqr(p1)) + s * p2
    pz = safe_sqrt(1.0 - sqr(p1) - sqr(p2))
    nh = p1[..., None] * t1 + p2[..., None] * t2v + pz[..., None] * vh
    wh = normalize(vec3(ax * nh[..., 0], ay * nh[..., 1],
                        torch.clamp_min(nh[..., 2], 1e-6)))
    return wh * sign[..., None]


def pdf_wh_ggx(wo, wh, ax, ay):
    """Visible-normal pdf: D(wh) G1(wo) |wo.wh| / |cos(wo)|."""
    return safe_div(D_ggx(wh, ax, ay) * G1_ggx(wo, ax, ay)
                    * torch.abs(dot(wo, wh)), abs_cos_theta(wo))


def pdf_wi_reflection(pdf_wh, wo, wh):
    """dwh/dwi Jacobian for reflection: pdf_wh / (4 |wo.wh|)."""
    return safe_div(pdf_wh, 4.0 * torch.abs(dot(wo, wh)))


def pdf_wi_transmission(pdf_wh, wo, wh, wi, eta):
    """Transmission Jacobian, eta = eta_t/eta_i seen from wo."""
    denom = sqr(dot(wi, wh) * eta + dot(wo, wh))
    return safe_div(pdf_wh * sqr(eta) * torch.abs(dot(wi, wh)), denom)


def brdf_div_fr(wo, wh, wi, ax, ay):
    """D G / (4 cos_o cos_i): the microfacet BRDF without Fresnel."""
    return safe_div(D_ggx(wh, ax, ay) * G_ggx(wo, wi, ax, ay),
                    torch.abs(4.0 * cos_theta(wo) * cos_theta(wi)))


def btdf_div_ft(wo, wh, wi, eta, ax, ay):
    """Microfacet BTDF without Fresnel in radiance transport; eta =
    eta_t/eta_i seen from wo, wh = normalize(wo + wi*eta)."""
    denom = sqr(dot(wi, wh) * eta + dot(wo, wh))
    return safe_div(
        D_ggx(wh, ax, ay) * G_ggx(wo, wi, ax, ay)
        * torch.abs(dot(wi, wh)) * torch.abs(dot(wo, wh)),
        torch.abs(cos_theta(wi) * cos_theta(wo)) * denom)
