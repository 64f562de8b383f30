"""Fresnel variants over a trailing spectral axis.

Counterpart of `vision_tpu/shading/fresnel.py`: Schlick, exact dielectric,
complex conductor, F82-tint and constant, and the host-side conversions
the material compiler uses (Schlick F0 from an IOR and back, the F82
edge-tint coefficient). Those take numpy arrays or floats.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import lerp, safe_sqrt, sqr

# fresnel mode ids used in the material table
FR_DIELECTRIC = 0
FR_CONDUCTOR = 1
FR_SCHLICK = 2
FR_CONSTANT = 3
FR_F82 = 4


def schlick_weight(cos_theta):
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return sqr(sqr(m)) * m


def fresnel_schlick(F0, cos_theta):
    """F0 [..., S], cos_theta [...]."""
    return lerp(schlick_weight(cos_theta)[..., None], F0, torch.ones_like(F0))


def schlick_F0_from_ior(ior):
    return sqr((ior - 1.0) / (ior + 1.0))


def schlick_ior_from_F0(f0):
    s = np.sqrt(np.clip(f0, 0.0, 0.99))
    return (1.0 + s) / (1.0 - s)


def fresnel_dielectric(abs_cos_theta_i, eta):
    """Exact unpolarized dielectric Fresnel; eta is the relative IOR of the
    transmitted side over the incident side."""
    sin2_i = 1.0 - sqr(abs_cos_theta_i)
    sin2_t = sin2_i / sqr(eta)
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_parl = (eta * abs_cos_theta_i - cos_t) / (eta * abs_cos_theta_i + cos_t)
    r_perp = (abs_cos_theta_i - eta * cos_t) / (abs_cos_theta_i + eta * cos_t)
    return torch.where(sin2_t >= 1.0, 1.0, 0.5 * (sqr(r_parl) + sqr(r_perp)))


def fresnel_complex(cos_theta_i, eta, k):
    """Conductor Fresnel with complex IOR eta - i k."""
    cos_theta_i = torch.clamp(cos_theta_i, 0.0, 1.0)
    sin2 = 1.0 - sqr(cos_theta_i)
    er = eta
    ei = k
    e2r = sqr(er) - sqr(ei)          # eta^2 real
    e2i = 2.0 * er * ei              # eta^2 imag
    d = torch.clamp_min(sqr(e2r) + sqr(e2i), 1e-20)
    str_ = sin2 * e2r / d
    sti = -sin2 * e2i / d
    cr = 1.0 - str_
    ci = -sti
    r = torch.sqrt(torch.clamp_min(sqr(cr) + sqr(ci), 1e-20))
    ctr = torch.sqrt(torch.clamp_min((r + cr) * 0.5, 1e-20))
    cti = torch.sign(ci) * torch.sqrt(torch.clamp_min((r - cr) * 0.5, 1e-20))
    num_r = er * cos_theta_i - ctr
    num_i = ei * cos_theta_i - cti
    den_r = er * cos_theta_i + ctr
    den_i = ei * cos_theta_i + cti
    den = torch.clamp_min(sqr(den_r) + sqr(den_i), 1e-20)
    rp2 = (sqr(num_r) + sqr(num_i)) / den
    num2_r = cos_theta_i - (er * ctr - ei * cti)
    num2_i = -(er * cti + ei * ctr)
    den2_r = cos_theta_i + (er * ctr - ei * cti)
    den2_i = (er * cti + ei * ctr)
    den2 = torch.clamp_min(sqr(den2_r) + sqr(den2_i), 1e-20)
    rs2 = (sqr(num2_r) + sqr(num2_i)) / den2
    return 0.5 * (rp2 + rs2)


def fresnel_f82(cos_theta, F0, b):
    """F82-tint metallic Fresnel: Schlick plus an edge-tint correction."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m5 = sqr(sqr(m)) * m
    schlick = F0 + (1.0 - F0) * m5[..., None]
    return schlick - b * (cos_theta * m5 * m)[..., None]


def f82_b_from_edge_tint(F0, edge_tint):
    """The F82 correction coefficient b from the edge tint at cos = 1/7
    (numpy, at material compile time)."""
    cos_82 = 1.0 / 7.0
    m = 1.0 - cos_82
    m5 = m ** 5
    schlick_at = F0 + (1.0 - F0) * m5
    denom = cos_82 * m5 * m
    return (schlick_at - edge_tint * schlick_at) / denom
