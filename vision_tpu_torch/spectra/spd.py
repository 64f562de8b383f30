"""Spectral power distributions, CIE data, IOR curves, metal complex IORs.

Counterpart of `vision_tpu/spectra/spd.py`: the CIE tables and the metal
table (`cie.npz`, `metal_ior.npz` in this package's own `data/`, read with
numpy), the linear-interpolated evaluation of an SPD sampled over [360, 830]
nm on the host and on the device (`spd_eval`, `spd_eval_rows`), the metals'
complex IOR at the sRGB peak wavelengths, and the glasses' Sellmeier IOR,
scalar or per wavelength (`glass_ior`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "data")

VISIBLE_MIN = 360.0
VISIBLE_MAX = 830.0
CIE_SAMPLES = 471  # 1nm

# sRGB response peak wavelengths (the JAX package's RGB_PEAK_WAVELENGTHS)
RGB_PEAK_WAVELENGTHS = (602.785, 539.285, 445.772)

_cie = np.load(os.path.join(DATA_DIR, "cie.npz"))
_metals = np.load(os.path.join(DATA_DIR, "metal_ior.npz"))

CIE_X = _cie["X"]
CIE_Y = _cie["Y"]
CIE_Z = _cie["Z"]
CIE_D65 = _cie["D65"]
CIE_Y_INTEGRAL = float(np.sum(CIE_Y))  # ~106.857 * (1nm)

METAL_NAMES = sorted({k[:-4] for k in _metals.files if k.endswith("_eta")})


def spd_eval_host(values, lambdas):
    """Linear-interp eval of a [N]-sample SPD spanning [360, 830] (host)."""
    values = np.asarray(values, np.float64)
    n = len(values)
    lambdas = np.clip(np.asarray(lambdas, np.float64), VISIBLE_MIN, VISIBLE_MAX)
    t = (lambdas - VISIBLE_MIN) / (VISIBLE_MAX - VISIBLE_MIN) * (n - 1)
    i0 = np.clip(np.floor(t).astype(int), 0, n - 1)
    i1 = np.clip(i0 + 1, 0, n - 1)
    w = t - i0
    return values[i0] * (1 - w) + values[i1] * w


def _lerp_index(lambdas, n):
    lam = torch.clamp(lambdas, VISIBLE_MIN, VISIBLE_MAX)
    t = (lam - VISIBLE_MIN) / (VISIBLE_MAX - VISIBLE_MIN) * (n - 1)
    i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    return i0, i1, t - i0.to(torch.float32)


def spd_eval(values, lambdas):
    """Device version: values [N] tensor, lambdas [...] -> [...]."""
    i0, i1, w = _lerp_index(lambdas, values.shape[0])
    return values[i0] * (1.0 - w) + values[i1] * w


def spd_eval_rows(table, rows, lambdas):
    """Per-lane SPD rows: table [N, K], rows [...], lambdas [..., S] ->
    [..., S]."""
    k = table.shape[1]
    i0, i1, w = _lerp_index(lambdas, k)
    flat = table.reshape(-1)
    r = rows.to(torch.int64)[..., None] * k
    return flat[r + i0] * (1.0 - w) + flat[r + i1] * w


def metal_complex_ior(name):
    """(eta_spd, k_spd) [95]-sample arrays for a named metal; Ag for an
    unknown name."""
    if f"{name}_eta" not in _metals.files:
        name = "Ag"
    return _metals[f"{name}_eta"], _metals[f"{name}_k"]


def metal_ior_rgb(name):
    """Complex IOR at the sRGB peak wavelengths -> (eta[3], k[3])."""
    eta_spd, k_spd = metal_complex_ior(name)
    eta = spd_eval_host(eta_spd, RGB_PEAK_WAVELENGTHS)
    k = spd_eval_host(k_spd, RGB_PEAK_WAVELENGTHS)
    return eta.astype(np.float32), k.astype(np.float32)


_SELLMEIER = {
    # name: (B1, C1, B2, C2, B3, C3) with lambda in micrometres
    "BK7": (1.03961212, 0.00600069867, 0.231792344, 0.0200179144,
            1.01046945, 103.560653),
    "LASF9": (2.00029547, 0.0121426017, 0.298926886, 0.0538736236,
              1.80691843, 156.530829),
}
GLASS_NAMES = list(_SELLMEIER.keys())


def glass_ior(name, lambdas):
    """Sellmeier IOR of a named glass (BK7 for an unknown name) at the
    wavelengths `lambdas` [nm], a float32 tensor."""
    if name not in _SELLMEIER:
        name = "BK7"
    b1, c1, b2, c2, b3, c3 = _SELLMEIER[name]
    lam = lambdas / 1000.0
    l2 = lam * lam
    f = b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2) + b3 * l2 / (l2 - c3)
    return torch.sqrt(f + 1.0)


def glass_ior_scalar(name):
    """Sellmeier IOR at the R peak wavelength (the RGB-mode glass IOR), in
    float32 as the JAX package computes it; BK7 for an unknown name."""
    if name not in _SELLMEIER:
        name = "BK7"
    b1, c1, b2, c2, b3, c3 = (np.float32(c) for c in _SELLMEIER[name])
    lam = np.float32(RGB_PEAK_WAVELENGTHS[0]) / np.float32(1000.0)
    l2 = lam * lam
    f = b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2) + b3 * l2 / (l2 - c3)
    return float(np.sqrt(f + np.float32(1.0)))
