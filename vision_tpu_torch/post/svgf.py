"""SVGF: spatiotemporal variance-guided filtering.

Counterpart of `vision_tpu/post/svgf.py`: temporal accumulation with
motion-vector reprojection, luminance moments for the variance (a 7x7
edge-aware spatial estimate while the history is short), and
variance-guided edge-stopping a-trous passes that also filter the
variance. It works on illumination demodulated by the albedo. Images are
[H, W, ...]; a shifted tap is `torch.roll`, which wraps at the border as
`jnp.roll` does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.math import luminance, safe_div


@dataclass
class SVGFState:
    illum: torch.Tensor    # [H, W, 3] accumulated illumination
    moments: torch.Tensor  # [H, W, 2] luminance first/second moments
    history: torch.Tensor  # [H, W] frame count


def init_state(h, w, device="cuda"):
    return SVGFState(illum=torch.zeros((h, w, 3), device=device),
                     moments=torch.zeros((h, w, 2), device=device),
                     history=torch.zeros((h, w), device=device))


def _bilinear_reproject(img, motion):
    """Sample img at pixel + motion (backward reprojection), clamped at the
    border. Returns (image, in-bounds mask)."""
    H, W = img.shape[:2]
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    sx = xx.to(torch.float32) + motion[..., 0]
    sy = yy.to(torch.float32) + motion[..., 1]
    x0 = torch.floor(sx).to(torch.int32)
    y0 = torch.floor(sy).to(torch.int32)
    fx = sx - x0
    fy = sy - y0
    if img.dim() == 3:
        fx, fy = fx[..., None], fy[..., None]

    def tap(xi, yi):
        return img[torch.clamp(yi, 0, H - 1).long(),
                   torch.clamp(xi, 0, W - 1).long()]

    out = (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)
    in_b = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    return out, in_b


def _shift2d(img, dy, dx):
    return torch.roll(img, (dy, dx), (0, 1))


def _spatial_moments(illum, normal, var_boost=1.0):
    """7x7 edge-aware luminance variance estimate (normal and luminance
    edge-stopping weights), for pixels whose temporal moments are still
    too noisy to trust."""
    lum = luminance(illum)
    m1 = torch.zeros_like(lum)
    m2 = torch.zeros_like(lum)
    wsum = torch.zeros_like(lum)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            ls = _shift2d(lum, dy, dx)
            ns = _shift2d(normal, dy, dx)
            w_n = torch.clamp(torch.sum(ns * normal, -1), 0.0, 1.0) ** 32
            w_l = torch.exp(-torch.abs(ls - lum) * 4.0)
            w = w_n * w_l
            m1 = m1 + ls * w
            m2 = m2 + ls * ls * w
            wsum = wsum + w
    m1 = safe_div(m1, wsum)
    m2 = safe_div(m2, wsum)
    return torch.clamp_min(m2 - m1 * m1, 0.0) * var_boost


_K5 = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]
_K3 = [0.25, 0.5, 0.25]


def _atrous_var_pass(color, var, normal, albedo, step, sigma_rt=4.0,
                     sigma_normal=128.0, sigma_albedo=8.0):
    """One variance-guided a-trous iteration that also filters the
    variance (var' = sum w^2 var / (sum w)^2); its luminance sigma comes
    from a 3x3 Gaussian prefilter of the current variance."""
    g = torch.zeros_like(var)
    for j in range(3):
        for i in range(3):
            g = g + _K3[j] * _K3[i] * _shift2d(var, j - 1, i - 1)
    denom = sigma_rt * torch.sqrt(torch.clamp_min(g, 0.0)) + 1e-4
    lum_c = luminance(color)
    acc = torch.zeros_like(color)
    vacc = torch.zeros_like(var)
    wsum = torch.zeros_like(var)
    for j in range(5):
        for i in range(5):
            dy = (j - 2) * step
            dx = (i - 2) * step
            c = _shift2d(color, dy, dx)
            v = _shift2d(var, dy, dx)
            n = _shift2d(normal, dy, dx)
            a = _shift2d(albedo, dy, dx)
            w_n = torch.pow(torch.clamp(torch.sum(n * normal, -1), 0.0, 1.0),
                            sigma_normal)
            w_l = torch.exp(-safe_div(torch.abs(luminance(c) - lum_c), denom))
            w_a = torch.exp(-torch.sum(torch.abs(a - albedo), -1) * sigma_albedo)
            w = _K5[j] * _K5[i] * w_n * w_l * w_a
            acc = acc + c * w[..., None]
            vacc = vacc + v * w * w
            wsum = wsum + w
    out = safe_div(acc, wsum[..., None])
    out_var = safe_div(vacc, torch.clamp_min(wsum * wsum, 1e-12))
    return out, out_var


def svgf_filter(color, albedo, normal, depth, motion, prev_state,
                prev_normal=None, prev_depth=None,
                n_passes=3, alpha=0.05, moments_alpha=0.2,
                history_limit=32.0, sigma_rt=10.0, sigma_normal=128.0):
    """One SVGF frame. All inputs [H, W, ...]. Returns (filtered,
    new_state). The a-trous passes use a luminance sigma of 4, as the JAX
    package's do (its `sigma_rt` is not read)."""
    illum = safe_div(color, torch.clamp_min(albedo, 1e-3))  # demodulate

    # ---- reproject ----
    prev_illum, valid = _bilinear_reproject(prev_state.illum, motion)
    prev_mom, _ = _bilinear_reproject(prev_state.moments, motion)
    prev_hist = _bilinear_reproject(prev_state.history[..., None],
                                    motion)[0][..., 0]
    if prev_normal is not None:
        pn, _ = _bilinear_reproject(prev_normal, motion)
        valid = valid & (torch.sum(pn * normal, -1) > 0.8)
    if prev_depth is not None:
        pd, _ = _bilinear_reproject(prev_depth[..., None], motion)
        rel = torch.abs(pd[..., 0] - depth) / torch.clamp_min(depth, 1e-3)
        valid = valid & (rel < 0.1)

    hist = torch.where(valid, torch.clamp_max(prev_hist + 1.0, history_limit),
                       1.0)
    a = torch.clamp_min(1.0 / hist, alpha)[..., None]
    am = torch.clamp_min(1.0 / hist, moments_alpha)[..., None]

    v3 = valid[..., None]
    illum_acc = torch.where(v3, prev_illum + (illum - prev_illum) * a, illum)
    lum = luminance(illum)
    mom = torch.stack([lum, lum * lum], -1)
    mom_acc = torch.where(v3, prev_mom + (mom - prev_mom) * am, mom)

    # ---- variance: temporal moments once the history suffices, the
    # spatial estimate while it is short ----
    var_t = torch.clamp_min(mom_acc[..., 1] - mom_acc[..., 0] ** 2, 0.0)
    var_s = _spatial_moments(illum_acc, normal,
                             var_boost=torch.clamp_min(4.0 / hist, 1.0))
    var = torch.where(hist >= 4.0, var_t, var_s)

    out = illum_acc
    for p in range(n_passes):
        out, var = _atrous_var_pass(out, var, normal, albedo, 1 << p,
                                    sigma_rt=4.0, sigma_normal=sigma_normal)

    filtered = out * torch.clamp_min(albedo, 1e-3)  # re-modulate
    return filtered, SVGFState(illum=illum_acc, moments=mom_acc, history=hist)
