"""Denoisers.

Counterpart of `vision_tpu/post/denoise.py`: an edge-aware a-trous wavelet
filter (the SVGF spatial core) guided by auxiliary feature buffers, and a
luminance-bilateral fallback when no feature buffers exist. Plain
functions: the JAX package's `jax.jit` has no counterpart.
"""
from __future__ import annotations

import torch

from ..core.math import luminance

_ATROUS_KERNEL = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]


def _shift2d(img, dy, dx):
    return torch.roll(img, (dy, dx), (0, 1))


def atrous_pass(color, normal, albedo, step, sigma_rt=10.0, sigma_normal=128.0,
                sigma_albedo=8.0):
    """One a-trous iteration with edge-stopping weights; images
    [H, W, 3]."""
    lum_c = luminance(color)
    acc = torch.zeros_like(color)
    wsum = torch.zeros(color.shape[:2], device=color.device)
    for j in range(5):
        for i in range(5):
            dy = (j - 2) * step
            dx = (i - 2) * step
            c = _shift2d(color, dy, dx)
            n = _shift2d(normal, dy, dx)
            a = _shift2d(albedo, dy, dx)
            w_n = torch.pow(torch.clamp(torch.sum(n * normal, -1), 0.0, 1.0),
                            sigma_normal)
            w_l = torch.exp(-torch.abs(luminance(c) - lum_c) * sigma_rt)
            w_a = torch.exp(-torch.sum(torch.abs(a - albedo), -1) * sigma_albedo)
            w = _ATROUS_KERNEL[j] * _ATROUS_KERNEL[i] * w_n * w_l * w_a
            acc = acc + c * w[..., None]
            wsum = wsum + w
    return acc / torch.clamp_min(wsum, 1e-8)[..., None]


def denoise_aov(color, normal, albedo, n_passes=3):
    """SVGF-style spatial filtering guided by first-bounce normal and
    albedo."""
    out = color
    for p in range(n_passes):
        out = atrous_pass(out, normal, albedo, 1 << p)
    return out


def denoise_simple(color, n_passes=2, sigma=8.0):
    """Feature-free bilateral fallback: the colour guides itself."""
    normal = torch.zeros_like(color)
    out = color
    for p in range(n_passes):
        out = atrous_pass(out, normal, color, 1 << p, sigma_rt=sigma,
                          sigma_normal=0.0, sigma_albedo=2.0)
    return out
