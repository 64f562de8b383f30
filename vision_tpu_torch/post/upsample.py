"""Joint-bilateral upsampling.

Counterpart of `vision_tpu/post/upsample.py`: upscale a low-resolution
radiance buffer to full resolution guided by the full-resolution G-buffer
(normal and depth edge-stopping weights). The real-time loop uses it when
GI runs on a reduced lattice (`gi_scale < 1`).
"""
from __future__ import annotations

import torch


def bilateral_upsample(low, normal_hi, depth_hi, sigma_n=32.0, sigma_d=0.1):
    """low [h, w, 3] -> [H, W, 3] where (H, W) = normal_hi.shape[:2]:
    4-tap joint-bilinear with guidance weights, the low-res guides being a
    nearest downsample of the high-res ones."""
    H, W = normal_hi.shape[:2]
    h, w = low.shape[:2]
    dev = low.device
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    fx = (xx + 0.5) / W * w - 0.5
    fy = (yy + 0.5) / H * h - 0.5
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, w - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, h - 1)
    dx = fx - x0
    dy = fy - y0

    def down_idx(xi, yi):
        gx = torch.clamp(((xi.to(torch.float32) + 0.5) / w * W).to(torch.int32),
                         0, W - 1)
        gy = torch.clamp(((yi.to(torch.float32) + 0.5) / h * H).to(torch.int32),
                         0, H - 1)
        return gx.long(), gy.long()

    acc = torch.zeros((H, W, 3), device=dev)
    wsum = torch.zeros((H, W), device=dev)
    for oy in (0, 1):
        for ox in (0, 1):
            xi = torch.clamp(x0 + ox, 0, w - 1)
            yi = torch.clamp(y0 + oy, 0, h - 1)
            wb = (dx if ox else (1 - dx)) * (dy if oy else (1 - dy))
            gx, gy = down_idx(xi, yi)
            w_n = torch.pow(torch.clamp(
                torch.sum(normal_hi[gy, gx] * normal_hi, -1), 0.0, 1.0), sigma_n)
            w_d = torch.exp(-torch.abs(depth_hi[gy, gx] - depth_hi)
                            / torch.clamp_min(depth_hi * sigma_d, 1e-4))
            wgt = wb * w_n * w_d + 1e-6
            acc = acc + low[yi.long(), xi.long()] * wgt[..., None]
            wsum = wsum + wgt
    return acc / wsum[..., None]
