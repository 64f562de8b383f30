"""Adaptive sampling: per-pixel convergence inspection.

Counterpart of `vision_tpu/integrator/adaptive.py`: each pixel's mean and
variance of luminance, kept by Welford updates over chunk means; a pixel
whose relative standard error falls below the threshold is converged and
takes no more samples (`render.render_adaptive` gives it a budget of 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.math import luminance, safe_div


@dataclass
class InspectorState:
    mean: torch.Tensor    # [N] running mean luminance
    m2: torch.Tensor      # [N] running sum of squared deviations
    count: torch.Tensor   # [N]

    @classmethod
    def initial(cls, n, device="cuda"):
        z = torch.zeros((n,), dtype=torch.float32, device=device)
        return cls(mean=z, m2=z, count=z)


def update(state, sample_rgb):
    """Welford update with this frame's per-pixel luminance."""
    x = luminance(sample_rgb)
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return InspectorState(mean=mean, m2=m2, count=count)


def update_where(state, sample_rgb, took):
    """Welford update only where `took` (a pixel that took no sample keeps
    its statistics). `sample_rgb` is [N, 3] colour or [N] luminance."""
    x = luminance(sample_rgb) if sample_rgb.dim() > 1 else sample_rgb
    count = torch.where(took, state.count + 1.0, state.count)
    delta = x - state.mean
    mean = torch.where(took, state.mean + safe_div(delta, count), state.mean)
    m2 = torch.where(took, state.m2 + delta * (x - mean), state.m2)
    return InspectorState(mean=mean, m2=m2, count=count)


def is_converged(state, threshold=0.05, min_samples=16.0):
    """Relative standard error below `threshold` after `min_samples`."""
    var = safe_div(state.m2, torch.clamp_min(state.count - 1.0, 1.0))
    se = torch.sqrt(torch.clamp_min(var, 0.0)
                    / torch.clamp_min(state.count, 1.0))
    rel = safe_div(se, torch.clamp_min(state.mean, 1e-3))
    return (state.count >= min_samples) & (rel < threshold)


def active_fraction(state, threshold=0.05, min_samples=16.0):
    return 1.0 - torch.mean(is_converged(state, threshold, min_samples)
                            .to(torch.float32))
