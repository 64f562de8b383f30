"""Surfel radiance cache.

Counterpart of `vision_tpu/caches/surfel.py`: a fixed pool of oriented disk
probes accumulating irradiance, one surfel slot per cell of a world-space
hash grid (the hash of `caches/sharc.py`). Spawning scatters G-buffer
points into empty cells; a query blends the containing cell's surfel with
a distance and orientation falloff.

One deliberate difference (ROADMAP C14): the JAX package's `spawn` writes
every lane, and a lane that is not fresh writes its slot's old state
back, so when the last lane of a cell is masked off it undoes an earlier
lane's spawn (XLA's CPU scatter keeps the highest lane). Here, of a cell's
fresh lanes the highest one writes and the others write nothing, resolved
by a scatter-max of the lane index, the same on every device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core.math import safe_div
from .sharc import _cell_hash, _quantise


@dataclass
class SurfelPool:
    pos: torch.Tensor         # [C, 3]
    normal: torch.Tensor      # [C, 3]
    radius: torch.Tensor      # [C]
    irradiance: torch.Tensor  # [C, 3]
    count: torch.Tensor       # [C]
    live: torch.Tensor        # [C] bool
    cell_size: float
    capacity: int

    @classmethod
    def create(cls, capacity=1 << 16, cell_size=0.15, device="cuda"):
        def z(*shape):
            return torch.zeros((capacity,) + shape, device=device)
        return cls(pos=z(3), normal=z(3), radius=z(), irradiance=z(3),
                   count=z(),
                   live=torch.zeros(capacity, dtype=torch.bool, device=device),
                   cell_size=cell_size, capacity=capacity)


def _slot(pool, pos):
    return _cell_hash(_quantise(pos, pool.cell_size)) % pool.capacity


def spawn(pool, pos, normal, mask):
    """Allocate surfels for covered surface points: a live cell keeps its
    surfel, an empty one takes its highest fresh lane."""
    slot = _slot(pool, pos)
    fresh = ~pool.live[slot] & mask
    lane = torch.arange(slot.shape[0], device=slot.device)
    win = torch.full((pool.capacity,), -1, dtype=torch.int64,
                     device=slot.device).scatter_reduce(
        0, slot, torch.where(fresh, lane, -1), "amax")
    got = win >= 0
    w = torch.clamp_min(win, 0)
    return replace(
        pool, pos=torch.where(got[..., None], pos[w], pool.pos),
        normal=torch.where(got[..., None], normal[w], pool.normal),
        radius=torch.where(got, pool.cell_size, pool.radius),
        live=pool.live | got)


def accumulate(pool, pos, radiance, mask):
    """Add irradiance samples into the containing live surfels."""
    slot = _slot(pool, pos)
    w = (mask & pool.live[slot]).to(torch.float32)
    return replace(
        pool, irradiance=pool.irradiance.index_add(0, slot,
                                                   radiance * w[..., None]),
        count=pool.count.index_add(0, slot, w))


def query(pool, pos, normal):
    """(irradiance [N, 3], weight) with distance and orientation
    falloff; a surfel needs at least 4 samples."""
    slot = _slot(pool, pos)
    cnt = pool.count[slot]
    mean = safe_div(pool.irradiance[slot], cnt[..., None])
    d = torch.linalg.norm(pos - pool.pos[slot], dim=-1)
    w_d = torch.clamp(
        1.0 - d / torch.clamp_min(pool.radius[slot] * 2.0, 1e-6), 0.0, 1.0)
    w_n = torch.clamp(torch.sum(normal * pool.normal[slot], -1), 0.0, 1.0)
    w = w_d * w_n * pool.live[slot] * (cnt >= 4.0)
    return mean * w[..., None], w
