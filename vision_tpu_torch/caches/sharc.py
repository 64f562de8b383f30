"""SHARC: spatial-hash radiance cache.

Counterpart of `vision_tpu/caches/sharc.py`: a fixed-size hash table of
structure-of-arrays (verification key, resolved radiance, the frame's
accumulator and sample count, a lifetime count). A sample's cell is its
position quantised at a voxel size set by its distance to the camera (the
LOD level) plus its normal's octant. Accumulation is a scatter-add,
insertion a scatter-max of the key into empty or matching slots (a
collision drops the sample); `resolve` folds the frame into an
exponential moving average.

The key arithmetic is the JAX package's uint32 PCG hash, kept in int64
tensors holding values in [0, 2^32) (`core/rng.py`'s masked arithmetic), so
slots and keys match the JAX package's bit for bit. A float sum into one
slot depends on the order of its terms, which the card does not fix.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core.math import safe_div
from ..core.rng import _pcg_hash as _hash

_M = 0xFFFFFFFF


@dataclass
class SharcCache:
    key: torch.Tensor       # [C] int64 holding a uint32 (0 = empty)
    radiance: torch.Tensor  # [C, 3] resolved cache value
    acc: torch.Tensor       # [C, 3] frame accumulator
    acc_n: torch.Tensor     # [C] frame sample count
    total_n: torch.Tensor   # [C] lifetime count
    base_voxel: float
    capacity: int

    @classmethod
    def create(cls, capacity=1 << 18, base_voxel=0.05, device="cuda"):
        def z(*shape):
            return torch.zeros((capacity,) + shape, device=device)
        return cls(key=torch.zeros(capacity, dtype=torch.int64, device=device),
                   radiance=z(3), acc=z(3), acc_n=z(), total_n=z(),
                   base_voxel=base_voxel, capacity=capacity)


def _quantise(pos, size):
    """floor(pos / size) as the JAX package's int32 -> uint32 cast (a
    negative cell wraps)."""
    return torch.floor(pos / size).to(torch.int32).to(torch.int64) & _M


def _cell_hash(q):
    return _hash(q[..., 0] ^ _hash(q[..., 1] ^ _hash(q[..., 2])))


def _cell_of(cache, pos, normal, cam_pos):
    """(slot index, verification key) of each sample: quantised position
    at its LOD level's voxel, the level and the normal's octant."""
    dist = torch.linalg.norm(pos - cam_pos, dim=-1)
    level = torch.clamp(
        torch.log2(torch.clamp_min(dist, 1e-3) + 1.0).to(torch.int32), 0, 7)
    voxel = cache.base_voxel * torch.pow(2.0, level.to(torch.float32))
    q = _quantise(pos, voxel[..., None])
    oct_ = ((normal[..., 0] > 0).long() | ((normal[..., 1] > 0).long() << 1)
            | ((normal[..., 2] > 0).long() << 2))
    h = _hash(_cell_hash(q) ^ (oct_ << 8) ^ (level.long() << 12))
    return h % cache.capacity, h | 1  # key 0 marks an empty slot


def update(cache, pos, normal, radiance, cam_pos, mask):
    """Accumulate per-vertex radiance samples into the frame accumulator.
    mask: valid lanes. A slot held by another key drops the sample."""
    slot, key = _cell_of(cache, pos, normal, cam_pos)
    cur = cache.key[slot]
    claimable = (cur == 0) | (cur == key)
    w = (mask & claimable).to(torch.float32)
    new_key = cache.key.scatter_reduce(
        0, slot, torch.where(claimable & mask, key, 0), "amax")
    acc = cache.acc.index_add(0, slot, radiance * w[..., None])
    acc_n = cache.acc_n.index_add(0, slot, w)
    return replace(cache, key=new_key, acc=acc, acc_n=acc_n)


def resolve(cache, ema=0.2):
    """Fold the frame accumulator into the cache: a fresh slot takes the
    frame's mean, a known one moves toward it by `ema`."""
    frame_mean = safe_div(cache.acc, cache.acc_n[..., None])
    has_new = cache.acc_n > 0
    a = torch.where(cache.total_n == 0, 1.0, ema)[..., None]
    rad = torch.where(has_new[..., None],
                      cache.radiance + (frame_mean - cache.radiance) * a,
                      cache.radiance)
    return replace(cache, radiance=rad, total_n=cache.total_n + cache.acc_n,
                   acc=torch.zeros_like(cache.acc),
                   acc_n=torch.zeros_like(cache.acc_n))


def query(cache, pos, normal, cam_pos):
    """(radiance [N, 3], hit mask): a hit needs the sample's key in its
    slot and at least 4 samples there."""
    slot, key = _cell_of(cache, pos, normal, cam_pos)
    ok = (cache.key[slot] == key) & (cache.total_n[slot] >= 4.0)
    return cache.radiance[slot] * ok[..., None].to(torch.float32), ok


def compaction(cache, min_count=1.0, decay=0.9):
    """Age entries; evict the cells whose decayed count falls below
    `min_count`."""
    n = cache.total_n * decay
    dead = n < min_count
    return replace(cache, key=torch.where(dead, 0, cache.key),
                   radiance=torch.where(dead[..., None], 0.0, cache.radiance),
                   total_n=torch.where(dead, 0.0, n))
