"""Ray and hit records carried through the wavefront loop.

Counterpart of `vision_tpu/core/types.py`: plain dataclasses of tensors that
share a leading wavefront axis, in place of flax pytrees.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch


@dataclass
class Ray:
    origin: torch.Tensor      # [..., 3]
    direction: torch.Tensor   # [..., 3] normalized
    t_max: torch.Tensor       # [...]

    @classmethod
    def make(cls, origin, direction, t_max=None):
        if t_max is None:
            t_max = torch.full(origin.shape[:-1], 1e30, dtype=torch.float32,
                               device=origin.device)
        return cls(origin=origin, direction=direction, t_max=t_max)

    def at(self, t):
        return self.origin + t[..., None] * self.direction


@dataclass
class Hit:
    """Closest-hit record: t (t_max on a miss), prim_id (int32, -1 on a
    miss) and the winner's barycentrics (b1, b2). `inst` is the TLAS
    instance (int32, -1 on a miss), set only by the instanced traversal,
    where prim_id is an object-space triangle shared by the instances."""
    t: torch.Tensor
    prim_id: torch.Tensor
    bary: torch.Tensor
    inst: torch.Tensor = None

    @property
    def is_miss(self):
        return self.prim_id < 0

    @property
    def is_hit(self):
        return self.prim_id >= 0


def take(rec, idx):
    """The record with every tensor field gathered at lanes `idx` along its
    leading axis (the JAX package's `jax.tree.map(lambda a: a[idx], rec)`);
    fields that are not tensors pass through."""
    return replace(rec, **{f.name: getattr(rec, f.name)[idx]
                           for f in fields(rec)
                           if isinstance(getattr(rec, f.name), torch.Tensor)})
