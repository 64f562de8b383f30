"""Alias tables: O(1) discrete sampling.

Counterpart of `vision_tpu/lights/alias.py`: Vose build on the host (numpy),
two row fetches per sample. The JAX package fetches rows through a one-hot
matmul (a TPU gather workaround, `vision_tpu/core/gather.py`); plain
indexing gives the same rows.
"""
from __future__ import annotations

import numpy as np
import torch


def build_alias(weights):
    """Host build. weights [N] -> (prob [N] f32, alias [N] i32, pmf [N] f32)."""
    w = np.asarray(weights, np.float64)
    n = len(w)
    total = w.sum()
    if total <= 0:
        pmf = np.full(n, 1.0 / n)
    else:
        pmf = w / total
    scaled = pmf * n
    prob = np.ones(n)
    alias = np.arange(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        if scaled[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32), pmf.astype(np.float32)


def sample_alias(prob, alias, pmf, u, offset=0, count=None):
    """Sample from the sub-table at rows [offset, offset + count). u [...]
    in [0, 1); offset and count are ints or int tensors shaped like u.
    Returns (index_in_subtable int64, pmf_value, u_remapped)."""
    n = count if count is not None else prob.shape[0]
    x = u * n
    i = torch.clamp_min(x.long(), 0)
    # an int count clamps without a host-to-device copy
    i = torch.minimum(i, n - 1) if torch.is_tensor(n) else torch.clamp_max(i, n - 1)
    frac = x - i.float()
    gi = offset + i
    p, ali, pmf_i = prob[gi], alias[gi].long(), pmf[gi]
    take_alias = frac >= p
    idx = torch.where(take_alias, ali, i)
    pmf_out = torch.where(take_alias, pmf[offset + ali], pmf_i)
    # remap the fraction for reuse
    u_rem = torch.where(
        take_alias,
        torch.clamp((frac - p) / torch.clamp_min(1.0 - p, 1e-9), 0.0, 1.0),
        torch.clamp(frac / torch.clamp_min(p, 1e-9), 0.0, 1.0))
    return idx, pmf_out, u_rem
