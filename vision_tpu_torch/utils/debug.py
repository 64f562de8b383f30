"""Debugging and observability utilities.

Counterpart of `vision_tpu/utils/debug.py`: a host scope timer, a pixel
rectangle's lane mask, a masked print of per-lane values' statistics,
a NaN / Inf / negative check of a radiance buffer, and the byte count of
a scene's tensors.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch


class ScopeTimer:
    """Host wall time of a `with` block (time.perf_counter). It does not
    wait for the device: synchronize inside the block to time device work."""

    def __init__(self, name, verbose=True):
        self.name = name
        self.verbose = verbose

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0
        if self.verbose:
            print(f"[timer] {self.name}: {self.elapsed * 1e3:.2f} ms")


def pixel_debug_mask(resolution, lo, hi, device="cuda"):
    """Boolean lane mask [W * H] of the pixel rectangle [lo, hi), on
    `device` (the card unless the caller asks for another)."""
    W, H = resolution
    pix = torch.arange(W * H, device=device)
    px = pix % W
    py = pix // W
    return (px >= lo[0]) & (px < hi[0]) & (py >= lo[1]) & (py < hi[1])


def debug_print_where(mask, fmt, *values):
    """Print, from the host, the mean, min and max of each value [N] or
    [N, C] over the lanes in `mask` [N], in the JAX package's format:
    `fmt [value i] mean=.. min=.. max=..` (nan where the mask is empty)."""
    m = mask.detach().cpu().numpy()
    for i, v in enumerate(values):
        a = v.detach().cpu().numpy()
        sel = np.where(m if a.ndim == 1 else m[..., None], a, np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # empty mask
            mean, lo, hi = np.nanmean(sel), np.nanmin(sel), np.nanmax(sel)
        print((fmt + " [value {i}] mean={m} min={lo} max={hi}").format(
            i=i, m=mean, lo=lo, hi=hi))


def validate_radiance(L, name="radiance"):
    """NaN / Inf / negative check on the host: (ok, counts)."""
    a = L.detach().cpu().numpy() if isinstance(L, torch.Tensor) else \
        np.asarray(L)
    stats = {
        "nan": int(np.isnan(a).sum()),
        "inf": int(np.isinf(a).sum()),
        "negative": int((a < 0).sum()),
    }
    ok = not any(stats.values())
    return ok, stats


def scene_memory_stats(scene_data):
    """Bytes of each tensor (or array) of a scene record, keyed by its
    dotted path through the nested records (SceneData's tables, the BVH
    records), plus "TOTAL"."""
    stats = {}

    def walk(prefix, obj):
        if hasattr(obj, "shape") and hasattr(obj, "dtype"):
            stats[prefix] = int(np.prod(obj.shape)) * obj.dtype.itemsize
        elif hasattr(obj, "__dataclass_fields__"):
            for k in obj.__dataclass_fields__:
                walk(f"{prefix}.{k}" if prefix else k, getattr(obj, k))

    walk("", scene_data)
    stats["TOTAL"] = sum(v for k, v in stats.items() if k != "TOTAL")
    return stats
