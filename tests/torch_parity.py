"""Shared helpers of the parity tests between `vision_tpu` (JAX, the
reference) and `vision_tpu_torch` (the PyTorch port): data passes between
the two packages as numpy arrays."""
import copy
import dataclasses

import numpy as np
import torch

from tests.fixtures import CBOX_JSON


def cbox(res, **changes):
    """A copy of CBOX_JSON at res x res."""
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [res, res]
    s.update(changes)
    return s


def _record_arrays(obj, prefix):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or dataclasses.is_dataclass(v):
            continue
        out[prefix + f.name] = np.asarray(v)
    return out


def jax_scene_arrays(scene):
    """The JAX scene state, every field as np.asarray, keyed as
    `vision_tpu_torch.scene.scene.scene_from_arrays` reads it."""
    d = scene.data
    arrays = _record_arrays(d, "")
    for name in ("materials", "lights", "atlas", "spectrum", "pbvh", "ipbvh"):
        if getattr(d, name) is not None:
            arrays.update(_record_arrays(getattr(d, name), name + "."))
    arrays.update(_record_arrays(scene.camera, "camera."))
    arrays.update(_record_arrays(scene.filter, "filter."))
    return arrays


def tt(a, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def np_(x):
    """torch tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def block_err(a, b, B=8):
    """8x8 block-averaged weighted error and relative bias of image a
    against b (the measure of tests/test_golden.py
    test_cbox_hdr_self_golden)."""
    H, W, _ = a.shape
    ab = a.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    bb = b.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    return np.abs(ab - bb).sum() / bb.sum(), (ab - bb).mean() / bb.mean()


def mostly_close(y, x, rtol, atol, loose, share=0.01):
    """y within (rtol, atol) of x on all but `share` of the rows (leading
    axis), and every element within `loose` (relative and absolute): for
    outputs where float32 rounding in another op order meets an
    ill-conditioned step (a square root or arccos near 0 / 1, a peaked
    lobe) on a few lanes."""
    x, y = np.asarray(x), np_(y)
    off = ~np.isclose(y, x, rtol=rtol, atol=atol)
    off = off.reshape(off.shape[0], -1).any(-1)
    assert off.mean() <= share, off.sum()
    np.testing.assert_allclose(y, x, rtol=loose, atol=loose)
