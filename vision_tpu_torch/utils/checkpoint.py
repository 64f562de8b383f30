"""Render-state checkpoint/resume.

Counterpart of `vision_tpu/utils/checkpoint.py`, in its file format: one
compressed npz with `accum`, `frame_index` and `extra/<key>/<key>...`
arrays, and `<path>.meta.json` listing the extra keys. A checkpoint either
package writes, the other resumes. The counter RNG keys off the frame
index, so a resumed render continues the exact sample sequence.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, accum, frame_index, extra=None):
    """Save progressive render state. extra: dict of additional state
    (nested dicts and records of tensors or arrays)."""
    payload = {"accum": _host(accum), "frame_index": np.asarray(frame_index)}
    meta = {"keys": []}
    if extra:
        for k, v in _flatten("extra", extra).items():
            payload[k] = _host(v)
            meta["keys"].append(k)
    np.savez_compressed(path, **payload)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path, device="cuda"):
    """Returns (accum tensor, frame_index int, extra dict of tensors), the
    tensors on `device` (the card unless the caller asks for another)."""
    with np.load(path, allow_pickle=False) as data:
        accum = torch.as_tensor(data["accum"], device=device)
        frame_index = int(data["frame_index"])
        extra = {}
        for k in data.files:
            if k.startswith("extra/"):
                _insert(extra, k.split("/")[1:],
                        torch.as_tensor(data[k], device=device))
    return accum, frame_index, extra


def _flatten(prefix, tree):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(f"{prefix}/{k}", v))
    elif hasattr(tree, "__dict__") and not hasattr(tree, "shape"):
        for k, v in vars(tree).items():
            out.update(_flatten(f"{prefix}/{k}", v))
    else:
        out[prefix] = tree
    return out


def _insert(d, keys, value):
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def render_resumable(scene, spp, checkpoint_path, checkpoint_every=32,
                     verbose=False):
    """Progressive render, one sample per pixel a pass, on the scene's
    device: checkpoints every `checkpoint_every` samples and at the end,
    and resumes from `checkpoint_path` if it exists. Returns the
    accumulation [H, W, 3] as numpy."""
    from ..render import _render_pass
    from ..sensor import film

    accum = None
    start = 0
    if os.path.exists(checkpoint_path):
        accum, start, _ = load_checkpoint(checkpoint_path, scene.device)
        if verbose:
            print(f"resuming at spp {start}")
    for frame in range(start, spp):
        img, _ = _render_pass(scene.data, scene.camera, scene.filter, frame,
                              scene.max_depth, scene.min_depth,
                              scene.rr_threshold)
        accum = img if accum is None else film.accumulate(accum, img,
                                                          float(frame))
        if (frame + 1) % checkpoint_every == 0 or frame + 1 == spp:
            save_checkpoint(checkpoint_path, accum, frame + 1)
    return _host(accum)
