"""Inverse rendering: differentiate the renderer with respect to scene
parameters.

Counterpart of `vision_tpu/diff/optimize.py`, on torch autograd. The
wavefront integrator is differentiable end to end; `render_with_params`
checkpoints each bounce (`pt.radiance(remat=True)`), so the backward
replays a bounce instead of keeping its activations. Discrete sampling
decisions are constants with respect to the parameters (the RNG is
detached), which gives the interior-derivative estimator; silhouette
gradients would need edge sampling, which neither package has.

What carries a gradient, as in the JAX package's CPU route: the closest
hit of the dense sweep (K1, `accel/dense_isect.py` `_Closest`), so the
camera pose reaches the hit point; the BVH walks' hits (K2 / K3) are
constants, as the JAX package's packet path makes them, and the any hit is
a boolean.

The parameter surface is the JAX package's four groups, keyed as there
(`GROUPS`; `params` is a nested dict {group: {key: tensor}}):
  materials: the material table's float columns (`float_leaves`),
  lights:    the light table's color, position and direction,
  atlas:     the texture atlas's texels (`data` [N, 3]),
  camera:    the camera-to-world pose `c2w`.

Every entry point runs on the card ("cuda") unless the caller passes
another `device`; a scene on another device than `device` raises.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..core import rng
from ..integrator import pt

GROUPS = ("materials", "lights", "atlas", "camera")
LIGHT_KEYS = ("color", "position", "direction")


def float_leaves(table):
    """Dict of the floating-point tensors of a record (the gradient
    surface): the same keys as the JAX package's `float_leaves`."""
    return {k: v for k, v in vars(table).items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}


def param_surface(scene, camera, groups=("materials",)):
    """The requested parameter groups of (SceneData, Camera), as the
    scene's own tensors."""
    out = {}
    if "materials" in groups:
        out["materials"] = float_leaves(scene.materials)
    if "lights" in groups:
        out["lights"] = {k: v for k, v in float_leaves(scene.lights).items()
                         if k in LIGHT_KEYS}
    if "atlas" in groups:
        out["atlas"] = {"data": scene.atlas.data}
    if "camera" in groups:
        out["camera"] = {"c2w": camera.c2w}
    return out


def params_from_arrays(arrays, device="cuda"):
    """The JAX package's `param_surface(...)` output as nested numpy arrays
    -> the same nested dict of float32 tensors on `device` (copies)."""
    return {g: {k: torch.tensor(v, dtype=torch.float32, device=device)
                for k, v in leaves.items()}
            for g, leaves in arrays.items()}


def apply_params(scene, camera, params):
    """(SceneData, Camera) with `params` substituted. Each record is
    rebuilt by `dataclasses.replace`, so its derived tables (packed rows)
    come from the new leaves and its lazily made ones (hero rows) are made
    anew; the light-selection tables stay as loaded, as in the JAX
    package."""
    if "materials" in params:
        scene = replace(scene, materials=replace(scene.materials,
                                                 **params["materials"]))
    if "lights" in params:
        scene = replace(scene, lights=replace(scene.lights, **params["lights"]))
    if "atlas" in params:
        scene = replace(scene, atlas=replace(scene.atlas, **params["atlas"]))
    if "camera" in params:
        camera = replace(camera, **params["camera"])
    return scene, camera


def _check_device(camera, device):
    dev = torch.device(device)
    have = camera.c2w.device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"diff: the scene is on {have}, device={device}")
    return dev


def render_with_params(scene, camera, params, frame_index, max_depth=4,
                       spp=1, *, device="cuda"):
    """Forward render with parameter groups overridden by `params`, through
    pixel centres, `spp` samples seeded (pixel, frame_index * spp + s), no
    Russian roulette, each bounce checkpointed. `params` may be a flat
    materials dict (legacy) or a nested group dict. Returns [H, W, 3]."""
    dev = _check_device(camera, device)
    if params and not any(k in GROUPS for k in params):
        params = {"materials": params}
    sc, camera = apply_params(scene, camera, params)
    W, H = camera.resolution
    n = W * H
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    p_film = torch.stack([(pix % W).to(torch.float32) + 0.5,
                          (pix // W).to(torch.float32) + 0.5], -1)
    img = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        st = rng.seed(pix, (int(frame_index) * spp + s) & 0xFFFFFFFF)
        ray = camera.generate_ray(p_film)
        L, _ = pt.radiance(sc, ray, st, max_depth=max_depth, min_depth=99,
                           remat=True)
        img = img + L
    return (img / spp).reshape(H, W, 3)


def make_loss(scene, camera, target, max_depth=4, spp=1, *, device="cuda"):
    """loss_fn(params, frame_index): the mean squared error of
    `render_with_params` against `target` [H, W, 3]."""
    _check_device(camera, device)
    if not isinstance(target, torch.Tensor):
        target = np.array(target, np.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)

    def loss_fn(params, frame_index):
        img = render_with_params(scene, camera, params, frame_index,
                                 max_depth, spp, device=device)
        d = img - target
        return torch.mean(d * d)

    return loss_fn


def _leaves(params):
    """Detached copies of the nested params that require grad."""
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in params.items()}
    return {g: _leaves(v) for g, v in params.items()}


def _flat(params):
    for v in params.values():
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from _flat(v)


def _adam(params, lr):
    # optax.adam's defaults, which are also torch's
    return torch.optim.Adam(list(_flat(params)), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _run(params, loss_fn, opt, clip, steps, verbose, fixed_frame):
    losses = []
    for i in range(steps):
        f = i if fixed_frame is None else fixed_frame
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, f)
        loss.backward()
        opt.step()
        clip(params)
        losses.append(loss.item())
        if verbose and i % 8 == 0:
            print(f"  step {i}: loss {losses[-1]:.6f}")
    return losses


def _clamp0(leaves):
    with torch.no_grad():
        for p in _flat(leaves):
            p.clamp_(min=0.0)
    return leaves


def optimize_materials(scene, camera, target, param_keys=("kd",), steps=32,
                       lr=5e-2, max_depth=3, spp=1, verbose=False,
                       fixed_frame=None, *, device="cuda"):
    """Adam-optimize selected material-table columns to match `target`;
    each step clamps them at 0. Returns (optimized params dict, losses).

    fixed_frame: render the loss with one fixed RNG frame (the target's
    frame gives a correlated, noise-cancelling estimator)."""
    all_params = float_leaves(scene.materials)
    params = _leaves({k: all_params[k] for k in param_keys})
    loss_fn = make_loss(scene, camera, target, max_depth, spp, device=device)
    losses = _run(params, loss_fn, _adam(params, lr), _clamp0, steps,
                  verbose, fixed_frame)
    return {k: v.detach() for k, v in params.items()}, losses


def _clip_physical(params):
    """Project back to physical ranges in place: reflectances, texels and
    light colour are non-negative; positions, directions and pose stay
    free."""
    for g in ("materials", "atlas"):
        if g in params:
            _clamp0(params[g])
    if "lights" in params and "color" in params["lights"]:
        _clamp0({"color": params["lights"]["color"]})
    return params


def optimize_scene(scene, camera, target, groups=("materials",), steps=32,
                   lr=5e-2, max_depth=3, spp=1, verbose=False,
                   fixed_frame=None, *, device="cuda"):
    """Adam-optimize any parameter groups (texture texels, light colour and
    position, camera pose, material columns) against `target`. Returns
    (optimized nested params dict, losses)."""
    params = _leaves(param_surface(scene, camera, groups))
    loss_fn = make_loss(scene, camera, target, max_depth, spp, device=device)
    losses = _run(params, loss_fn, _adam(params, lr), _clip_physical, steps,
                  verbose, fixed_frame)
    return {g: {k: v.detach() for k, v in leaves.items()}
            for g, leaves in params.items()}, losses
