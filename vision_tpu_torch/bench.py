"""Benchmark ladder of the port on one NVIDIA GPU: the counterpart of the
JAX package's `bench.py`, with its schema, rungs, sizes and protocol.

    python -m vision_tpu_torch.bench [--device cuda]

Run from the root of a checkout: the headline and gradient rungs load the
cornell box of `tests/fixtures.py` by path. Prints ONE JSON line.
`metric` / `value` / `unit` / `vs_baseline` track the headline number
(cbox 512^2 d8 path-tracing throughput, relative to this package's first
measurement on an H100); `extra` carries the other rungs:

  - staircase_512_d4_mrays: 262k-tri mesh through the BVH walk (K2)
  - staircase_sol_mrays:    speed-of-light bound for that rung: the bare
    closest-hit walk (K2 alone) on tile-coherent primary rays
  - prism_hero_256_mrays:   hero-wavelength dispersion scene
  - cbox_256_d4_grad_mrays: forward+backward (inverse-rendering grad step);
    rays counted are forward-traced rays, time includes the backward sweep
  - staircase_grad_mrays:   the same fwd+bwd metric on a BVH scene
  - kitchen_1M_mrays:       million-triangle scene
  - classroom_rt_ms:        one real-time frame (ReSTIR DI+GI + SHARC +
    SVGF) on classroom 512^2

The rungs that read a scene of the reference tree (`REF`: the checkout's
`reference/res/render_scene`, or $VT_BENCH_SCENES) are left out of the
line while their file is absent. Each of them takes `path=` to run its
code on another scene file. Rays counted are actual traced rays (closest +
shadow, active lanes only) from the integrator's counter, summed on the
device in int64 and read once at the end of a rung.
"""
from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cbox rung's value from this package's first H100 run (NVIDIA H100
# 80GB HBM3, 700.00 W); vs_baseline is relative to it
BASELINE_MRAYS = 27.85

RES = 512
DEPTH = 8
WARMUP = 2
ITERS = 16
REF = os.environ.get("VT_BENCH_SCENES",
                     os.path.join(_ROOT, "reference", "res", "render_scene"))
GRAD_RES = 256   # bench_grad, bench_staircase_grad
PRISM_RES = 256
TILE = 32        # _tile_order's tile edge


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cbox_json():
    """`tests/fixtures.py` CBOX_JSON, loaded by path (a `tests` package
    elsewhere on sys.path must not shadow the checkout's)."""
    spec = importlib.util.spec_from_file_location(
        "vt_bench_fixtures", os.path.join(_ROOT, "tests", "fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return copy.deepcopy(mod.CBOX_JSON)


def _cbox(res, device):
    from .scene.scene import Scene
    s = _cbox_json()
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [res, res]
    return Scene(s, device)


def _load(path, res, device):
    """The scene file at `path`, its camera at res x res (None: as the
    file says); None when the file is absent."""
    from .scene import desc
    from .scene.scene import Scene
    if not os.path.exists(path):
        return None
    raw = desc.load_jsonc(path)
    if res is not None:
        raw["camera"]["param"]["radiance_collector"]["param"][
            "resolution"] = [res, res]
    return Scene(raw, device, scene_dir=os.path.dirname(os.path.abspath(path)))


def _tile_order(W, H, tile=TILE):
    """lane -> pixel permutation grouping pixels into tile x tile squares
    (row-major within a tile, tiles row-major): the JAX package's
    `integrator/pt.py` `_tile_order`, kept here for the speed-of-light
    rung's coherent primaries."""
    pix = np.arange(W * H, dtype=np.int64)
    x = pix % W
    y = pix // W
    k = (((y // tile) * ((W + tile - 1) // tile) + x // tile)
         * (tile * tile) + (y % tile) * tile + (x % tile))
    return np.argsort(k, kind="stable").astype(np.uint32)


def _wave_metric(sc, spp, depth, warmup, iters, frame_stride=None,
                 stats=None):
    """Mrays/s of `iters` timed `render_wave` passes after `warmup`
    untimed ones (frames 0.. for the warm-ups, 100 + i * stride for the
    timed passes). `stats`, when given, receives the traced rays and the
    seconds."""
    from .integrator import pt
    dev = sc.camera.c2w.device
    stride = frame_stride if frame_stride is not None else spp
    for i in range(warmup):
        pt.render_wave(sc.data, sc.camera, sc.filter, i, spp=spp,
                       max_depth=depth)
    _sync(dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(iters):
        _, aovs = pt.render_wave(sc.data, sc.camera, sc.filter,
                                 100 + i * stride, spp=spp, max_depth=depth)
        nrays += aovs["nrays"]
    _sync(dev)
    dt = time.perf_counter() - t0
    n = int(nrays)
    if stats is not None:
        stats.update(nrays=n, seconds=dt)
    return n / dt / 1e6


def bench_cbox(device="cuda"):
    sc = _cbox(RES, device)
    return _wave_metric(sc, spp=16, depth=DEPTH, warmup=WARMUP, iters=ITERS)


def bench_staircase(path=None, device="cuda"):
    sc = _load(path or os.path.join(REF, "staircase/vision_scene.json"), RES,
               device)
    if sc is None or sc.data.pbvh is None:
        return None
    return _wave_metric(sc, spp=2, depth=4, warmup=1, iters=2)


def bench_prism(path=None, device="cuda"):
    sc = _load(path or os.path.join(REF, "cbox/cbox-prism.json"), PRISM_RES,
               device)
    if sc is None:
        return None
    return _wave_metric(sc, spp=16, depth=6, warmup=1, iters=4)


def grad_step(sc, depth):
    """bench.py's gradient step on `sc`: one fixed pixel-centre ray a
    pixel, `rng.seed(pix, frame)`, `pt.radiance(max_depth=depth,
    remat=True)`, the L2 loss against zeros, differentiated with respect
    to every floating tensor of the material table. Returns
    step(frame) -> (loss, {key: gradient}, traced rays as a 0-dim int64
    tensor)."""
    from .core import rng
    from .diff.optimize import float_leaves
    from .integrator import pt
    data, cam = sc.data, sc.camera
    dev = cam.c2w.device
    W, H = cam.resolution
    R = W * H
    pix = torch.arange(R, dtype=torch.int64, device=dev)
    p_film = torch.stack([(pix % W).to(torch.float32) + 0.5,
                          (pix // W).to(torch.float32) + 0.5], -1)
    ray = cam.generate_ray(p_film, torch.zeros((R, 2), device=dev))
    target = torch.zeros((R, 3), device=dev)
    mf = {k: v.detach().clone().requires_grad_(True)
          for k, v in float_leaves(data.materials).items()}

    def step(frame):
        scene = replace(data, materials=replace(data.materials, **mf))
        st = rng.seed(pix, frame)
        L, aovs = pt.radiance(scene, ray, st, max_depth=depth, remat=True)
        loss = torch.mean((L - target) ** 2)
        for v in mf.values():
            v.grad = None
        loss.backward()
        grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
                 for k, v in mf.items()}  # a column off the path: zeros
        return loss.detach(), grads, aovs["nrays"]

    return step


def _grad_metric(sc, depth, iters):
    """Forward+backward Mrays/s of `iters` timed gradient steps after one
    untimed step (frame 0; then frames 1..iters)."""
    dev = sc.camera.c2w.device
    step = grad_step(sc, depth)
    step(0)
    _sync(dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(iters):
        nrays += step(i + 1)[2]
    _sync(dev)
    return int(nrays) / (time.perf_counter() - t0) / 1e6


def bench_grad(device="cuda"):
    """Forward+backward Mrays/s: grad of an L2 image loss w.r.t. material
    floats through the checkpointed wavefront."""
    return _grad_metric(_cbox(GRAD_RES, device), depth=4, iters=6)


def bench_staircase_sol(path=None, device="cuda"):
    """Speed-of-light for the staircase rung: the bare closest-hit walk
    (K2) on tile-coherent primaries (no shading, no NEE, no bounce
    incoherence)."""
    from .accel import packet_isect
    sc = _load(path or os.path.join(REF, "staircase/vision_scene.json"), None,
               device)
    if sc is None or sc.data.pbvh is None:
        return None
    dev = sc.camera.c2w.device
    R = RES * RES
    pix = torch.as_tensor(_tile_order(RES, RES).astype(np.int64), device=dev)
    p_film = torch.stack([(pix % RES).to(torch.float32) + 0.5,
                          (pix // RES).to(torch.float32) + 0.5], -1)
    ray = sc.camera.generate_ray(p_film, torch.zeros((R, 2), device=dev))
    rays = (ray.origin.contiguous(), ray.direction.contiguous(),
            ray.t_max.contiguous())

    def f():
        return packet_isect.closest(*rays, sc.data.pbvh)[0]

    f()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(4):
        f()
    _sync(dev)
    return R * 4 / (time.perf_counter() - t0) / 1e6


def bench_staircase_grad(path=None, device="cuda"):
    """Forward+backward on a BVH scene: grad of an L2 loss w.r.t. material
    floats through the checkpointed wavefront on staircase 256^2 depth 2."""
    sc = _load(path or os.path.join(REF, "staircase/vision_scene.json"),
               GRAD_RES, device)
    if sc is None or sc.data.pbvh is None:
        return None
    return _grad_metric(sc, depth=2, iters=2)


def bench_kitchen(path=None, device="cuda"):
    """Million-triangle scene (kitchen, 1.05M tris): full PT through the
    BVH walk."""
    sc = _load(path or os.path.join(REF, "kitchen/vision_scene.json"), RES,
               device)
    if sc is None or sc.data.pbvh is None:
        return None
    return _wave_metric(sc, spp=1, depth=3, warmup=1, iters=2)


def bench_classroom_rt(path=None, device="cuda"):
    """Real-time integrator frame time (ms) on classroom 512^2: ReSTIR DI +
    GI + SHARC + SVGF, four frames after three."""
    from .integrator import realtime as rt
    sc = _load(path or os.path.join(REF, "classroom/vision_scene.json"), RES,
               device)
    if sc is None:
        return None
    dev = sc.camera.c2w.device
    state = rt.RealTimeState.initial((RES, RES), device=dev)
    img, state = rt.render_realtime(sc.data, sc.camera, state)
    _sync(dev)
    # steady state (temporal reuse warm)
    for _ in range(2):
        img, state = rt.render_realtime(sc.data, sc.camera, state)
    _sync(dev)
    t0 = time.perf_counter()
    n = 4
    for _ in range(n):
        img, state = rt.render_realtime(sc.data, sc.camera, state)
    _sync(dev)
    return (time.perf_counter() - t0) / n * 1e3


# extra's keys, in bench.py's order, and the function of each
RUNGS = [("staircase_512_d4_mrays", "bench_staircase"),
         ("staircase_sol_mrays", "bench_staircase_sol"),
         ("prism_hero_256_mrays", "bench_prism"),
         ("cbox_256_d4_grad_mrays", "bench_grad"),
         ("staircase_grad_mrays", "bench_staircase_grad"),
         ("kitchen_1M_mrays", "bench_kitchen"),
         ("classroom_rt_ms", "bench_classroom_rt")]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vision_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure on (default: cuda)")
    dev = ap.parse_args(argv).device
    out = {}
    mrays = bench_cbox(device=dev)
    out["metric"] = "cbox_512_d8_pt_throughput"
    out["value"] = round(mrays, 3)
    out["unit"] = "Mrays/s"
    out["vs_baseline"] = round(mrays / BASELINE_MRAYS, 3)
    extra = {}
    for name, fn in RUNGS:
        try:
            v = globals()[fn](device=dev)
            if v is not None:
                extra[name] = round(v, 3)
        except Exception as e:  # a rung must never sink the headline metric
            extra[name] = f"error: {type(e).__name__}: {e}"
    out["extra"] = extra
    print(json.dumps(out))


if __name__ == "__main__":
    main()
