"""Profile the PyTorch port's main path on one NVIDIA GPU.

    python3 tools/profile_torch_render.py [--scene NAME] [TRACE_DIR]

Renders a scene at 512^2, depth 8 (NAME: `cbox`, tests/fixtures.py
CBOX_JSON, the default; `cbox_sphere`, `cbox_spheres_instanced`,
`cbox_glass`, `cbox_zoo`, `cbox_sky`, `cbox_glass_hero`, `fog_cbox`,
`cbox_sss`, `cbox_tex`, `env_sphere` or `lf_cbox` (a 512^2 base, grid 3),
tests/torch_scenes.py; `gltf_cbox`, its GLB written to a temporary
directory and imported; `cbox_adaptive`, the cbox through
`render(adaptive=True)`, whose 4 spp are one chunk) at 1 spp
to warm up, then at 4 spp timed plain and
once more under torch.profiler, and prints JSON lines: the device's busy
share of the traced window, device time by kernel (top 25), the device
time, launches and share of device time of K1 (dense sweep), K2 and K3
(BVH walks), and kernel launches per wavefront iteration. The Chrome trace goes to
TRACE_DIR/profile_render.json when a directory is given. Needs a CUDA
device.

`--scene cbox_rt` profiles the real-time loop instead
(`integrator/realtime.py` at its defaults: SHARC, GI at full resolution):
the cbox at 512^2 runs three frames to reach the steady state, then one
frame timed plain, one under torch.profiler (busy share, launches, top
kernels, K1's launches) and one split into its stages in the order
`render_realtime` calls them (G-buffer, ReSTIR DI, ReSTIR GI with the
cache's query, update and resolve, SVGF with the composite), each stage
under its own profiler window. `--cpu-ops RES` counts the operations each
stage dispatches on the CPU at RES^2 instead (no card needed; the count
does not depend on the resolution).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPP = 4  # 31 wavefront iterations: a short steady window, a ~50 MB trace


def _self_device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# kernel families by the name of their CUDA kernels
FAMILIES = {"k1_dense": "dense_", "k2_flat_bvh": "bvh_walk_kernel<false",
            "k3_instanced_bvh": "bvh_walk_kernel<true"}


def _load(rel):
    # by path: a site-packages `tests` package may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def staged_frame(data, camera, state, run):
    """One frame of `render_realtime` at its defaults (SHARC, GI at full
    resolution, m_light 8, spatial_taps 2, svgf_passes 3, gi_bounce_depth
    2, a static camera), its four stages each called as run(name, fn).
    Returns (image, new state) as `render_realtime` does."""
    from vision_tpu_torch.caches import sharc
    from vision_tpu_torch.integrator import realtime as rt
    from vision_tpu_torch.integrator import restir, restir_gi
    from vision_tpu_torch.lights import lights as lt
    from vision_tpu_torch.post import svgf
    from vision_tpu_torch.sensor.gbuffer import compute_gbuffer
    W, H = camera.resolution
    frame = state.frame
    cam_pos = camera.c2w[:3, 3]
    prev_di = prev_gi = None
    if state.gbuffer is not None:
        prev_di = (state.reservoir, state.gbuffer)
        prev_gi = (state.gi_reservoir, state.gbuffer)
    gb = run("gbuffer", lambda: compute_gbuffer(data, camera, frame,
                                                prev_camera=camera))
    _, L_direct, new_res = run("restir_di", lambda: restir.restir_di(
        data, gb, rt._lane_seeds(W * H, 0x9E3779B9, frame), prev=prev_di,
        frame_index=frame, m_light=8, spatial_taps=2, resolution=(W, H)))

    def gi():
        _, L_ind, new_gi, (x_s, n_s, L_path, ok) = restir_gi.restir_gi(
            data, gb, rt._lane_seeds(W * H, 0x7F4A7C15, frame), prev=prev_gi,
            resolution=(W, H), spatial_taps=2, bounce_depth=2,
            sharc=state.sharc, cam_pos=cam_pos)
        return L_ind, new_gi, sharc.resolve(sharc.update(
            state.sharc, x_s, n_s, L_path, cam_pos, ok))
    L_ind, new_gi, new_cache = run("restir_gi_with_cache", gi)

    def filt():
        env = lt.env_radiance(data.lights, data.atlas, -gb.wo)
        v3 = gb.valid[..., None]
        L_surf = torch.where(v3, L_direct + L_ind - gb.emission, 0.0)
        img, new_svgf = svgf.svgf_filter(
            L_surf.reshape(H, W, 3), gb.albedo.reshape(H, W, 3),
            gb.normal.reshape(H, W, 3), gb.depth.reshape(H, W),
            gb.motion.reshape(H, W, 2), state.svgf, n_passes=3)
        return img + torch.where(v3, gb.emission, env).reshape(H, W, 3), \
            new_svgf
    img, new_svgf = run("svgf", filt)
    return img, rt.RealTimeState(
        reservoir=new_res, gi_reservoir=new_gi, sharc=new_cache, gbuffer=gb,
        svgf=new_svgf, frame=frame + 1)


def _device_window(fn):
    """fn() under torch.profiler: (result, device ms, kernel launches,
    {kernel name: (device ms, launches)})."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_name = {e.key: (_self_device_us(e) / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0}
    return (out, sum(v[0] for v in by_name.values()),
            sum(v[1] for v in by_name.values()), by_name)


def count_cpu_ops(res):
    """Operations each stage of a steady-state frame dispatches on the
    CPU (the cbox at res^2, after three frames)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import vision_tpu_torch as vt
    from vision_tpu_torch.integrator import realtime as rt

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    desc = _load("tests/fixtures.py").CBOX_JSON
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        res, res]
    sc = vt.load_scene(desc, device="cpu")
    state = rt.RealTimeState.initial((res, res), device="cpu")
    for _ in range(3):
        _, state = rt.render_realtime(sc.data, sc.camera, state)
    ops = {}

    def run(name, fn):
        with Count() as c:
            out = fn()
        ops[name] = c.n
        return out
    staged_frame(sc.data, sc.camera, state, run)
    print(json.dumps(dict(phase="cpu_ops", scene="cbox_rt", res=res,
                          ops_by_stage=ops, ops=sum(ops.values()))))


def profile_realtime(vt, smi, trace_dir):
    """The real-time loop's steady-state frame on the cbox at 512^2."""
    from vision_tpu_torch.accel import dense_isect as di
    from vision_tpu_torch.integrator import realtime as rt
    res = 512
    sc = vt.load_scene(_load("tests/fixtures.py").CBOX_JSON, device="cuda")
    state = rt.RealTimeState.initial((res, res), device="cuda")
    for _ in range(3):  # one warm-up frame, two to fill the history
        _, state = rt.render_realtime(sc.data, sc.camera, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state = rt.render_realtime(sc.data, sc.camera, state)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    for k in di.LAUNCHES:
        di.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    (_, state), busy_ms, launches, by_name = _device_window(
        lambda: rt.render_realtime(sc.data, sc.camera, state))
    wall = time.perf_counter() - t0
    k1 = dict(di.LAUNCHES)
    stages = {}

    def run(name, fn):
        out, ms, n, _ = _device_window(fn)
        stages[name] = dict(device_ms=ms, launches=n)
        return out
    staged_frame(sc.data, sc.camera, state, run)
    print(json.dumps(dict(
        phase="profile", scene="cbox_rt", device=torch.cuda.get_device_name(0),
        power=smi, res=res, frame_s_unprofiled=wall_plain,
        frame_s_profiled=wall, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / 1e3 / wall_plain,
        kernel_launches=launches, k1_launches=k1, stages=stages)))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for key, (ms, n) in top[:25]:
        print(json.dumps(dict(kernel=key[:120], device_ms=ms, count=n,
                              share=ms / max(busy_ms, 1e-9))))
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            rt.render_realtime(sc.data, sc.camera, state)
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "profile_realtime.json"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cbox",
                    choices=["cbox", "cbox_sphere", "cbox_spheres_instanced",
                             "cbox_glass", "cbox_zoo", "cbox_sky",
                             "cbox_glass_hero", "fog_cbox", "cbox_sss",
                             "cbox_tex", "env_sphere", "lf_cbox",
                             "gltf_cbox", "cbox_adaptive", "cbox_rt"])
    ap.add_argument("--cpu-ops", type=int, metavar="RES",
                    help="cbox_rt: count each stage's operations on the CPU "
                         "at RES^2 (no card needed)")
    ap.add_argument("trace_dir", nargs="?")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.cpu_ops:
        count_cpu_ops(args.cpu_ops)
        return
    if not torch.cuda.is_available():
        sys.exit("profile_torch_render.py needs a CUDA device")
    import vision_tpu_torch as vt
    if args.scene == "cbox_rt":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        profile_realtime(vt, smi, args.trace_dir)
        return
    adaptive = args.scene == "cbox_adaptive"
    if args.scene in ("cbox", "cbox_adaptive"):
        desc = _load("tests/fixtures.py").CBOX_JSON
    elif args.scene != "gltf_cbox":
        desc = getattr(_load("tests/torch_scenes.py"), args.scene)(512)
    if args.scene == "cbox_zoo":
        desc = _load("tests/torch_scenes.py").cbox_zoo(512, sub_div=40)
    if args.scene == "gltf_cbox":
        tmp = tempfile.TemporaryDirectory()
        desc, sdir = _load("tests/torch_scenes.py").gltf_cbox_scene(
            tmp.name, 512)
        scene = vt.Scene(desc, "cuda", scene_dir=sdir)
    else:
        scene = vt.load_scene(desc, device="cuda")
    vt.render(scene, spp=1, adaptive=adaptive)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vt.render(scene, spp=SPP, adaptive=adaptive)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    stats = {}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        vt.render(scene, spp=SPP, adaptive=adaptive, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # CPU-side ops (aten::*) report their kernels' device time too: keep
    # the device-side events only
    kernels = [(e.key, _self_device_us(e), e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0]
    busy_us = sum(r[1] for r in kernels)
    launches = sum(r[2] for r in kernels)
    kernels.sort(key=lambda r: -r[1])
    share = {}
    for fam, pat in FAMILIES.items():
        us = sum(r[1] for r in kernels if pat in r[0])
        n = sum(r[2] for r in kernels if pat in r[0])
        share.update({f"{fam}_share_of_device": us / max(busy_us, 1e-9),
                      f"{fam}_device_ms": us / 1e3, f"{fam}_launches": n,
                      f"{fam}_ms_per_launch": us / 1e3 / max(n, 1)})
    print(json.dumps(dict(
        phase="profile", scene=args.scene,
        device=torch.cuda.get_device_name(0),
        power=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(),
        res=scene.resolution[0], spp=SPP, wall_s_unprofiled=wall_plain,
        wall_s=wall, iters=stats["iters"],
        nrays=stats["nrays"], device_busy_s=busy_us / 1e6,
        device_busy_share=busy_us / 1e6 / wall,
        **share,
        kernel_launches=launches,
        launches_per_iter=launches / max(stats["iters"], 1))))
    for key, us, n in kernels[:25]:
        print(json.dumps(dict(kernel=key[:120], device_ms=us / 1e3, count=n,
                              share=us / max(busy_us, 1e-9))))
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir,
                                              "profile_render.json"))


if __name__ == "__main__":
    main()
