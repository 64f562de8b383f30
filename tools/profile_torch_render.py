"""Profile the PyTorch port's main path on one NVIDIA GPU.

    python3 tools/profile_torch_render.py [--scene NAME] [TRACE_DIR]

Renders a scene at 512^2, depth 8 (NAME: `cbox`, tests/fixtures.py
CBOX_JSON, the default; `cbox_sphere`, `cbox_spheres_instanced`,
`cbox_glass`, `cbox_zoo`, `cbox_sky`, `cbox_glass_hero`, `fog_cbox`,
`cbox_sss`, `cbox_tex`, `env_sphere` or `lf_cbox` (a 512^2 base, grid 3),
tests/torch_scenes.py; `cbox_adaptive`, the cbox through
`render(adaptive=True)`, whose 4 spp are one chunk) at 1 spp
to warm up, then at 4 spp timed plain and
once more under torch.profiler, and prints JSON lines: the device's busy
share of the traced window, device time by kernel (top 25), the device
time, launches and share of device time of K1 (dense sweep), K2 and K3
(BVH walks), and kernel launches per wavefront iteration. The Chrome trace goes to
TRACE_DIR/profile_render.json when a directory is given. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cbox",
                    choices=["cbox", "cbox_sphere", "cbox_spheres_instanced",
                             "cbox_glass", "cbox_zoo", "cbox_sky",
                             "cbox_glass_hero", "fog_cbox", "cbox_sss",
                             "cbox_tex", "env_sphere", "lf_cbox",
                             "cbox_adaptive"])
    ap.add_argument("trace_dir", nargs="?")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_render.py needs a CUDA device")
    sys.path.insert(0, ROOT)
    import vision_tpu_torch as vt
    adaptive = args.scene == "cbox_adaptive"
    if args.scene in ("cbox", "cbox_adaptive"):
        desc = _load("tests/fixtures.py").CBOX_JSON
    else:
        desc = getattr(_load("tests/torch_scenes.py"), args.scene)(512)
    if args.scene == "cbox_zoo":
        desc = _load("tests/torch_scenes.py").cbox_zoo(512, sub_div=40)
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
