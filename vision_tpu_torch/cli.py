"""Command-line renderer of the port.

    python -m vision_tpu_torch.cli -s scene.json -o out.png [-d cuda|cpu]

Counterpart of `vision_tpu/cli.py`, with the same options: -s (scene JSON
or a .gltf / .glb file), -o (.png, or .exr for the linear HDR), --spp,
-d (`cuda`, the default, or `cpu`; nothing is probed), --denoise
(`post/denoise.py` `denoise_simple` before the tonemap), -p (`fixed`:
`render.render`; `graph`: the render graph's one sample; `realtime`:
--spp frames of the real-time loop, averaged; `bake`: a 256-wide lightmap
baked at --spp (16) samples, then its display pass), --adaptive, -q, -t
(torch's CPU threads), --clear-cache (removes the port's compiled
libraries, which are rebuilt at first use), --distributed (starts the
process group from the environment, `parallel/launch.py`, and exits
non-zero without one) and -m cli. Without -p the scene's own pipeline
type picks (`bake` -> bake, `customized` -> graph).
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser("vision-tpu-torch",
                                 description="path tracer on PyTorch + CUDA")
    ap.add_argument("-s", "--scene", required=True,
                    help="scene JSON(C), .gltf or .glb file")
    ap.add_argument("-o", "--output", default=None, help="output image path")
    ap.add_argument("--spp", type=int, default=None, help="samples per pixel")
    ap.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"],
                    help="device to render on (default: cuda)")
    ap.add_argument("--denoise", action="store_true",
                    help="apply the post denoiser before tonemap")
    ap.add_argument("-p", "--pipeline", default=None,
                    choices=["fixed", "graph", "bake", "realtime"],
                    help="render pipeline (default: the scene's choice; "
                         "bake = lightmap bake + display, realtime = --spp "
                         "frames of the ReSTIR DI/GI loop)")
    ap.add_argument("-m", "--mode", default="cli", choices=["cli"],
                    help="run mode")
    ap.add_argument("--clear-cache", action="store_true",
                    help="remove the compiled kernel and host libraries "
                         "before rendering (they are rebuilt at first use)")
    ap.add_argument("-t", "--threads", type=int, default=None,
                    help="torch's CPU thread count")
    ap.add_argument("--adaptive", action="store_true",
                    help="variance-based adaptive sampling")
    ap.add_argument("--distributed", action="store_true",
                    help="start the torch.distributed process group from "
                         "the environment (torchrun; one process a card)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.clear_cache:
        from .accel import cuda_build
        shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    if args.distributed:
        from .parallel import launch
        if not launch.init_distributed(device=args.device):
            # asked for several processes: rendering alone would be wrong
            raise SystemExit("--distributed: no process group to join (set "
                             "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, "
                             "e.g. with torchrun)")

    from .render import postprocess, render
    from .scene.scene import load_scene
    from .sensor import film

    t0 = time.time()
    scene = load_scene(args.scene, args.device)
    if not args.quiet:
        print(f"scene loaded: {scene.data.tri_geom.shape[0]} tris, "
              f"{scene.data.materials.kd.shape[0]} materials, "
              f"{scene.data.lights.n_lights} lights "
              f"({time.time() - t0:.2f}s)")

    pipeline = args.pipeline or {"bake": "bake", "customized": "graph"}.get(
        scene.pipeline_type)
    if pipeline == "bake":
        from .pipelines.bake import bake_scene, render_baked
        baked = bake_scene(scene.data, lightmap_res=256, spp=args.spp or 16)
        hdr = render_baked(scene.data, scene.camera, baked)
    elif pipeline == "realtime":
        from .integrator import realtime as rt
        state = rt.RealTimeState.initial(scene.camera.resolution,
                                         device=args.device)
        acc = None
        for i in range(max(1, args.spp or 16)):
            img, state = rt.render_realtime(scene.data, scene.camera, state)
            w = 1.0 / (i + 1)
            acc = img if acc is None else acc * (1 - w) + img * w
        hdr = acc
    elif pipeline == "graph":
        from .pipelines.graph import default_graph
        g = default_graph(scene.data, scene.camera, scene.filter)
        hdr = g.execute(ctx={"frame_index": 0, "max_depth": scene.max_depth,
                             "tone_mapper": scene.tone_mapper,
                             "exposure": scene.exposure})["accum"]
    else:
        hdr = render(scene, spp=args.spp, verbose=not args.quiet,
                     adaptive=args.adaptive)
    if args.denoise:
        from .post.denoise import denoise_simple
        hdr = denoise_simple(hdr)
    out = args.output or scene.output_fn
    if out.endswith(".exr"):
        film.to_exr(hdr.cpu().numpy(), out)
    else:
        film.to_png(postprocess(scene, hdr).cpu().numpy(), out)
    if not args.quiet:
        print(f"wrote {out} ({time.time() - t0:.2f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
