"""Make the golden of the glTF cbox with the JAX package on the CPU: the
reference `chip_smoke.py` holds the port's render of the imported scene
against.

    JAX_PLATFORMS=cpu python tools/gen_torch_gltf_golden.py [out.npz]

Writes `tests/torch_scenes.py` `gltf_cbox` (a GLB with the cbox's walls
and boxes as pbrMetallicRoughness materials, the floor textured with
`tests/assets_torch/tiles.jpg`, a gold sphere of sub_div 16, the ceiling
emitter as emissiveFactor, a KHR_lights_punctual point light and the
cbox camera; 996 triangles) into a temporary directory, imports it with
the JAX package (`vision_tpu.scene.gltf.load_gltf_scene`, which reads the
JPEG through PIL), sets 128x128 and depth 8, and renders it in two halves
of SPP / 2 samples through the JAX package's dense sweep, as
`tools/gen_torch_mesh_golden.py` renders its scenes. Writes
`tests/goldens/gltf_cbox_hdr.npz` (or `out.npz`): the image, the settings,
the seconds taken and the error between the halves; fails unless the
gate `chip_smoke.py` applies (8x8-block weighted error < 0.06, |bias| <
0.025) is at least three times that error.
"""
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from gen_torch_mesh_golden import (CHUNK, GOLD_BIAS, GOLD_WERR,  # noqa: E402
                                   block_err)

RES = 128
SPP = 4096


def main():
    import jax.numpy as jnp
    import tests.torch_scenes as scenes
    from vision_tpu.render import _wave_pass
    from vision_tpu.scene.gltf import load_gltf_scene
    from vision_tpu.scene.scene import Scene

    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "goldens", "gltf_cbox_hdr.npz")
    with tempfile.TemporaryDirectory() as d:
        desc = load_gltf_scene(scenes.gltf_cbox(d))
        desc["camera"]["param"]["radiance_collector"]["param"][
            "resolution"] = [RES, RES]
        desc["integrator"] = {"type": "pt", "param": {"max_depth": 8}}
        sc = Scene(desc, scene_dir=d)
    assert sc.data.pbvh is None and sc.max_depth == 8
    print(f"gltf_cbox: {sc.data.tri_p0.shape[0]} triangles", flush=True)

    halves = []
    t0 = time.time()
    for h in range(2):
        acc = np.zeros((RES, RES, 3), np.float64)
        for f0 in range(h * SPP // 2, (h + 1) * SPP // 2, CHUNK):
            img, _ = _wave_pass(sc.data, sc.camera, sc.filter, jnp.uint32(f0),
                                CHUNK, sc.max_depth, sc.min_depth,
                                jnp.float32(sc.rr_threshold))
            acc += np.asarray(img, np.float64)
            if f0 % 256 == 0:
                print(f"  frames {f0}-{f0 + CHUNK - 1}: "
                      f"{time.time() - t0:.1f} s", flush=True)
        halves.append(acc / (SPP // 2 // CHUNK))
    seconds = time.time() - t0
    werr, bias = block_err(halves[0], halves[1])
    img = (0.5 * (halves[0] + halves[1])).astype(np.float32)
    print(f"render: {seconds:.1f} s, halves werr {werr:.4f} bias {bias:.4f}; "
          f"gate/half ratios {GOLD_WERR / werr:.1f} "
          f"{GOLD_BIAS / max(abs(bias), 1e-9):.1f}", flush=True)
    if GOLD_WERR < 3 * werr or GOLD_BIAS < 3 * abs(bias):
        raise SystemExit("the gate is not three times the half-spp error")
    np.savez_compressed(out_path, img=img, res=RES, spp=SPP, depth=8,
                        seconds=seconds, half_werr=werr, half_bias=bias)
    print(f"wrote {out_path}: mean {img.mean():.5f}", flush=True)


if __name__ == "__main__":
    main()
