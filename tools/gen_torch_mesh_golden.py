"""Make the HDR golden of one of the port's scenes with the JAX package on
the CPU: the reference `chip_smoke.py` holds the port's render of that
scene against.

    JAX_PLATFORMS=cpu python tools/gen_torch_mesh_golden.py [scene] [out.npz]

`scene` is one of SCENES (default `cbox_sphere`), built by
`tests/torch_scenes.py`; the golden goes to
`tests/goldens/<scene>_hdr.npz` unless `out.npz` is given. Each scene
renders at 128x128, depth 8, in two halves of SPP/2 samples (frames 0 to
SPP/2 - 1 and SPP/2 to SPP - 1, the regeneration wavefront in chunks of
8); the golden is their mean.

  * `cbox_sphere`: the cornell box plus a 261,120-triangle sphere on the
    short box (261,156 triangles, the port's K2 path), 128 spp.
  * `cbox_glass`: `make_glass_cbox` (glass and mirror boxes, 36
    triangles, K1), 1024 spp.
  * `cbox_zoo`: `cbox_sphere(sub_div=40)` geometry (6,276 triangles, K2)
    with every material family and the point, spot and projector lights,
    128 spp.
  * `cbox_glass_hero`: `cbox_glass` under the hero spectrum of dimension 4
    (dispersive BK7), 4096 spp.
  * `fog_cbox`: the cbox in a global homogeneous fog (sigma_s 0.3,
    sigma_a 0.01, g 0), srgb, 4096 spp.
  * `cbox_tex`: the cbox with a baked image node, a uv-mapped texture, a
    normal map, a fresnel-driven colour, an IES spot and a textured
    emitter, read from `tests/assets_torch/` (36 triangles, K1), 4096 spp.

Before a BVH scene renders, the script checks the JAX trace it relies on:
on the CPU the JAX package traces such a scene with `intersect_bvh`, whose
loop stops after 10,000 lock-step iterations without a word (ROADMAP
fault C7). So the primary wavefront and one cosine bounce from its hits
(seeded) are traced by `trace_closest` and by `intersect_brute` over all
triangles, and the lanes where they disagree beyond an exact-t tie are
counted.

The gate `chip_smoke.py` applies (8x8-block weighted error < 0.06, |bias|
< 0.025, the thresholds of tests/test_golden.py) must be at least three
times the error between the two halves; the script fails otherwise.

Measured on an 8-core CPU host, JAX on the CPU:
  * `cbox_sphere`: scene build 5.8 s, trace check 24.8 s (0 of 16,384
    primary and 0 of 16,384 bounce lanes disagree beyond a tie), 128 spp
    in 1,539 s. The two halves differ by weighted error 0.0121 and bias
    -0.0020, so the gate is 4.9x and 12.5x the half-spp error. (A first
    attempt at 64 spp gave 0.0201, a ratio of 3.0, and was not kept.)
  * `cbox_glass`: 1024 spp in 91.4 s; halves differ by weighted error
    0.0163 and bias 0.0013: the gate is 3.7x and 19.6x.
  * `cbox_zoo`: trace check 0 of 16,384 primary and 0 of 12,087 bounce
    lanes; 512 spp through the dense sweep in 1,611.6 s; halves differ by
    0.0165 and 0.0008: the gate is 3.6x and 29.9x. (A first attempt, 128
    spp through the CPU BVH walk in 1,798.3 s, gave 0.0319, a ratio of
    1.9, and was not kept.)
  * `cbox_glass_hero`: 4096 spp in 1,098.7 s; halves differ by 0.0125 and
    0.0006: the gate is 4.8x and 40.2x. (1024 spp, 246.6 s, gave 0.0271,
    a ratio of 2.2, and was not kept: the hero estimator is noisier.)
  * `fog_cbox`: 4096 spp in 274.7 s; halves differ by 0.0151 and 0.0028:
    the gate is 4.0x and 9.0x. (1024 spp, 61.5 s, gave 0.0276, a ratio of
    2.2, and was not kept.)
  * `cbox_tex`: 4096 spp in 380.2 s; halves differ by 0.0032 and -0.0002:
    the gate is 18.7x and 116.3x.
"""
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

RES = 128
SCENES = {"cbox_sphere": 128, "cbox_glass": 1024, "cbox_zoo": 512,
          "cbox_glass_hero": 4096, "fog_cbox": 4096, "cbox_tex": 4096}
# scenes the JAX package traces with its dense sweep over every triangle
# (`intersect_brute`) instead of its CPU BVH walk: the same hits (the
# trace check below compares the two), 4.5x faster on the CPU at 6,276
# triangles
DENSE = {"cbox_zoo"}
CHUNK = 8
SEED = 0
GOLD_WERR = 0.06
GOLD_BIAS = 0.025


def block_err(a, b, B=8):
    H, W, _ = a.shape
    ab = a.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    bb = b.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    return float(np.abs(ab - bb).sum() / bb.sum()), \
        float((ab - bb).mean() / bb.mean())


def trace_check(sc):
    """Lanes where the CPU trace (`trace_closest`) and the dense sweep
    (`intersect_brute`) disagree beyond an exact-t tie, on the primary
    wavefront and one seeded cosine bounce."""
    import jax.numpy as jnp
    from vision_tpu.accel import intersect as isect
    from vision_tpu.core.types import Ray
    from vision_tpu.integrator import pt

    d = sc.data
    R = RES * RES
    pix = np.arange(R)
    p = np.stack([pix % RES + 0.5, pix // RES + 0.5], -1).astype(np.float32)
    ray = sc.camera.generate_ray(jnp.asarray(p), jnp.zeros((R, 2)))
    out = {}
    g = np.random.default_rng(SEED)
    for name in ("primary", "bounce"):
        h1 = pt.trace_closest(d, ray)
        h2 = isect.intersect_brute(ray, d.tri_p0, d.tri_e1, d.tri_e2)
        i1, i2 = np.asarray(h1.prim_id), np.asarray(h2.prim_id)
        t1, t2 = np.asarray(h1.t), np.asarray(h2.t)
        tie = np.abs(t1 - t2) <= 1e-6 * np.abs(t2)
        out[name] = int(((i1 != i2) & ~tie).sum())
        out[name + "_hits"] = int((i2 >= 0).sum())
        if name == "bounce":
            break
        pos, ng, _, _, _, _, _ = pt.compute_interaction(d, ray, h2)
        ng = np.asarray(ng)
        ng = np.where((np.sum(ng * np.asarray(ray.direction), -1) > 0)[:, None],
                      -ng, ng)
        u = g.random((R, 2))
        r, phi = np.sqrt(u[:, 0]), 2 * np.pi * u[:, 1]
        a = np.where(np.abs(ng[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
        t = np.cross(a, ng)
        t /= np.linalg.norm(t, axis=-1, keepdims=True)
        b = np.cross(ng, t)
        w = (t * (r * np.cos(phi))[:, None] + b * (r * np.sin(phi))[:, None]
             + ng * np.sqrt(1.0 - u[:, :1]))
        w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
        o = pt.spawn_origin(pos, jnp.asarray(ng), jnp.asarray(w), 1.0)
        keep = i2 >= 0   # bounce only from lanes that hit
        ray = Ray.make(o[keep], jnp.asarray(w[keep]))
    return out


def main():
    import jax.numpy as jnp
    import tests.torch_scenes as scenes
    from vision_tpu.render import _wave_pass
    from vision_tpu.scene.scene import Scene

    name = sys.argv[1] if len(sys.argv) > 1 else "cbox_sphere"
    spp = SCENES[name]
    out_path = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ROOT, "tests", "goldens", f"{name}_hdr.npz")
    t0 = time.time()
    sc = Scene(getattr(scenes, name)(RES))
    check = {"primary": 0, "bounce": 0}
    if sc.data.pbvh is not None:
        t1 = time.time()
        check = trace_check(sc)
        print(f"trace check ({time.time() - t1:.1f} s): {check}", flush=True)
        if check["primary"] or check["bounce"]:
            raise SystemExit("the CPU trace disagrees with intersect_brute")
    if name in DENSE:
        import vision_tpu.scene.scene as jscene
        limit = jscene.BRUTE_FORCE_MAX_TRIS
        jscene.BRUTE_FORCE_MAX_TRIS = 1 << 30
        try:
            sc = Scene(getattr(scenes, name)(RES))
        finally:
            jscene.BRUTE_FORCE_MAX_TRIS = limit
        assert sc.data.pbvh is None
    print(f"{name}: {sc.data.tri_p0.shape[0]} triangles, scene "
          f"{time.time() - t0:.1f} s", flush=True)

    halves = []
    t0 = time.time()
    for h in range(2):
        acc = np.zeros((RES, RES, 3), np.float64)
        for f0 in range(h * spp // 2, (h + 1) * spp // 2, CHUNK):
            img, _ = _wave_pass(sc.data, sc.camera, sc.filter, jnp.uint32(f0),
                                CHUNK, sc.max_depth, sc.min_depth,
                                jnp.float32(sc.rr_threshold))
            acc += np.asarray(img, np.float64)
            print(f"  frames {f0}-{f0 + CHUNK - 1}: {time.time() - t0:.1f} s",
                  flush=True)
        halves.append(acc / (spp // 2 // CHUNK))
    seconds = time.time() - t0
    werr, bias = block_err(halves[0], halves[1])
    img = (0.5 * (halves[0] + halves[1])).astype(np.float32)
    print(f"render: {seconds:.1f} s, halves werr {werr:.4f} bias {bias:.4f}; "
          f"gate/half ratios {GOLD_WERR / werr:.1f} {GOLD_BIAS / max(abs(bias), 1e-9):.1f}",
          flush=True)
    if GOLD_WERR < 3 * werr or GOLD_BIAS < 3 * abs(bias):
        raise SystemExit("the gate is not three times the half-spp error")
    np.savez_compressed(out_path, img=img, res=RES, spp=spp,
                        depth=sc.max_depth, seconds=seconds,
                        half_werr=werr, half_bias=bias,
                        trace_check=np.asarray([check["primary"],
                                                check["bounce"]]))
    print(f"wrote {out_path}: mean {img.mean():.5f}", flush=True)


if __name__ == "__main__":
    main()
