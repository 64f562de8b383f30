"""Write the image and IES files of the port's textured test scenes into
`tests/assets_torch/`, with PIL and OpenCV (the port reads them with its
own decoders, `vision_tpu_torch/scene/imageio.py`, and needs neither).

    python tools/gen_torch_assets.py [out_dir]

  * `checker.png`: 64x64 RGB, 8x8 squares of a warm white and a blue.
  * `bumps.png`: 64x64 RGB tangent-space normal map of a 4x4 grid of
    domes, n * 0.5 + 0.5.
  * `projector.png`: 128x64 RGBA, three colour bands under a diagonal
    stripe pattern, alpha falling from left to right (the loader drops it).
  * `sky_a.hdr`, `sky_b.hdr`: 64x32 lat-long skies (a blue sky with a sun
    and a dark ground; a warm dusk gradient), Radiance RGBE with run-length
    scanlines as OpenCV writes them.
  * `spot.ies`: an LM-63-2002 profile with TILT=NONE, one horizontal angle
    and a soft cone of 10 vertical angles from 0 to 90 degrees (the narrow
    profile of tests/test_lights.py widened and smoothed).

The output is deterministic: running it again writes the same bytes.
"""
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")

IES = """IESNA:LM-63-2002
[TEST] port scene spot
[MANUFAC] generated by tools/gen_torch_assets.py
TILT=NONE
1 1000 1 10 1 1 2 0 0 0
1 1 0
0 10 20 30 40 50 60 70 80 90
0
1000 980 900 750 520 300 140 50 10 0
"""


def checker():
    y, x = np.mgrid[0:64, 0:64]
    on = ((x // 8 + y // 8) % 2).astype(bool)
    img = np.where(on[..., None], [235, 225, 205], [40, 70, 160])
    return img.astype(np.uint8)


def bumps():
    y, x = np.mgrid[0:64, 0:64].astype(np.float64)
    cx, cy = (x % 16) - 7.5, (y % 16) - 7.5
    r2 = (cx * cx + cy * cy) / 49.0
    dome = np.where(r2 < 1.0, np.sqrt(np.clip(1.0 - r2, 0.0, 1.0)), 0.0)
    gy, gx = np.gradient(dome * 3.0)
    n = np.stack([-gx, gy, np.ones_like(gx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.round((n * 0.5 + 0.5) * 255.0).astype(np.uint8)


def projector():
    y, x = np.mgrid[0:64, 0:128]
    bands = np.array([[230, 60, 50], [60, 200, 80], [60, 90, 230]])
    rgb = bands[np.minimum(x * 3 // 128, 2)]
    stripe = ((x + y) // 6) % 2 == 0
    rgb = np.where(stripe[..., None], rgb, rgb // 3 + 40)
    alpha = (255 - x * 2)[..., None]
    return np.concatenate([rgb, alpha], -1).astype(np.uint8)


def sky(kind):
    h, w = 32, 64
    theta = (np.arange(h) + 0.5) / h * np.pi          # 0 at the +z pole
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    t = np.cos(theta)[:, None] * np.ones((1, w))
    if kind == "a":
        up = np.clip(t, 0.0, 1.0)[..., None]
        img = (1.0 - up) * [1.1, 1.15, 1.2] + up * [0.25, 0.45, 1.0]
        img = np.where((t < 0.0)[..., None], [0.12, 0.1, 0.08], img)
        # a sun 40 degrees above the horizon at phi = 1.0
        ts, ps = np.deg2rad(50.0), 1.0
        d = (np.sin(theta)[:, None] * np.sin(ts) * np.cos(phi[None] - ps)
             + np.cos(theta)[:, None] * np.cos(ts))
        img = img + (d > np.cos(np.deg2rad(8.0)))[..., None] * [40.0, 36.0, 30.0]
    else:
        up = np.clip(t, 0.0, 1.0)[..., None]
        img = (1.0 - up) * [1.4, 0.6, 0.3] + up * [0.15, 0.12, 0.35]
        img = img * (0.8 + 0.2 * np.cos(phi))[None, :, None]
        img = np.where((t < 0.0)[..., None], [0.05, 0.04, 0.04], img)
    return img.astype(np.float32)


def main():
    from PIL import Image
    import cv2
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)
    Image.fromarray(checker(), "RGB").save(os.path.join(out, "checker.png"))
    Image.fromarray(bumps(), "RGB").save(os.path.join(out, "bumps.png"))
    Image.fromarray(projector(), "RGBA").save(
        os.path.join(out, "projector.png"))
    for k in ("a", "b"):
        cv2.imwrite(os.path.join(out, f"sky_{k}.hdr"), sky(k)[..., ::-1])
    with open(os.path.join(out, "spot.ies"), "w") as f:
        f.write(IES)
    for fn in sorted(os.listdir(out)):
        print(fn, os.path.getsize(os.path.join(out, fn)))


if __name__ == "__main__":
    main()
