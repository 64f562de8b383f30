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
  * JPEG files, written by PIL (libjpeg-turbo), and `jpeg_decodes.npz`,
    what PIL decodes from each (`Image.open(p).convert("RGB")`):
    `tiles.jpg` (128x128 terracotta tiles, 4:2:0, quality 90; the
    floor texture of `tests/torch_scenes.py` `gltf_cbox`), `strip.jpg`
    (33x65, 4:2:2, quality 50, optimized Huffman tables, a restart
    interval of 2 MCUs), `grey.jpg` (17x9 greyscale, quality 95) and
    `grain_2048.jpg` (2048x2048, 4:2:0, quality 85: smooth waves under a
    fine grain, the decoder's timing case; the .npz holds the sha256 of
    its decode and the decode of its 128x128 corner); and
    `progressive.jpg` (`strip()` saved progressive), which the port's
    decoder refuses (ROADMAP queue A, 7c).

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


def tiles():
    y, x = np.mgrid[0:128, 0:128].astype(np.float64)
    grout = ((x % 32) < 2) | ((y % 32) < 2)
    tone = 0.85 + 0.15 * np.sin(0.9 * (x // 32) + 1.7 * (y // 32))[..., None]
    base = np.array([176.0, 92.0, 60.0]) * tone
    mottle = 12.0 * np.sin(x * 0.37 + np.cos(y * 0.21) * 3.0)[..., None]
    img = np.where(grout[..., None], [200.0, 196.0, 186.0], base + mottle)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def strip():
    y, x = np.mgrid[0:65, 0:33].astype(np.float64)
    r = 128 + 120 * np.sin(x * 0.4) * np.cos(y * 0.13)
    g = 255 * y / 64.0
    b = 255 - 7.7 * x
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


def grey():
    y, x = np.mgrid[0:9, 0:17]
    return ((x * 15 + y * 28) % 256).astype(np.uint8)


def grain(n=2048):
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    waves = np.stack([np.sin(7.0 * x + 3.0 * y), np.cos(5.0 * y - 2.0 * x),
                      np.sin(11.0 * x * y + 1.0)], -1)
    noise = np.random.RandomState(1).randint(-9, 10, (n, n, 3))
    return np.clip(np.round(128 + 90 * waves + noise), 0, 255).astype(np.uint8)


JPEGS = {  # name: (image, PIL save options)
    "tiles.jpg": (tiles, dict(quality=90, subsampling=2)),
    "strip.jpg": (strip, dict(quality=50, subsampling=1, optimize=True,
                              restart_marker_blocks=2)),
    "grey.jpg": (grey, dict(quality=95)),
    "grain_2048.jpg": (grain, dict(quality=85, subsampling=2)),
}
CORNER = 128  # the decode kept of the large file: its CORNER^2 top left


def write_jpegs(out):
    """The JPEG files and their PIL decodes (`jpeg_decodes.npz`)."""
    import hashlib
    from PIL import Image
    dec = {}
    for fn, (make, opts) in JPEGS.items():
        p = os.path.join(out, fn)
        Image.fromarray(make()).save(p, **opts)
        rgb = np.asarray(Image.open(p).convert("RGB"))
        key = fn.rsplit(".", 1)[0]
        if rgb.shape[0] > CORNER:
            dec[key + ".sha256"] = np.frombuffer(
                hashlib.sha256(rgb.tobytes()).digest(), np.uint8)
            dec[key + ".shape"] = np.asarray(rgb.shape)
            rgb = rgb[:CORNER, :CORNER]
        dec[key] = rgb
    np.savez_compressed(os.path.join(out, "jpeg_decodes.npz"), **dec)
    Image.fromarray(strip()).save(os.path.join(out, "progressive.jpg"),
                                  quality=80, progressive=True)


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
    write_jpegs(out)
    for fn in sorted(os.listdir(out)):
        print(fn, os.path.getsize(os.path.join(out, fn)))


if __name__ == "__main__":
    main()
