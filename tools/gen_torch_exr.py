"""Write the OpenEXR test files of the port's decoder
(`vision_tpu_torch/scene/imageio.py` `read_exr`) into `tests/assets_torch/`
through libOpenEXR, with the decodes they are held against.

    python tools/gen_torch_exr.py [out_dir]

Needs g++ and libOpenEXR 3.x's headers and libraries (`libopenexr-dev`;
`$EXR_INCLUDE`, default /usr/include/OpenEXR and /usr/include/Imath). It
compiles `tools/exr_tool.cpp` into a temporary directory, writes each file
with it, and reads each back with Imf::InputFile, the class OpenCV's EXR
decoder reads through (the JAX package reads .exr files with
`cv2.imread`): `exr_decodes.npz` holds, per decodable file, that decode as
the JAX package's loader returns it (float32 [H, W, 3]: R, G, B, or Y
replicated; A dropped).

  * One file a compression and channel type: `rle_{half,float}`,
    `piz_{half,float}`, `pxr24_{half,float}`, `b44_{half,float}` (B44
    keeps FLOAT channels as they are), `b44a_half`, `dwaa_half` (R, G, B
    and an A that DWA run-length codes), `dwab_half`, `dwaa_y` (a lone Y)
    and `dwab_mixed` (HALF R, G and a FLOAT B: DWA's rules make FLOAT R,
    G, B lossy too, decoded to half and widened).
    Their pixels come from a seed: a smooth ramp, noise, a flat patch,
    and values across half's range (denormals, 0, inf, NaN) where the
    codec is lossless.
  * Layouts: `tiled_one` (ZIP, 16 x 8 tiles, partial edge tiles),
    `tiled_mipmap` (RLE, DECREASING_Y), `tiled_ripmap` (PIZ, 13 x 7 tiles
    rounded up, RANDOM_Y), `scan_decreasing` (PXR24, DECREASING_Y, a data
    window from (-3, 5)), `multipart` (part 0 a PIZ scanline part, part 1
    a ZIP part) and `multipart_tiled` (part 0 RLE tiles).
  * Files InputFile refuses (`deep_scanline`, `deep_tiled`: no npz
    entry) and files for ROADMAP 7e (`yc`: luminance-chroma, `uint`:
    UINT channels, `deep_composite`: deep scanlines with Z and A, which
    InputFile composites).
  * The twins of the scenes' skies (`tests/torch_scenes.py`
    `env_sphere_files`): `sky_a.exr` (FLOAT, PIZ, scanlines) and
    `sky_b.exr` (FLOAT, RLE, 8 x 8 tiles, MIPMAP), holding the OpenCV
    decodes of `sky_a.hdr` / `sky_b.hdr`, so they decode to the same
    arrays.
  * `piz_2048.exr`: 2048 x 1024 HALF RGB, PIZ, smooth procedural content,
    the decoder's timing case; the .npz holds the sha256 of its decode
    and its 128 x 128 corner.

The output is deterministic: running it again writes the same bytes and
the same decodes.
"""
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "assets_torch")
TOOL_SRC = os.path.join(ROOT, "tools", "exr_tool.cpp")

# Imf::Compression
NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA, DWAB = range(10)


def build_tool(tmp):
    """Compile exr_tool.cpp into `tmp`; returns its path."""
    inc = os.environ.get("EXR_INCLUDE", "/usr/include/OpenEXR:/usr/include/"
                         "Imath").split(":")
    exe = os.path.join(tmp, "exr_tool")
    subprocess.run(["g++", "-O2", "-std=c++17", *(f"-I{i}" for i in inc),
                    TOOL_SRC, "-o", exe, "-lOpenEXR", "-lImath", "-lIex"],
                   check=True)
    return exe


class Tool:
    """exr_tool in a temporary directory: write and read files."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.exe = build_tool(tmp)

    def write(self, path, planes, chans, **spec):
        """planes float32 [C, H, W], chans "R:HALF,..." in plane order."""
        planes = np.ascontiguousarray(planes, np.float32)
        h, w = planes.shape[1:]
        sp = os.path.join(self.tmp, "spec")
        dp = os.path.join(self.tmp, "planes.f32")
        with open(sp, "w") as f:
            for k, v in dict(width=w, height=h, channels=chans, **spec).items():
                f.write(f"{k}={v}\n")
        planes.tofile(dp)
        subprocess.run([self.exe, "write", path, sp, dp], check=True)

    def read(self, path):
        """InputFile's decode: {channel: float32 [H, W]}, or None where it
        throws (the message printed)."""
        out = os.path.join(self.tmp, "decode.f32")
        r = subprocess.run([self.exe, "read", path, out], capture_output=True,
                           text=True)
        lines = r.stdout.splitlines()
        if not lines or lines[0] != "ok":
            print("  InputFile refuses", os.path.basename(path), ":",
                  lines[0] if lines else r.stderr.strip())
            return None
        names = [ln.split()[0] for ln in lines[1:-1]]
        x0, y0, x1, y1 = (int(v) for v in lines[-1].split()[1:])
        a = np.fromfile(out, np.float32).reshape(len(names), y1 - y0 + 1,
                                                 x1 - x0 + 1)
        return dict(zip(names, a))


def as_loaded(dec):
    """InputFile's channels -> what the JAX package's loader returns."""
    pick = ("R", "G", "B") if "R" in dec else ("Y",) * 3
    return np.ascontiguousarray(np.stack([dec[c] for c in pick], -1))


def content(g, c, h, w, special=True, flat=True):
    """c planes [c, h, w] float32: a smooth ramp on the left, noise in the
    middle, a flat patch, and (special) values across half's range on
    the right: denormals, 0, -0, inf, -inf, NaN, large and tiny values."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    p = np.empty((c, h, w), np.float32)
    for k in range(c):
        ramp = 0.2 + 0.8 * np.sin(x / 9.0 + k) ** 2 + 0.01 * y
        noise = np.abs(g.standard_normal((h, w))).astype(np.float32) * 1.5
        p[k] = np.where(x < w // 3, ramp, noise)
        if flat:
            p[k, : h // 3, w // 3:2 * w // 3] = 0.25 * (k + 1)
        if special:
            e = g.integers(-24, 16, (h, w - 2 * w // 3))
            v = (g.random((h, w - 2 * w // 3)) + 1) * 2.0 ** e
            v *= np.where(g.random(v.shape) < 0.3, -1, 1)
            v.flat[::7] = 0.0
            v.flat[1::11] = -0.0
            v.flat[2::13] = np.inf
            v.flat[3::17] = -np.inf
            v.flat[4::19] = np.nan
            v.flat[5::23] = 6e-8          # half's smallest denormal
            v.flat[6::29] = 65504.0
            p[k, :, 2 * w // 3:] = v
    return p


# the files for ROADMAP 7e, which the port refuses naming it (no decode kept)
NOT_PORTED = ("yc", "uint", "deep_composite")
RGB_H = "B:HALF,G:HALF,R:HALF"
RGB_F = "B:FLOAT,G:FLOAT,R:FLOAT"


def cases(g):
    """name -> (planes, channels, spec): the files of this script."""
    H, W = 37, 45
    c = {}
    for comp, name in ((RLE, "rle"), (PIZ, "piz"), (PXR24, "pxr24"),
                       (B44, "b44")):
        for t, ch in (("half", RGB_H), ("float", RGB_F)):
            c[f"{name}_{t}"] = (content(g, 3, H, W), ch,
                                dict(compression=comp))
    c["b44a_half"] = (content(g, 3, H, W), RGB_H, dict(compression=B44A))
    dwa = dict(special=False)
    c["dwaa_half"] = (content(g, 4, 45, 67, **dwa), "A:HALF," + RGB_H,
                      dict(compression=DWAA))
    c["dwab_half"] = (content(g, 3, 270, 40, **dwa), RGB_H,
                      dict(compression=DWAB))
    c["dwaa_y"] = (content(g, 1, 45, 67, **dwa), "Y:HALF",
                   dict(compression=DWAA))
    c["dwab_mixed"] = (content(g, 3, 270, 40, **dwa),
                       "B:FLOAT,G:HALF,R:HALF", dict(compression=DWAB))
    c["tiled_one"] = (content(g, 3, H, W), RGB_F,
                      dict(compression=ZIP, tile="16,8,0,0"))
    c["tiled_mipmap"] = (content(g, 3, H, W), RGB_H,
                         dict(compression=RLE, tile="8,16,1,0", lineorder=1))
    c["tiled_ripmap"] = (content(g, 3, H, W), RGB_F,
                         dict(compression=PIZ, tile="13,7,2,1", lineorder=2))
    c["scan_decreasing"] = (content(g, 3, H, W), RGB_F,
                            dict(compression=PXR24, lineorder=1, xmin=-3,
                                 ymin=5))
    c["multipart"] = (content(g, 3, H, W), RGB_H,
                      dict(compression=PIZ, layout="multipart"))
    c["multipart_tiled"] = (content(g, 3, H, W), RGB_F,
                            dict(compression=RLE, tile="16,16,0,0",
                                 layout="multipart"))
    c["deep_scanline"] = (content(g, 3, 9, 11), RGB_F,
                          dict(compression=ZIPS, layout="deepscanline"))
    c["deep_tiled"] = (content(g, 3, 9, 11), RGB_F,
                       dict(compression=RLE, tile="8,8,0,0",
                            layout="deeptiled"))
    c["deep_composite"] = (content(g, 5, 9, 11, special=False),
                           "A:HALF,B:FLOAT,G:FLOAT,R:FLOAT,Z:FLOAT",
                           dict(compression=NONE, layout="deepscanline"))
    c["yc"] = (content(g, 3, 10, 12, special=False), "R:HALF,G:HALF,B:HALF",
               dict(compression=ZIP, layout="yc"))
    c["uint"] = (np.floor(content(g, 3, 9, 11, special=False) * 1000),
                 "B:UINT,G:UINT,R:UINT", dict(compression=ZIP))
    return c


def timing_content(h=1024, w=2048):
    """Smooth procedural HALF content for the timing file: soft bands and
    rings, quantised to 1/256 so PIZ keeps it small."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    p = np.stack([0.5 + 0.45 * np.sin(x / 97.0 + k) * np.cos(y / 61.0 - k)
                  + 0.05 * np.sin(np.hypot(x - w / 2, y - h / 2) / 23.0)
                  for k in range(3)])
    return np.round(p * 256) / 256


def write_all(out, tool):
    g = np.random.default_rng(2024)
    dec = {}
    for name, (planes, chans, spec) in cases(g).items():
        p = os.path.join(out, name + ".exr")
        tool.write(p, planes, chans, **spec)
        d = tool.read(p)
        if d is not None and name not in NOT_PORTED:
            dec[name + ".exr"] = as_loaded(d)
    import cv2  # the skies' decodes, as the JAX package loads sky_*.hdr
    for k, spec in (("a", dict(compression=PIZ)),
                    ("b", dict(compression=RLE, tile="8,8,1,0"))):
        sky = cv2.imread(os.path.join(out, f"sky_{k}.hdr"),
                         cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)[..., ::-1]
        p = os.path.join(out, f"sky_{k}.exr")
        tool.write(p, np.ascontiguousarray(sky.transpose(2, 0, 1)[::-1]),
                   RGB_F, **spec)
        dec[f"sky_{k}.exr"] = as_loaded(tool.read(p))
        assert np.array_equal(dec[f"sky_{k}.exr"], sky.astype(np.float32))
    p = os.path.join(out, "piz_2048.exr")
    tool.write(p, timing_content()[::-1], RGB_H, compression=PIZ)
    full = as_loaded(tool.read(p))
    dec["piz_2048.exr:sha256"] = np.frombuffer(
        hashlib.sha256(full.tobytes()).digest(), np.uint8)
    dec["piz_2048.exr:corner"] = full[:128, :128]
    np.savez_compressed(os.path.join(out, "exr_decodes.npz"), **dec)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="gen_torch_exr_")
    try:
        write_all(out, Tool(tmp))
    finally:
        shutil.rmtree(tmp)
    for fn in sorted(os.listdir(out)):
        if fn.endswith(".exr") or fn == "exr_decodes.npz":
            print(fn, os.path.getsize(os.path.join(out, fn)))


if __name__ == "__main__":
    main()
