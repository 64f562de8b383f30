"""Write the OpenEXR test files of the port's decoder
(`vision_tpu_torch/scene/imageio.py` `read_exr`) into `tests/assets_torch/`
through libOpenEXR, with the decodes they are held against.

    python tools/gen_torch_exr.py [out_dir]

Needs g++, libOpenEXR 3.x's headers and libraries (`libopenexr-dev`;
`$EXR_INCLUDE`, default /usr/include/OpenEXR and /usr/include/Imath), the
system OpenCV 4.6.0 built with OpenEXR (`libopencv-dev`;
`$OPENCV_INCLUDE`, default /usr/include/opencv4) and the pip cv2 (the
skies' decodes); run `tools/gen_torch_assets.py` first (it writes
`sky_*.hdr`). It compiles `tools/exr_tool.cpp` and `tools/cv_read.cpp`
into a temporary directory, writes each file with the first and reads it
back with Imf::InputFile, the class OpenCV's EXR decoder reads through:
`exr_decodes.npz` holds, per file InputFile decodes and OpenCV takes as it
is, that decode as the JAX package's loader returns it (float32 [H, W,
3]: R, G, B, or Y replicated; A dropped). The files OpenCV converts with
its own code are held against `cv::imread(p, IMREAD_ANYCOLOR |
IMREAD_ANYDEPTH)` of OpenCV 4.6.0 through `cv_read` (ROADMAP C22: the pip
cv2 reads no EXR): `exr_cv_decodes.npz`.

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
    entry).
  * Slice 7e.2 (`cv_cases`; decodes in `exr_cv_decodes.npz`): `yc`
    (luminance-chroma) and `yc_{none,rle,zips,piz,pxr24,b44,b44a,dwaa,
    dwab}` (RgbaOutputFile's Y, RY, BY under each compression),
    `yc_chroma` (its own chromaticities), `sub_rgb` and `sub_ycc` (other
    samplings), the channel sets `ch_*` (`ch_layer` and `ch_a`, which
    OpenCV refuses, and `ch_ya`, whose OpenCV decode is undefined, have no
    entry), `uint`, `uint_piz`, `uint_mixed`, `uint_yc_dwaa`,
    `deep_composite` and `deep_k4_{none,rle,zips}` (0-4 samples a pixel
    with Z, ZBack and A), the perceptually linear `b44_plinear`,
    `b44a_plinear_y`, `dwaa_plinear`, `dwab_plinear_y`, full-range noise
    under DWA (`dwaa_noise`, `dwab_noise_rgb`), DWA blocks of version 1
    (`dwaa_v1`, `dwab_v1_y`: written as version 2 with the legacy rules'
    channels, then the version set to 1 and the rules dropped) and
    `b44a_log_table` (hand-built: every 16-bit value as a flat 4 x 4
    block, so its decode is B44's log table).
  * The twin scenes' files (`tests/torch_scenes.py` `cbox_sky_yc`,
    `env_sphere_cv`): `sky_yc.exr` (`sky_a.hdr`'s pixels through
    RgbaOutputFile's luminance-chroma mode, PIZ), `sky_yc_ref.exr` (its
    OpenCV decode as uncompressed FLOAT), `sky_b_deep.exr` (deep, 1-3
    samples a pixel compositing to `sky_b.hdr`'s decode exactly) and
    `sky_a_pfm.hdr` (`sky_a.hdr`'s decode as a PFM written by the pip
    cv2).
  * The twins of the scenes' skies (`tests/torch_scenes.py`
    `env_sphere_files`): `sky_a.exr` (FLOAT, PIZ, scanlines) and
    `sky_b.exr` (FLOAT, RLE, 8 x 8 tiles, MIPMAP), holding the OpenCV
    decodes of `sky_a.hdr` / `sky_b.hdr`, so they decode to the same
    arrays.
  * `piz_2048.exr`: 2048 x 1024 HALF RGB, PIZ, smooth procedural content,
    the decoder's timing case; the .npz holds the sha256 of its decode
    and its 128 x 128 corner. Likewise `yc_2048.exr` (the same content
    through the luminance-chroma mode, PIZ) and `deep_512.exr` (512^2,
    1-4 samples a pixel with Z and A, ZIPS) in `exr_cv_decodes.npz`.

The output is deterministic: running it again writes the same bytes and
the same decodes.
"""
import hashlib
import os
import shutil
import struct
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)   # the port's OpenEXR header and B44 helpers
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


# the files whose reference is OpenCV's own conversion (their decodes are
# in exr_cv_decodes.npz, not exr_decodes.npz)
OPENCV_ONLY = ("yc", "uint", "deep_composite")
RGB_H = "B:HALF,G:HALF,R:HALF"
RGB_F = "B:FLOAT,G:FLOAT,R:FLOAT"
YC = "R:HALF,G:HALF,B:HALF"   # RgbaOutputFile's R, G, B, written as Y, RY, BY


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
    c["yc"] = (content(g, 3, 10, 12, special=False), YC,
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
        d = None if name in OPENCV_ONLY else tool.read(p)
        if d is not None:
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


def build_cv_read(tmp):
    """Compile cv_read.cpp against the system OpenCV into `tmp`."""
    inc = os.environ.get("OPENCV_INCLUDE", "/usr/include/opencv4")
    exe = os.path.join(tmp, "cv_read")
    subprocess.run(["g++", "-O2", "-std=c++17", f"-I{inc}",
                    os.path.join(ROOT, "tools", "cv_read.cpp"), "-o", exe,
                    "-lopencv_imgcodecs", "-lopencv_core"], check=True)
    return exe


CV_DEPTH = {0: np.uint8, 2: np.uint16, 4: np.int32, 5: np.float32}


class CvRead:
    """cv_read in a temporary directory: `cv::imread(p, IMREAD_ANYCOLOR |
    IMREAD_ANYDEPTH)` through the system OpenCV (4.6.0, linked to
    libOpenEXR), as the JAX package's loader returns it (float32 [H, W,
    3] RGB, one channel replicated), or None for an empty result."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.exe = build_cv_read(tmp)

    def read(self, path):
        out = os.path.join(self.tmp, "cv.raw")
        r = subprocess.run([self.exe, path, out], capture_output=True,
                           text=True, check=True)
        if r.stdout.split()[0] == "empty":
            return None
        h, w, c, depth = (int(v) for v in r.stdout.split())
        a = np.fromfile(out, CV_DEPTH[depth]).reshape(h, w, c)
        a = a.astype(np.float32)
        if c == 1:
            a = np.concatenate([a] * 3, 2)
        return np.ascontiguousarray(a[..., :3][..., ::-1])


def ints(g, c, h, w, scale=1e5):
    """c planes of integers (UINT channels)."""
    return np.floor(content(g, c, h, w, special=False) * scale)


def deep_planes(g, c, h, w, k=4, least=0):
    """A deep part of c channels (sorted: A, colours, Z, ZBack) and 0-k
    samples a pixel: counts, then k planes a channel. A is mostly in
    [0.1, 0.9], sometimes exactly 1 (the pixel stops there) or above;
    Z takes few values, so ties and samples out of depth order are
    common; ZBack is Z + 0.25."""
    counts = g.integers(least, k + 1, (h, w)).astype(np.float32)
    a = 0.1 + 0.8 * g.random((k, h, w))
    a[g.random((k, h, w)) < 0.1] = 1.0
    a[g.random((k, h, w)) < 0.03] = 1.5
    col = [content(g, k, h, w, special=False) for _ in range(c - 3)]
    z = g.integers(0, 4, (k, h, w)) * 0.5
    return np.concatenate([counts[None], a, *col, z, z + 0.25]).astype(
        np.float32)


def cv_cases(g):
    """name -> (planes, channels, spec): the files whose reference is
    OpenCV 4.6.0's decode."""
    c = {}
    for comp, name in ((NONE, "none"), (RLE, "rle"), (ZIPS, "zips"),
                       (PIZ, "piz"), (PXR24, "pxr24"), (B44, "b44"),
                       (B44A, "b44a"), (DWAA, "dwaa"), (DWAB, "dwab")):
        c[f"yc_{name}"] = (content(g, 3, 38, 46, special=False), YC,
                           dict(compression=comp, layout="yc"))
    c["yc_chroma"] = (content(g, 3, 16, 24, special=False), YC,
                      dict(compression=ZIPS, layout="yc", chromaticities=(
                          "0.7,0.28,0.17,0.8,0.13,0.04,0.32,0.33")))
    c["sub_rgb"] = (content(g, 3, 16, 24), "B:HALF,G:FLOAT:2:1,R:HALF:2:2",
                    dict(compression=PIZ))
    chroma = content(g, 3, 16, 24, special=False) - np.float32(
        [[[0.0]], [[0.8]], [[0.8]]])
    c["sub_ycc"] = (chroma[::-1].copy(), "BY:HALF:1:2,RY:HALF:2:1,Y:FLOAT",
                    dict(compression=ZIP))
    for name, chans in (("ch_rg", "G:HALF,R:HALF"), ("ch_g", "G:FLOAT"),
                        ("ch_rgbz", "B:HALF,G:HALF,R:HALF,Z:FLOAT"),
                        ("ch_z", "Z:FLOAT"), ("ch_yz", "Y:HALF,Z:FLOAT"),
                        ("ch_y_ry", "RY:HALF,Y:HALF"),
                        ("ch_layer", "diffuse.B:HALF,diffuse.G:HALF,"
                                     "diffuse.R:HALF"), ("ch_a", "A:HALF")):
        n = len(chans.split(","))
        c[name] = (content(g, n, 13, 29), chans, dict(compression=ZIP))
    c["ch_ya"] = (content(g, 2, 8, 300), "A:HALF,Y:HALF",
                  dict(compression=NONE))
    c["uint_piz"] = (ints(g, 3, 37, 45), "B:UINT,G:UINT,R:UINT",
                     dict(compression=PIZ))
    c["uint_mixed"] = (np.concatenate([content(g, 2, 37, 45),
                                       ints(g, 1, 37, 45)]),
                       "B:FLOAT,G:HALF,R:UINT", dict(compression=PXR24))
    c["uint_yc_dwaa"] = (np.concatenate([chroma[1:] * 0.5,
                                         ints(g, 1, 16, 24)]),
                         "BY:HALF,RY:HALF,Y:UINT", dict(compression=DWAA))
    deep = "A:HALF,B:HALF,G:HALF,R:FLOAT,Z:FLOAT,ZBack:FLOAT"
    for comp, name in ((NONE, "none"), (RLE, "rle"), (ZIPS, "zips")):
        c[f"deep_k4_{name}"] = (deep_planes(g, 6, 19, 23), deep, dict(
            compression=comp, layout="deepscanline", deepk=4))
    c["b44_plinear"] = (content(g, 3, 37, 45, special=False), RGB_H,
                        dict(compression=B44, plinear="R,G,B"))
    c["b44a_plinear_y"] = (content(g, 1, 37, 45, special=False), "Y:HALF",
                           dict(compression=B44A, plinear="Y"))
    c["dwaa_plinear"] = (content(g, 4, 45, 67, special=False),
                         "A:HALF," + RGB_H,
                         dict(compression=DWAA, plinear="A,R,G,B"))
    c["dwab_plinear_y"] = (content(g, 1, 270, 40, special=False), "Y:HALF",
                           dict(compression=DWAB, plinear="Y"))
    noise = dict(special=False, flat=False)
    c["dwaa_noise"] = (content(g, 1, 256, 256, **noise) * 3 - 2, "Y:HALF",
                       dict(compression=DWAA, plinear="Y"))
    c["dwab_noise_rgb"] = (content(g, 3, 128, 128, **noise) * 3 - 2, RGB_H,
                           dict(compression=DWAB))
    c["dwaa_v1"] = (content(g, 4, 45, 67, special=False), "A:HALF," + RGB_H,
                    dict(compression=DWAA))
    c["dwab_v1_y"] = (content(g, 1, 270, 40, special=False), "Y:HALF",
                      dict(compression=DWAB))
    return c


# what OpenCV 4.6.0 returns no image for (the JAX package raises)
CV_REFUSED = ("ch_layer", "ch_a")
# Y and A without RY or BY: OpenCV 4.6.0 reads Y into one of its three
# slots and converts the other two, which it never wrote, so its result is
# whatever its row buffer held (ROADMAP C22); the port gives zeros
CV_UNDEFINED = ("ch_ya",)


def _chunks(data):
    """A single-part scanline file -> (the bytes before its offset table,
    its chunks (y, data))."""
    from vision_tpu_torch.scene import imageio as tio
    attrs, pos = tio._exr_header(data)
    comp = attrs["compression"][1][0]
    _, y0, _, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    n = -(-(y1 - y0 + 1) // tio._EXR_LINES[comp])
    offs = struct.unpack(f"<{n}Q", data[pos:pos + 8 * n])
    chunks = []
    for o in offs:
        y, size = struct.unpack("<ii", data[o:o + 8])
        chunks.append((y, data[o + 8:o + 8 + size]))
    return data[:pos], chunks


def _join(head, chunks):
    at = len(head) + 8 * len(chunks)
    offs, body = [], b""
    for y, blk in chunks:
        offs.append(at + len(body))
        body += struct.pack("<ii", y, len(blk)) + blk
    return head + struct.pack(f"<{len(offs)}Q", *offs) + body


def dwa_version_1(data):
    """A DWA file of channels whose legacy rules equal the written ones (R,
    G, B, A, Y) -> the same file in version-1 blocks: the version field
    set to 1 and the channel rules dropped."""
    from vision_tpu_torch.scene import imageio as tio
    head, chunks = _chunks(data)
    attrs, _ = tio._exr_header(data)
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    line = (x1 - x0 + 1) * sum(dt.itemsize for _, dt in tio._exr_channels(
        attrs["channels"][1]))
    lines = tio._EXR_LINES[attrs["compression"][1][0]]
    out = []
    for y, blk in chunks:
        if len(blk) >= line * min(lines, y1 - y + 1):
            out.append((y, blk))         # stored raw
            continue
        fields = list(struct.unpack("<11Q", blk[:88]))
        assert fields[0] == 2
        rules, = struct.unpack("<H", blk[88:90])
        fields[0] = 1
        out.append((y, struct.pack("<11Q", *fields) + blk[88 + rules:]))
    return _join(head, out)


def b44_table_file():
    """A B44A file of one HALF channel Y marked perceptually linear, 1024
    x 1024, whose 65,536 flat 4 x 4 blocks hold every 16-bit value once:
    its decode is B44's log table (its sha256 and corner are kept)."""
    from vision_tpu_torch.scene import imageio as tio
    ordered = np.arange(65536)
    half = tio._b44_ordered_to_half(ordered)
    t = np.empty(65536, np.int64)
    t[half] = ordered                    # the stored value of each half
    blocks = t.reshape(256, 256)         # [block row, block column]
    chunks = []
    for i in range(32):                  # 32 lines, 8 block rows a chunk
        b = blocks[8 * i:8 * i + 8].reshape(-1)
        flat = np.stack([b >> 8, b & 0xFF, np.full_like(b, 0xFC)], -1)
        chunks.append((32 * i, flat.astype(np.uint8).tobytes()))
    chlist = b"Y\0" + struct.pack("<iB3xii", 1, 1, 1, 1) + b"\0"
    box = struct.pack("<iiii", 0, 0, 1023, 1023)
    head = (struct.pack("<ii", tio.EXR_MAGIC, 2)
            + tio._attr("channels", "chlist", chlist)
            + tio._attr("compression", "compression", bytes([B44A]))
            + tio._attr("dataWindow", "box2i", box)
            + tio._attr("displayWindow", "box2i", box)
            + tio._attr("lineOrder", "lineOrder", bytes([0]))
            + tio._attr("pixelAspectRatio", "float", struct.pack("<f", 1))
            + tio._attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
            + tio._attr("screenWindowWidth", "float", struct.pack("<f", 1))
            + b"\0")
    return _join(head, chunks)


def sky_deep_planes(sky, g):
    """sky [H, W, 3] -> a deep part (A, B, G, R, Z; 3 samples kept a
    pixel) whose composite is `sky` bit for bit: an optional transparent
    empty sample in front (A = 0: it adds 0), the sky (A = 1: it is added
    whole), then junk behind that the full alpha hides; stored out of
    depth order."""
    h, w, _ = sky.shape
    front = g.random((h, w)) < 0.5
    behind = g.integers(0, 2, (h, w))
    counts = 1 + front + behind
    a = np.zeros((3, h, w), np.float32)
    col = np.zeros((3, 3, h, w), np.float32)   # [colour B G R, sample]
    z = np.zeros((3, h, w), np.float32)
    for y in range(h):
        for x in range(w):
            s = []
            if front[y, x]:
                s.append((0.0, (0.0, 0.0, 0.0), 1.0))
            s.append((1.0, tuple(sky[y, x, ::-1]), 5.0))
            if behind[y, x]:
                s.append((0.5, (7.0, 7.0, 7.0), 2.0))
            for k, (av, cv, zv) in enumerate(s):
                a[k, y, x], z[k, y, x] = av, zv
                col[:, k, y, x] = cv
    return np.concatenate([counts[None].astype(np.float32), a,
                           col.reshape(9, h, w), z])


def write_cv(out, tool, cv):
    """The files whose reference is OpenCV 4.6.0's decode, the twin scenes'
    skies, and exr_cv_decodes.npz."""
    import cv2
    g = np.random.default_rng(7015)
    dec = {}

    def keep(name, whole=True):
        p = os.path.join(out, name)
        d = cv.read(p)
        if whole:
            dec[name] = d
        else:
            dec[name + ":sha256"] = np.frombuffer(
                hashlib.sha256(d.tobytes()).digest(), np.uint8)
            dec[name + ":corner"] = d[:128, :128]
        return d

    for name in OPENCV_ONLY:
        keep(name + ".exr")
    for name, (planes, chans, spec) in cv_cases(g).items():
        p = os.path.join(out, name + ".exr")
        tool.write(p, planes, chans, **spec)
        if name.startswith("dwa") and name.endswith(("_v1", "_v1_y")):
            with open(p, "rb") as f:
                data = dwa_version_1(f.read())
            with open(p, "wb") as f:
                f.write(data)
        if name in CV_REFUSED:
            assert cv.read(p) is None, name
        elif name not in CV_UNDEFINED:
            keep(name + ".exr")
    with open(os.path.join(out, "b44a_log_table.exr"), "wb") as f:
        f.write(b44_table_file())
    keep("b44a_log_table.exr", whole=False)
    # the twin scenes' files
    sky = {k: cv2.imread(os.path.join(out, f"sky_{k}.hdr"),
                         cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)[..., ::-1]
           for k in "ab"}
    p = os.path.join(out, "sky_yc.exr")
    tool.write(p, np.ascontiguousarray(sky["a"].transpose(2, 0, 1)), YC,
               compression=PIZ, layout="yc")
    got = keep("sky_yc.exr")
    p = os.path.join(out, "sky_yc_ref.exr")
    tool.write(p, np.ascontiguousarray(got.transpose(2, 0, 1)[::-1]), RGB_F,
               compression=NONE)
    assert np.array_equal(keep("sky_yc_ref.exr").view(np.uint32),
                          got.view(np.uint32))
    p = os.path.join(out, "sky_b_deep.exr")
    tool.write(p, sky_deep_planes(sky["b"], g), "A:FLOAT,B:FLOAT,G:FLOAT,"
               "R:FLOAT,Z:FLOAT", compression=ZIPS, layout="deepscanline",
               deepk=3)
    assert np.array_equal(keep("sky_b_deep.exr"), sky["b"])
    p = os.path.join(out, "sky_a_pfm.hdr")
    pfm = os.path.join(tool.tmp, "sky.pfm")
    cv2.imwrite(pfm, sky["a"][..., ::-1])
    shutil.copyfile(pfm, p)
    assert np.array_equal(cv2.imread(p, cv2.IMREAD_ANYCOLOR
                                     | cv2.IMREAD_ANYDEPTH)[..., ::-1],
                          sky["a"])
    # the timing files
    p = os.path.join(out, "yc_2048.exr")
    tool.write(p, timing_content(), YC, compression=PIZ, layout="yc")
    keep("yc_2048.exr", whole=False)
    p = os.path.join(out, "deep_512.exr")
    tool.write(p, deep_timing_planes(), "A:HALF,B:HALF,G:HALF,R:HALF,Z:FLOAT",
               compression=ZIPS, layout="deepscanline", deepk=4)
    keep("deep_512.exr", whole=False)
    np.savez_compressed(os.path.join(out, "exr_cv_decodes.npz"), **dec)


def deep_timing_planes(n=512):
    """512 x 512, 1-4 samples a pixel, smooth colours quantised to 1/16,
    A 0.25-0.75 and Z in depth order, so ZIPS keeps it near 1 MB."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    counts = 1 + (x // 7 + y // 5) % 4
    k = np.arange(4, dtype=np.float32)[:, None, None]
    a = np.broadcast_to(0.25 + 0.125 * ((k + x // 16) % 5), (4, n, n))
    col = [np.round((0.5 + 0.45 * np.sin(x / (97.0 + 11 * c) + k)
                     * np.cos(y / 89.0 - k)) * 16) / 16 for c in range(3)]
    z = np.broadcast_to(1.0 + k + np.floor((x + y) / 64), (4, n, n))
    return np.concatenate([counts[None], a, *col, z]).astype(np.float32)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="gen_torch_exr_")
    try:
        tool = Tool(tmp)
        write_all(out, tool)
        write_cv(out, tool, CvRead(tmp))
    finally:
        shutil.rmtree(tmp)
    for fn in sorted(os.listdir(out)):
        if fn.endswith(".exr") or fn.startswith("exr_") or fn.endswith(
                "_pfm.hdr"):
            print(fn, os.path.getsize(os.path.join(out, fn)))


if __name__ == "__main__":
    main()
