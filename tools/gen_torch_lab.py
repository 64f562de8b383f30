"""Write `vision_tpu_torch/data/lab_srgb.npz`: the node values of the
colour lookup table through which LittleCMS 2.17 (the one PIL 12.1.0
carries) converts PIL's 8-bit LAB images to RGB (`Image.convert("RGB")`
builds an ImageCms transform from `createProfile("LAB")`, the Lab v2
identity profile, to `createProfile("sRGB")`, perceptual intent).

LittleCMS optimises that 8-bit transform into a 33 x 33 x 33 table of
16-bit RGB nodes, sampled from the whole float pipeline (Lab v4 -> v2,
the identity table, v2 -> v4, Lab -> XYZ, the sRGB matrix, the inverse
sRGB curves) at the inputs floor(i * 65535 / 32 + 0.5). This script reads
those nodes from LittleCMS itself: the same profiles, a 16-bit Lab ->
16-bit RGB transform without optimisation, evaluated at the node inputs
(through ctypes; the library PIL bundles, or the system's liblcms2).
`vision_tpu_torch/scene/pilread.py` `lab_to_rgb` then interpolates them
as LittleCMS does (its tetrahedral Eval3Inputs in 16.16 fixed point,
after PIL's LabV2 8-bit input encoding, before its 16 -> 8-bit output
rounding). With `--check` it holds that against PIL's conversion of
every one of the 2^24 LAB triples (about a minute).

    python tools/gen_torch_lab.py [--check]
"""
import ctypes
import ctypes.util
import glob
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "vision_tpu_torch", "data", "lab_srgb.npz")
GRID = 33


def _lcms():
    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "liblcms2*"))
    path = libs[0] if libs else ctypes.util.find_library("lcms2")
    lib = ctypes.CDLL(path)
    lib.cmsCreateLab2Profile.restype = ctypes.c_void_p
    lib.cmsCreateLab2Profile.argtypes = [ctypes.c_void_p]
    lib.cmsCreate_sRGBProfile.restype = ctypes.c_void_p
    lib.cmsCreateTransform.restype = ctypes.c_void_p
    lib.cmsCreateTransform.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint32]
    lib.cmsDoTransform.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_uint32]
    lib.cmsDeleteTransform.argtypes = [ctypes.c_void_p]
    lib.cmsCloseProfile.argtypes = [ctypes.c_void_p]
    return lib


def nodes():
    """uint16 [33, 33, 33, 3]: RGB at the Lab (v4, 16-bit) node inputs."""
    lib = _lcms()
    lab, srgb = lib.cmsCreateLab2Profile(None), lib.cmsCreate_sRGBProfile()
    type_lab16 = (10 << 16) | (3 << 3) | 2          # TYPE_Lab_16
    type_rgb16 = (4 << 16) | (3 << 3) | 2           # TYPE_RGB_16
    xform = lib.cmsCreateTransform(lab, type_lab16, srgb, type_rgb16,
                                   0, 0x0100)       # cmsFLAGS_NOOPTIMIZE
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5).astype(
        np.uint16)
    grid = np.ascontiguousarray(np.stack(np.meshgrid(q, q, q, indexing="ij"),
                                         -1).reshape(-1, 3))
    out = np.zeros_like(grid)
    lib.cmsDoTransform(xform, grid.ctypes.data, out.ctypes.data, len(grid))
    lib.cmsDeleteTransform(xform)
    lib.cmsCloseProfile(lab)
    lib.cmsCloseProfile(srgb)
    return out.reshape(GRID, GRID, GRID, 3)


def check():
    """The port's conversion of every LAB triple against PIL's."""
    from PIL import Image
    sys.path.insert(0, ROOT)
    from vision_tpu_torch.scene import pilread
    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), lab.tobytes())
                      .convert("RGB")).reshape(-1, 3)
    bad = 0
    for i in range(0, 1 << 24, 1 << 22):
        got = pilread.lab_to_rgb(lab[i:i + (1 << 22)] ^ np.uint8(128) *
                                 np.array([0, 1, 1], np.uint8))
        bad += int((got != want[i:i + (1 << 22)]).any(-1).sum())
    print(f"{bad} of {1 << 24} LAB triples differ from PIL's conversion")
    return bad == 0


if __name__ == "__main__":
    np.savez_compressed(OUT, nodes=nodes())
    if "--check" in sys.argv[1:] and not check():
        sys.exit(1)
