"""ctypes bindings of the port's host library: the SAH BVH builder
(`native/bvh_builder.cpp`), the OBJ parser (`csrc/mesh_io.cpp`), the
JPEG entropy decoder (`csrc/jpeg_huff.cpp`), the serial stages of the
OpenEXR, TIFF and GIF codecs (`csrc/image_codecs.cpp`) and the WebP
bitstream decoders (`csrc/webp_codec.cpp`).

Counterpart of `vision_tpu/native.py` (`build_bvh_native`,
`build_bvh_boxes_native`, `load_obj_native`) for the port, which may not
import the JAX package. At first use the five sources are compiled with
g++ into `vision_tpu_torch/_build/` (the tracked `native/libvision_native.so`
is neither loaded nor rebuilt). The OBJ parser is the port's own copy of
`native/mesh_io.cpp`'s: its vertex cache keys on the exact index triple
(ROADMAP C15). A missing compiler or a failed build raises: the port has
no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

from .accel.cuda_build import compile_library

_HERE = os.path.dirname(__file__)
SOURCES = [os.path.join(_HERE, "..", "native", "bvh_builder.cpp"),
           os.path.join(_HERE, "csrc", "mesh_io.cpp"),
           os.path.join(_HERE, "csrc", "jpeg_huff.cpp"),
           os.path.join(_HERE, "csrc", "image_codecs.cpp"),
           os.path.join(_HERE, "csrc", "webp_codec.cpp")]
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None


def build():
    """Compile the builder unless this source's library exists.
    Returns (library path, seconds spent, compiler log)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX): the host library "
                           "is compiled from source at first use")
    return compile_library("vision_native", cxx, CXX_FLAGS, SOURCES)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        F = ctypes.POINTER(ctypes.c_float)
        I = ctypes.POINTER(ctypes.c_int32)
        lib.vt_build_bvh.argtypes = [F, F, F, ctypes.c_int64, ctypes.c_int32,
                                     F, F, I, I, I, I, I]
        lib.vt_build_bvh.restype = ctypes.c_int64
        lib.vt_build_bvh_boxes.argtypes = [F, F, ctypes.c_int64, ctypes.c_int32,
                                           F, F, I, I, I, I, I]
        lib.vt_build_bvh_boxes.restype = ctypes.c_int64
        lib.vt_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MeshBlob)]
        lib.vt_load_obj.restype = ctypes.c_int32
        lib.vt_free_mesh.argtypes = [ctypes.POINTER(_MeshBlob)]
        lib.vt_free_mesh.restype = None
        lib.vt_obj_key.argtypes = [ctypes.c_int64] * 3 + [
            ctypes.POINTER(ctypes.c_uint64)]
        lib.vt_obj_key.restype = None
        P = ctypes.c_void_p
        lib.vt_jpeg_decode_scan.argtypes = [P, ctypes.c_int64, ctypes.c_int32,
                                            P, P, P, P] + [ctypes.c_int32] * 8
        lib.vt_jpeg_decode_scan.restype = ctypes.c_int64
        lib.vt_jpeg_decode_arith_scan.argtypes = [
            P, ctypes.c_int64, ctypes.c_int32, P, P, P] + [ctypes.c_int32] * 8
        lib.vt_jpeg_decode_arith_scan.restype = ctypes.c_int64
        lib.vt_jpeg_decode_lossless.argtypes = [
            P, ctypes.c_int64, ctypes.c_int32, P, P, P, P] + \
            [ctypes.c_int32] * 5
        lib.vt_jpeg_decode_lossless.restype = ctypes.c_int64
        for name, args in (("vt_exr_huf_decode", [P, ctypes.c_int64, P,
                                                  ctypes.c_int64]),
                           ("vt_exr_rle_decode", [P, ctypes.c_int64, P,
                                                  ctypes.c_int64]),
                           ("vt_dwa_unrle_ac", [P, ctypes.c_int64,
                                                ctypes.c_int64, P, P]),
                           ("vt_lzw_decode", [P, ctypes.c_int64, P,
                                              ctypes.c_int64, ctypes.c_int32,
                                              ctypes.c_int32]),
                           ("vt_packbits_decode", [P, ctypes.c_int64, P,
                                                   ctypes.c_int64])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int64
        for name in ("vt_webp_vp8l_decode", "vt_webp_alph_decode",
                     "vt_webp_vp8_decode"):
            getattr(lib, name).argtypes = [P, ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, P]
            getattr(lib, name).restype = ctypes.c_int64
        lib.vt_webp_coverage.argtypes = [P, ctypes.c_int32]
        lib.vt_webp_coverage.restype = ctypes.c_int64
        _lib = lib
    return _lib


class _MeshBlob(ctypes.Structure):
    _fields_ = [("positions", ctypes.POINTER(ctypes.c_float)),
                ("normals", ctypes.POINTER(ctypes.c_float)),
                ("uvs", ctypes.POINTER(ctypes.c_float)),
                ("triangles", ctypes.POINTER(ctypes.c_int32)),
                ("n_verts", ctypes.c_int64),
                ("n_tris", ctypes.c_int64)]


def load_obj_native(path):
    """Parse an OBJ file: (positions [V,3], normals [V,3], uvs [V,2]
    float32, triangles [T,3] int32), one vertex per distinct v/vt/vn
    triple in the order of first use, polygons fan-triangulated; a missing
    vt or vn gives zeros. Raises FileNotFoundError / OSError when the file
    cannot be opened / read."""
    lib = _library()
    blob = _MeshBlob()
    rc = lib.vt_load_obj(os.fsencode(path), ctypes.byref(blob))
    if rc == -1:
        raise FileNotFoundError(f"cannot open {path}")
    if rc != 0:
        raise OSError(f"cannot read {path}")
    try:
        nv, nt = blob.n_verts, blob.n_tris
        out = [np.ctypeslib.as_array(ptr, (n, k)).copy() for ptr, n, k in (
            (blob.positions, nv, 3), (blob.normals, nv, 3), (blob.uvs, nv, 2),
            (blob.triangles, nt, 3))]
    finally:
        lib.vt_free_mesh(ctypes.byref(blob))
    return tuple(out)


def obj_key(vi, ti, ni):
    """The OBJ parser's vertex-cache key of a 0-based index triple (-1 for
    an absent vt / vn): two 64-bit words."""
    out = (ctypes.c_uint64 * 2)()
    _library().vt_obj_key(vi, ti, ni, out)
    return tuple(out)


def jpeg_decode_scan(data, start, comps, planes, bits, vals, mcux, mcuy,
                     restart, prog=None):
    """Huffman-decode one JPEG scan (`csrc/jpeg_huff.cpp`). data: the
    file's bytes, the scan's data from `start`; comps: int32 [n, 7] rows
    (DC table, AC table, h, v, blocks a plane row, blocks wide and high for
    a one-component scan); planes: each component's int16 [rows, blocks a
    row, 64] coefficients, written in place (a progressive scan adds its
    band to them); bits uint8 [8, 16], vals uint8 [8, 256]: the DC tables
    0-3 then the AC tables; prog: None for a sequential scan, else (Ss,
    Se, Ah, Al) of a progressive one. Returns the offset in `data` of the
    marker that ends the scan."""
    buf = np.frombuffer(data, np.uint8)
    comps = np.ascontiguousarray(comps, np.int32)
    bits = np.ascontiguousarray(bits, np.uint8)
    vals = np.ascontiguousarray(vals, np.uint8)
    _check_planes(planes, comps)
    ptrs = (ctypes.c_void_p * len(planes))(*(p.ctypes.data for p in planes))
    rc = _library().vt_jpeg_decode_scan(
        buf.ctypes.data + start, len(buf) - start, len(planes),
        comps.ctypes.data, ptrs, bits.ctypes.data, vals.ctypes.data,
        mcux, mcuy, restart, prog is not None, *(prog or (0, 63, 0, 0)))
    return start + _scan_end(rc)


def _check_planes(planes, comps):
    for p in planes:
        if p.dtype != np.int16 or not p.flags.c_contiguous or p.shape[-1] != 64:
            raise ValueError("coefficient planes must be C-contiguous int16 "
                             "[rows, cols, 64]")
    if comps.shape != (len(planes), 7):
        raise ValueError("one [7] row a component")
    if not 1 <= len(planes) <= 4:
        raise ValueError("a JPEG scan holds 1 to 4 components")


def _scan_end(rc):
    """A scan decoder's return: the offset of the marker that ends the
    scan, or the error it met."""
    if rc < 0:
        raise ValueError({-1: "corrupt JPEG data: a bad Huffman code",
                          -2: "corrupt JPEG Huffman table",
                          -3: "corrupt JPEG data: a restart marker is "
                              "missing",
                          -4: "a lossless JPEG restart interval of part of "
                              "a row (libjpeg refuses it)",
                          -5: "a JPEG scan of no or more than 4 components, "
                              "or a table outside 0-3"}[rc])
    return rc


def jpeg_decode_arith_scan(data, start, comps, planes, cond, mcux, mcuy,
                           restart, prog=None):
    """Decode one arithmetic-coded JPEG scan (`csrc/jpeg_huff.cpp`), its
    arguments as `jpeg_decode_scan`'s but for cond: int32 [12], the DC
    conditioning bounds L and U of tables 0-3, then the AC K of tables 0-3
    (the DAC segment's, T.81's defaults 0, 1, 5)."""
    buf = np.frombuffer(data, np.uint8)
    comps = np.ascontiguousarray(comps, np.int32)
    cond = np.ascontiguousarray(cond, np.int32)
    _check_planes(planes, comps)
    ptrs = (ctypes.c_void_p * len(planes))(*(p.ctypes.data for p in planes))
    rc = _library().vt_jpeg_decode_arith_scan(
        buf.ctypes.data + start, len(buf) - start, len(planes),
        comps.ctypes.data, ptrs, cond.ctypes.data, mcux, mcuy, restart,
        prog is not None, *(prog or (0, 63, 0, 0)))
    return start + _scan_end(rc)


def jpeg_decode_lossless(data, start, tables, planes, bits, vals, restart,
                         psv, pt):
    """Decode one lossless JPEG scan (`csrc/jpeg_huff.cpp`) of components
    sampled 1x1: tables, each component's DC table (0-3); planes, each
    component's uint16 [h, w] samples, written in place; bits / vals as
    for `jpeg_decode_scan`; restart: MCUs an interval (0 none); psv: the
    predictor (1-7); pt: the point transform. Returns the offset in `data`
    of the marker that ends the scan."""
    buf = np.frombuffer(data, np.uint8)
    tables = np.ascontiguousarray(tables, np.int32)
    bits = np.ascontiguousarray(bits, np.uint8)
    vals = np.ascontiguousarray(vals, np.uint8)
    if not 1 <= len(planes) <= 4 or tables.shape != (len(planes),):
        raise ValueError("a JPEG scan holds 1 to 4 components, a DC table "
                         "each")
    h, w = planes[0].shape
    for p in planes:
        if p.dtype != np.uint16 or not p.flags.c_contiguous or p.shape != (h, w):
            raise ValueError("sample planes must be C-contiguous uint16 [h, w]")
    ptrs = (ctypes.c_void_p * len(planes))(*(p.ctypes.data for p in planes))
    rc = _library().vt_jpeg_decode_lossless(
        buf.ctypes.data + start, len(buf) - start, len(planes),
        tables.ctypes.data, ptrs, bits.ctypes.data, vals.ctypes.data, w, h,
        restart, psv, pt)
    return start + _scan_end(rc)


def _bytes(data):
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)


def exr_huf_decode(data, n_out):
    """OpenEXR's Huffman decoder (PIZ, DWA's AC coefficients): the coded
    bytes -> uint16 [n_out]. Raises ValueError where libOpenEXR throws."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint16)
    if _library().vt_exr_huf_decode(buf.ctypes.data, len(data),
                                    out.ctypes.data, n_out) < 0:
        raise ValueError("corrupt OpenEXR Huffman data")
    return out[:n_out]


def exr_rle_decode(data, n_out):
    """OpenEXR's byte run-length decoder -> uint8 [n_out]. Raises
    ValueError for a stream of another length, as libOpenEXR does."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    n = _library().vt_exr_rle_decode(buf.ctypes.data, len(data),
                                     out.ctypes.data, n_out)
    if n != n_out:
        raise ValueError("corrupt OpenEXR run-length data")
    return out[:n_out]


def dwa_unrle_ac(ac, n_blocks):
    """DWA's AC run-length decoder: uint16 values -> (uint16 [n_blocks, 64]
    halves in zig-zag order, index 0 zero; int32 [n_blocks], the index of
    each block's last value; the values read). Raises ValueError where the
    values run out."""
    ac = np.ascontiguousarray(ac, np.uint16)
    if not ac.size:
        ac = np.zeros(1, np.uint16)[:0]
    blocks = np.zeros((max(n_blocks, 1), 64), np.uint16)
    last = np.zeros(max(n_blocks, 1), np.int32)
    n = _library().vt_dwa_unrle_ac(ac.ctypes.data, ac.size, n_blocks,
                                   blocks.ctypes.data, last.ctypes.data)
    if n < 0:
        raise ValueError("corrupt OpenEXR DWA AC data")
    return blocks[:n_blocks], last[:n_blocks], n


def lzw_decode(data, n_out, min_bits=8, msb=True):
    """LZW -> uint8 [at most n_out]: msb=True, TIFF's (9- to 12-bit codes,
    most significant bit first, the early width change); msb=False, GIF's
    and old-style TIFF's (least significant bit first, codes from
    min_bits + 1 bits). Stops at the end code, at n_out bytes or where the
    data ends. Raises ValueError for a code not yet in the table."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    n = _library().vt_lzw_decode(buf.ctypes.data, len(data), out.ctypes.data,
                                 n_out, min_bits, int(msb))
    if n < 0:
        raise ValueError("corrupt LZW data: a code not yet in the table")
    return out[:n]


def packbits_decode(data, n_out):
    """TIFF PackBits -> uint8 [at most n_out] (fewer where the data ends)."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    n = _library().vt_packbits_decode(buf.ctypes.data, len(data),
                                      out.ctypes.data, n_out)
    return out[:n]


_WEBP_ERRORS = {
    "vt_webp_vp8l_decode": {-1: "a bad VP8L header", -2: "a VP8L image of "
                            "another size than its header's",
                            -3: "bad VP8L prefix codes or transforms",
                            -4: "bad VP8L pixel data"},
    "vt_webp_alph_decode": {-1: "a bad ALPH header", -2: "raw ALPH data "
                            "shorter than the image", -3: "bad VP8L-coded "
                            "ALPH data"},
    "vt_webp_vp8_decode": {-1: "a truncated VP8 header", -2: "a bad VP8 "
                           "frame tag or start code", -3: "a VP8 first "
                           "partition past the data", -4: "a bad VP8 "
                           "segment or filter header", -5: "VP8 token "
                           "partitions past the data", -6: "a premature "
                           "end of the VP8 first partition", -7: "a "
                           "premature end of a VP8 token partition",
                           -9: "a VP8 frame of another size than its "
                           "header's"}}


def _webp_call(name, data, width, height, out):
    buf = _bytes(data)
    rc = getattr(_library(), name)(buf.ctypes.data, len(data), width, height,
                                   out.ctypes.data)
    if rc < 0:
        raise ValueError(f"corrupt WebP data: {_WEBP_ERRORS[name][rc]}")
    return out


def webp_vp8l_decode(data, width, height):
    """A VP8L bitstream (the chunk's payload, signature byte first, through
    the end of the data libwebp is given) -> uint32 [height, width]
    0xAARRGGBB, as libwebp decodes it. Raises ValueError where libwebp
    fails."""
    return _webp_call("vt_webp_vp8l_decode", data, width, height,
                      np.zeros((height, width), np.uint32))


def webp_alph_decode(data, width, height):
    """An ALPH chunk's payload -> uint8 [height, width] alpha, as libwebp
    decodes it (raw or VP8L-coded, unfiltered). Raises ValueError where
    libwebp fails."""
    return _webp_call("vt_webp_alph_decode", data, width, height,
                      np.zeros((height, width), np.uint8))


def webp_vp8_decode(data, width, height):
    """A VP8 key frame (the chunk's payload through the end of the data
    libwebp is given) -> uint8 [height, width, 3] RGB, as libwebp decodes
    it (loop filter, "fancy" chroma upsampling). Raises ValueError where
    libwebp fails."""
    return _webp_call("vt_webp_vp8_decode", data, width, height,
                      np.zeros((height, width, 3), np.uint8))


def webp_coverage(reset=False):
    """The WebP decoders' path counters since the last reset: int64 [66]
    (the layout is `csrc/webp_codec.cpp`'s `Cov`)."""
    out = np.zeros(66, np.int64)
    n = _library().vt_webp_coverage(out.ctypes.data, int(reset))
    return out[:n]


def _run(fn, inputs, n, max_leaf):
    """Call a builder entry point; returns the flat arrays of the tree."""
    F = ctypes.POINTER(ctypes.c_float)
    I = ctypes.POINTER(ctypes.c_int32)
    cap = max(2 * n, 2)
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    first, count, skip, axis = (np.empty(cap, np.int32) for _ in range(4))
    order = np.empty(max(n, 1), np.int32)
    nn = fn(*(a.ctypes.data_as(F) for a in inputs), n, max_leaf,
            lo.ctypes.data_as(F), hi.ctypes.data_as(F),
            first.ctypes.data_as(I), count.ctypes.data_as(I),
            skip.ctypes.data_as(I), order.ctypes.data_as(I),
            axis.ctypes.data_as(I))
    if nn <= 0:
        raise ValueError(f"the BVH builder returned {nn} nodes for {n} prims")
    return dict(lo=lo[:nn].copy(), hi=hi[:nn].copy(), first=first[:nn].copy(),
                count=count[:nn].copy(), skip=skip[:nn].copy(),
                axis=axis[:nn].copy(), order=order[:n].copy())


def build_bvh_native(p0, p1, p2, max_leaf=4):
    """Binned-SAH BVH over triangles. Returns a dict of flat arrays:
    lo/hi [N,3] f32, first/count/skip/axis [N] i32 (axis: split axis of an
    inner node, -1 for a leaf; the left child covers the lower side of it),
    order [T] i32 (leaf ranges are contiguous in it)."""
    a = [np.ascontiguousarray(x, np.float32) for x in (p0, p1, p2)]
    return _run(_library().vt_build_bvh, a, len(a[0]), max_leaf)


def build_bvh_boxes_native(lo, hi, max_leaf=1):
    """The same tree over boxes lo/hi [N,3] (the TLAS over instance
    bounds); `order` permutes box ids."""
    a = [np.ascontiguousarray(x, np.float32) for x in (lo, hi)]
    return _run(_library().vt_build_bvh_boxes, a, len(a[0]), max_leaf)
