"""ctypes bindings of the port's host library: the SAH BVH builder
(`native/bvh_builder.cpp`), the OBJ parser (`csrc/mesh_io.cpp`), the
JPEG entropy decoder (`csrc/jpeg_huff.cpp`), the serial stages of the
OpenEXR, TIFF (SGILog among them) and GIF codecs
(`csrc/image_codecs.cpp`), the WebP bitstream decoders
(`csrc/webp_codec.cpp`), JPEG 2000's tier-1 (`csrc/j2k_codec.cpp`,
and `csrc/j2k_ht.cpp` for Part 15's HT code-blocks) and the tiles of
AV1 intra frames with their deblocking filter (`csrc/av1_codec.cpp`).

Counterpart of `vision_tpu/native.py` (`build_bvh_native`,
`build_bvh_boxes_native`, `load_obj_native`) for the port, which may not
import the JAX package. At first use the eight sources are compiled with
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
           os.path.join(_HERE, "csrc", "webp_codec.cpp"),
           os.path.join(_HERE, "csrc", "j2k_codec.cpp"),
           os.path.join(_HERE, "csrc", "j2k_ht.cpp"),
           os.path.join(_HERE, "csrc", "av1_codec.cpp")]
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
                                            P, P, P, P] + \
            [ctypes.c_int32] * 8 + [P]
        lib.vt_jpeg_decode_scan.restype = ctypes.c_int64
        lib.vt_ojpeg_decode_scan.argtypes = [
            P, ctypes.c_int64, ctypes.c_int32, P, P, P, P] + \
            [ctypes.c_int32] * 3 + [P]
        lib.vt_ojpeg_decode_scan.restype = ctypes.c_int64
        lib.vt_jpeg_decode_arith_scan.argtypes = [
            P, ctypes.c_int64, ctypes.c_int32, P, P, P] + \
            [ctypes.c_int32] * 8 + [P]
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
        lib.vt_bc7_decode.argtypes = [P, ctypes.c_int64, P]
        lib.vt_bc7_decode.restype = None
        lib.vt_bc6h_decode.argtypes = [P, ctypes.c_int64, ctypes.c_int32, P]
        lib.vt_bc6h_decode.restype = None
        lib.vt_fax_decode.argtypes = [P, ctypes.c_int64, ctypes.c_int64, P,
                                      ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, P, ctypes.c_int32, P]
        lib.vt_fax_decode.restype = ctypes.c_int32
        lib.vt_zstd_decode.argtypes = [P, ctypes.c_int64, P, ctypes.c_int64]
        lib.vt_zstd_decode.restype = ctypes.c_int64
        lib.vt_thunder_decode.argtypes = [P, ctypes.c_int64, P,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int64]
        lib.vt_thunder_decode.restype = ctypes.c_int32
        lib.vt_fli_decode.argtypes = [P, ctypes.c_int64, P, ctypes.c_int64,
                                      ctypes.c_int64]
        lib.vt_fli_decode.restype = ctypes.c_int64
        lib.vt_sgilog_decode.argtypes = [P, ctypes.c_int64, P, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int32]
        lib.vt_sgilog_decode.restype = ctypes.c_int64
        lib.vt_j2k_t1_decode.argtypes = [P, ctypes.c_int64, P, P, P, P]
        lib.vt_j2k_t1_decode.restype = ctypes.c_int64
        lib.vt_j2k_ht_decode.argtypes = [P, ctypes.c_int64, P, P, P, P, P]
        lib.vt_j2k_ht_decode.restype = ctypes.c_int64
        lib.vt_av1_decode_frame.argtypes = [P, ctypes.c_int64, P, P, P, P, P]
        lib.vt_av1_decode_frame.restype = ctypes.c_int64
        lib.vt_av1_coverage.argtypes = [P, ctypes.c_int32]
        lib.vt_av1_coverage.restype = None
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
    Se, Ah, Al) of a progressive one. Returns (the offset in `data` of the
    marker that ends the scan, the iMCU row of the last MCU begun before
    the data ran out: libjpeg's last_good_iMCU_row)."""
    buf = np.frombuffer(data, np.uint8)
    comps = np.ascontiguousarray(comps, np.int32)
    bits = np.ascontiguousarray(bits, np.uint8)
    vals = np.ascontiguousarray(vals, np.uint8)
    _check_planes(planes, comps)
    ptrs = (ctypes.c_void_p * len(planes))(*(p.ctypes.data for p in planes))
    good = ctypes.c_int32(0)
    rc = _library().vt_jpeg_decode_scan(
        buf.ctypes.data + start, len(buf) - start, len(planes),
        comps.ctypes.data, ptrs, bits.ctypes.data, vals.ctypes.data,
        mcux, mcuy, restart, prog is not None, *(prog or (0, 63, 0, 0)),
        ctypes.byref(good))
    return start + _scan_end(rc), good.value


def ojpeg_decode_scan(data, start, comps, planes, bits, vals, mcux, mcuy,
                      restart):
    """Huffman-decode the sequential scan of the stream libtiff's
    old-style JPEG codec hands libjpeg (`csrc/jpeg_huff.cpp`), with the
    arguments of `jpeg_decode_scan`: a restart marker other than the one
    due, or data that runs past the stream's end, stops the decoding with
    libjpeg's error. Returns (the offset in `data` of the marker that ends
    the scan, the MCU at which libjpeg stopped, or None)."""
    buf = np.frombuffer(data, np.uint8)
    comps = np.ascontiguousarray(comps, np.int32)
    bits = np.ascontiguousarray(bits, np.uint8)
    vals = np.ascontiguousarray(vals, np.uint8)
    _check_planes(planes, comps)
    ptrs = (ctypes.c_void_p * len(planes))(*(p.ctypes.data for p in planes))
    failed = ctypes.c_int64(-1)
    rc = _library().vt_ojpeg_decode_scan(
        buf.ctypes.data + start, len(buf) - start, len(planes),
        comps.ctypes.data, ptrs, bits.ctypes.data, vals.ctypes.data,
        mcux, mcuy, restart, ctypes.byref(failed))
    if rc in (-3, -6):
        return None, failed.value
    return start + _scan_end(rc), None


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
                              "or a table outside 0-3",
                          -6: "JPEG data cut short by the file's end (PIL "
                              "refuses it as truncated)"}[rc])
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
    good = ctypes.c_int32(0)
    rc = _library().vt_jpeg_decode_arith_scan(
        buf.ctypes.data + start, len(buf) - start, len(planes),
        comps.ctypes.data, ptrs, cond.ctypes.data, mcux, mcuy, restart,
        prog is not None, *(prog or (0, 63, 0, 0)), ctypes.byref(good))
    return start + _scan_end(rc), good.value


def jpeg_decode_lossless(data, start, tables, planes, bits, vals, restart,
                         psv, pt, sampling=None, mcus=None):
    """Decode one lossless JPEG scan (`csrc/jpeg_huff.cpp`) as libjpeg-turbo
    does: tables, each component's DC table (0-3); planes, each
    component's uint16 [height, width] samples at its own size, written in
    place; bits / vals as for `jpeg_decode_scan`; restart: MCUs an
    interval (0 none); psv: the predictor (1-7); pt: the point transform;
    sampling: each component's (h, v) (1x1 when None); mcus: the frame's
    (MCUs a row, MCU rows), an MCU hmax x vmax samples (the first plane's
    width and height when None). A scan of one component is
    non-interleaved (an MCU one sample, v rows an iMCU row). Returns the
    offset in `data` of the marker that ends the scan."""
    buf = np.frombuffer(data, np.uint8)
    tables = np.ascontiguousarray(tables, np.int32)
    bits = np.ascontiguousarray(bits, np.uint8)
    vals = np.ascontiguousarray(vals, np.uint8)
    if not 1 <= len(planes) <= 4 or tables.shape != (len(planes),):
        raise ValueError("a JPEG scan holds 1 to 4 components, a DC table "
                         "each")
    for p in planes:
        if p.dtype != np.uint16 or not p.flags.c_contiguous or p.ndim != 2:
            raise ValueError("sample planes must be C-contiguous uint16 "
                             "[height, width]")
    sampling = sampling or [(1, 1)] * len(planes)
    mcux, mcuy = mcus or (planes[0].shape[1], planes[0].shape[0])
    comp = np.array([[t, h, v, p.shape[1], p.shape[0]] for t, (h, v), p in
                     zip(tables, sampling, planes)], np.int32)
    ptrs = (ctypes.c_void_p * len(planes))(*(p.ctypes.data for p in planes))
    rc = _library().vt_jpeg_decode_lossless(
        buf.ctypes.data + start, len(buf) - start, len(planes),
        comp.ctypes.data, ptrs, bits.ctypes.data, vals.ctypes.data, mcux,
        mcuy, restart, psv, pt)
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
    """LZW -> (uint8 [at most n_out], whether it decoded without an error):
    msb=True, TIFF's (9- to 12-bit codes, most significant bit first, the
    early width change); msb=False, GIF's and old-style TIFF's (least
    significant bit first, codes from min_bits + 1 bits). Stops at the end
    code, at n_out bytes or where the data ends; at a code not yet in the
    table it gives the bytes before it and False."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    n = _library().vt_lzw_decode(buf.ctypes.data, len(data), out.ctypes.data,
                                 n_out, min_bits, int(msb))
    return (out[:n], True) if n >= 0 else (out[:-2 - n], False)


def packbits_decode(data, n_out):
    """TIFF PackBits -> uint8 [at most n_out] (fewer where the data ends)."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    n = _library().vt_packbits_decode(buf.ctypes.data, len(data),
                                      out.ctypes.data, n_out)
    return out[:n]


def fax_runs(rowpixels, two_d):
    """libtiff's CCITT state of a directory (Fax3SetupState): 2 x nruns
    zeroed run words, nruns the row's pixels + 1 rounded up to 32, doubled
    where rows refer to the row before; then its no-EOL flag."""
    nruns = -(-(rowpixels + 1) // 32) * 32 * (2 if two_d else 1)
    return np.zeros(2 * nruns + 1, np.uint32)


def fax_decode(data, n_out, rowpixels, rowbytes, kind, opts, runs, parity):
    """One strip or tile of CCITT RLE (kind 2), RLEW (32771), Group 3 (3,
    `opts` its T4Options) or Group 4 (4) data, as libtiff's tif_fax3.c
    decodes it -> (uint8 [n_out], libtiff's result: 1 success, -1 failure
    (the rows before it written), 2 a Group 4 strip ended early with
    success, -2 a fraction of a row; the rows written). `runs`: the
    directory's `fax_runs` buffer, updated in place; `parity`: the strip's
    file offset mod 2."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    done = np.zeros(1, np.int64)
    rc = _library().vt_fax_decode(buf.ctypes.data, len(data), parity,
                                  out.ctypes.data, n_out, rowpixels, rowbytes,
                                  kind, opts, runs.ctypes.data,
                                  (len(runs) - 1) // 2, done.ctypes.data)
    return out[:n_out], rc, int(done[0])


def zstd_decode(data, n_out):
    """libtiff's ZSTDDecode (libzstd's streaming decoder, RFC 8878) of one
    strip or tile -> (uint8 [at most n_out], whether libzstd decoded it
    without an error)."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    n = _library().vt_zstd_decode(buf.ctypes.data, len(data),
                                  out.ctypes.data, n_out)
    return (out[:n], True) if n >= 0 else (out[:0], False)


def thunder_decode(data, n_out, width, rowbytes):
    """libtiff's ThunderScan decoder of one strip -> (uint8 [n_out], rows
    of 4-bit pixels as far as written, whether it succeeded)."""
    buf = _bytes(data)
    out = np.zeros(max(n_out, 1), np.uint8)
    rc = _library().vt_thunder_decode(buf.ctypes.data, len(data),
                                      out.ctypes.data, n_out, width, rowbytes)
    return out[:n_out], rc == 1


def fli_decode(buf, img):
    """One call of PIL's FLI frame decoder (FliDecode.c) on the bytes
    `buf` into `img` (uint8 [h, w], written in place) -> the bytes it
    consumed (>= 0) where it asks for more data, -1 at the frame's end,
    -2 where it fails."""
    data = _bytes(buf)
    return int(_library().vt_fli_decode(data.ctypes.data, len(buf),
                                        img.ctypes.data, img.shape[1],
                                        img.shape[0]))


def sgilog_decode(data, npixels, nrows, kind):
    """One strip or tile of SGILog data, as libtiff's tif_luv.c decodes it
    a row at a time: kind 16 (LogL16, two run-length coded byte planes), 32
    (LogLuv32, four) or 24 (LogLuv24, three raw bytes a pixel) -> (uint32
    [nrows, npixels] codes, the rows decoded whole: the rest are zeros, a
    short count libtiff's "Not enough data" error)."""
    buf = _bytes(data)
    out = np.zeros((max(nrows, 1), max(npixels, 1)), np.uint32)
    done = _library().vt_sgilog_decode(buf.ctypes.data, len(data),
                                       out.ctypes.data, npixels, nrows, kind)
    return out[:nrows, :npixels], int(done)


def j2k_t1_decode(data, info, segs, steps, out):
    """JPEG 2000 code-blocks through tier-1 as OpenJPEG 2.5 decodes them
    (`csrc/j2k_codec.cpp`), each written into `out` (int32 for the 5/3
    path, float32 for the 9/7) at its offset: info int64 [n, 12] (see
    `vt_j2k_t1_decode`), segs int64 (length, passes) pairs, steps float32
    [n]. Returns None, or the index of the first code-block OpenJPEG
    refuses."""
    buf = _bytes(data + b"\0\0")
    info = np.ascontiguousarray(info, np.int64)
    segs = np.ascontiguousarray(segs, np.int64)
    steps = np.ascontiguousarray(steps, np.float32)
    assert out.flags.c_contiguous and out.itemsize == 4
    n = len(info)
    done = _library().vt_j2k_t1_decode(buf.ctypes.data, n, info.ctypes.data,
                                       segs.ctypes.data, steps.ctypes.data,
                                       out.ctypes.data)
    return None if done == n else int(done)


# why OpenJPEG's HT block decoder stops (`csrc/j2k_ht.cpp`), as its
# messages say it
HT_REFUSALS = {1: "ROI in an HT code-block",
               2: "more than 3 coding passes",
               3: "more than 30 bit-planes",
               4: "more zero bit-planes than bit-planes",
               5: "invalid code-block length values",
               6: "not 2 <= Scup <= min(Lcup, 4079)",
               7: "an incorrect MEL segment sequence",
               8: "U_q larger than the zero bit-planes + 1",
               9: "VLC code producing significant samples outside the "
                  "code-block"}


def j2k_ht_decode(data, info, segs, steps, out):
    """JPEG 2000 HT code-blocks (Part 15) as OpenJPEG 2.5's HT decoder
    decodes them (`csrc/j2k_ht.cpp`), each written into `out` (int32 for
    the 5/3 path, float32 for the 9/7) at its offset: info int64 [n, 14]
    (see `vt_j2k_ht_decode`), segs int64 (length, passes) pairs, steps
    float32 [n]. Returns None, or (the index of the first code-block
    OpenJPEG refuses, why: `HT_REFUSALS`)."""
    buf = _bytes(data)
    info = np.ascontiguousarray(info, np.int64)
    segs = np.ascontiguousarray(segs, np.int64)
    steps = np.ascontiguousarray(steps, np.float32)
    assert out.flags.c_contiguous and out.itemsize == 4
    why = np.zeros(1, np.int32)
    n = len(info)
    done = _library().vt_j2k_ht_decode(buf.ctypes.data, n, info.ctypes.data,
                                       segs.ctypes.data, steps.ctypes.data,
                                       out.ctypes.data, why.ctypes.data)
    return None if done == n else (int(done), HT_REFUSALS[int(why[0])])


# why dav1d refuses a frame (`csrc/av1_codec.cpp`)
AV1_REFUSALS = {-2: "an AV1 tile past the data",
                -3: "an AV1 block size without a chroma block size (a "
                    "vertical partition in 4:2:2)",
                -4: "an AV1 tile whose symbols run past its data",
                -5: "an AV1 intra block copy vector into its own superblock"}


def av1_decode_frame(data, tiles, prm, width, height, ssx, ssy, mono):
    """The tiles of one AV1 intra frame, then its deblocking filter
    (`csrc/av1_codec.cpp`):
    tiles [(offset, size)] into `data` in raster order, prm the frame's
    parameters (see `vt_av1_decode_frame`; allow_intrabc last), width /
    height the frame's
    4x4-aligned size. Returns [Y, U, V] uint8 planes at that size (U, V
    zero-sized for 4:0:0); raises ValueError where dav1d refuses it."""
    buf = _bytes(data)
    t = np.ascontiguousarray(np.asarray(tiles, np.int64).reshape(-1))
    prm = np.ascontiguousarray(prm, np.int32)
    cw, ch = (0, 0) if mono else (width >> ssx, height >> ssy)
    planes = [np.zeros((height, width), np.uint8),
              np.zeros((max(ch, 1), max(cw, 1)), np.uint8),
              np.zeros((max(ch, 1), max(cw, 1)), np.uint8)]
    rc = _library().vt_av1_decode_frame(
        buf.ctypes.data, len(data), t.ctypes.data, prm.ctypes.data,
        *(p.ctypes.data for p in planes))
    if rc < 0:
        raise ValueError(f"corrupt AVIF: {AV1_REFUSALS[int(rc)]} (dav1d "
                         "refuses it)")
    return planes


def av1_coverage(reset=False):
    """The AV1 decoder's path counters since the last reset: int64 [190]
    (the layout is `csrc/av1_codec.cpp`'s COV_* indices)."""
    out = np.zeros(190, np.int64)
    _library().vt_av1_coverage(out.ctypes.data, int(reset))
    return out


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


def bc7_decode(blocks):
    """BC7 blocks (uint8 [n, 16]) -> RGBA uint8 [n, 16, 4], as PIL's
    BcnDecode.c decodes them."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    out = np.zeros((max(len(blocks), 1), 16, 4), np.uint8)
    _library().vt_bc7_decode(blocks.ctypes.data, len(blocks), out.ctypes.data)
    return out[:len(blocks)]


def bc6h_decode(blocks, signed):
    """BC6H blocks (uint8 [n, 16]), unsigned or signed -> RGB uint8
    [n, 16, 3], as PIL's BcnDecode.c gives them: each half clamped to
    [0, 1] and scaled to 8 bits."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    out = np.zeros((max(len(blocks), 1), 16, 3), np.uint8)
    _library().vt_bc6h_decode(blocks.ctypes.data, len(blocks), int(signed),
                              out.ctypes.data)
    return out[:len(blocks)]


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
