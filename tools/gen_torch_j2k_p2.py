"""JPEG 2000 files with Part 2's markers (CBD, MCT, MCC, MCO) and tiles of
fewer resolutions than an earlier tile, for `tests/assets_torch/`.

`tools/gen_torch_j2k.py` writes them with its own files (`p2_files`), so
`j2k_decodes.npz` holds PIL's decode of each and `j2k_cv_decodes.npz` the
pip cv2's (`tools/gen_torch_j2k_cv.py` reads every `j2k_*` file). The
markers are spliced into finished codestreams (`splice`): a codestream of
PIL's encoder or of `J2kWriter`, then CBD, MCT, MCC and MCO segments put
after SIZ, at the end of the main header or after a tile-part's SOT (its
Psot grown to match).

  * `j2k_p2_*`: what PIL 12.1.0 (OpenJPEG 2.5.4) decodes, `j2k_bad_p2_*`
    what it refuses; the pip cv2 5.0.0 (OpenJPEG 2.5.3) may decode or
    refuse either under a .hdr / .exr name.
  * `checker_j2kp2.jp2` (the checker, CBD and a main-header MCO offset
    array) and `projector_j2kp2cv.exr` (the projector's RGB, four tiles
    whose tile-part headers carry different MCOs), the twins' files.
  * `edit_cases`: seeded byte edits of some of the files, whose outcomes
    (`edit_digests`) the two .npz files keep under "p2edits:sha256".
  * The tile-resolution files (`j2k_p2_res_*`, `j2k_bad_p2_res_*`): COD,
    COC and POC in tile-part headers. Each library decodes each of them
    `RES_RUNS` times, each time in a child process of its own
    (`res_runs`); the .npz files keep the runs' digests under
    "<name>:runs", and the generator stops if they disagree.

The libraries run in child processes (`library_decodes`), as a broken
file could crash them. The output is deterministic: running it again
writes the same bytes.
"""
import hashlib
import importlib.util
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

SEED = 26
RES_RUNS = 5


def _j2k_module():
    spec = importlib.util.spec_from_file_location(
        "vt_gen_torch_j2k_p2_base", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gen_torch_j2k.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Part 2's marker segments
# ---------------------------------------------------------------------------

def _seg(code, body):
    return struct.pack(">HH", code, len(body) + 2) + body


def cbd(depths, ncbd=None):
    """CBD: Ncbd (the component count unless given), then each component's
    depth byte ((prec - 1) | 0x80 for signed)."""
    return _seg(0xFF78, struct.pack(">H", len(depths) if ncbd is None
                                    else ncbd) + bytes(depths))


def mct(index, etype, values, atype=1, zmct=0, ymct=0):
    """MCT: Zmct, Imct (index | array type << 8 | element type << 10),
    Ymct, then the array (`values` of the element type: 0 int16, 1 int32,
    2 float32, 3 float64)."""
    raw = b"".join(struct.pack((">h", ">i", ">f", ">d")[etype], v)
                   for v in values)
    return _seg(0xFF74, struct.pack(">HHH", zmct, index | atype << 8 |
                                    etype << 10, ymct) + raw)


def mcc(index, ncomp, deco=0, offset=0, reversible=0, zmcc=0, ymcc=0,
        qmcc=1, xmcc=1, wide=False, tail=b""):
    """MCC: one collection of array decorrelation over components
    0..ncomp-1 (Cmcc and Wmcc 2 bytes each where `wide`), Tmcc naming the
    decorrelation and offset MCT records; `tail` bytes after it."""
    n = 2 if wide else 1
    idx = struct.pack(">H", ncomp | (0x8000 if wide else 0)) + b"".join(
        v.to_bytes(n, "big") for v in range(ncomp))
    body = struct.pack(">HBHH", zmcc, index, ymcc, qmcc)
    if qmcc:
        body += bytes([xmcc]) + idx + idx + \
            (reversible << 16 | offset << 8 | deco).to_bytes(3, "big")
    return _seg(0xFF75, body + tail)


def mco(stages, nmco=None):
    return _seg(0xFF77, bytes([len(stages) if nmco is None else nmco]) +
                bytes(stages))


# ---------------------------------------------------------------------------
# splicing into finished codestreams
# ---------------------------------------------------------------------------

def _main_end(cs):
    """The offsets of the end of SIZ and of the main header (the first
    SOT) of a codestream."""
    pos, siz_end = 2, None
    while True:
        m, n = struct.unpack_from(">HH", cs, pos)
        if m == 0xFF90:
            return siz_end, pos
        if m == 0xFF51:
            siz_end = pos + 2 + n
        pos += 2 + n


def splice(cs, after_siz=b"", main_end=b"", tiles=None):
    """A codestream with marker segments put after SIZ, at the end of the
    main header, and after the SOT of each tile's first tile-part
    (`tiles`: tile index -> bytes), each Psot grown by what it got."""
    tiles = tiles or {}
    siz_end, pos = _main_end(cs)
    out = bytearray(cs[:siz_end] + after_siz + cs[siz_end:pos] + main_end)
    seen = set()
    while struct.unpack_from(">H", cs, pos)[0] == 0xFF90:
        tile, psot = struct.unpack_from(">HI", cs, pos + 4)
        end = pos + psot if psot else len(cs) - 2
        extra = tiles.get(tile, b"") if tile not in seen else b""
        seen.add(tile)
        sot = bytearray(cs[pos:pos + 12])
        if psot:
            struct.pack_into(">I", sot, 6, psot + len(extra))
        out += sot + extra + cs[pos + 12:end]
        pos = end
    return bytes(out + cs[pos:])


def in_jp2(jp2_bytes, fn):
    """A JP2 file with its codestream put through `fn`."""
    G = _j2k_module()
    boxes = G.boxes(jp2_bytes)
    return b"\0\0\0\x0cjP  \r\n\x87\n" + b"".join(
        G.box(t, fn(p) if t == b"jp2c" else p) for t, p in boxes[1:])


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def _ident(n):
    """MCT 1: an n x n int16 identity matrix."""
    return mct(1, 0, [1 if i % (n + 1) == 0 else 0 for i in range(n * n)])


def p2_files(prev):
    """The `j2k_p2_*` / `j2k_bad_p2_*` files, from codestreams of
    `prev` (`tools/gen_torch_j2k.py`'s files by name) and of its writers:
    name -> bytes."""
    G = _j2k_module()
    cs_of = G.codestream_of
    rgb = prev["j2k_rgb_rev.j2k"]                 # 45 x 33, 5/3, no MCT
    rgb_mct = cs_of(prev["j2k_rgb_rev_mct.jp2"])  # 5/3, RCT
    irr = cs_of(prev["j2k_rgb_irr_mct.jp2"])      # 9/7, ICT
    grey = prev["j2k_l_rev.j2k"]                  # 37 x 40
    i16 = cs_of(prev["j2k_i16_rev.jp2"])          # 26 x 21, 16 bits
    f = {}
    u8 = [7] * 3
    # CBD: the precision and sign OpenJPEG decodes to
    f["j2k_p2_cbd_same.j2k"] = splice(rgb, cbd(u8))
    f["j2k_p2_cbd7.j2k"] = splice(rgb, cbd([6] * 3))
    f["j2k_p2_cbd_signed.j2k"] = splice(rgb, cbd([0x87] * 3))
    f["j2k_p2_cbd12.j2k"] = splice(rgb_mct, cbd([11] * 3))
    f["j2k_p2_cbd_mixed.j2k"] = splice(rgb, cbd([4, 0x89, 15]))
    f["j2k_p2_cbd5_grey.j2k"] = splice(grey, cbd([4]))
    f["j2k_p2_cbd20.jp2"] = G.jp2(splice(rgb_mct, cbd([19] * 3)), 45, 33, 3,
                                   colr=(1, 16))
    f["j2k_p2_cbd_bpcc.jp2"] = G.jp2(splice(rgb_mct, cbd([11] * 3)), 45, 33,
                                     3, bpc=255, colr=(1, 16),
                                     extra=[(b"bpcc", bytes(u8))])
    f["j2k_p2_cbd_i16.jp2"] = G.jp2(splice(i16, cbd([7])), 26, 21, 1,
                                    bpc=15, colr=(1, 17))
    f["j2k_p2_cbd_irr.jp2"] = G.jp2(splice(irr, cbd([9] * 3)), 45, 33, 3,
                                    colr=(1, 16))
    f["j2k_bad_p2_cbd_ncbd.j2k"] = splice(rgb, cbd(u8, ncbd=0x8003))
    f["j2k_bad_p2_cbd_two.j2k"] = splice(rgb, cbd(u8[:2], ncbd=3))
    f["j2k_bad_p2_cbd_prec.j2k"] = splice(rgb, cbd([31, 7, 7]))
    # MCT / MCC / MCO: an MCO resets the DC level shift, an MCC's offset
    # array sets it; a decorrelation matrix is read and checked, never
    # applied (COD's MCT is at most 1)
    off100 = mct(2, 0, [100] * 3, atype=2)
    rec = _ident(3) + off100 + mcc(1, 3, deco=1, offset=2)
    f["j2k_p2_mct_inert.j2k"] = splice(rgb, rec)
    f["j2k_p2_mco_alone.j2k"] = splice(rgb, mco([1]))
    f["j2k_p2_mco_offsets.j2k"] = splice(rgb_mct, rec + mco([1]))
    f["j2k_p2_mco_int32.j2k"] = splice(rgb, mct(
        3, 1, [-40, 2**31 - 1, 300], atype=2) + mcc(4, 3, offset=3) +
        mco([4]))
    f["j2k_p2_mco_int16.j2k"] = splice(rgb, mct(
        3, 0, [-1, 200, 60], atype=2) + mcc(5, 3, offset=3) + mco([5]))
    f["j2k_p2_mco_f32.j2k"] = splice(rgb, mct(
        3, 2, [99.9, -0.7, float("nan")], atype=2) + mcc(5, 3, offset=3) +
        mco([5]))
    f["j2k_p2_mco_f64.jp2"] = G.jp2(splice(irr, mct(
        7, 3, [140.5, 1e12, -3.99], atype=2) + mcc(2, 3, offset=7),
        main_end=mco([2])), 45, 33, 3, colr=(1, 16))
    f["j2k_p2_mco_end.j2k"] = splice(rgb, rec, main_end=mco([1]))
    f["j2k_p2_mco_tile.j2k"] = splice(rgb, rec, tiles={0: mco([1])})
    f["j2k_p2_mco_second.j2k"] = splice(rgb, _ident(3) + off100 +
                                        mcc(1, 3, deco=1) +
                                        mcc(2, 3, offset=2) + mco([2]))
    f["j2k_p2_mco_before_mcc.j2k"] = splice(rgb, off100 + mco([1]) +
                                            mcc(1, 3, offset=2))
    f["j2k_p2_mco_before_cod.j2k"] = splice(rgb, rec + mco([1]))
    f["j2k_p2_mco_stages2.j2k"] = splice(rgb, rec + mco([1, 1]))
    f["j2k_p2_mcc_ncomp.j2k"] = splice(rgb, off100 + mcc(1, 2, offset=2) +
                                       mco([1]))
    f["j2k_p2_mcc_xmcc0.j2k"] = splice(rgb, off100 + mcc(1, 3, offset=2,
                                                         xmcc=0) + mco([1]))
    f["j2k_p2_mcc_wide.j2k"] = splice(rgb, off100 + mcc(
        1, 3, offset=2, wide=True, reversible=1) + mco([1]))
    f["j2k_p2_mcc_qmcc2.j2k"] = splice(rgb, off100 + mcc(1, 3, offset=2,
                                                         qmcc=2) + mco([1]))
    f["j2k_p2_mct_replaced.j2k"] = splice(rgb, off100 + mcc(1, 3, offset=2) +
                                          mct(2, 0, [20, 40, 60], atype=2) +
                                          mco([1]))
    f["j2k_p2_matrix_mct1.j2k"] = splice(rgb_mct, mct(
        1, 2, [0.5, 0, 0, 0.2, 1, 0, 0, 0, 2]) + off100 +
        mcc(1, 3, deco=1, offset=2) + mco([1]))
    f["j2k_p2_zmct.j2k"] = splice(rgb, mct(2, 0, [100] * 3, zmct=1) + mco([1]))
    f["j2k_bad_p2_mcc_missing.j2k"] = splice(rgb, mct(
        2, 0, [100] * 3, zmct=1) + mcc(1, 3, offset=2))
    f["j2k_bad_p2_mct_size.j2k"] = splice(rgb, mct(2, 0, [100] * 4) +
                                          mcc(1, 3, offset=2) + mco([1]))
    f["j2k_bad_p2_mct_ymct.j2k"] = splice(rgb, mct(2, 0, [100] * 3, ymct=1) +
                                          mcc(1, 3, offset=2) + mco([1]))
    f["j2k_bad_p2_mcc_size.j2k"] = splice(rgb, off100 + mcc(
        1, 3, offset=2, tail=b"\0") + mco([1]))
    f["j2k_bad_p2_mco_size.j2k"] = splice(rgb, rec + mco([1], nmco=0))
    # tiles whose tile-part headers carry their own MCT / MCC / MCO
    f["j2k_p2_tiles_mco.j2k"] = tiles_mco(G, G._smooth(
        np.random.default_rng(SEED), 40, 44, 3), (24, 20))
    f["j2k_p2_grey12_mco.j2k"] = G.J2kWriter(
        24, 20, [(12, 0, 1, 1)], G._rev(3, 12, cblk=(4, 4)) +
        mct(1, 0, [3000], atype=2) + mcc(1, 1, offset=1) + mco([1]), 261,
        bits=10).build()
    f.update(res_files(G))
    return f


def tiles_mco(G, img, tile):
    """A tiled RGB codestream (PIL's encoder, 5/3, RCT) whose tiles carry
    different MCOs: tile 0 none (SIZ's shift), tile 1 int16 offsets,
    tile 2 an MCO that names no MCC (shift 0), tile 3 float32 offsets;
    later tiles keep SIZ's."""
    cs = G.pil_encode(img, tile_size=tile, mct=1, no_jp2=True)
    return splice(cs, tiles={
        1: mct(1, 0, [100, 128, 160], atype=2) + mcc(1, 3, offset=1) +
        mco([1]),
        2: mco([1]),
        3: mct(2, 2, [140.7, 90.2, 200.9], atype=2) + mcc(3, 3, offset=2) +
        mco([3])})


def res_files(G):
    """Tiles with fewer resolutions than an earlier tile decoded (COD and
    COC in tile-part headers), and a tile whose POC stops short after a
    whole tile: OpenJPEG takes each tile's resno_decoded afresh."""
    one, rgb = [(8, 0, 1, 1)], [(8, 0, 1, 1)] * 3
    hdr = G._rev(3, cblk=(4, 4))
    steps = [(9, 100)] + [(9, 50), (9, 60), (10, 10)] * 2
    f = {}
    f["j2k_p2_res_3_2.j2k"] = G.J2kWriter(
        32, 16, one, hdr, 262, tile=(16, 16),
        tile_headers={1: G.cod(2, cblk=(4, 4))}).build()
    f["j2k_p2_res_4123.j2k"] = G.J2kWriter(
        30, 29, one, G._rev(4, cblk=(4, 4)), 263, tile=(16, 16),
        tile_headers={1: G.cod(1, cblk=(4, 4)), 2: G.cod(2, cblk=(4, 4)),
                      3: G.cod(3, cblk=(4, 4))}).build()
    f["j2k_p2_res_coc.j2k"] = G.J2kWriter(
        32, 16, rgb, hdr, 264, tile=(16, 16),
        tile_headers={1: G.coc(1, 1, cblk=(4, 4))}).build()
    f["j2k_p2_res_poc.j2k"] = G.J2kWriter(
        32, 16, one, hdr, 265, tile=(16, 16),
        tile_headers={1: G.cod(4, cblk=(4, 4)) +
                      G.qcd(0, 2, G.rev_steps(4, 8)) +
                      G.poc([(0, 0, 1, 2, 1, 0)])}).build()
    f["j2k_p2_res_irr.j2k"] = G.J2kWriter(
        32, 16, one, G.cod(3, qmf=0) + G.qcd(2, 2, steps), 266,
        tile=(16, 16), tile_headers={1: G.cod(1, qmf=0)}).build()
    f["j2k_bad_p2_res_mct.j2k"] = G.J2kWriter(
        32, 16, rgb, G._rev(3, cblk=(4, 4), mct=1), 267, tile=(16, 16),
        tile_headers={1: G.coc(2, 2, cblk=(4, 4))}).build()
    return f


def checker_twin(checker_rgb):
    """`checker_j2kp2.jp2`: the checker (PIL's encoder, 5/3), its CBD
    giving 9-bit samples and its main header's MCO int16 offsets."""
    G = _j2k_module()
    return in_jp2(G.pil_encode(checker_rgb), lambda cs: splice(
        cs, cbd([8] * 3), main_end=mct(5, 0, [170, 150, 210], atype=2) +
        mcc(9, 3, offset=5) + mco([9])))


def projector_twin(projector_rgb):
    """`projector_j2kp2cv.exr`: the projector's RGB as `tiles_mco` tiles
    of 64 x 32."""
    return tiles_mco(_j2k_module(), projector_rgb, (64, 32))


# ---------------------------------------------------------------------------
# seeded edits, and the libraries' outcomes in child processes
# ---------------------------------------------------------------------------

EDIT_SOURCES = ("j2k_p2_cbd12.j2k", "j2k_p2_mco_offsets.j2k",
                "j2k_p2_mco_f64.jp2", "j2k_p2_tiles_mco.j2k",
                "j2k_p2_mct_inert.j2k", "j2k_p2_cbd_bpcc.jp2",
                "j2k_p2_res_4123.j2k", "j2k_p2_mcc_wide.j2k")
EDITS_EACH = 25


def _header_end(data):
    """The end of the first tile-part header (its SOD) of a JP2 file or
    codestream: the bytes Part 2's markers live in."""
    return data.index(b"\xff\x93") + 2


def edit_cases(files):
    """EDITS_EACH seeded edits of each file of EDIT_SOURCES (`files`: name
    -> bytes): a cut, or one or two bytes replaced or with a bit flipped,
    two edits in three inside the headers -> [(source, bytes)], in
    order."""
    out = []
    for si, fn in enumerate(EDIT_SOURCES):
        src = files[fn]
        head = _header_end(src)
        g = np.random.default_rng(SEED * 1000 + si)
        for _ in range(EDITS_EACH):
            d = bytearray(src)
            kind = int(g.integers(3))
            hi = head if g.random() < 2 / 3 else len(d)
            if kind == 0:
                d = d[:int(g.integers(1, hi))]
            else:
                for _ in range(int(g.integers(1, 3))):
                    i = int(g.integers(0, hi))
                    d[i] = int(g.integers(0, 256)) if kind == 1 else \
                        d[i] ^ (1 << int(g.integers(8)))
            out.append((fn, bytes(d)))
    return out


def digest(img):
    """The sha256 of a decode (its shape, then its samples as float32), or
    32 zero bytes for a refusal."""
    if img is None:
        return bytes(32)
    img = np.ascontiguousarray(img, np.float32)
    return hashlib.sha256(str(img.shape).encode() + img.tobytes()).digest()


_PIL = (
    "import os, sys, warnings\n"
    "import numpy as np\n"
    "from PIL import Image\n"
    "warnings.filterwarnings('ignore')\n"
    "d = sys.argv[1]\n"
    "for fn in sorted(os.listdir(d)):\n"
    "    try:\n"
    "        with Image.open(os.path.join(d, fn)) as im:\n"
    "            a = np.asarray(im.convert('RGB'))\n"
    "    except Exception:\n"
    "        continue\n"
    "    np.save(os.path.join(d, fn + '.npy'), a)\n")

_CV = (
    "import os, sys\n"
    "import numpy as np\n"
    "import cv2\n"
    "d = sys.argv[1]\n"
    "for fn in sorted(os.listdir(d)):\n"
    "    try:\n"
    "        a = cv2.imread(os.path.join(d, fn), cv2.IMREAD_ANYCOLOR | "
    "cv2.IMREAD_ANYDEPTH)\n"
    "    except cv2.error:\n"
    "        a = None\n"
    "    if a is not None:\n"
    "        a = a.astype(np.float32)\n"
    "        a = np.stack([a] * 3, -1) if a.ndim == 2 else a[..., 2::-1]\n"
    "        np.save(os.path.join(d, fn + '.npy'), a)\n")


def library_decodes(named, lib):
    """{name: bytes} -> {name: PIL's convert("RGB") (lib "pil", the files
    named .j2k) or what the JAX package's loader gets through the pip cv2
    (lib "cv", named .exr: float32 RGB), None where it refuses}, one child
    process for all."""
    tmp = tempfile.mkdtemp()
    try:
        keys = sorted(named)
        ext = ".exr" if lib == "cv" else ".j2k"
        for i, k in enumerate(keys):
            with open(os.path.join(tmp, f"{i:05d}{ext}"), "wb") as fh:
                fh.write(named[k])
        subprocess.run([sys.executable, "-c", _CV if lib == "cv" else _PIL,
                        tmp], check=True, capture_output=True)
        out = {}
        for i, k in enumerate(keys):
            p = os.path.join(tmp, f"{i:05d}{ext}.npy")
            out[k] = np.load(p) if os.path.exists(p) else None
        return out
    finally:
        for fn in os.listdir(tmp):
            os.remove(os.path.join(tmp, fn))
        os.rmdir(tmp)


def edit_digests(files, lib):
    """The library's outcome of each of `edit_cases(files)`: uint8 [n, 32],
    `digest` of its decode."""
    edits = edit_cases(files)
    dec = library_decodes({f"{i:04d}": d for i, (_, d) in
                           enumerate(edits)}, lib)
    return np.array([np.frombuffer(digest(dec[f"{i:04d}"]), np.uint8)
                     for i in range(len(edits))])


def res_runs(files, lib):
    """RES_RUNS decodes of each tile-resolution file, each in a child
    process of its own -> {name: uint8 [RES_RUNS, 32] digests}; raises
    where the runs of a file disagree or one dies (a file OpenJPEG cannot
    decode the same way twice has no outcome to hold the port to)."""
    out = {}
    for fn in sorted(f for f in files if "_p2_res_" in f):
        runs = [digest(library_decodes({fn: files[fn]}, lib)[fn])
                for _ in range(RES_RUNS)]
        if len(set(runs)) != 1:
            raise RuntimeError(f"{lib} decodes {fn} otherwise run by run")
        out[fn] = np.array([np.frombuffer(r, np.uint8) for r in runs])
    return out
