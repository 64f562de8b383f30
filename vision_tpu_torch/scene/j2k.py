"""JPEG 2000 (Part 1, Part 2's CBD, MCT, MCC and MCO markers, and Part
15's HT code-blocks) as the JAX package's loader gets it under any name
but .hdr / .exr: `PIL.Image.open(p).convert("RGB")`, PIL 12.1.0's
Jpeg2KImagePlugin over OpenJPEG 2.5.4 (the counterpart of PIL's plugin,
its Jpeg2KDecode.c and the library it drives).

Three layers, each as its reference runs it:

  * PIL's plugin (`_open`): the codestream's SIZ or the JP2 header boxes
    give the mode (L, I;16, LA, RGB, RGBA; CMYK from a colr box; P / PA
    from a pclr box of at most 8 bits, its palette built as
    `ImagePalette.getcolor` builds it) and the size; what its reading
    raises decides whether the next plugin is tried.
  * OpenJPEG (`_Jp2`, `_Codestream`, `_decode_tile`): the JP2 boxes
    (`opj_jp2_read_header_procedure`) and the colour space they give; the main header and the tile-part
    headers with their checks (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM,
    PPT, TLM, PLM, PLT, CRG, COM, and Part 2's CBD, MCT, MCC and MCO:
    CBD sets the precision and sign each component is decoded to, an
    MCO resets each component's DC level shift in the main header's or
    its tile's coding parameters, and the offset array of its MCC sets
    it; a decorrelation matrix is checked, never applied, as COD's MCT
    is at most 1); tiles read and decoded as
    `opj_read_tile_header` / `opj_decode_tile_data` hand them to PIL (a
    tile decoded when its last tile-part is read, the rest at EOC; the
    codestream must go on with SOT or EOC after each); tier-2 (tag trees,
    layers, Lblock, codeword segments under each code-block style, SOP and
    EPH, precincts, the five progressions and POC, packet headers in PPM /
    PPT; each component's resno_decoded, the highest resolution a packet
    of the tile was read for, taken afresh in each tile); tier-1, ROI and
    the coefficients in `csrc/j2k_codec.cpp`
    (`native.j2k_t1_decode`); the inverse 5/3 wavelet in integers and the
    9/7 in float32 with OpenJPEG's lifting constants and order (its
    high-pass scaled by 2 / K, its step sizes without the band gain); RCT,
    ICT in float32; the tile's DC level shifts, lrintf and the clamp to
    each component's precision; each tile's components packed as
    `opj_tcd_update_tile_data` packs them (1, 2 or 4 bytes a sample).
    OpenJPEG's decoder runs in strict mode: a stream cut short fails.
  * PIL's unpackers (`_unpack`): picked by the mode, the colour space
    (unspecified, unknown or an ICC profile: grey for one or two
    components, sRGB for three or four, sYCC when component 0 is whole
    and component 1 or 2 sub-sampled) and the component count (the grey
    ones take no sub-sampling; the others read rows of w / dx samples of
    OpenJPEG's buffer); each sample shifted from its precision to 8 (16
    for I;16) bits with its signed offset and rounding; sYCC through
    PIL's YCbCr -> RGB; then `convert("RGB")`.

Under a .hdr / .exr name the JAX package's loader reads JPEG 2000 through
OpenCV over OpenJPEG 2.5.3's whole-image API: `WholeImage` drives the
same OpenJPEG layers as opj_read_header / opj_decode do (the tiles
composed into one image, JP2's pclr / cmap / cdef applied, the colour
space from colr), and `cvj2k.py` converts its components as OpenCV does.

Part 15 (HTJ2K): CAP and CPF are read and left unused, as OpenJPEG reads
them; a tile-component whose code-block style has the HT bit (0x40) has
its segments read as OpenJPEG's tier-2 reads an HT block's (the first
holds the cleanup pass alone, the next every pass still to come) and its
blocks decoded by `native.j2k_ht_decode` (`csrc/j2k_ht.cpp`, OpenJPEG's
HT block decoder); HTMIXED (0x80) is refused, as both releases refuse it.

What PIL refuses raises ValueError (the JAX package's slot takes its
default).
"""
from __future__ import annotations

import copy
import dataclasses
import struct

import numpy as np

from .. import native
from .pilread import _PassOn, _opened, _rgb, _ycbcr_to_rgb

_FMT = "JPEG2000"
_J2K_SIG = b"\xffO\xffQ"
_JP2_SIG = b"\0\0\0\x0cjP  \r\n\x87\n"

# OpenJPEG's 9/7 constants (dwt.c): K, the historical 2 / K of
# BUG_WEIRD_TWO_INVK, and the lifting steps
_K = np.float32(1.230174105)
_TWO_INVK = np.float32(1.625732422)
_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)

_LRCP, _RLCP, _RPCL, _PCRL, _CPRL = range(5)
_MAXRLVLS = 33
_MAXBANDS = 3 * _MAXRLVLS - 2

# colour spaces (OPJ_COLOR_SPACE)
_UNSPECIFIED, _SRGB, _GRAY, _SYCC, _EYCC, _CMYK = range(6)


def _refused(what):
    return ValueError(f"JPEG 2000 file {what}: PIL (the JAX package's "
                      "reader) refuses it too")


class _Fail(Exception):
    """OpenJPEG returns false: PIL's decoder reports a broken stream."""


# ---------------------------------------------------------------------------
# PIL's plugin (Jpeg2KImagePlugin)
# ---------------------------------------------------------------------------

class _Fp:
    """A file object over bytes: reads past the end come back short."""

    def __init__(self, data, pos=0):
        self.data, self.pos = data, pos

    def read(self, n):
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def seek(self, off):
        if self.pos + off < 0:
            raise _Fail("negative seek")      # OSError / ValueError in PIL
        self.pos += off

    def tell(self):
        return self.pos


class _BoxReader:
    """PIL's BoxReader, raising as it raises: SyntaxError -> _PassOn,
    OSError -> ValueError, struct.error -> _PassOn."""

    def __init__(self, fp, length=-1):
        self.fp, self.has_length, self.length = fp, length >= 0, length
        self.remaining = -1

    def _can_read(self, n):
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def read_bytes(self, n):
        if not self._can_read(n):
            raise _PassOn("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise _refused("whose header is cut short")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt):
        return struct.unpack(fmt, self.read_bytes(struct.calcsize(fmt)))

    def boxes(self):
        size = self.remaining
        return _BoxReader(_Fp(self.read_bytes(size)), size)

    def has_next(self):
        if self.has_length:
            return self.fp.tell() + self.remaining < self.length
        return True

    def next_type(self):
        if self.remaining > 0:
            self.fp.seek(self.remaining)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _PassOn("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _parse_codestream(fp):
    hdr = fp.read(2)
    if len(hdr) < 2:
        raise _PassOn
    lsiz = struct.unpack(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    if len(siz) < 38:
        raise _PassOn
    xsiz, ysiz, xosiz, yosiz = struct.unpack_from(">IIII", siz, 4)
    csiz = struct.unpack_from(">H", siz, 36)[0]
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        if len(siz) < 39:
            raise _PassOn
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise _PassOn("unable to determine J2K image mode")
    return size, mode


def _getcolor_palette(entries, npc):
    """ImagePalette.getcolor over the pclr entries, as the plugin calls it
    (an "RGBA" palette for four columns, else "RGB"): a colour already
    there is not added again, a new one goes at len(palette) // 3 (or 4),
    even where its bytes are not that long -> the palette's RGB rows."""
    size = 4 if npc == 4 else 3
    pal = bytearray()
    colors = {}
    for color in entries:
        if color in colors:
            continue
        index = len(pal) // size
        if index >= 256:
            raise _refused("with more than 256 palette colours")
        colors[color] = index
        if index * size < len(pal):
            pal[index * size:index * size + size] = bytes(color)
        else:
            pal += bytes(color)
    n = len(pal) // size
    return np.frombuffer(bytes(pal[:n * size]), np.uint8).reshape(
        n, size)[:, :3]


def _parse_jp2_header(fp):
    reader = _BoxReader(fp)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise _refused("without a jp2h box")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                colors = [tuple(header.fields(">" + "B" * npc))
                          for _ in range(ne)]
                palette = _getcolor_palette(colors, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise _PassOn("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp):
    while True:
        marker = fp.read(2)
        if not marker:
            return
        if len(marker) < 2:
            raise _PassOn
        if marker[1] in (0x90, 0xD9):
            return
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise _PassOn
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            fp.read(length - 2)
            return
        fp.seek(length - 2)


def _open(data):
    """Jpeg2KImageFile._open -> (codec, (w, h), mode, palette)."""
    fp = _Fp(data, 4)
    palette = None
    try:
        if data[:4] == _J2K_SIG:
            codec = "j2k"
            size, mode = _parse_codestream(fp)
            _parse_comment(fp)
        elif data[:12] == _JP2_SIG:
            codec = "jp2"
            fp.pos = 12
            size, mode, palette = _parse_jp2_header(fp)
            if fp.read(12).endswith(b"jp2c" + _J2K_SIG):
                hdr = fp.read(2)
                if len(hdr) < 2:
                    raise _PassOn
                fp.seek(struct.unpack(">H", hdr)[0] - 2)
                _parse_comment(fp)
        else:
            raise _PassOn("not a JPEG 2000 file")
    except _Fail:
        raise _refused("whose header PIL cannot seek through") from None
    except struct.error:
        raise _PassOn from None
    return codec, size, mode, palette


# ---------------------------------------------------------------------------
# OpenJPEG: the JP2 boxes (jp2.c)
# ---------------------------------------------------------------------------

_JP2_IMG_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


class _Jp2:
    """What opj_jp2_read_header reads before the codestream: the ihdr
    size, the colour space (enumcs) and where the codestream starts."""

    def __init__(self, data):
        self.data = data
        self.state = set()
        self.ihdr = None          # (w, h, numcomps, bpc)
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None          # (entries [NE, NPC] uint32, sizes, signs)
        self.cmap = None          # [(cmp, mtyp, pcol)] a palette column
        self.cdef = None          # [(cn, typ, asoc)]
        self.has_jp2h = False
        self.start = self._read(0)

    def _boxhdr(self, pos):
        d = self.data
        if len(d) - pos < 8:
            return None
        length, typ = struct.unpack_from(">I4s", d, pos)
        if length == 0:
            return len(d) - pos, typ, 8
        if length == 1:
            if len(d) - pos < 16:
                return None
            hi, length = struct.unpack_from(">II", d, pos + 8)
            if hi != 0:
                raise _Fail("box sizes of 2^32 or more")
            return length, typ, 16
        return length, typ, 8

    def _read(self, pos):
        d = self.data
        while True:
            hdr = self._boxhdr(pos)
            if hdr is None:
                return None
            length, typ, nread = hdr
            if typ == b"jp2c":
                if "header" in self.state:
                    return pos + nread
                raise _Fail("bad placed codestream")
            if length == 0:
                raise _Fail("box of undefined size")
            if length < nread:
                raise _Fail("invalid box size")
            size = length - nread
            body = pos + nread
            known = typ in (b"jP  ", b"ftyp", b"jp2h")
            if known or typ in _JP2_IMG_BOXES:
                if not known:
                    if "header" not in self.state:
                        self.state.add("unknown")
                        if len(d) - body < size:
                            raise _Fail("box past the file")
                        pos = body + size
                        continue
                if len(d) - body < size:
                    raise _Fail("box past the file")
                payload = d[body:body + size]
                if typ == b"jP  ":
                    self._jp(payload)
                elif typ == b"ftyp":
                    self._ftyp(payload)
                elif typ == b"jp2h":
                    self._jp2h(payload)
                else:
                    self._img_box(typ, payload)
            else:
                if "signature" not in self.state:
                    raise _Fail("first box not the signature box")
                if "file_type" not in self.state:
                    raise _Fail("second box not the file type box")
                self.state.add("unknown")
                if len(d) - body < size:
                    raise _Fail("box past the file")
            pos = body + size

    def _jp(self, p):
        if self.state:
            raise _Fail("signature box not first")
        if len(p) != 4 or p != b"\r\n\x87\n":
            raise _Fail("bad signature box")
        self.state.add("signature")

    def _ftyp(self, p):
        if self.state != {"signature"}:
            raise _Fail("ftyp box not second")
        if len(p) < 8 or (len(p) - 8) % 4:
            raise _Fail("bad ftyp box")
        self.state.add("file_type")

    def _jp2h(self, p):
        if "file_type" not in self.state:
            raise _Fail("jp2h box before ftyp")
        has_ihdr = False
        pos = 0
        while pos < len(p):
            left = len(p) - pos
            if left < 8:
                raise _Fail("jp2h box cut")
            length, typ = struct.unpack_from(">I4s", p, pos)
            nread = 8
            if length == 1:
                if left < 16:
                    raise _Fail("jp2h box cut")
                hi, length = struct.unpack_from(">II", p, pos + 8)
                if hi != 0 or length == 0:
                    raise _Fail("bad sub-box size")
                nread = 16
            elif length == 0:
                raise _Fail("sub-box of undefined size")
            if length < nread or length > left:
                raise _Fail("sub-box length inconsistent")
            if typ in _JP2_IMG_BOXES:
                self._img_box(typ, p[pos + nread:pos + length])
            if typ == b"ihdr":
                has_ihdr = True
            pos += length
        if not has_ihdr:
            raise _Fail("jp2h box without ihdr")
        self.state.add("header")
        self.has_jp2h = True

    def _img_box(self, typ, p):
        if typ == b"ihdr":
            if self.ihdr is not None:
                return
            if len(p) != 14:
                raise _Fail("bad ihdr size")
            h, w, nc, bpc = struct.unpack_from(">IIHB", p)
            if h < 1 or w < 1 or nc < 1 or nc > 16384:
                raise _Fail("bad ihdr values")
            self.ihdr = (w, h, nc, bpc)
        elif typ == b"colr":
            if len(p) < 3:
                raise _Fail("bad colr size")
            if self.has_colr:
                return
            meth = p[0]
            if meth == 1:
                if len(p) < 7:
                    raise _Fail("bad colr size")
                self.enumcs = struct.unpack_from(">I", p, 3)[0]
                self.has_colr = True
            elif meth == 2:
                self.enumcs = 0
                self.has_colr = True
        elif typ == b"bpcc":
            nc = self.ihdr[2] if self.ihdr else 0
            if len(p) != nc:
                raise _Fail("bad bpcc size")
        elif typ == b"pclr":
            if self.pclr is not None or len(p) < 3:
                raise _Fail("bad pclr box")
            ne, npc = struct.unpack_from(">HB", p)
            if ne == 0 or ne > 1024 or npc == 0 or len(p) < 3 + npc:
                raise _Fail("bad pclr box")
            sizes = [(b & 0x7F) + 1 for b in p[3:3 + npc]]
            widths = [min((n + 7) >> 3, 4) for n in sizes]
            if len(p) < 3 + npc + ne * sum(widths):
                raise _Fail("pclr box cut")
            entries, pos = [], 3 + npc
            for _ in range(ne):
                for n in widths:
                    entries.append(int.from_bytes(p[pos:pos + n], "big"))
                    pos += n
            self.pclr = (np.array(entries, np.uint32).reshape(ne, npc),
                         sizes, [b >> 7 for b in p[3:3 + npc]])
        elif typ == b"cmap":
            if self.pclr is None or self.cmap is not None or \
                    len(p) < 4 * len(self.pclr[1]):
                raise _Fail("bad cmap box")
            self.cmap = [struct.unpack_from(">HBB", p, 4 * i)
                         for i in range(len(self.pclr[1]))]
        elif typ == b"cdef":
            if self.cdef is not None or len(p) < 2:
                raise _Fail("bad cdef box")
            n = struct.unpack_from(">H", p)[0]
            if n == 0 or len(p) < 2 + 6 * n:
                raise _Fail("bad cdef box")
            self.cdef = [struct.unpack_from(">HHH", p, 2 + 6 * i)
                         for i in range(n)]

    def color_space(self):
        """The colour space PIL's decoder gets: one of the five enumerated
        ones, else (another enumcs, an ICC profile, no colr box) guessed
        as for a bare codestream."""
        return {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC,
                12: _CMYK}.get(self.enumcs, _UNSPECIFIED)


# ---------------------------------------------------------------------------
# OpenJPEG: the codestream's headers (j2k.c)
# ---------------------------------------------------------------------------

class _Tccp:
    """A tile-component's coding parameters (opj_tccp_t)."""

    def __init__(self):
        self.csty = 0
        self.numres = 0
        self.cblkw = self.cblkh = 0
        self.cblksty = 0
        self.qmfbid = 0
        self.prcw = [15] * _MAXRLVLS
        self.prch = [15] * _MAXRLVLS
        self.qntsty = 0
        self.numgbits = 0
        self.steps = [(0, 0)] * _MAXBANDS      # (expn, mant)
        self.roishift = 0

    def copy(self):
        c = _Tccp()
        c.__dict__.update(self.__dict__)
        c.prcw, c.prch, c.steps = list(self.prcw), list(self.prch), \
            list(self.steps)
        return c


class _Mct:
    """An MCT record (opj_mct_data_t): Imct's index and element type, its
    array (None once freed: data size 0)."""

    def __init__(self):
        self.index = self.etype = 0
        self.data = None


class _Mcc:
    """An MCC record (opj_simple_mcc_decorrelation_data_t): its index,
    component count and the MCT records it names."""

    def __init__(self):
        self.index = self.nb_comps = 0
        self.deco = self.offset = None


class _Tcp:
    """A tile's coding parameters (opj_tcp_t), its tile-parts and data;
    Part 2's records and each component's DC level shift
    (tccp->m_dc_level_shift: from SIZ, reset by MCO)."""

    def __init__(self, ncomp):
        self.csty = 0
        self.prg = 0
        self.numlayers = 0
        self.mct = 0
        self.tccps = [_Tccp() for _ in range(ncomp)]
        self.shifts = [0] * ncomp
        self.mcts = []
        self.mccs = []
        # the MCC slot after the last record, which keeps what a marker
        # that was not taken wrote there; room for 10 more at a time
        self.mcc_spare = _Mcc()
        self.mcc_room = 10
        self.pocs = []
        self.ppt = {}
        self.part = -1
        self.nparts = 0
        self.data = None

    def copy(self):
        t = _Tcp(0)
        t.__dict__.update(self.__dict__)
        t.tccps = [c.copy() for c in self.tccps]
        t.shifts = list(self.shifts)
        t.mcts = [copy.copy(m) for m in self.mcts]
        remap = {id(a): b for a, b in zip(self.mcts, t.mcts)}

        def mcc(m):
            c = copy.copy(m)
            c.deco = remap.get(id(m.deco))
            c.offset = remap.get(id(m.offset))
            return c
        t.mccs = [mcc(m) for m in self.mccs]
        t.mcc_spare = mcc(self.mcc_spare)
        t.pocs, t.ppt = list(self.pocs), dict(self.ppt)
        return t


# the decoder's states a marker is valid in (J2K_STATE_*)
_MHSIZ, _MH, _TPHSOT, _TPH = 1, 2, 4, 8
_NEOC, _EOC_ST = 16, 32
_SOT, _SOD, _EOC = 0xFF90, 0xFF93, 0xFFD9
_MARKERS = {0xFF90: _MH | _TPHSOT, 0xFF52: _MH | _TPH, 0xFF53: _MH | _TPH,
            0xFF5E: _MH | _TPH, 0xFF5C: _MH | _TPH, 0xFF5D: _MH | _TPH,
            0xFF5F: _MH | _TPH, 0xFF51: _MHSIZ, 0xFF55: _MH, 0xFF57: _MH,
            0xFF58: _TPH, 0xFF60: _MH, 0xFF61: _TPH, 0xFF91: 0, 0xFF63: _MH,
            0xFF64: _MH | _TPH, 0xFF74: _MH | _TPH, 0xFF78: _MH,
            0xFF50: _MH, 0xFF59: _MH, 0xFF75: _MH | _TPH, 0xFF77: _MH | _TPH}
# Part 2's MCT arrays: bytes an element (int16, int32, float32, float64)
_MCT_SIZE = (2, 4, 4, 8)


class _Codestream:
    """opj_j2k_read_header and the tile-part loop of
    opj_j2k_read_tile_header / opj_j2k_decode_tile, over `data` from
    `pos` (the stream runs to the end of the file, as OpenJPEG's does).
    `release` "2.5.3" keeps that release's one rule found to differ from
    2.5.4's: a later SOT cut short fails the tile-part count check."""

    def __init__(self, data, pos, ihdr=None, release="2.5.4"):
        self.d, self.pos, self.end = data, pos, len(data)
        self.ihdr = ihdr
        self.release = release
        self.ppm = None
        self.ppm_markers = {}
        self._main_header()

    # --- stream helpers ---------------------------------------------------
    def left(self):
        return self.end - self.pos

    def read(self, n):
        if self.left() < n:
            raise _Fail("stream too short")
        out = self.d[self.pos:self.pos + n]
        self.pos += n
        return out

    def marker(self):
        return struct.unpack(">H", self.read(2))[0]

    # --- the main header ----------------------------------------------------
    def _main_header(self):
        if self.marker() != 0xFF4F:
            raise _Fail("no SOC")
        self.state = _MHSIZ
        self.siz = False
        has = set()
        cur = self.marker()
        while cur != _SOT:
            if cur < 0xFF00:
                raise _Fail("a marker expected")
            if cur not in _MARKERS:
                cur = self._unknown()
                if cur == _SOT:
                    break
            has.add(cur)
            if not self.state & _MARKERS[cur]:
                raise _Fail("marker out of place")
            size = self.marker()
            if size < 2:
                raise _Fail("invalid marker size")
            self._handler(cur, self.read(size - 2), None)
            cur = self.marker()
        if not {0xFF51, 0xFF52, 0xFF5C} <= has:
            raise _Fail("SIZ, COD or QCD missing")
        self._merge_ppm()

    def _unknown(self):
        """opj_j2k_read_unk: skip 2-byte words up to a known marker (an
        unknown one is valid in the main header after SIZ)."""
        while True:
            m = self.marker()
            if m < 0xFF00:
                continue
            if not self.state & _MARKERS.get(m, _MH | _TPH):
                raise _Fail("marker out of place")
            if m in _MARKERS:
                return m

    def _handler(self, m, p, tcp):
        """The marker handlers: main header (tcp None) or tile-part."""
        t = self.default if tcp is None and self.siz else tcp
        if m in (0xFF50, 0xFF59):
            return      # Part 15's CAP and CPF: read and left unused
        if m == 0xFF51:
            self._siz(p)
        elif m == 0xFF52:
            self._cod(p, t)
        elif m == 0xFF53:
            self._coc(p, t)
        elif m == 0xFF5C:
            self._qcd(p, t)
        elif m == 0xFF5D:
            self._qcc(p, t)
        elif m == 0xFF5E:
            self._rgn(p, t)
        elif m == 0xFF5F:
            self._poc(p, t)
        elif m == 0xFF55:
            self._tlm(p)
        elif m == 0xFF57:
            if len(p) < 1:
                raise _Fail("bad PLM")
        elif m == 0xFF58:
            self._plt(p)
        elif m == 0xFF60:
            self._ppm(p)
        elif m == 0xFF61:
            self._ppt(p, tcp)
        elif m == 0xFF63:
            if len(p) != 4 * self.ncomp:
                raise _Fail("bad CRG")
        elif m == 0xFF78:
            self._cbd(p)
        elif m == 0xFF74:
            self._mct(p, t)
        elif m == 0xFF75:
            self._mcc(p, t)
        elif m == 0xFF77:
            self._mco(p, t)
        elif m == 0xFF90:
            self._sot(p)

    def _siz(self, p):
        if len(p) < 36 or (len(p) - 36) % 3:
            raise _Fail("bad SIZ size")
        (self.rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
         ncomp) = struct.unpack_from(">HIIIIIIIIH", p)
        if ncomp >= 16385 or ncomp != (len(p) - 36) // 3:
            raise _Fail("bad SIZ component count")
        if x0 >= x1 or y0 >= y1:
            raise _Fail("empty image")
        if tdx == 0 or tdy == 0:
            raise _Fail("bad tile size")
        if tx0 > x0 or ty0 > y0 or min(tx0 + tdx, 2**32 - 1) <= x0 or \
                min(ty0 + tdy, 2**32 - 1) <= y0:
            raise _Fail("illegal tile offset")
        if self.ihdr is not None and self.ihdr[:2] != (x1 - x0, y1 - y0):
            raise _Fail("ihdr and SIZ sizes differ")
        comps = []
        for i in range(ncomp):
            s, dx, dy = p[36 + 3 * i:39 + 3 * i]
            if not (1 <= dx <= 255 and 1 <= dy <= 255):
                raise _Fail("bad sub-sampling")
            prec = (s & 0x7F) + 1
            if prec > 31:
                raise _Fail("precision past 31 bits")
            comps.append((prec, s >> 7, dx, dy))
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.tdx, self.tdy, self.tx0, self.ty0 = tdx, tdy, tx0, ty0
        self.ncomp, self.comps = ncomp, comps
        self.tw = -(-(x1 - tx0) // tdx)
        self.th = -(-(y1 - ty0) // tdy)
        if self.tw == 0 or self.th == 0 or self.tw > 65535 // self.th:
            raise _Fail("bad tile count")
        self.default = _Tcp(ncomp)
        self.default.shifts = [0 if sgnd else 1 << (prec - 1)
                               for prec, sgnd, _, _ in comps]
        self.siz = True
        self.state = _MH

    # --- Part 2 (opj_j2k_read_cbd / mct / mcc / mco, opj_j2k_add_mct) ------
    def _cbd(self, p):
        """Each component's precision and sign for the image OpenJPEG
        decodes into (its clamp, its samples' size, what PIL and OpenCV
        are told); the DC level shift stays SIZ's."""
        if len(p) != self.ncomp + 2 or \
                struct.unpack_from(">H", p)[0] != self.ncomp:
            raise _Fail("bad CBD")
        comps = []
        for (_, _, dx, dy), b in zip(self.comps, p[2:]):
            prec = (b & 0x7F) + 1
            if prec > 31:
                raise _Fail("CBD precision past 31 bits")
            comps.append((prec, b >> 7, dx, dy))
        self.comps = comps

    def _mct(self, p, t):
        if len(p) < 2:
            raise _Fail("bad MCT")
        if struct.unpack_from(">H", p)[0]:      # Zmct: a later part, skipped
            return
        if len(p) <= 6:
            raise _Fail("bad MCT")
        imct, ymct = struct.unpack_from(">HH", p, 2)
        rec = next((r for r in t.mcts if r.index == imct & 0xFF), None)
        if rec is None:
            rec = _Mct()
            t.mcts.append(rec)
        rec.data = None
        rec.index, rec.etype = imct & 0xFF, (imct >> 10) & 3
        if ymct:                                 # a record left without data
            return
        rec.data = p[6:]

    def _mcc(self, p, t):
        """An MCC marker; where OpenJPEG warns and goes on, what it wrote to
        the record so far stays."""
        if len(p) < 2:
            raise _Fail("bad MCC")
        if struct.unpack_from(">H", p)[0]:      # Zmcc
            return
        if len(p) < 7:
            raise _Fail("bad MCC")
        rec = next((r for r in t.mccs if r.index == p[2]), None)
        new = rec is None
        if new:
            if len(t.mccs) == t.mcc_room:
                t.mcc_room += 10
                t.mcc_spare = _Mcc()
            rec = t.mcc_spare
        rec.index = p[2]
        ymcc, qmcc = struct.unpack_from(">HH", p, 3)
        if ymcc or qmcc > 1:
            return
        size, q = len(p) - 7, 7
        for _ in range(qmcc):
            if size < 3:
                raise _Fail("bad MCC")
            if p[q] != 1:                       # not array decorrelation
                return
            n = struct.unpack_from(">H", p, q + 1)[0]
            q, size = q + 3, size - 3
            nb, rec.nb_comps = 1 + (n >> 15), n & 0x7FFF
            if size < nb * rec.nb_comps + 2:
                raise _Fail("bad MCC")
            size -= nb * rec.nb_comps + 2
            for j in range(rec.nb_comps):
                if int.from_bytes(p[q:q + nb], "big") != j:
                    return
                q += nb
            n = struct.unpack_from(">H", p, q)[0]
            q += 2
            nb = 1 + (n >> 15)
            if n & 0x7FFF != rec.nb_comps:
                return
            if size < nb * rec.nb_comps + 3:
                raise _Fail("bad MCC")
            size -= nb * rec.nb_comps + 3
            for j in range(rec.nb_comps):
                if int.from_bytes(p[q:q + nb], "big") != j:
                    return
                q += nb
            tm = int.from_bytes(p[q:q + 3], "big")
            q += 3
            rec.deco = rec.offset = None
            for attr, idx in (("deco", tm & 0xFF),
                              ("offset", (tm >> 8) & 0xFF)):
                if idx:
                    found = next((r for r in t.mcts if r.index == idx), None)
                    if found is None:
                        raise _Fail("MCC names a missing MCT")
                    setattr(rec, attr, found)
        if size:
            raise _Fail("bad MCC size")
        if new:
            t.mccs.append(rec)
            t.mcc_spare = _Mcc()

    def _mco(self, p, t):
        """Every component's DC level shift reset to 0, then each stage's
        MCC applied (OpenJPEG takes one stage; its search for the stage's
        MCC looks at the first record only)."""
        if len(p) < 1:
            raise _Fail("bad MCO")
        if p[0] > 1:
            return
        if len(p) != p[0] + 1:
            raise _Fail("bad MCO")
        t.shifts = [0] * self.ncomp
        for idx in p[1:]:
            if not t.mccs or t.mccs[0].index != idx:
                continue
            rec = t.mccs[0]
            if rec.nb_comps != self.ncomp:
                continue
            for arr, n in ((rec.deco, self.ncomp ** 2),
                           (rec.offset, self.ncomp)):
                if arr is not None and \
                        len(arr.data or b"") != _MCT_SIZE[arr.etype] * n:
                    raise _Fail("an MCT array of the wrong size")
            if rec.offset is not None:
                t.shifts = _mct_ints(rec.offset, self.ncomp)

    def _spcod(self, p, tccp):
        if len(p) < 5:
            raise _Fail("bad SPcod")
        tccp.numres = p[0] + 1
        if tccp.numres > _MAXRLVLS:
            raise _Fail("too many resolutions")
        tccp.cblkw, tccp.cblkh = p[1] + 2, p[2] + 2
        if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
            raise _Fail("bad code-block size")
        tccp.cblksty = p[3]
        if tccp.cblksty & 0x80:
            raise _Fail("mixed HT code-blocks")
        tccp.qmfbid = p[4]
        if tccp.qmfbid > 1:
            raise _Fail("bad transform")
        n = 5
        if tccp.csty & 1:
            if len(p) - 5 < tccp.numres:
                raise _Fail("bad SPcod")
            for i in range(tccp.numres):
                v = p[5 + i]
                if i and (not v & 0xF or not v >> 4):
                    raise _Fail("bad precinct size")
                tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
            n += tccp.numres
        else:
            tccp.prcw = [15] * _MAXRLVLS
            tccp.prch = [15] * _MAXRLVLS
        return n

    def _cod(self, p, t):
        if len(p) < 5:
            raise _Fail("bad COD")
        t.csty, t.prg = p[0], p[1]
        if t.csty & ~7:
            raise _Fail("bad Scod")
        if t.prg > _CPRL:
            t.prg = -1
        t.numlayers = struct.unpack_from(">H", p, 2)[0]
        if t.numlayers < 1:
            raise _Fail("no layers")
        t.mct = p[4]
        if t.mct > 1:
            raise _Fail("bad MCT")
        for c in t.tccps:
            c.csty = t.csty & 1
        if self._spcod(p[5:], t.tccps[0]) != len(p) - 5:
            raise _Fail("bad COD size")
        ref = t.tccps[0]
        for c in t.tccps[1:]:
            c.numres, c.cblkw, c.cblkh = ref.numres, ref.cblkw, ref.cblkh
            c.cblksty, c.qmfbid = ref.cblksty, ref.qmfbid
            c.prcw, c.prch = list(ref.prcw), list(ref.prch)

    def _comp_no(self, p):
        room = 1 if self.ncomp <= 256 else 2
        if len(p) < room:
            raise _Fail("bad component number")
        c = p[0] if room == 1 else struct.unpack_from(">H", p)[0]
        return c, room

    def _coc(self, p, t):
        room = 1 if self.ncomp <= 256 else 2
        if len(p) < room + 1:
            raise _Fail("bad COC")
        c, _ = self._comp_no(p)
        if c >= self.ncomp:
            raise _Fail("bad COC component")
        t.tccps[c].csty = p[room]
        if self._spcod(p[room + 1:], t.tccps[c]) != len(p) - room - 1:
            raise _Fail("bad COC size")

    def _sqcd(self, p, tccp):
        if len(p) < 1:
            raise _Fail("bad SQcd")
        tccp.qntsty, tccp.numgbits = p[0] & 0x1F, p[0] >> 5
        size = len(p) - 1
        if tccp.qntsty == 1:
            nb = 1
        else:
            nb = size if tccp.qntsty == 0 else size // 2
        steps = list(tccp.steps)
        if tccp.qntsty == 0:
            if size < nb:
                raise _Fail("bad SQcd")
            for b in range(min(nb, _MAXBANDS)):
                steps[b] = (p[1 + b] >> 3, 0)
            used = nb
        else:
            if size < 2 * nb:
                raise _Fail("bad SQcd")
            for b in range(min(nb, _MAXBANDS)):
                v = struct.unpack_from(">H", p, 1 + 2 * b)[0]
                steps[b] = (v >> 11, v & 0x7FF)
            used = 2 * nb
        if tccp.qntsty == 1:
            e0, m0 = steps[0]
            for b in range(1, _MAXBANDS):
                steps[b] = (max(e0 - (b - 1) // 3, 0), m0)
        tccp.steps = steps
        return used + 1

    def _qcd(self, p, t):
        if self._sqcd(p, t.tccps[0]) != len(p):
            raise _Fail("bad QCD size")
        ref = t.tccps[0]
        for c in t.tccps[1:]:
            c.qntsty, c.numgbits, c.steps = ref.qntsty, ref.numgbits, \
                list(ref.steps)

    def _qcc(self, p, t):
        c, room = self._comp_no(p)
        if c >= self.ncomp:
            raise _Fail("bad QCC component")
        if self._sqcd(p[room:], t.tccps[c]) != len(p) - room:
            raise _Fail("bad QCC size")

    def _rgn(self, p, t):
        room = 1 if self.ncomp <= 256 else 2
        if len(p) != 2 + room:
            raise _Fail("bad RGN")
        c, _ = self._comp_no(p)
        if c >= self.ncomp:
            raise _Fail("bad RGN component")
        t.tccps[c].roishift = p[room + 1]

    def _poc(self, p, t):
        room = 1 if self.ncomp <= 256 else 2
        chunk = 5 + 2 * room
        if len(p) == 0 or len(p) % chunk:
            raise _Fail("bad POC")
        if len(t.pocs) + len(p) // chunk >= 32:
            raise _Fail("too many POCs")
        fmt = ">B" + ("B" if room == 1 else "H") + "HB" + \
            ("B" if room == 1 else "H") + "B"
        pocs = list(t.pocs)
        for i in range(len(p) // chunk):
            r0, c0, l1, r1, c1, prg = struct.unpack_from(fmt, p, i * chunk)
            pocs.append((r0, c0, l1, r1, min(c1, self.ncomp), prg))
        t.pocs = pocs

    def _tlm(self, p):
        if len(p) < 2:
            raise _Fail("bad TLM")
        st = (p[1] >> 4) & 3
        if st == 3:
            raise _Fail("bad TLM")
        q = ((p[1] >> 6) & 1) * 2 + 2 + st
        if (len(p) - 2) % q:
            raise _Fail("bad TLM")

    def _plt(self, p):
        if len(p) < 1:
            raise _Fail("bad PLT")
        v = 0
        for b in p[1:]:
            v |= b & 0x7F
            v = v << 7 if b & 0x80 else 0
        if v:
            raise _Fail("bad PLT")

    def _ppm(self, p):
        if len(p) < 2:
            raise _Fail("bad PPM")
        if p[0] in self.ppm_markers:
            raise _Fail("Zppm read twice")
        self.ppm_markers[p[0]] = p[1:]

    def _merge_ppm(self):
        if not self.ppm_markers:
            return
        out = bytearray()
        remaining = 0
        for z in sorted(self.ppm_markers):
            d = self.ppm_markers[z]
            if remaining >= len(d):
                out += d
                remaining -= len(d)
                continue
            out += d[:remaining]
            i = remaining
            remaining = 0
            while i < len(d):
                if len(d) - i < 4:
                    raise _Fail("Nppm cut")
                n = struct.unpack_from(">I", d, i)[0]
                i += 4
                out += d[i:i + n]
                if len(d) - i >= n:
                    i += n
                else:
                    remaining = n - (len(d) - i)
                    i = len(d)
        if remaining:
            raise _Fail("corrupted PPM")
        self.ppm = bytes(out)
        self.ppm_pos = 0

    def _ppt(self, p, tcp):
        if len(p) < 2:
            raise _Fail("bad PPT")
        if self.ppm_markers:
            raise _Fail("PPT after PPM")
        if p[0] in tcp.ppt:
            raise _Fail("Zppt read twice")
        tcp.ppt[p[0]] = p[1:]

    # --- tile-parts (opj_j2k_read_tile_header, opj_j2k_read_sot / sod) -----
    def _sot(self, p):
        if len(p) != 8:
            raise _Fail("bad SOT")
        tile, psot, part, nparts = struct.unpack(">HIBB", p)
        if tile >= self.tw * self.th:
            raise _Fail("bad tile number")
        tcp = self.tcps[tile]
        if tcp.part + 1 != part:
            raise _Fail("tile-part out of order")
        tcp.part = part
        if psot != 0 and psot < 14 and psot != 12:
            raise _Fail("bad Psot")
        if psot == 0:
            self.last_part = True
        if tcp.nparts and part >= tcp.nparts:
            raise _Fail("TPsot past TNsot")
        if nparts:
            nparts += self.nparts_correction
            if tcp.nparts and part >= tcp.nparts:
                raise _Fail("TPsot past TNsot")
            if part >= nparts:
                raise _Fail("TPsot past TNsot")
            tcp.nparts = nparts
        if tcp.nparts and tcp.nparts == part + 1:
            self.can_decode = True
        self.sot_length = 0 if self.last_part else psot - 12
        self.cur_tile = tile

    def tiles(self, whole=False):
        """Yield each tile's index when OpenJPEG hands it to PIL, its tcp
        holding its data; raises _Fail where OpenJPEG returns false.
        `whole`: as opj_j2k_decode_tiles, stop once as many tiles as the
        image has were decoded."""
        decoded = 0
        self.tcps = [self.default.copy() for _ in range(self.tw * self.th)]
        self.can_decode = False
        self.last_part = False
        self.nparts_correction = 0
        checked = False
        self.cur_tile = 0
        state = _TPHSOT
        while True:
            if state == _EOC_ST:
                cur = _EOC
            elif state != _TPHSOT:
                raise _Fail("the codestream goes on with neither SOT nor EOC")
            else:
                cur = _SOT
            while not self.can_decode and cur != _EOC:
                while cur != _SOD:
                    if self.left() == 0:
                        state = _NEOC
                        break
                    size = self.marker()
                    if size < 2:
                        raise _Fail("inconsistent marker size")
                    if state & _TPH and self.sot_length != 0:
                        if self.sot_length < size + 2:
                            raise _Fail("Sot length too small")
                        self.sot_length -= size + 2
                    if not state & _MARKERS.get(cur, _MH | _TPH):
                        raise _Fail("marker out of place")
                    if size - 2 > self.left():
                        raise _Fail("marker past the stream")
                    body = self.read(size - 2)
                    if cur not in _MARKERS:
                        raise _Fail("unknown marker in a tile-part header")
                    if cur == _SOT:
                        self._handler(cur, body, None)
                        state = _TPH
                    else:
                        self._handler(cur, body, self.tcps[self.cur_tile])
                    cur = self.marker()
                if self.left() == 0 and state == _NEOC:
                    break
                state = self._sod()
                if self.can_decode and not checked:
                    checked = True
                    # skipped where the tile declares one tile-part
                    if self.tcps[self.cur_tile].nparts != 1 and \
                            self._needs_correction():
                        self.can_decode = False
                        self.nparts_correction = 1
                        for t in self.tcps:
                            if t.nparts:
                                t.nparts += 1
                if not self.can_decode:
                    if self.left() < 2:
                        lone = [i for i, t in enumerate(self.tcps)
                                if t.part == 0 and t.nparts == 0]
                        if self.cur_tile + 1 == len(self.tcps) and lone:
                            self.cur_tile = lone[0]
                            cur = _EOC
                            state = _EOC_ST
                            break
                        raise _Fail("stream too short")
                    cur = self.marker()
            if cur == _EOC and state != _EOC_ST:
                self.cur_tile = 0
                state = _EOC_ST
            if not self.can_decode:
                while self.cur_tile < len(self.tcps) and \
                        self.tcps[self.cur_tile].data is None:
                    self.cur_tile += 1
                if self.cur_tile == len(self.tcps):
                    return
            tcp = self.tcps[self.cur_tile]
            if tcp.data is None:
                raise _Fail("tile without data")
            yield self.cur_tile
            tcp.data = None
            self.can_decode = False
            if state not in (_NEOC, _EOC_ST) or \
                    (state == _NEOC and self.left()):
                if self.left() < 2:
                    raise _Fail("stream too short after a tile")
                m = self.marker()
                if m == _EOC:
                    self.cur_tile = 0
                    state = _EOC_ST
                elif m != _SOT:
                    if self.left():
                        raise _Fail("no SOT or EOC after a tile")
                    state = _NEOC
            decoded += 1
            if whole and (decoded == len(self.tcps) or
                          (state == _NEOC and not self.left())):
                return

    def _sod(self):
        """opj_j2k_read_sod (strict) -> the next state."""
        tcp = self.tcps[self.cur_tile]
        if self.last_part:
            self.sot_length = (self.left() - 2) & 0xFFFFFFFF
        elif self.sot_length >= 2:
            self.sot_length -= 2
        n = self.sot_length
        if n:
            if n > self.left():
                raise _Fail("tile-part past the stream")
            tcp.data = (tcp.data or b"") + self.d[self.pos:self.pos + n]
            self.pos += n
        return _TPHSOT

    def _needs_correction(self):
        """opj_j2k_need_nb_tile_parts_correction: a later SOT of this
        tile with TPsot == TNsot."""
        pos = self.pos
        tile = self.cur_tile
        d = self.d
        while True:
            if len(d) - pos < 2:
                return False
            if struct.unpack_from(">H", d, pos)[0] != _SOT:
                return False
            if len(d) - pos < 12:
                if self.release == "2.5.3":
                    raise _Fail("stream too short in a later SOT")
                return False        # a stream cut here fails later, or not
            if struct.unpack_from(">H", d, pos + 2)[0] != 10:
                raise _Fail("inconsistent SOT size")
            t, psot, part, nparts = struct.unpack_from(">HIBB", d, pos + 4)
            if t == tile:
                return part == nparts
            if psot < 14:
                return False
            pos += 12
            if len(d) - pos < psot - 12:
                return False
            pos += psot - 12


# ---------------------------------------------------------------------------
# OpenJPEG: a tile's geometry (opj_tcd_init_tile) and tier-2 (t2.c, pi.c)
# ---------------------------------------------------------------------------

def _mct_ints(rec, n):
    """An MCT array's n elements as OpenJPEG reads them into int32 offsets:
    an int16 as its unsigned 16 bits, an int32 as it is, a float by C's
    truncating cast (x86's 0x80000000 where it does not fit)."""
    fmt = (">H", ">i", ">f", ">d")[rec.etype]
    size = _MCT_SIZE[rec.etype]
    out = []
    for i in range(n):
        v = struct.unpack_from(fmt, rec.data, i * size)[0]
        if rec.etype >= 2:
            v = int(v) if np.isfinite(v) and -2**31 <= int(v) < 2**31 \
                else -2**31
        out.append(v)
    return out


def _cdiv(a, b):
    return -(-a // b)


def _cdivpow2(a, e):
    return -((-a) >> e)


class _TagTree:
    """opj_tgt_tree_t: a quad-tree over cw x ch leaves."""

    def __init__(self, w, h):
        parent = []
        sizes = []
        nw, nh = w, h
        while True:
            sizes.append((nw, nh))
            if nw * nh <= 1:
                break
            nw, nh = (nw + 1) // 2, (nh + 1) // 2
        offs = [0]
        for sw, sh in sizes:
            offs.append(offs[-1] + sw * sh)
        for lvl, (sw, sh) in enumerate(sizes):
            for y in range(sh):
                for x in range(sw):
                    if lvl + 1 < len(sizes):
                        pw = sizes[lvl + 1][0]
                        parent.append(offs[lvl + 1] + (y // 2) * pw + x // 2)
                    else:
                        parent.append(-1)
        self.parent = parent
        self.reset()

    def reset(self):
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio, leaf, threshold):
        stk = []
        node = leaf
        while self.parent[node] >= 0:
            stk.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stk:
                break
            node = stk.pop()
        return value[node] < threshold


class _Bio:
    """opj_bio_t reading packet headers: a byte after 0xFF gives 7 bits;
    past the end, zeros."""

    __slots__ = ("d", "p", "start", "end", "buf", "ct")

    def __init__(self, d, p, end):
        self.d, self.p, self.start, self.end = d, p, p, end
        self.buf = self.ct = 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.p < self.end:
            self.buf |= self.d[self.p]
            self.p += 1

    def bit(self):
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self):
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0

    def numbytes(self):
        return self.p - self.start


class _Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "segs", "numsegs", "numbps",
                 "numlenbits", "numnewpasses", "chunks")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.segs = []          # [maxpasses, numpasses, len, newlen, newpasses]
        self.numsegs = 0
        self.numbps = 0
        self.numlenbits = 0
        self.numnewpasses = 0
        self.chunks = []


class _Prc:
    __slots__ = ("x0", "y0", "x1", "y1", "cw", "ch", "cblks", "incl", "imsb")


class _Band:
    __slots__ = ("bandno", "x0", "y0", "x1", "y1", "numbps", "step", "prcs")


class _Res:
    __slots__ = ("x0", "y0", "x1", "y1", "pdx", "pdy", "pw", "ph", "bands")


def _tile_geometry(cs, tileno, tcp):
    """opj_tcd_init_tile: each component's resolutions, bands, precincts
    and code-blocks."""
    p, q = tileno % cs.tw, tileno // cs.tw
    tx0 = max(cs.tx0 + p * cs.tdx, cs.x0)
    ty0 = max(cs.ty0 + q * cs.tdy, cs.y0)
    tx1 = min(cs.tx0 + (p + 1) * cs.tdx, cs.x1)
    ty1 = min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)
    comps = []
    for c, (prec, sgnd, dx, dy) in enumerate(cs.comps):
        tccp = tcp.tccps[c]
        cx0, cy0 = _cdiv(tx0, dx), _cdiv(ty0, dy)
        cx1, cy1 = _cdiv(tx1, dx), _cdiv(ty1, dy)
        ress = []
        for resno in range(tccp.numres):
            lev = tccp.numres - 1 - resno
            r = _Res()
            r.x0, r.y0 = _cdivpow2(cx0, lev), _cdivpow2(cy0, lev)
            r.x1, r.y1 = _cdivpow2(cx1, lev), _cdivpow2(cy1, lev)
            r.pdx, r.pdy = tccp.prcw[resno], tccp.prch[resno]
            px0 = (r.x0 >> r.pdx) << r.pdx
            py0 = (r.y0 >> r.pdy) << r.pdy
            px1 = _cdivpow2(r.x1, r.pdx) << r.pdx
            py1 = _cdivpow2(r.y1, r.pdy) << r.pdy
            r.pw = 0 if r.x0 == r.x1 else (px1 - px0) >> r.pdx
            r.ph = 0 if r.y0 == r.y1 else (py1 - py0) >> r.pdy
            if resno == 0:
                cbgx0, cbgy0, cbgw, cbgh = px0, py0, r.pdx, r.pdy
                bandnos = (0,)
            else:
                cbgx0, cbgy0 = _cdivpow2(px0, 1), _cdivpow2(py0, 1)
                cbgw, cbgh = r.pdx - 1, r.pdy - 1
                bandnos = (1, 2, 3)
            cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
            r.bands = []
            for bandno in bandnos:
                b = _Band()
                b.bandno = bandno
                if bandno == 0:
                    b.x0, b.y0 = _cdivpow2(cx0, lev), _cdivpow2(cy0, lev)
                    b.x1, b.y1 = _cdivpow2(cx1, lev), _cdivpow2(cy1, lev)
                else:
                    ox, oy = bandno & 1, bandno >> 1
                    b.x0 = _cdivpow2(cx0 - (ox << lev), lev + 1)
                    b.y0 = _cdivpow2(cy0 - (oy << lev), lev + 1)
                    b.x1 = _cdivpow2(cx1 - (ox << lev), lev + 1)
                    b.y1 = _cdivpow2(cy1 - (oy << lev), lev + 1)
                idx = 0 if resno == 0 else 3 * (resno - 1) + bandno
                expn, mant = tccp.steps[idx]
                # decoder, irreversible: no band gain (BUG_WEIRD_TWO_INVK)
                gain = 0 if tccp.qmfbid == 0 else (0 if bandno == 0 else
                                                   2 if bandno == 3 else 1)
                b.step = np.float32((1.0 + mant / 2048.0) *
                                    2.0 ** (prec + gain - expn))
                b.numbps = expn + tccp.numgbits - 1
                b.prcs = []
                for precno in range(r.pw * r.ph):
                    pr = _Prc()
                    gx = cbgx0 + (precno % r.pw) * (1 << cbgw)
                    gy = cbgy0 + (precno // r.pw) * (1 << cbgh)
                    pr.x0, pr.y0 = max(gx, b.x0), max(gy, b.y0)
                    pr.x1 = min(gx + (1 << cbgw), b.x1)
                    pr.y1 = min(gy + (1 << cbgh), b.y1)
                    bx0 = (pr.x0 >> cbw) << cbw
                    by0 = (pr.y0 >> cbh) << cbh
                    bx1 = _cdivpow2(pr.x1, cbw) << cbw
                    by1 = _cdivpow2(pr.y1, cbh) << cbh
                    pr.cw, pr.ch = (bx1 - bx0) >> cbw, (by1 - by0) >> cbh
                    if pr.cw < 0 or pr.ch < 0:
                        pr.cw = pr.ch = 0
                    pr.cblks = []
                    for j in range(pr.cw * pr.ch):
                        x = bx0 + (j % pr.cw) * (1 << cbw)
                        y = by0 + (j // pr.cw) * (1 << cbh)
                        pr.cblks.append(_Cblk(max(x, pr.x0), max(y, pr.y0),
                                              min(x + (1 << cbw), pr.x1),
                                              min(y + (1 << cbh), pr.y1)))
                    n = pr.cw * pr.ch
                    pr.incl = _TagTree(pr.cw, pr.ch) if n else None
                    pr.imsb = _TagTree(pr.cw, pr.ch) if n else None
                    b.prcs.append(pr)
                r.bands.append(b)
            ress.append(r)
        comps.append(dict(x0=cx0, y0=cy0, x1=cx1, y1=cy1, res=ress,
                          tccp=tccp, prec=prec, sgnd=sgnd, dx=dx, dy=dy))
    return (tx0, ty0, tx1, ty1), comps


def _packets(tcp, comps, tile_box):
    """The packet iterators of opj_pi_create_decode / opj_pi_next: yield
    (layno, resno, compno, precno) in the codestream's order."""
    ncomp = len(comps)
    max_res = max(len(c["res"]) for c in comps)
    max_prec = max((r.pw * r.ph for c in comps for r in c["res"]), default=0)
    step_c = max_prec
    step_r = ncomp * step_c
    step_l = max_res * step_r
    size = tcp.numlayers * step_l
    include = bytearray(size)
    if tcp.pocs:
        pocs = [(r0, c0, min(l1, tcp.numlayers), r1, c1, prg)
                for r0, c0, l1, r1, c1, prg in tcp.pocs]
    else:
        pocs = [(0, 0, tcp.numlayers, max_res, ncomp, tcp.prg)]
    tx0, ty0, tx1, ty1 = tile_box
    for r0, c0, l1, r1, c1, prg in pocs:
        if prg == -1:
            raise _Fail("unknown progression order")
        if c0 >= ncomp or c1 >= ncomp + 1:
            continue

        def emit(lay, res, comp, prec):
            index = lay * step_l + res * step_r + comp * step_c + prec
            if index >= size:
                raise StopIteration
            if not include[index]:
                include[index] = 1
                return True
            return False

        def body(comp, res, x, y):
            """The position test of opj_pi_next_rpcl / pcrl / cprl ->
            precno or None."""
            cp = comps[comp]
            if res >= len(cp["res"]):
                return None
            rr = cp["res"][res]
            lev = len(cp["res"]) - 1 - res
            dxl, dyl = cp["dx"] << lev, cp["dy"] << lev
            trx0, try0 = _cdiv(tx0, dxl), _cdiv(ty0, dyl)
            trx1, try1 = _cdiv(tx1, dxl), _cdiv(ty1, dyl)
            rpx, rpy = rr.pdx + lev, rr.pdy + lev
            if rpx >= 31 or rpy >= 31:
                return None
            if not (y % (cp["dy"] << rpy) == 0 or
                    (y == ty0 and ((try0 << lev) % (1 << rpy)))):
                return None
            if not (x % (cp["dx"] << rpx) == 0 or
                    (x == tx0 and ((trx0 << lev) % (1 << rpx)))):
                return None
            if rr.pw == 0 or rr.ph == 0 or trx0 == trx1 or try0 == try1:
                return None
            prci = (_cdiv(x, dxl) >> rr.pdx) - (trx0 >> rr.pdx)
            prcj = (_cdiv(y, dyl) >> rr.pdy) - (try0 >> rr.pdy)
            return prci + prcj * rr.pw

        def steps(cset):
            """The x and y the position loops visit where some (component,
            resolution) of `cset` can have a packet."""
            xs, ys = {tx0}, {ty0}
            for comp in cset:
                cp = comps[comp]
                for res, rr in enumerate(cp["res"]):
                    lev = len(cp["res"]) - 1 - res
                    mx = cp["dx"] << (rr.pdx + lev)
                    my = cp["dy"] << (rr.pdy + lev)
                    xs.update(range(_cdiv(tx0, mx) * mx, tx1, mx))
                    ys.update(range(_cdiv(ty0, my) * my, ty1, my))
            return sorted(xs), sorted(ys)

        try:
            if prg in (_LRCP, _RLCP):
                outer = ((lay, res) for lay in range(l1)
                         for res in range(r0, r1)) if prg == _LRCP else \
                    ((lay, res) for res in range(r0, r1)
                     for lay in range(l1))
                for lay, res in outer:
                    for comp in range(c0, c1):
                        cp = comps[comp]
                        if res >= len(cp["res"]):
                            continue
                        rr = cp["res"][res]
                        for prec in range(rr.pw * rr.ph):
                            if emit(lay, res, comp, prec):
                                yield lay, res, comp, prec
            elif prg in (_RPCL, _PCRL):
                xs, ys = steps(range(ncomp))
                if prg == _RPCL:
                    order = ((res, y, x) for res in range(r0, r1)
                             for y in ys for x in xs)
                    for res, y, x in order:
                        for comp in range(c0, c1):
                            prec = body(comp, res, x, y)
                            if prec is None:
                                continue
                            for lay in range(l1):
                                if emit(lay, res, comp, prec):
                                    yield lay, res, comp, prec
                else:
                    for y in ys:
                        for x in xs:
                            for comp in range(c0, c1):
                                nres = min(r1, len(comps[comp]["res"]))
                                for res in range(r0, nres):
                                    prec = body(comp, res, x, y)
                                    if prec is None:
                                        continue
                                    for lay in range(l1):
                                        if emit(lay, res, comp, prec):
                                            yield lay, res, comp, prec
            elif prg == _CPRL:
                for comp in range(c0, c1):
                    xs, ys = steps((comp,))
                    nres = min(r1, len(comps[comp]["res"]))
                    for y in ys:
                        for x in xs:
                            for res in range(r0, nres):
                                prec = body(comp, res, x, y)
                                if prec is None:
                                    continue
                                for lay in range(l1):
                                    if emit(lay, res, comp, prec):
                                        yield lay, res, comp, prec
        except StopIteration:
            pass


def _init_seg(cblk, sty, first):
    if sty & 0x04:
        maxp = 1
    elif sty & 0x01:
        if first:
            maxp = 10
        else:
            prev = cblk.segs[-1][0] if cblk.segs else 0
            maxp = 2 if prev in (1, 10) else 1
    else:
        maxp = 109
    cblk.segs.append([maxp, 0, 0, 0, 0])


def _numpasses(bio):
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _read_packet(src, pos, end, hdr, tcp, res, lay, prec, sty):
    """opj_t2_decode_packet: the header (from the packet or from `hdr`,
    PPM / PPT's packet headers [data, pos, end]) and the code-block
    segments it announces -> the position after the packet's data."""
    if lay == 0:
        for b in res.bands:
            if b.x1 - b.x0 == 0 or b.y1 - b.y0 == 0:
                continue
            pr = b.prcs[prec]
            if pr.incl is not None:
                pr.incl.reset()
                pr.imsb.reset()
            for cb in pr.cblks:
                cb.numsegs = 0
                cb.segs = []
    if tcp.csty & 2:
        if end - pos < 6:
            pass
        elif src[pos] != 0xFF or src[pos + 1] != 0x91:
            pass
        else:
            pos += 6
    if hdr is None:
        hd, hp, he = src, pos, end
    else:
        hd, hp, he = hdr
    bio = _Bio(hd, hp, he)
    present = bio.bit()
    bands = [b for b in res.bands
             if b.x1 - b.x0 != 0 and b.y1 - b.y0 != 0]
    if present:
        for b in bands:
            pr = b.prcs[prec]
            for k, cb in enumerate(pr.cblks):
                if not cb.numsegs:
                    inc = pr.incl.decode(bio, k, lay + 1)
                else:
                    inc = bio.bit()
                if not inc:
                    cb.numnewpasses = 0
                    continue
                if not cb.numsegs:
                    i = 0
                    while not pr.imsb.decode(bio, k, i):
                        i += 1
                    cb.numbps = (b.numbps + 1 - i) & 0xFFFFFFFF
                    cb.numlenbits = 3
                cb.numnewpasses = _numpasses(bio)
                inc = 0
                while bio.bit():
                    inc += 1
                cb.numlenbits += inc
                if not cb.numsegs:
                    segno = 0
                    cb.segs = []
                    _init_seg(cb, sty, True)
                else:
                    segno = cb.numsegs - 1
                    if cb.segs[segno][1] == cb.segs[segno][0]:
                        segno += 1
                        del cb.segs[segno:]
                        _init_seg(cb, sty, False)
                n = cb.numnewpasses
                while True:
                    seg = cb.segs[segno]
                    if sty & 0x40:
                        # HT: the first segment holds the cleanup pass
                        # alone, a later one every pass still to come
                        seg[4] = 1 if segno == 0 else n
                    else:
                        seg[4] = min(seg[0] - seg[1], n)
                    nbits = cb.numlenbits + seg[4].bit_length() - 1
                    if nbits > 32:
                        raise _Fail("invalid bit number")
                    seg[3] = bio.read(nbits)
                    n -= seg[4]
                    if n <= 0:
                        break
                    segno += 1
                    del cb.segs[segno:]
                    _init_seg(cb, sty, False)
    bio.inalign()
    hp2 = hp + bio.numbytes()
    if tcp.csty & 4:
        # OpenJPEG 2.5.4 fails on a missing EPH (a missing SOP is a warning)
        if he - hp2 < 2 or hd[hp2] != 0xFF or hd[hp2 + 1] != 0x92:
            raise _Fail("expected EPH marker")
        hp2 += 2
    if hdr is None:
        pos = hp2
    else:
        hdr[1] = hp2
    if not present:
        return pos
    # opj_t2_read_packet_data, strict
    for b in bands:
        pr = b.prcs[prec]
        for cb in pr.cblks:
            if not cb.numnewpasses:
                continue
            if not cb.numsegs:
                si = 0
                cb.numsegs = 1
            else:
                si = cb.numsegs - 1
                if cb.segs[si][1] == cb.segs[si][0]:
                    si += 1
                    cb.numsegs += 1
            while True:
                seg = cb.segs[si]
                if pos + seg[3] > end:
                    raise _Fail("segment too long")
                cb.chunks.append((pos, seg[3]))
                pos += seg[3]
                seg[2] += seg[3]
                seg[1] += seg[4]
                cb.numnewpasses -= seg[4]
                if cb.numnewpasses > 0:
                    si += 1
                    cb.numsegs += 1
                else:
                    break
    return pos


def _tier2(tcp, comps, tile_box, cs):
    """opj_t2_decode_packets: every packet of the tile in its order, the
    headers from the packets or from PPM / PPT, each code-block's
    segments attached to it -> each component's resno_decoded, the highest
    resolution a packet of this tile was read for (OpenJPEG starts it at 0
    in each tile, whatever an earlier tile decoded)."""
    data = tcp.data
    decoded = [0] * cs.ncomp
    if cs.ppm is not None:
        hdr = [cs.ppm, cs.ppm_pos, len(cs.ppm)]
    elif tcp.ppt:
        ppt = b"".join(tcp.ppt[z] for z in sorted(tcp.ppt))
        hdr = [ppt, 0, len(ppt)]
    else:
        hdr = None
    pos = 0
    end = len(data)
    for lay, resno, compno, prec in _packets(tcp, comps, tile_box):
        cp = comps[compno]
        tccp = cp["tccp"]
        pos = _read_packet(data, pos, end, hdr, tcp, cp["res"][resno], lay,
                           prec, tccp.cblksty)
        decoded[compno] = max(decoded[compno], resno)
    if cs.ppm is not None:
        cs.ppm_pos = hdr[1]
    return decoded


# ---------------------------------------------------------------------------
# OpenJPEG: tier-1, the wavelets, the colour transforms, the level shift
# ---------------------------------------------------------------------------

def _tier1(data, cp):
    """Every code-block of one tile-component into its buffer (int32 for
    5/3, float32 for 9/7), OpenJPEG's Mallat layout: HT code-blocks
    (the style's 0x40) through `native.j2k_ht_decode`, the others through
    `native.j2k_t1_decode`."""
    ress = cp["res"]
    tccp = cp["tccp"]
    w = ress[-1].x1 - ress[-1].x0
    h = ress[-1].y1 - ress[-1].y0
    irrev = tccp.qmfbid == 0
    ht = bool(tccp.cblksty & 0x40)
    out = np.zeros((max(h, 1), max(w, 1)), np.float32 if irrev else np.int32)
    info, segs, steps, chunks = [], [], [], []
    off = 0
    for resno, r in enumerate(ress):
        for b in r.bands:
            if b.x1 - b.x0 == 0 or b.y1 - b.y0 == 0:
                continue
            for pr in b.prcs:
                for cb in pr.cblks:
                    x = cb.x0 - b.x0
                    y = cb.y0 - b.y0
                    if b.bandno & 1:
                        pres = ress[resno - 1]
                        x += pres.x1 - pres.x0
                    if b.bandno & 2:
                        pres = ress[resno - 1]
                        y += pres.y1 - pres.y0
                    nseg = cb.numsegs
                    row = [off, len(segs) // 2, nseg, cb.x1 - cb.x0,
                           cb.y1 - cb.y0]
                    if ht:
                        # OpenJPEG reads a block of one chunk where it lies
                        # in the tile's data (a buffer aligned to 16), a
                        # block of more from a buffer of its own
                        row += [b.numbps, cb.numbps, tccp.roishift,
                                tccp.cblksty]
                        tail = [len(cb.chunks), cb.chunks[0][0] & 3
                                if len(cb.chunks) == 1 else 0]
                    else:
                        row += [b.bandno, cb.numbps if cb.numbps < 2**31
                                else cb.numbps - 2**32, tccp.roishift,
                                tccp.cblksty]
                        tail = []
                    info.append(row + [y * out.shape[1] + x, out.shape[1],
                                       int(irrev)] + tail)
                    for s in cb.segs[:nseg]:
                        segs += (s[2], s[1])
                    for cpos, clen in cb.chunks:
                        chunks.append(data[cpos:cpos + clen])
                        off += clen
                    steps.append(b.step)
    buf = b"".join(chunks)
    if ht:
        bad = native.j2k_ht_decode(buf, np.array(info, np.int64).reshape(
            -1, 14), np.array(segs, np.int64), np.array(steps, np.float32),
            out)
        if bad is not None:
            raise _Fail(f"an HT code-block OpenJPEG stops at: {bad[1]}")
    else:
        bad = native.j2k_t1_decode(buf, np.array(info, np.int64).reshape(
            -1, 12), np.array(segs, np.int64), np.array(steps, np.float32),
            out)
        if bad is not None:
            raise _Fail("a code-block of 31 bit-planes or more")
    return out[:h, :w]


def _interleave(x, sn, cas):
    """Rows of [sn lows | highs] (axis 0) -> the samples in place order:
    lows at parity `cas`, highs at the other."""
    w = np.empty_like(x)
    w[cas::2] = x[:sn]
    w[1 - cas::2] = x[sn:]
    return w


def _neighbours(w, par):
    """Left + right neighbour of each sample of parity `par` along axis 0,
    with symmetric extension (a sample at either end counts its one
    neighbour twice)."""
    n = len(w)
    t = w[par::2]
    m = len(t)
    side = np.empty_like(t)
    if par:
        side[:] = w[0:n - 1:2][:m]
    else:
        side[0] = w[1]
        side[1:] = w[1:n - 1:2][:m - 1]
    right = w[par + 1::2]
    k = len(right)
    side[:k] += right[:m]
    if k < m:
        side[k:] += w[n - 2]
    return t, side


def _idwt53(w, cas):
    """The inverse 5/3 along axis 0 of `w` (interleaved, int32), with
    symmetric extension; one sample: kept, or halved (truncating) at an
    odd coordinate."""
    if len(w) == 1:
        if cas:
            w = np.where(w < 0, -((-w) // 2), w // 2).astype(np.int32)
        return w
    t, side = _neighbours(w, cas)
    t -= (side + 2) >> 2
    t, side = _neighbours(w, 1 - cas)
    t += side >> 1
    return w


def _idwt97(w, cas):
    """opj_v8dwt_decode along axis 0 (interleaved, float32): lows by K,
    highs by 2 / K, then the four lifting steps, each sample
    x + (left + right) * c in float32 with symmetric extension; one
    sample is left as it is."""
    if len(w) == 1:
        return w
    w[cas::2] *= _K
    w[1 - cas::2] *= _TWO_INVK
    for par, c in ((cas, -_DELTA), (1 - cas, -_GAMMA), (cas, -_BETA),
                   (1 - cas, -_ALPHA)):
        t, side = _neighbours(w, par)
        side *= c
        t += side
    return w


def _idwt(a, ress, irrev):
    """opj_dwt_decode_tile: for each level, the rows of the resolution
    (horizontal), then its columns (vertical)."""
    one = _idwt97 if irrev else _idwt53
    for r in range(1, len(ress)):
        prev, cur = ress[r - 1], ress[r]
        rw, rh = cur.x1 - cur.x0, cur.y1 - cur.y0
        sw, sh = prev.x1 - prev.x0, prev.y1 - prev.y0
        if rw == 0 or rh == 0:
            continue
        cx, cy = cur.x0 % 2, cur.y0 % 2
        blk = one(_interleave(np.ascontiguousarray(a[:rh, :rw].T), sw, cx),
                  cx).T
        a[:rh, :rw] = one(_interleave(blk, sh, cy), cy)
    return a


def _decode_tile(cs, tileno):
    tcp = cs.tcps[tileno]
    box, comps = _tile_geometry(cs, tileno, tcp)
    decoded = _tier2(tcp, comps, box, cs)
    planes, rds, origins = [], [], []
    for c, cp in enumerate(comps):
        # OpenJPEG inverts the wavelet up to resno_decoded, and hands on
        # that resolution's samples (the last one but where the tile's
        # packets stop short of it)
        rd = decoded[c]
        a = _tier1(tcp.data, cp)
        r = cp["res"][rd]
        planes.append(_idwt(a, cp["res"][:rd + 1], cp["tccp"].qmfbid == 0)
                      [:r.y1 - r.y0, :r.x1 - r.x0])
        rds.append(rd)
        origins.append((r.x0, r.y0))
    if tcp.mct == 1:
        if len(comps) >= 3:
            full = [(cp["res"][-1].x1 - cp["res"][-1].x0) *
                    (cp["res"][-1].y1 - cp["res"][-1].y0) for cp in comps[:3]]
            if len({len(cp["res"]) for cp in comps[:3]}) != 1 or \
                    len(set(rds[:3])) != 1 or len(set(full)) != 1:
                raise _Fail("MCT over components of other sizes")
            # component 0's transform picks RCT or ICT; a component of the
            # other kind has its 32-bit samples taken as the other type
            rct = comps[0]["tccp"].qmfbid == 1
            kind = np.int32 if rct else np.float32
            y, u, v = (np.ascontiguousarray(p).view(kind) for p in planes[:3])
            with np.errstate(all="ignore"):
                if rct:
                    g = y - ((u + v) >> 2)
                    yuv = [v + g, g, u + g]
                else:
                    yuv = [y + v * np.float32(1.402),
                           y - u * np.float32(0.34413) -
                           v * np.float32(0.71414),
                           y + u * np.float32(1.772)]
            planes[:3] = [x.view(p.dtype) for x, p in zip(yuv, planes[:3])]
    out = []
    for cp, a, shift in zip(comps, planes, tcp.shifts):
        prec, sgnd = cp["prec"], cp["sgnd"]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else \
            (0, (1 << prec) - 1)
        if cp["tccp"].qmfbid == 1:
            # the sum in int32 (it wraps), then the clamp
            v = a.astype(np.int64) + shift
            v = np.clip((v + 2**31) % 2**32 - 2**31, lo, hi)
        else:
            # lrintf in int64, the shift, then the clamp; beyond INT_MAX /
            # INT_MIN and NaN take the bounds
            with np.errstate(invalid="ignore"):
                f = np.clip(a, np.float32(-2**31), np.float32(2**31))
                nan = np.isnan(f)
                v = np.clip(np.rint(np.where(nan, 0, f).astype(np.float64))
                            .astype(np.int64) + shift, lo, hi)
                v[a > np.float32(2**31)] = hi
                v[(a < np.float32(-2**31)) | nan] = lo
        out.append(v)
    return box, out, origins


# ---------------------------------------------------------------------------
# OpenJPEG's whole-image API (opj_read_header, opj_decode), as OpenCV's
# Jpeg2KOpjDecoder drives it
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Component:
    """An opj_image_comp_t after opj_decode: `data` (int64 [h, w], the
    component's w x h samples at (x0, y0) on its own grid), its precision,
    sign and sub-sampling."""

    data: np.ndarray
    prec: int
    sgnd: int
    dx: int
    dy: int
    x0: int
    y0: int


class WholeImage:
    """opj_read_header of a JP2 file (OPJ_CODEC_JP2) or a bare codestream
    (OPJ_CODEC_J2K): `comps` [(prec, sgnd, dx, dy)] as SIZ and CBD give
    them and `size` (w, h) as SIZ gives it; `decode()` is opj_decode.
    Raises _Fail where OpenJPEG returns false (IndexError where the data
    runs out under the port's reading)."""

    def __init__(self, data):
        self.jp2 = None
        if data[:12] == _JP2_SIG:
            self.jp2 = _Jp2(data)
            if not self.jp2.has_jp2h or self.jp2.ihdr is None:
                raise _Fail("JP2 without jp2h or ihdr")
            if self.jp2.start is None:
                raise _Fail("no codestream")
            self.cs = _Codestream(data, self.jp2.start, self.jp2.ihdr,
                                  "2.5.3")
        else:
            self.cs = _Codestream(data, 0, release="2.5.3")
        self.comps = self.cs.comps
        self.size = (self.cs.x1 - self.cs.x0, self.cs.y1 - self.cs.y0)

    def decode(self):
        """opj_jp2_decode / opj_j2k_decode -> ([Component], colour space):
        the tiles decoded as opj_j2k_decode_tiles decodes them (it stops
        after as many tiles as the image has), each tile-component's
        samples at its decoded resolution placed as
        opj_j2k_update_image_data places them (that resolution's
        coordinates taken on the full-size grid: a component whose packets
        stop short of its last resolution fills a corner of each tile),
        the rest zeros; then JP2's colour boxes as
        opj_jp2_apply_color_postprocessing applies them."""
        cs = self.cs
        out = []
        for prec, sgnd, dx, dy in cs.comps:
            x0, y0 = _cdiv(cs.x0, dx), _cdiv(cs.y0, dy)
            out.append(Component(np.zeros((_cdiv(cs.y1, dy) - y0,
                                           _cdiv(cs.x1, dx) - x0), np.int64),
                                 prec, sgnd, dx, dy, x0, y0))
        n = 0
        for tileno in cs.tiles(whole=True):
            _, planes, origins = _decode_tile(cs, tileno)
            for comp, a, (rx0, ry0) in zip(out, planes, origins):
                sy, oy, ny = _span(comp.y0, comp.data.shape[0], ry0,
                                   a.shape[0])
                sx, ox, nx = _span(comp.x0, comp.data.shape[1], rx0,
                                   a.shape[1])
                comp.data[sy:sy + ny, sx:sx + nx] = a[oy:oy + ny, ox:ox + nx]
            n += 1
        if not n:
            raise _Fail("no tile decoded")
        if self.jp2 is None:
            return out, _UNSPECIFIED
        return _colour_boxes(self.jp2, out), self.jp2.color_space()


def _span(d0, dn, r0, rn):
    """One axis of opj_j2k_update_image_data: a component's [d0, d0 + dn)
    and a tile's decoded resolution [r0, r0 + rn) -> (the first sample
    written, the first one read, how many)."""
    if d0 < r0:
        start, off = r0 - d0, 0
        n = rn if d0 + dn >= r0 + rn else d0 + dn - r0
    else:
        start, off = 0, d0 - r0
        n = rn - off if d0 + dn >= r0 + rn else dn
    if n < 0:
        raise _Fail("a tile outside its component")
    return start, off, n


def _colour_boxes(jp2, comps):
    """opj_jp2_check_color, then pclr applied where a cmap box maps it
    (opj_jp2_apply_pclr; a pclr box alone is dropped), then cdef's
    channel swaps (opj_jp2_apply_cdef)."""
    cmap = list(jp2.cmap) if jp2.pclr is not None and jp2.cmap else None
    if jp2.cdef is not None:
        nch = len(cmap) if cmap else len(comps)
        for cn, _, asoc in jp2.cdef:
            if cn >= nch or (asoc not in (0, 65535) and asoc - 1 >= nch):
                raise _Fail("cdef names a channel past the image's")
        if set(range(nch)) - {cn for cn, _, _ in jp2.cdef}:
            raise _Fail("incomplete channel definitions")
    if cmap:
        nch = len(cmap)
        sane, used = True, [False] * nch
        for i, (cmp, mtyp, pcol) in enumerate(cmap):
            if cmp >= len(comps):
                sane = False
            if mtyp not in (0, 1) or pcol >= nch or (used[pcol] and mtyp) \
                    or (mtyp == 0 and pcol) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        if any(not u and m[1] for u, m in zip(used, cmap)):
            sane = False
        if sane and len(comps) == 1 and not all(used):
            # "Component mapping seems wrong. Trying to correct."
            cmap = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(cmap)]
        if not sane:
            raise _Fail("a cmap box OpenJPEG cannot apply")
        entries, sizes, signs = jp2.pclr
        top = len(entries) - 1
        new = []
        for i, (cmp, mtyp, pcol) in enumerate(cmap):
            old = comps[cmp]
            if mtyp == 0:
                data = old.data
            else:
                idx = np.clip(old.data, 0, top)
                data = entries[idx, pcol].view(np.int32).astype(np.int64)
            new.append(dataclasses.replace(old, data=data, prec=sizes[i],
                                           sgnd=signs[i]))
        comps = new
    if jp2.cdef is not None:
        info = [list(e) for e in jp2.cdef]
        for i, (cn, typ, asoc) in enumerate(info):
            if cn >= len(comps) or asoc in (0, 65535):
                continue
            acn = asoc - 1
            if acn >= len(comps):
                continue
            if cn != acn and typ == 0:
                comps[cn], comps[acn] = comps[acn], comps[cn]
                for e in info[i + 1:]:
                    if e[0] == cn:
                        e[0] = acn
                    elif e[0] == acn:
                        e[0] = cn
    return comps


# ---------------------------------------------------------------------------
# PIL's decoder (Jpeg2KDecode.c): tiles, unpackers, then convert("RGB")
# ---------------------------------------------------------------------------

# (mode, colour space, components) -> unpacker
_UNPACKERS = {("L", _GRAY, 1): "l", ("P", _SRGB, 1): "l",
              ("PA", _SRGB, 2): "la", ("I;16", _GRAY, 1): "i",
              ("LA", _GRAY, 2): "la",
              ("RGB", _GRAY, 1): "grey_rgb", ("RGB", _GRAY, 2): "grey_rgb",
              ("RGB", _SRGB, 3): "rgb", ("RGB", _SYCC, 3): "ycc",
              ("RGB", _SRGB, 4): "rgb", ("RGB", _SYCC, 4): "ycc",
              ("RGBA", _GRAY, 1): "grey_rgb", ("RGBA", _GRAY, 2): "la",
              ("RGBA", _SRGB, 3): "rgb", ("RGBA", _SYCC, 3): "ycc",
              ("RGBA", _GRAY, 4): "rgba", ("RGBA", _SRGB, 4): "rgba",
              ("RGBA", _SYCC, 4): "ycca",
              ("CMYK", _CMYK, 4): "rgba"}


def _word_bytes(prec):
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _shifted(v, prec, sgnd, bits):
    """j2ku_shift(offset + word, shift) of one component's samples as PIL
    reads them from OpenJPEG's buffer (1, 2 or 4 bytes, unsigned)."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift == 0:
        return (v + offset) & ((1 << bits) - 1)
    word = v & ((1 << (8 * _word_bytes(prec))) - 1)
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (offset + word) & 0xFFFFFFFF
    x = (x >> -shift) if shift < 0 else (x << shift) & 0xFFFFFFFF
    return x & ((1 << bits) - 1)


def _unpack(kind, img, box, x0, y0, planes, meta):
    """One tile through PIL's unpacker `kind` into `img` (uint8 [H, W, 4],
    or [H, W] for L, P and I;16)."""
    tx0, ty0, tx1, ty1 = box
    w, h = tx1 - tx0, ty1 - ty0
    ys, xs = slice(ty0 - y0, ty1 - y0), slice(tx0 - x0, tx1 - x0)
    if any(p.shape != (h, w) for p in planes):
        planes = _buffer_words(planes, meta, w, h, kind)
    sh = [_shifted(c, m[0], m[1], 16 if kind == "i" else 8)
          for c, m in zip(planes, meta)]
    if kind in ("l", "i"):
        img[ys, xs] = sh[0]
    elif kind == "grey_rgb":
        img[ys, xs, :3] = sh[0][..., None]
        img[ys, xs, 3] = 255
    elif kind == "la":
        img[ys, xs, :3] = sh[0][..., None]
        img[ys, xs, 3] = sh[1]
    else:
        n = 4 if kind in ("rgba", "ycca") else 3
        out = img[ys, xs]
        for i in range(n):
            out[..., i] = sh[i]
        if n == 3:
            out[..., 3] = 255
        if kind in ("ycc", "ycca"):
            out[..., :3] = _ycbcr_to_rgb(out[..., :3])


def _buffer_words(planes, meta, w, h, kind):
    """The words PIL's unpacker `kind` reads for a w x h tile whose
    components are not all w x h (sub-sampled, or stopped at a lower
    resolution): OpenJPEG's buffer (each component's samples, 1, 2 or 4
    bytes each, one after another, zero-padded to PIL's size) read as the
    unpacker indexes it: the grey ones rows of w samples (the alpha after
    w x h of the first component), the sRGB / sYCC ones rows of w / dx
    samples and sample x / dx."""
    sizes = [_word_bytes(m[0]) for m in meta]
    chunks = []
    for a, csiz in zip(planes, sizes):
        v = a.astype(np.int64) & ((1 << (8 * csiz)) - 1)
        chunks.append(v.astype("<u%d" % csiz).view(np.uint8).ravel())
    buf = np.concatenate(chunks)
    size = max(len(buf), w * h * sum(sizes)) + 4 * (w + h) + 16
    buf = np.concatenate([buf, np.zeros(size - len(buf), np.uint8)])
    yy, xx = np.mgrid[0:h, 0:w]
    if kind in ("l", "i", "grey_rgb", "la"):
        bases = [0, sizes[0] * w * h][:2 if kind == "la" else 1]
        idx = [base + csiz * (yy * w + xx)
               for base, csiz in zip(bases, sizes)]
    else:
        idx, cptr = [], 0
        for (_, _, dx, dy), csiz in zip(meta, sizes):
            idx.append(cptr + csiz * ((yy // dy) * (w // dx) + xx // dx))
            cptr += csiz * (w // dx) * (h // dy)
    out = []
    for i, csiz in zip(idx, sizes):
        word = np.zeros((h, w), np.int64)
        for k in range(csiz):
            word |= buf[i + k].astype(np.int64) << (8 * k)
        out.append(word)
    return out


def _decode(data, codec, mode, size):
    """PIL's jpeg2k decoder over OpenJPEG -> the image of `mode` ([H, W]
    or [H, W, 4]), or ValueError where it reports a broken stream."""
    try:
        if codec == "jp2":
            jp2 = _Jp2(data)
            if not jp2.has_jp2h or jp2.ihdr is None:
                raise _Fail("JP2 without jp2h or ihdr")
            if jp2.start is None:
                raise _Fail("no codestream")
            cs = _Codestream(data, jp2.start, jp2.ihdr)
            space = jp2.color_space()
        else:
            cs = _Codestream(data, 0)
            space = _UNSPECIFIED
        if not 1 <= cs.ncomp <= 4:
            raise _Fail("no unpacker for the components")
        if space == _UNSPECIFIED:
            sub = [dx != 1 or dy != 1 for _, _, dx, dy in cs.comps]
            space = _GRAY if cs.ncomp <= 2 else (
                _SYCC if not sub[0] and (sub[1] or sub[2]) else _SRGB)
        kind = _UNPACKERS.get((mode, space, cs.ncomp))
        if any(dx != 1 or dy != 1 for _, _, dx, dy in cs.comps) and \
                kind in ("l", "i", "grey_rgb", "la"):
            kind = None         # these unpackers take no sub-sampling
        if kind is None:
            raise _Fail("no unpacker for the components")
        w, h = size
        img = np.zeros((h, w) if kind in ("l", "i") and mode in
                       ("L", "P", "I;16") else (h, w, 4),
                       np.uint16 if mode == "I;16" else np.uint8)
        meta = cs.comps
        for tileno in cs.tiles():
            box, comps, _ = _decode_tile(cs, tileno)
            tx0, ty0, tx1, ty1 = box
            if tx0 >= tx1 or ty0 >= ty1 or tx0 < cs.x0 or ty0 < cs.y0 or \
                    tx1 - cs.x0 > w or ty1 - cs.y0 > h:
                raise _Fail("tile outside the image")
            _unpack(kind, img, box, cs.x0, cs.y0, comps, meta)
        return img
    except _Fail as e:
        raise _refused(f"that OpenJPEG fails on ({e})") from None
    except IndexError:
        raise _refused("that OpenJPEG fails on (data cut short)") from None


def read(data):
    """A JPEG 2000 file as `PIL.Image.open(p).convert("RGB")` gives it:
    uint8 [H, W, 3]. Raises _PassOn where PIL's plugin passes the file on,
    ValueError where PIL refuses it."""
    codec, size, mode, palette = _open(data)
    _opened(_FMT, *size)
    img = _decode(data, codec, mode, size)
    if mode in ("P", "PA"):
        return _rgb("P", img if img.ndim == 2 else img[..., 0], palette)
    return _rgb(mode, img)


def read_icns_resource(data):
    """An ICNS JPEG 2000 icon resource as IcnsImagePlugin reads it:
    Jpeg2KImageFile over its bytes, then convert("RGBA") (which gives
    what convert("RGB") gives, once the alpha is dropped) -> uint8
    [H, W, 3]."""
    try:
        return read(data)
    except _PassOn:
        raise _refused("in an ICNS icon that PIL cannot identify") from None
