"""TIFF directories as the two libraries the JAX package reaches read
them: PIL's TiffImagePlugin (its own IFD reader and `_setup`, which pick
the mode, the size and, for uncompressed files, the strips PIL reads
itself) and libtiff 4.7 (`TIFFReadDirectory`, which PIL's decoder for
compressed files and OpenCV's TIFF reader both run). The two disagree on
edited files: PIL keeps the tags it read before a tag whose data lies past
the file's end, takes the last of two entries of one tag and skips types
it does not know; libtiff needs the whole directory, keeps the first of
two entries, refuses an entry of the wrong type or count for the tags
that lay the image out, pads a short strip table with zeros and estimates
a missing or zero byte count (ROADMAP C26).

Errors follow `pilread`'s convention: `pilread._PassOn` where PIL takes
the file as not this format (SyntaxError, TypeError, KeyError,
IndexError), ValueError where the library refuses it.
"""
from __future__ import annotations

import struct
from fractions import Fraction

import numpy as np

from . import pilread

# entry type -> (struct code, bytes) of the types PIL's directory loads
# (ImageFileDirectory_v2._load_dispatch; 17 and 18 are skipped there)
PIL_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
             5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
             9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
             13: ("I", 4), 16: ("Q", 8)}
# the bytes of each type libtiff knows (TIFFDataWidth)
_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_INT_TYPES = {1: "B", 6: "b", 3: "H", 8: "h", 4: "I", 9: "i", 16: "Q",
              17: "q"}
# the spec'd number of values of the tags `_setup` reads (PIL's TiffTags:
# 1 is a scalar, 0 a tuple of any length)
_PIL_LENGTH = {256: 1, 257: 1, 258: 0, 259: 1, 262: 1, 266: 1, 273: 0,
               274: 1, 277: 1, 278: 1, 279: 0, 284: 1, 317: 1, 320: 0,
               322: 1, 323: 1, 324: 0, 325: 0, 338: 0, 339: 0, 347: 1,
               530: 2, 532: 6}
# PIL's COMPRESSION_INFO: the codes it names (any other is a KeyError)
PIL_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946,
                    34676, 34677, 34925, 50000, 50001)


def _rational(n, d):
    """PIL's IFDRational: a fraction, NaN for a zero denominator."""
    return float("nan") if d == 0 else Fraction(n, d)


def pil_ifd(data, bo, big=False):
    """IFD 0 as PIL's ImageFileDirectory_v2 loads it and `tag_v2` gives
    each value: {tag: value}. `big`: BigTIFF's layout (8-byte counts and
    offsets, 20-byte entries, values of up to 8 bytes in the entry). An
    entry of a type PIL does not load, or of no values, is skipped; an
    entry whose data lies past the file's end, or a directory cut by it,
    ends the reading with the tags read so far (PIL warns). BYTE and
    UNDEFINED values are bytes, ASCII a str, rationals fractions; a tag of
    one spec'd value is that value (the first of several), any other a
    tuple (one value of a tag PIL does not know: that value)."""
    n_data = len(data)
    tags = {}
    word, entry, inline = ("Q", 20, 8) if big else ("I", 12, 4)
    pos, = struct.unpack(bo + word, data[8:16] if big else data[4:8])
    head = 8 if big else 2
    if pos + head > n_data:
        return tags
    n, = struct.unpack(bo + ("Q" if big else "H"), data[pos:pos + head])
    for k in range(n):
        e = pos + head + entry * k
        if e + entry > n_data:
            break
        tag, typ, count = struct.unpack(bo + "HH" + word,
                                        data[e:e + 4 + inline])
        if typ not in PIL_TYPES:
            continue
        fmt, unit = PIL_TYPES[typ]
        size = unit * count
        if size > inline:
            at, = struct.unpack(bo + word, data[e + 4 + inline:e + entry])
            if at + size > n_data:
                break                         # _safe_read: OSError, caught
        else:
            at = e + 4 + inline
        if size == 0:
            continue
        raw = data[at:at + size]
        if typ in (1, 7):
            v = raw
        elif typ == 2:
            v = (raw[:-1] if raw.endswith(b"\0") else raw).decode("latin-1")
        else:
            v = struct.unpack(bo + fmt * count, raw)
            if typ in (5, 10):
                v = tuple(_rational(v[i], v[i + 1])
                          for i in range(0, len(v), 2))
        length = _PIL_LENGTH.get(tag)
        if typ == 1 or (typ in (2, 7) and length == 1):
            tags[tag] = v
        elif typ in (2, 7):
            tags[tag] = v if length is None else (v,)
        elif length == 1 or (length is None and len(v) == 1):
            tags[tag] = v[0]
        else:
            tags[tag] = v
    return tags


class PilSetup:
    """What PIL's `TiffImageFile._setup` takes from the tags, up to the
    mode: `compression`, `planar`, `photo`, `fill`, `xsize`, `ysize`,
    `sample_format`, `bps`, `extra`, `spp` (tuples where PIL has
    sequences)."""

    def __init__(self, tags):
        try:
            self._setup(tags)
        except (TypeError, KeyError, IndexError):
            raise pilread._PassOn from None

    def _setup(self, t):
        comp = t.get(259, 1)
        if comp not in PIL_COMPRESSIONS:
            raise KeyError(comp)                  # COMPRESSION_INFO[...]
        self.compression = int(comp)
        self.planar = t.get(284, 1)
        photo = t.get(262, 0)
        if self.compression == 6:                 # old-style JPEG
            photo = 6
        self.photo = photo
        self.fill = t.get(266, 1)
        if 256 not in t or 257 not in t:
            raise TypeError("Missing dimensions")
        xsize, ysize = t[256], t[257]
        if type(xsize) is not int or type(ysize) is not int:
            raise ValueError("TIFF of invalid dimensions: PIL refuses it")
        self.xsize, self.ysize = xsize, ysize
        sf = t.get(339, (1,))
        if len(sf) > 1 and max(sf) == min(sf) == 1:
            sf = (1,)
        bps = t.get(258, (1,))
        extra = t.get(338, ())
        spp = t.get(277, 3 if self.compression == 6 and photo in (2, 6)
                    else 1)
        if spp > 6:                               # MAX_SAMPLESPERPIXEL
            raise pilread._PassOn
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            raise pilread._PassOn                 # unknown data organization
        # OPEN_INFO's keys are tuples of ints: bytes or strings match none
        if not all(isinstance(x, tuple) and all(type(v) is int for v in x)
                   for x in (sf, bps, extra)) or type(photo) is not int \
                or self.fill not in (1, 2):
            raise pilread._PassOn                 # unknown pixel mode
        self.sample_format, self.bps, self.extra = sf, bps, extra
        self.spp = spp


def pil_strips(tags, s):
    """The tiles PIL reads an uncompressed file by (its `_setup`):
    [(x0, y0, x1, y1, plane, offset, stride)], stride the bytes a row of
    a tile past the right edge (0: the tile's own width). Strips or tiles
    the offsets do not reach are left black; an extent outside the image
    or of no pixels is refused (setimage's ValueError)."""
    if 273 in tags:
        offsets = tags[273]
        h = tags.get(278, s.ysize)
        w = s.xsize
    elif 324 in tags:
        offsets = tags[324]
        w, h = tags.get(322), tags.get(323)
        if type(w) is not int or type(h) is not int:
            raise ValueError("TIFF of invalid tile dimensions: PIL refuses "
                             "it")
    else:
        raise pilread._PassOn                     # unknown data organization
    try:
        offsets = tuple(offsets)
        if w == s.xsize and h == s.ysize and s.planar != 2:
            offsets = offsets[-1:]               # every tile covers the image
        out = []
        x = y = layer = 0
        for off in offsets:
            stride = w * sum(s.bps) / 8 if x + w > s.xsize else 0
            if s.planar == 2:
                stride /= len(s.bps)
            out.append((x, y, min(x + w, s.xsize), min(y + h, s.ysize), layer,
                        off, int(stride)))
            x += w
            if x >= s.xsize:
                x, y = 0, y + h
                if y >= s.ysize:
                    y = 0
                    layer += 1
    except TypeError:
        raise pilread._PassOn from None
    # PIL's setimage reads extents with x0 == x1 == 0 as the whole image
    out = [(0, 0, s.xsize, s.ysize) + t[4:] if t[0] == t[2] == 0 else t
           for t in out]
    for x0, y0, x1, y1, *_ in out:
        if not (0 <= x0 < x1 <= s.xsize and 0 <= y0 < y1 <= s.ysize):
            raise ValueError("TIFF tile outside the image: PIL refuses it "
                             "(tile cannot extend outside image)")
    return out


# ---------------------------------------------------------------------------
# libtiff's TIFFReadDirectory
# ---------------------------------------------------------------------------

LOGL, LOGLUV = 32844, 32845


def sgilog_setup(d):
    """libtiff's LogLuvSetupDecode of a LogLuv or LogL directory d for the
    data format the caller has set (LogLuvInitState, LogL16InitState):
    ValueError where it fails, as every strip then fails. LogLuv takes
    contiguous samples only, LogL one sample (`imageio._tiff_codec_setup`
    refuses SGILog of any other photometric)."""
    if d.photometric == LOGLUV and d.planar != 1:
        raise _refused("SGILog of planar samples (SGILog cannot handle "
                       "non-contiguous data)")
    if d.photometric == LOGL and d.spp != 1:
        raise _refused(f"LogL of {d.spp} samples")


class _Err(Exception):
    """A TIFFReadDirEntry* error (count, type, range or I/O)."""


def _refused(what):
    return ValueError(f"TIFF {what} (libtiff refuses it)")


class LibtiffDir:
    """Directory 0 as libtiff 4.7's TIFFReadDirectory sets it up: the
    fields `width`, `length`, `bps`, `spp`, `compression`, `photometric`
    (None when absent), `planar`, `fill`, `sample_format`, `predictor`,
    `rows` (rows a strip), `tile` ((width, length) or None), `extra`,
    `colormap`, `jpegtables`, `subsampling`, `inkset`, `orientation`,
    `offsets` and `counts` (one a strip or tile, as libtiff reads and
    mends them). Raises ValueError where TIFFReadDirectory fails."""

    def __init__(self, data, bo):
        self.data, self.bo = data, bo
        n_data = len(data)
        # TIFFClientOpen's header checks: version 42, or 43 (BigTIFF) with
        # an offset size of 8 and a zero word after it
        if len(data) < 8:
            raise _refused("header cut by the file's end")
        version, = struct.unpack(bo + "H", data[2:4])
        self.big = version == 43
        if version not in (42, 43):
            raise _refused(f"of version {version}")
        if self.big and (len(data) < 16 or struct.unpack(
                bo + "HH", data[4:8]) != (8, 0)):
            raise _refused("BigTIFF header")
        word, entry = ("Q", 20) if self.big else ("I", 12)
        self.word, self.inline = word, 8 if self.big else 4
        pos, = struct.unpack(bo + word, data[8:16] if self.big else data[4:8])
        head = 8 if self.big else 2
        if pos + head > n_data:
            raise _refused("directory count past the file's end")
        n, = struct.unpack(bo + ("Q" if self.big else "H"),
                           data[pos:pos + head])
        if n > 4096 or pos + head + entry * n > n_data:
            raise _refused("directory past the file's end")
        self.n_entries = n
        entries = {}
        self.all_entries = []
        for k in range(n):
            e = pos + head + entry * k
            tag, typ, count = struct.unpack(bo + "HH" + word,
                                            data[e:e + 4 + self.inline])
            self.all_entries.append((typ, count))
            entries.setdefault(tag, (typ, count, e + 4 + self.inline))
        self.entries = entries
        # libtiff's CCITT decoder state, kept from one strip to the next
        # (`imageio._tiff_fax`)
        self.fax_runs = None
        self._read()

    # -- TIFFReadDirEntry* --------------------------------------------------
    def _values(self, tag, limit=None, types=_INT_TYPES):
        """The integer values of an entry (at most `limit`), as libtiff's
        array readers check them."""
        typ, count, vpos = self.entries[tag]
        if typ not in types:
            raise _Err("type")
        n = count if limit is None else min(count, limit)
        unit = _WIDTH[typ]
        # the entry's own count (up to 10) decides whether its values sit
        # in the entry or at the offset it holds (ArrayWithLimit)
        if min(count, 10) * unit <= self.inline and n * unit <= self.inline:
            at = vpos
        else:
            at, = struct.unpack(self.bo + self.word,
                                self.data[vpos:vpos + self.inline])
        if at + n * unit > len(self.data):
            raise _Err("io")
        v = struct.unpack(self.bo + types[typ] * n,
                          self.data[at:at + n * unit])
        if any(x < 0 for x in v):
            raise _Err("range")
        return v

    def floats(self, tag, n, default):
        """A float tag of n values as libtiff's TIFFReadDirEntryFloatArray
        gives them (a rational as float(num) / float(den), 0 for a zero
        denominator), or `default` where the entry is missing or not of n
        values."""
        if tag not in self.entries:
            return default
        typ, count, vpos = self.entries[tag]
        codes = {5: "II", 10: "ii", 11: "f", 12: "d"}
        if count != n or typ not in codes and typ not in _INT_TYPES:
            return default
        unit = _WIDTH[typ]
        at = vpos if n * unit <= self.inline else struct.unpack(
            self.bo + self.word, self.data[vpos:vpos + self.inline])[0]
        if at + n * unit > len(self.data):
            return default
        code = codes.get(typ) or _INT_TYPES[typ]
        v = struct.unpack(self.bo + code * n, self.data[at:at + n * unit])
        f32 = np.float32
        if typ in (5, 10):
            return [f32(0) if v[2 * i + 1] == 0 else
                    f32(v[2 * i]) / f32(v[2 * i + 1]) for i in range(n)]
        return [f32(x) for x in v]

    def _scalar(self, tag, bits):
        typ, count, _ = self.entries[tag]
        if count != 1:
            raise _Err("count")
        v, = self._values(tag)
        if v >= 1 << bits:
            raise _Err("range")
        return v

    def _short_or_persample(self, tag):
        """TIFFReadDirEntryShort, or with a count other than 1
        TIFFReadDirEntryPersampleShort (at least spp values, all equal)."""
        try:
            return self._scalar(tag, 16)
        except _Err as e:
            if str(e) != "count":
                raise
        typ, count, _ = self.entries[tag]
        if count < self.spp:
            raise _Err("count")
        v = self._values(tag)
        if any(x >= 1 << 16 for x in v):
            raise _Err("range")
        if len(set(v[:self.spp])) != 1:
            raise _Err("per-sample values differ")
        return v[0]

    def _fetch(self, tag, default, bits=16, check=None):
        """TIFFFetchNormalTag with recover: a bad entry, or a value the
        field refuses, is ignored (the default stays)."""
        if tag not in self.entries:
            return default
        try:
            v = self._scalar(tag, bits)
        except _Err:
            return default
        return v if check is None or check(v) else default

    def _must(self, tag, default, bits, check=None):
        """TIFFFetchNormalTag without recover: any failure fails the
        directory."""
        if tag not in self.entries:
            return default
        try:
            v = self._scalar(tag, bits)
        except _Err as e:
            raise _refused(f"tag {tag} of a bad {e}") from None
        if check is not None and not check(v):
            raise _refused(f"tag {tag} of value {v}")
        return v

    # -- the directory ------------------------------------------------------
    def _read(self):
        ent = self.entries
        self.spp = self._must(277, 1, 16, lambda v: v != 0)
        if 259 in ent:
            try:
                self.compression = self._short_or_persample(259)
            except _Err as e:
                raise _refused(f"compression of a bad {e}") from None
        else:
            self.compression = 1
        # the first pass: the tags that lay the image out
        self.width = self._must(256, None, 32)
        self.length = self._must(257, None, 32)
        tw = self._must(322, None, 32)
        tl = self._must(323, None, 32)
        self.planar = self._must(284, 1, 16, lambda v: v in (1, 2))
        self.rows = self._must(278, 0xFFFFFFFF, 32, lambda v: v != 0)
        self.extra = ()
        if 338 in ent:
            try:
                extra = list(self._values(338))
            except _Err as e:
                raise _refused(f"extra samples of a bad {e}") from None
            extra = [2 if v == 999 else v for v in extra]
            if len(extra) > self.spp or any(v > 2 for v in extra):
                raise _refused(f"extra samples {extra}")
            self.extra = tuple(extra)
        ojpeg = self.compression == 6
        if ojpeg and self.planar == 2 and ent.get(273, (0, 0))[1] == 1 and \
                ent.get(279, (0, 0))[1] == 1:
            self.planar = 1     # the OJPEG hack: one strip is contiguous
        if self.width is None and self.length is None:
            raise _refused("without its dimensions")
        self.width = self.width or 0
        self.length = self.length or 0
        # the second pass
        self.bps = 1
        if 258 in ent:
            try:
                self.bps = self._short_or_persample(258)
            except _Err as e:
                raise _refused(f"bits per sample of a bad {e}") from None
        self.sample_format = 1
        if 339 in ent:
            try:
                self.sample_format = self._short_or_persample(339)
            except _Err as e:
                raise _refused(f"sample format of a bad {e}") from None
            if not 1 <= self.sample_format <= 6:
                raise _refused(f"sample format {self.sample_format}")
        # MinSampleValue / MaxSampleValue are read as BitsPerSample is, and
        # SMinSampleValue / SMaxSampleValue need one value a sample: a bad
        # entry fails the directory
        for tag in (280, 281):
            if tag in ent:
                try:
                    self._short_or_persample(tag)
                except _Err as e:
                    raise _refused(f"tag {tag} of a bad {e}") from None
        for tag in (340, 341):
            if tag in ent and ent[tag][1] != self.spp:
                raise _refused(f"tag {tag} of a bad count")
        self.photometric = self._fetch(262, None)
        self.fill = self._fetch(266, 1, check=lambda v: v in (1, 2))
        self.orientation = self._fetch(274, 1, check=lambda v: 1 <= v <= 8)
        self.predictor = self._fetch(317, 1) if self.compression in (
            5, 8, 32946, 34925, 50000) else 1
        self.t4options = self._fetch(292, 0, bits=32) \
            if self.compression == 3 else 0
        self.colormap = None
        if 320 in ent and 258 in ent and self.bps <= 24:
            if ent[320][1] == 3 << self.bps:
                try:
                    self.colormap = self._values(320)
                except _Err:
                    pass
        self.jpegtables = None
        if 347 in ent and ent[347][0] == 7:
            typ, count, vpos = ent[347]
            at = vpos if count <= self.inline else struct.unpack(
                self.bo + self.word, self.data[vpos:vpos + self.inline])[0]
            if at + count <= len(self.data):
                self.jpegtables = self.data[at:at + count]
        self.subsampling = (2, 2)
        if 530 in ent:
            try:
                v = self._values(530)
                if len(v) == 2:
                    self.subsampling = v
            except _Err:
                pass
        if ojpeg:
            # TIFFReadDirectory's OJPEG hacks: a missing (or unread)
            # Photometric is YCbCr, RGB is YCbCr, a missing BitsPerSample
            # is 8, a missing SamplesPerPixel 3 for YCbCr and 1 for grey
            if self.photometric in (None, 2):
                self.photometric = 6
            if 258 not in ent:
                self.bps = 8
            if 277 not in ent and self.photometric in (0, 1, 6):
                self.spp = 1 if self.photometric in (0, 1) else 3
        if self.photometric == 3 and self.colormap is None:
            if self.bps >= 8 and self.spp == 3:
                self.photometric = 2
            elif self.bps >= 8:
                self.photometric = 1
            else:
                raise _refused("palette without its colour map")
        if tw is not None or tl is not None:
            self.tile = (tw or 0, tl or 0)
            if 0 in self.tile:
                raise _refused("of zero tiles")
            n = -(-self.width // self.tile[0]) * -(-self.length //
                                                     self.tile[1])
        else:
            self.tile = None
            n = 1 if self.rows == 0xFFFFFFFF else -(-self.length // self.rows)
        if self.planar == 2:
            n *= self.spp
        if n == 0:
            raise _refused("of zero strips")
        self.n_chunks = n
        off_tag, cnt_tag = (324, 325) if self.tile else (273, 279)
        if off_tag not in ent and not (ojpeg and not self.tile and n == 1):
            raise _refused("without its strip or tile offsets")
        self.inkset = self._fetch(332, 1)
        # "Defining non-color channels as ExtraSamples": the samples past
        # the photometric's colour channels count as unspecified extras
        colour = {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 6: 3, 8: 3, 9: 3,
                  10: 3, 32845: 3, 5: 4, 32803: 4}.get(self.photometric, 0)
        if colour and self.spp - len(self.extra) > colour:
            self.extra += (0,) * (self.spp - len(self.extra) - colour)
        # the strip (tile) tables: read up to the chunks there are, short
        # ones padded with zeros
        try:
            self.offsets = self._strile(off_tag) if off_tag in ent else None
            counts = self._strile(cnt_tag) if cnt_tag in ent else None
        except _Err as e:
            raise _refused(f"strip table of a bad {e}") from None
        if ojpeg:
            # the OJPEG codec reads its own data: no table is mended
            self.counts = counts
            return
        if counts is None:
            if (self.planar == 1 and n > 1) or (self.planar == 2 and
                                                n != self.spp):
                raise _refused("without its strip byte counts")
            counts = self._estimate()
        elif n == 1 and not self.tile and self._count_looks_bad(counts[0]):
            counts = self._estimate()
        elif self.planar == 1 and n > 2 and self.compression == 1 and \
                counts[0] != counts[1] and counts[0] and counts[1]:
            counts = self._estimate()        # "Wrong StripByteCounts field"
        self.counts = counts

    def _strile(self, tag):
        v = list(self._values(tag, limit=self.n_chunks))
        return v + [0] * (self.n_chunks - len(v))

    def _count_looks_bad(self, count):
        """ByteCountLooksBad for a one-strip image."""
        off = self.offsets[0]
        if off == 0:
            return False
        if count == 0:
            return True
        if self.compression != 1:
            return False
        size = len(self.data)
        if off <= size and count > size - off:
            return True
        return count < self.scanline() * self.length

    def scanline(self):
        """TIFFScanlineSize: the bytes of a row of a strip."""
        spp = self.spp if self.planar == 1 else 1
        return -(-self.width * spp * self.bps // 8)

    def _estimate(self):
        """EstimateStripByteCounts."""
        size = len(self.data)
        if self.compression != 1:
            if self.big:
                space = 16 + 8 + self.n_entries * 20 + 8
            else:
                space = 8 + 2 + self.n_entries * 12 + 4
            for typ, count in self.all_entries:
                if typ not in _WIDTH:
                    raise _refused(f"entry of unknown type {typ}")
                d = _WIDTH[typ] * count
                space += d if d > self.inline else 0
            space = size if size < space else size - space
            if self.planar == 2:
                space //= self.spp
            counts = [space] * self.n_chunks
            last = self.offsets[-1]
            if last + counts[-1] > size:
                counts[-1] = 0 if last >= size else size - last
            return counts
        if self.tile:
            return [self.chunk_size(self.tile[1])] * self.n_chunks
        per_image = self.n_chunks // (self.spp if self.planar == 2 else 1)
        return [self.scanline() * (self.length // per_image)] * self.n_chunks

    def chunk_size(self, rows):
        """The decoded bytes of a strip of `rows` rows, or of a tile."""
        spp = self.spp if self.planar == 1 else 1
        cols = self.tile[0] if self.tile else self.width
        return -(-cols * spp * self.bps // 8) * rows

    def chunks(self):
        """(x0, y0, cols, rows, plane, k) of each strip or tile k, as
        libtiff lays them out: planes, then rows, then columns; rows a
        strip (or the tile's), the last strip cut at the image's end."""
        w, h = self.width, self.length
        tw, th = self.tile if self.tile else (w, min(self.rows, h))
        k = 0
        for plane in range(self.spp if self.planar == 2 else 1):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    yield x0, y0, tw, th if self.tile else min(th, h - y0), \
                        plane, k
                    k += 1

    def chunk(self, k):
        """The raw bytes of strip or tile k (TIFFFillStrip / TIFFFillTile):
        refused for a zero byte count or one past the file's end."""
        off, count = self.offsets[k], self.counts[k]
        if count == 0 or count > len(self.data) or off > len(self.data) - count:
            raise _refused(f"strip or tile {k} of {count} bytes at {off}")
        return self.data[off:off + count]
