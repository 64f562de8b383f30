"""Old-style JPEG TIFF (compression 6) as PIL 12.1.0 reads it through
libtiff 4.7.1's OJPEG codec (tif_ojpeg.c; its source is not at hand: the
rules below were settled against PIL on generated and edited files).

libtiff never hands libjpeg the file's JPEG bytes as they are. It reads
the markers of one byte source, the JPEGInterchangeFormat stream and then
every strip or tile in turn, up to the first SOS, keeping the tables, DRI,
SOF and SOS it meets; without a SOF there it makes one from the tags
(JPEGQTables, JPEGDCTables and JPEGACTables at their offsets, component ids
0-2, the YCbCrSubsampling). It then writes a stream of its own: SOI, the
quantisation tables 0-3, the DC and AC Huffman tables 0-3, a DRI where
there is a restart interval (a file of several strips gets one a strip),
the SOF, an SOS of the plane's components (Ss 0, Se 63, Ah Al 0), the rest
of the source as entropy-coded data with an RSTn after each strip but the
last, and EOI (`_stream`). The JPEG's own sampling wins over the tag's
(OJPEGSubsamplingCorrect); for a sampling a TIFF cannot hold libtiff asks
libjpeg to upsample, and then refuses the factors libjpeg starts with.

A file of three samples that libtiff calls YCbCr goes, as PIL reads it,
through libtiff's RGBA reader: libjpeg's raw (downsampled) components
packed into the TIFF's YCbCr data units, a strip at a time, each converted
by libtiff's tables (`cvtiff.ycbcr_units`, `ycbcr_to_rgb`); planes, one
libjpeg session each. A one-sample file is read a strip at a time as
libjpeg's samples. libtiff's decoder runs one libjpeg session over a
plane's strips: an error in it (a restart marker out of order, which its
resync_to_restart refuses, or a source that runs dry) makes that strip's
read give zeros, and the next strip's skip over the failed one fails,
which PIL refuses.
"""
from __future__ import annotations

import struct

import numpy as np

from . import cvtiff, imageio, tiffdir

_SOF = (0xC0, 0xC1, 0xC3)       # the frames tif_ojpeg.c takes
_BUDGET = 1 << 20               # bytes past what libjpeg can read


def _refused(what):
    return imageio._tiff_refused(f"of old-style JPEG {what} (libtiff fails)")


class _Dry(Exception):
    """OJPEGReadBufferFill found no more data."""


class _Stuck(ValueError):
    """libjpeg failed to start on libtiff's stream (OJPEGWriteHeaderInfo),
    which leaves the codec unable to start another session."""


def _tags(d):
    """What OJPEGVSetField keeps of the directory's tags (an entry of a
    bad type, count or value is ignored): JPEGInterchangeFormat and its
    length, the restart interval, the offsets of the three kinds of
    tables (a count past 3 ignores the tag)."""
    def one(tag, bits):
        if tag not in d.entries:
            return 0
        try:
            return d._scalar(tag, bits)
        except tiffdir._Err:
            return 0

    def offsets(tag):
        try:
            v = d._values(tag) if tag in d.entries else ()
        except tiffdir._Err:
            v = ()
        return list(v) + [0] * (3 - len(v)) if len(v) <= 3 else [0] * 3

    return dict(jif=one(513, 64), jif_len=one(514, 64),
                restart=one(515, 16), q=offsets(519), dc=offsets(520),
                ac=offsets(521))


class _Source:
    """OJPEGReadBufferFill's byte source: the JPEGInterchangeFormat bytes,
    then each strip's (an offset of 0 or past the file's end skipped, a
    byte count of 0 read to the file's end, one past it cut there). A
    strip table libtiff lacks dries the source up. The reads of
    OJPEGReadByte / Word / Block cross from one part to the next;
    OJPEGReadSkip stops at its part's end."""

    def __init__(self, d, jif, jif_len):
        data, n = d.data, len(d.data)
        self.data = data
        self.parts = []                  # (start, end, strip or -1)
        if jif:
            self.parts.append((jif, jif + jif_len, -1))
        for k in range(d.n_chunks):
            if d.offsets is None:
                self.parts.append(None)
                break
            off = d.offsets[k]
            if off == 0:
                continue
            if d.counts is None:
                self.parts.append(None)
                break
            if off >= n:
                continue
            count = d.counts[k]
            end = n if count == 0 or off + count > n else off + count
            self.parts.append((off, end, k))
        self.i, self.pos, self.end = -1, 0, 0

    def _next(self):
        self.i += 1
        if self.i >= len(self.parts) or self.parts[self.i] is None:
            self.i = len(self.parts)
            raise _Dry
        self.pos, self.end = self.parts[self.i][:2]

    def peek(self):
        while self.pos >= self.end:
            self._next()
        return self.data[self.pos]

    def byte(self):
        v = self.peek()
        self.pos += 1
        return v

    def word(self):
        return self.byte() << 8 | self.byte()

    def block(self, n):
        return bytes(self.byte() for _ in range(n))

    def skip(self, n):
        self.pos += min(n, self.end - self.pos)


class _Codec:
    """The state of tif_ojpeg.c that its header readers fill: the tables
    (whole segments, by id), DRI, SOF and SOS."""

    def __init__(self, d, spp, hv, restart):
        self.d, self.spp, self.hv = d, spp, hv
        self.per_plane = spp if d.planar == 1 else 1
        self.restart = restart
        self.q, self.dc, self.ac = {}, {}, {}
        self.sof = None                  # marker, y, x, [(id, hv, tq)]
        self.sos = [(0, 0)] * spp        # (id, tables) a component
        self.corrected = None            # (first SOF's hv, upsampled)
        tw = d.tile[0] if d.tile else d.width
        tl = d.tile[1] if d.tile else min(d.rows, d.length) \
            if d.rows != 0xFFFFFFFF else d.length
        self.strile = (tw, tl)
        self.total = -(-d.length // tl) * tl if d.tile else d.length

    # -- OJPEGReadHeaderInfoSec ---------------------------------------------
    def read_header(self, src, correct):
        """The markers of the source up to the first SOS, or to a byte
        that starts no marker; `correct`: OJPEGSubsamplingCorrect's pass,
        which reads only the first SOF's sampling (returns it, or None)
        and never fails. Raises ValueError where libtiff fails."""
        try:
            while True:
                if src.peek() != 0xFF:
                    break
                src.byte()
                m = src.byte()
                while m == 0xFF:
                    m = src.byte()
                if m == 0xD8:
                    continue
                if m == 0xFE or 0xE0 <= m <= 0xEF:
                    n = src.word()
                    if n < 2:
                        raise _refused("segment shorter than its length")
                    if n > 2:
                        src.skip(n - 2)
                elif m == 0xDD:
                    if src.word() != 4:
                        raise _refused("DRI")
                    self.restart = src.word()
                elif m == 0xDB:
                    self._dqt(src, correct)
                elif m == 0xC4:
                    self._dht(src, correct)
                elif m in _SOF:
                    hv = self._sof(src, m, correct)
                    if correct:
                        return hv
                elif m == 0xDA:
                    if correct:
                        return self.corrected
                    self._sos(src)
                    return None
                else:
                    raise _refused(f"marker 0x{m:02X} in its header")
        except _Dry:
            if correct:
                return self.corrected
            raise _refused("data that ends in its header") from None
        except ValueError:
            if correct:
                return self.corrected
            raise
        if not correct and self.sof is None:
            self._from_tags()
        return None

    def _dqt(self, src, correct):
        n = src.word()
        if n <= 2:
            raise _refused("DQT")
        if correct:
            src.skip(n - 2)
            return
        n -= 2
        while n > 0:
            if n < 65:
                raise _refused("DQT")
            t = src.block(65)
            if t[0] & 15 > 3:
                raise _refused("DQT")
            self.q[t[0] & 15] = _seg(0xDB, t)
            n -= 65

    def _dht(self, src, correct):
        n = src.word()
        if n <= 2:
            raise _refused("DHT")
        if correct:
            src.skip(n - 2)
            return
        t = src.block(n - 2)
        k = t[0]
        if k >> 4 not in (0, 1) or k & 15 > 3:
            raise _refused("DHT")
        (self.ac if k >> 4 else self.dc)[k & 15] = _seg(0xC4, t)

    def _sof(self, src, marker, correct):
        if self.sof is not None:
            raise _refused("second SOF")
        m = src.word()
        if m < 11 or (m - 8) % 3:
            raise _refused("SOF")
        n = (m - 8) // 3
        if not correct and n != self.spp:
            raise _refused("SOF of another number of samples")
        if src.byte() != 8:
            raise _refused("SOF of other than 8 bits")
        w, tw = self.d.width, self.strile[0]
        if correct:
            src.skip(4)
        else:
            y = src.word()
            if y < self.d.length and y < self.total:
                raise _refused("SOF of a smaller height")
            x = src.word()
            if (x < w and x < tw) or x > tw:
                raise _refused("SOF of another width")
        if src.byte() != n:
            raise _refused("SOF")
        comps = []
        for q in range(n):
            c, hv = src.byte(), src.byte()
            if correct:
                # what OJPEGSubsamplingCorrect keeps, even where the
                # reading fails after it
                if q == 0:
                    self.corrected = (hv, hv >> 4 not in (1, 2, 4) or
                                      hv & 15 not in (1, 2, 4))
                elif hv != 0x11:
                    self.corrected = (self.corrected[0], True)
            elif not self.force and hv != (self.hv if q == 0 else 0x11):
                raise _refused("SOF of another sampling")
            comps.append((c, hv, src.byte()))
        if correct:
            return self.corrected
        self.sof = (marker, y, x, comps)
        return None

    def _sos(self, src, plane=0):
        if self.sof is None:
            raise _refused("SOS before its SOF")
        if src.word() != 6 + 2 * self.per_plane or \
                src.byte() != self.per_plane:
            raise _refused("SOS")
        for o in range(plane, plane + self.per_plane):
            self.sos[o] = (src.byte(), src.byte())
        src.skip(3)

    def secondary_sos(self, src, plane):
        """OJPEGReadSecondarySos: from the end of the last plane's SOS,
        the data up to the next SOS marker, and that SOS, plane by plane
        up to `plane`."""
        try:
            for p in range(1, plane + 1):
                while True:
                    m = src.byte()
                    if m == 0xFF:
                        while m == 0xFF:
                            m = src.byte()
                        if m == 0xDA:
                            break
                self._sos(src, p)
        except _Dry:
            raise _refused("plane without its SOS") from None

    def _from_tags(self):
        """OJPEGReadHeaderInfoSecTables*: the tables at the tags' offsets
        (one a sample, a sample whose offset is the previous one's reusing
        its table; an offset repeated further back fails), then a SOF0 of
        the strip's or tile's width and the image's length in whole
        strips or tiles, component ids 0-2."""
        data, tags = self.d.data, self.tags
        tq, tda = [0] * self.spp, [0] * self.spp
        for key in ("q", "dc", "ac"):
            offs = tags[key]
            if offs[0] == 0:
                raise _refused("without its JPEG tables")
            for m in range(self.spp):
                if offs[m] == 0 or (m and offs[m] == offs[m - 1]):
                    if key == "q":
                        tq[m] = tq[m - 1]
                    elif key == "dc":
                        tda[m] = tda[m - 1]
                    else:
                        tda[m] |= tda[m - 1] & 15
                    continue
                if offs[m] in offs[:max(m - 1, 0)]:
                    raise _refused("tables of repeated offsets")
                if key == "q":
                    self.q[m] = _seg(0xDB, bytes([m]) +
                                     _table(data, offs[m], 64))
                    tq[m] = m
                    continue
                counts = _table(data, offs[m], 16)
                vals = _table(data, offs[m] + 16, sum(counts))
                seg = _seg(0xC4, bytes([(key == "ac") << 4 | m]) + counts +
                           vals)
                if key == "dc":
                    self.dc[m] = seg
                    tda[m] = m << 4
                else:
                    self.ac[m] = seg
                    tda[m] |= m
        hv = [self.hv] + [0x11] * (self.spp - 1)
        self.sof = (0xC0, self.total, self.strile[0],
                    [(m, hv[m], tq[m]) for m in range(self.spp)])
        self.sos = [(m, tda[m]) for m in range(self.spp)]


def _table(data, off, n):
    """n bytes of a table at `off` (TIFFReadFile: all of them, or fail)."""
    if off + n > len(data):
        raise _refused("table past the file's end")
    return data[off:off + n]


def _seg(m, body):
    return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body


def _stream(cd, src, plane, budget):
    """The JPEG stream libtiff writes for libjpeg's session of `plane`,
    from the source's position after the header: the data of the part the
    header ended in, then each later part's, an RSTn after each strip's
    but the last strip's (after which EOI); a part the header read to its
    end gets no marker; where no strip is left to read after an RSTn, the
    stream ends (libjpeg's next read fails). `budget` bounds the data,
    past what libjpeg can read."""
    out = bytearray(b"\xff\xd8")
    for tables in (cd.q, cd.dc, cd.ac):
        for t in range(4):
            out += tables.get(t, b"")
    if cd.restart & 0xFFFF:
        out += _seg(0xDD, struct.pack(">H", cd.restart & 0xFFFF))
    m, y, x, comps = cd.sof
    comps = comps[plane:plane + cd.per_plane]
    sos = cd.sos[plane:plane + cd.per_plane]
    out += _seg(m, struct.pack(">BHHB", 8, y & 0xFFFF, x & 0xFFFF,
                               len(comps)) +
                b"".join(bytes(c) for c in comps))
    out += _seg(0xDA, bytes([len(sos)]) + b"".join(bytes(c) for c in sos) +
                bytes([0, 63, 0]))
    start = len(out)
    n_rst, last = 0, cd.d.n_chunks - 1
    parts, i, pos = src.parts, src.i, src.pos
    while i < len(parts) and parts[i] is not None and \
            len(out) - start < budget:
        a, b, k = parts[i]
        if pos < b:
            out += src.data[pos:b]
            if k == last:
                return bytes(out + b"\xff\xd9")
            if k >= 0:
                out += bytes([0xFF, 0xD0 + (n_rst & 7)])
                n_rst += 1
        i += 1
        if i < len(parts) and parts[i] is not None:
            pos = parts[i][0]
    return bytes(out)


def subsampling(d):
    """The YCbCrSubsampling libtiff reports for an old-style JPEG file
    (OJPEGSubsamplingCorrect): 1 x 1 for other than three YCbCr samples;
    else the sampling of the first SOF before the first SOS, where it
    finds one, over the tag's (2 x 2 without the tag); 1 x 1 where libjpeg
    upsamples (a sampling a TIFF cannot hold). -> ((hs, vs), upsampled)."""
    if d.spp != 3 or d.photometric not in (6, 10):
        return (1, 1), False
    tags = _tags(d)
    sub = tuple(v & 0xFF for v in d.subsampling)
    cd = _Codec(d, 3, 0, tags["restart"])
    got = cd.read_header(_source(d, tags), correct=True)
    if got is None:
        return sub, False
    hv, force = got
    return ((1, 1) if force else (hv >> 4, hv & 15)), force


def _source(d, tags):
    jif, jif_len = tags["jif"], tags["jif_len"]
    n = len(d.data)
    if jif >= n:
        jif = jif_len = 0
    elif jif and (jif_len == 0 or jif + jif_len > n):
        jif_len = n - jif
    return _Source(d, jif, jif_len)


class Session:
    """libtiff's decoding of one plane (OJPEGPreDecode, OJPEGDecodeRaw /
    Scanlines): the stream libjpeg reads, its coefficients and the rows
    they give, handed over in order by `units`. ValueError where the
    setup fails (the header, or libjpeg's start)."""

    def __init__(self, d, plane=0):
        self.d = d
        spp = d.spp
        if spp not in (1, 3):
            raise _refused(f"of {spp} samples")
        self.sub, force = subsampling(d) if spp == 3 else ((1, 1), False)
        hs, vs = self.sub
        tags = _tags(d)
        cd = _Codec(d, spp, hs << 4 | vs, tags["restart"])
        cd.force, cd.tags = force, tags
        # a sampling a TIFF cannot hold is libjpeg's to upsample, which
        # fails below for three components (libtiff wants 1 x 1 factors)
        self.raw = cd.per_plane == 3 and not force
        tw, tl = cd.strile
        if tl < d.length:
            # strips or tiles of whole MCU rows, each a restart interval
            if hs not in (1, 2, 4) or vs not in (1, 2, 4):
                raise _refused("strips of an invalid sampling")
            if tl % (vs * 8):
                raise _refused("strips of other than whole MCU rows")
            cd.restart = -(-tw // (hs * 8)) * (tl // (vs * 8))
        src = _source(d, tags)
        cd.read_header(src, correct=False)
        if plane:
            cd.secondary_sos(src, plane)
        if cd.sof[0] == 0xC3:
            # libjpeg refuses libtiff's SOS (Ss 0, Se 63) in a lossless frame
            raise _refused("of a lossless SOF3 (libjpeg refuses its scan)")
        blocks = -(-cd.sof[1] // 8) * -(-cd.sof[2] // 8) * 3 + 16
        jpeg = _stream(cd, src, plane, 256 * blocks + _BUDGET)
        try:
            frame, comps, planes, latched, failed = imageio._jpeg_scans(
                jpeg, ojpeg=True)
        except (ValueError, struct.error, IndexError) as e:
            raise _Stuck(_refused(f"JPEG data libjpeg refuses ({e})")) \
                from None
        H, W, hmax, vmax, mcux, mcuy = frame
        if (hmax, vmax) != (hs, vs) or len(comps) == 3 and not self.raw \
                or W != cd.sof[2]:
            # OJPEGWriteHeaderInfo's checks of what libjpeg starts with
            raise _Stuck(_refused("sampled or sized otherwise than libtiff "
                                  "expects"))
        if self.raw and -(-tw // 8) + 2 * -(-tw // (8 * hs)) != sum(
                -(-W * c["h"] // (8 * hmax)) for c in comps):
            # OJPEGDecodeRaw's check that libjpeg's rows hold the units
            raise _refused("JPEG data of another number of MCUs a row")
        self.n_imcu = mcuy
        # the iMCU row of the MCU libjpeg stopped at (a one-component
        # scan's MCU is a block)
        if failed is None:
            self.failed = mcuy
        elif len(comps) == 1:
            self.failed = failed // -(-comps[0]["w"] // 8)
        else:
            self.failed = failed // mcux
        self.tw = tw
        self.px = []
        for ci, c in enumerate(comps):
            b = imageio._idct_islow(planes[ci], latched[ci])
            self.px.append(b.transpose(0, 2, 1, 3).reshape(c["bh"] * 8,
                                                         c["bw"] * 8))
        self.unit_row = 0                # libtiff's subsampling_convert_state
        self.dead = False

    def units(self, n_rows):
        """The next n_rows rows libtiff hands over (raw: data units, int
        [n_rows, units, hs * vs + 2]; one component: samples [n_rows,
        width]), or None where libjpeg fails in them (PIL's read of them
        then gives zeros). Past the frame's last iMCU row libjpeg gives no
        lines and libtiff's buffer keeps that row's."""
        hs, vs = self.sub
        tw = self.tw
        uh = -(-tw // hs)
        out = np.zeros((n_rows, uh, hs * vs + 2) if self.raw else
                       (n_rows, tw), np.int64)
        for r in range(n_rows):
            u = self.unit_row
            imcu = u // 8
            if self.dead or self.failed <= imcu < self.n_imcu:
                self.dead = True
                return None
            if imcu >= self.n_imcu:
                u = (self.n_imcu - 1) * 8 + u % 8
            if self.raw:
                y = _padded(self.px[0][u * vs:(u + 1) * vs], uh * hs)
                out[r, :, :hs * vs] = y.reshape(vs, uh, hs).transpose(
                    1, 0, 2).reshape(uh, hs * vs)
                out[r, :, -2] = _padded(self.px[1][u], uh)
                out[r, :, -1] = _padded(self.px[2][u], uh)
            else:
                out[r] = _padded(self.px[0][u], tw)
            self.unit_row += 1
        return out


def _padded(a, n):
    """a's last axis cut or padded with zeros to n."""
    a = a[..., :n]
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])])


def read(d, kind):
    """An old-style JPEG TIFF as PIL reads it: d its directory as libtiff
    reads it, kind PIL's mode for it ("ycbcr" or "grey", `imageio.
    _tiff_mode`) -> uint8 [H, W, 3]. A file libtiff calls YCbCr goes
    through libtiff's RGBA reader (three 8-bit samples, a sampling it has
    a routine for), a block of strips or a row of tiles at a time, each
    block's buffer fresh: a failure of the codec's setup for a block's
    first read is PIL's refusal (for a later plane or tile, zeros), a
    read libjpeg fails in gives zeros. Any other file is read strip by
    strip, and any failure is PIL's refusal."""
    if d.photometric != 6:
        if kind != "grey" or d.spp != 1:
            raise _refused("of a layout PIL reads otherwise")
        s = Session(d)
        out = np.zeros((d.length, d.width), np.uint8)
        for x0, y0, cols, rows, _, k in d.chunks():
            got = s.units(rows)
            if got is None:
                raise _refused("strip libjpeg fails in")
            v = got[:min(rows, d.length - y0), :min(cols, d.width - x0)]
            out[y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v
        return np.repeat(out[..., None], 3, -1)
    if d.spp != 3 or d.bps != 8 or kind != "ycbcr":
        raise _refused("YCbCr libtiff's RGBA reader has no routine for")
    sub = subsampling(d)[0]
    if sub not in cvtiff._YCBCR_PUT or (d.planar == 2 and sub != (1, 1)):
        raise _refused(f"sampling {sub} (libtiff's RGBA reader has no "
                       "routine for it)")
    d.subsampling = sub
    cvtiff.ycbcr_to_rgb(d, np.zeros((0, 3), np.int64))  # its tables' checks
    if d.planar == 2:
        return _read_planar(d)
    s = Session(d)
    hs, vs = sub
    line = -(-s.tw // hs) * (hs * vs + 2)
    per_row = -(-d.width // s.tw) if d.tile else 1
    block = {}

    def chunk(k, n):
        first = k % per_row == 0
        if s.dead:
            # the codec's skip over the strip libjpeg failed in fails
            if first:
                raise _refused("strip after the one libjpeg fails in")
            return bytes(n)
        if first:
            block["buf"] = np.zeros(n, np.uint8)
        got = s.units(n // line)
        if got is None:
            block["buf"][:] = 0
        else:
            block["buf"][:got.size] = got.reshape(-1)
        return block["buf"].tobytes()

    return cvtiff.ycbcr_to_rgb(d, cvtiff.ycbcr_units(d, chunk)).astype(
        np.uint8)


def _read_planar(d):
    """A planar YCbCr file (1 x 1) as libtiff's RGBA reader reads it
    (gtStripSeparate / gtTileSeparate, putseparate8bitYCbCr11tile): each
    block's Y, Cb and Cr strips, one libjpeg session a plane; a plane
    whose setup fails reads as zeros, except the first plane of a block,
    which PIL refuses."""
    sessions, stuck = [], False
    for plane in range(3):
        try:
            if stuck:
                raise _refused("plane after one libjpeg fails to start on")
            sessions.append(Session(d, plane))
        except ValueError as e:
            if plane == 0 or d.n_chunks > 3:
                # a later plane's failure leaves the codec unable to start
                # plane 0's session again, or (its search for its SOS) moves
                # the source plane 0's session reads from: PIL refuses the
                # file at its next block
                raise
            stuck = stuck or isinstance(e, _Stuck)
            sessions.append(None)
    w, h = d.width, d.length
    ycc = np.zeros((h, w, 3), np.int64)
    for x0, y0, cols, rows, plane, k in d.chunks():
        s = sessions[plane]
        if s is None or s.dead:
            if plane == 0 and (x0 == 0 or s is None):
                raise _refused("strip libtiff fails to set up for")
            continue
        got = s.units(rows)
        if got is not None:
            v = got[:min(rows, h - y0), :min(cols, w - x0)]
            ycc[y0:y0 + v.shape[0], x0:x0 + v.shape[1], plane] = v
    return cvtiff.ycbcr_to_rgb(d, ycc).astype(np.uint8)
