"""AVIF files on PIL's route, decoded as PIL 12.1.0's `AvifImagePlugin`
decodes them: PIL hands the whole file to libavif 1.3.0, which parses the
HEIF container (`avifParse`), gives the primary item's AV1 key frame (and
its alpha auxiliary item's) to dav1d 1.5.1 and converts the planes to
8-bit RGB or RGBA (libyuv where it has the matrix, else libavif's own
path); `convert("RGB")` then drops the alpha.

Decoded here, bit for bit: single-image files (`ftyp` brand `avif` /
`mif1`) whose primary item is one `av01` item holding an 8-bit AV1 key
frame, at 4:4:4, 4:2:2, 4:2:0 or 4:0:0, in one tile or several: coded
lossless (`base_q_idx` 0 and no delta q: CodedLossless), or lossy with
the quantiser, every intra transform size and type and the deblocking
filter (what aom writes at speeds 5-10), with any intra tool, intra block
copy among them (what aom writes for flat and screen-like images: the
displacement vectors, the var-tx tree and the inter transform sets); the
alpha item too where it is such a frame. The container, the OBUs and the
headers are read here; the tiles go to `csrc/av1_codec.cpp`
(`native.av1_decode_frame`).

What libavif or dav1d refuse raises ValueError (PIL's own refusal: a
container libavif cannot parse is PIL's SyntaxError, which passes the file
on to the plugins after AVIF: `pilread` does that through `PassOn`). What
PIL decodes and this module does not yet raises NotImplementedError naming
ROADMAP queue A's sub-item: 7e.8a.2b (CDEF, loop restoration, delta q /
lf, quantiser matrices, segments' alt-q / alt-lf), 7e.8a.2c.2 (superres,
film grain), 7e.8a.3 (grid items, 10/12-bit samples, image sequences,
premultiplied alpha, other encoders' files).
"""
from __future__ import annotations

import numpy as np

from .. import native


class PassOn(Exception):
    """libavif's parse failed: PIL raises SyntaxError, which passes the
    file on to the next plugin."""


def _later(sub, what):
    return NotImplementedError(
        f"AVIF: {what} (ROADMAP queue A, item {sub})")


# ---------------------------------------------------------------------------
# AV1: OBUs, the sequence header and the frame header of a key frame

OBU_SEQUENCE_HEADER, OBU_FRAME_HEADER, OBU_TILE_GROUP = 1, 3, 4
OBU_FRAME, OBU_REDUNDANT_FRAME_HEADER = 6, 7


class _Bits:
    """MSB-first bit reader over data[pos:end]; reading past `end` is a
    truncated header, which dav1d refuses."""

    def __init__(self, data, pos=0, end=None):
        self.d = data
        self.bit = pos * 8
        self.end = (len(data) if end is None else end) * 8

    def f(self, n):
        v = 0
        for _ in range(n):
            if self.bit >= self.end:
                raise ValueError("corrupt AVIF: an AV1 header past the end "
                                 "of its OBU (dav1d refuses it)")
            v = (v << 1) | ((self.d[self.bit >> 3] >> (7 - (self.bit & 7)))
                            & 1)
            self.bit += 1
        return v

    def su(self, n):
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v

    def uvlc(self):
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1

    def ns(self, n):
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)


def _leb128(data, pos, end):
    v = 0
    for i in range(8):
        if pos >= end:
            raise ValueError("corrupt AVIF: a truncated AV1 OBU size")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, pos
    return v, pos


def _obus(data):
    """(type, temporal_id, spatial_id, payload start, payload end) of each
    OBU of a temporal unit, as dav1d splits them."""
    pos, end, out = 0, len(data), []
    while pos < end:
        h = data[pos]  # dav1d checks the forbidden bit only when strict
        typ, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            if pos >= end:
                raise ValueError("corrupt AVIF: a truncated AV1 OBU header")
            tid, sid = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = _leb128(data, pos, end)
        else:
            size = end - pos
        if size > end - pos:
            raise ValueError("corrupt AVIF: an AV1 OBU past the end of the "
                             "item's data")
        out.append((typ, tid, sid, pos, pos + size))
        pos += size
    return out


def _sequence_header(b):
    s = {}
    s["profile"] = b.f(3)
    if s["profile"] > 2:
        raise ValueError("corrupt AVIF: AV1 seq_profile > 2")
    s["still"] = b.f(1)
    s["reduced"] = b.f(1)
    s["timing"] = s["decoder_model"] = 0
    s["op_idc"] = [0]
    s["dm_present"] = [0]
    if s["reduced"]:
        if not s["still"]:
            raise ValueError("corrupt AVIF: reduced_still_picture_header "
                             "without still_picture")
        b.f(5)
    else:
        s["timing"] = b.f(1)
        if s["timing"]:
            b.f(32)
            b.f(32)
            s["equal_interval"] = b.f(1)
            if s["equal_interval"]:
                b.uvlc()
            s["decoder_model"] = b.f(1)
            if s["decoder_model"]:
                s["buffer_delay_len"] = b.f(5) + 1
                b.f(32)
                s["removal_len"] = b.f(5) + 1
                s["presentation_len"] = b.f(5) + 1
        idd = b.f(1)
        n_ops = b.f(5) + 1
        s["op_idc"], s["dm_present"] = [], []
        for _ in range(n_ops):
            s["op_idc"].append(b.f(12))
            if b.f(5) > 7:
                b.f(1)
            dm = 0
            if s["decoder_model"]:
                dm = b.f(1)
                if dm:
                    n = s["buffer_delay_len"]
                    b.f(n)
                    b.f(n)
                    b.f(1)
            s["dm_present"].append(dm)
            if idd and b.f(1):
                b.f(4)
    wb, hb = b.f(4) + 1, b.f(4) + 1
    s["max_w"], s["max_h"] = b.f(wb) + 1, b.f(hb) + 1
    s["wbits"], s["hbits"] = wb, hb
    s["frame_id"] = 0 if s["reduced"] else b.f(1)
    if s["frame_id"]:
        s["delta_frame_id_len"] = b.f(4) + 2
        s["frame_id_len"] = b.f(3) + 1 + s["delta_frame_id_len"]
    s["sb128"] = b.f(1)
    s["filter_intra"] = b.f(1)
    s["edge_filter"] = b.f(1)
    s["order_hint_bits"] = 0
    if s["reduced"]:
        s["force_sct"], s["force_imv"] = 2, 2
    else:
        b.f(4)  # interintra, masked compound, warped motion, dual filter
        order_hint = b.f(1)
        if order_hint:
            b.f(2)  # jnt_comp, ref_frame_mvs
        s["force_sct"] = 2 if b.f(1) else b.f(1)
        if s["force_sct"] > 0:
            s["force_imv"] = 2 if b.f(1) else b.f(1)
        else:
            s["force_imv"] = 2
        if order_hint:
            s["order_hint_bits"] = b.f(3) + 1
    s["superres"] = b.f(1)
    s["enable_cdef"] = b.f(1)
    s["enable_restoration"] = b.f(1)
    # color_config
    hbd = b.f(1)
    depth = 8
    if s["profile"] == 2 and hbd:
        depth = 12 if b.f(1) else 10
    elif hbd:
        depth = 10
    s["depth"] = depth
    mono = 0 if s["profile"] == 1 else b.f(1)
    s["mono"] = mono
    cp = tc = mc = 2
    if b.f(1):
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    s["cicp"] = (cp, tc, mc)
    if mono:
        s["full_range"] = b.f(1)
        s["ssx"] = s["ssy"] = 1
        s["separate_uv_dq"] = 0
    elif cp == 1 and tc == 13 and mc == 0:
        s["full_range"] = 1
        s["ssx"] = s["ssy"] = 0
        if s["profile"] != 1 and not (s["profile"] == 2 and depth == 12):
            raise ValueError("corrupt AVIF: sRGB AV1 colours outside "
                             "4:4:4's profiles")
        s["separate_uv_dq"] = b.f(1)
    else:
        s["full_range"] = b.f(1)
        if s["profile"] == 0:
            s["ssx"] = s["ssy"] = 1
        elif s["profile"] == 1:
            s["ssx"] = s["ssy"] = 0
        elif depth == 12:
            s["ssx"] = b.f(1)
            s["ssy"] = b.f(1) if s["ssx"] else 0
        else:
            s["ssx"], s["ssy"] = 1, 0
        if s["ssx"] and s["ssy"]:
            b.f(2)  # chroma_sample_position: libavif's conversion ignores it
        s["separate_uv_dq"] = b.f(1)
    s["film_grain"] = b.f(1)
    return s


def _tile_log2(blk, target):
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _frame_header(b, s, tid, sid):
    """The uncompressed header of a shown key frame; returns its fields."""
    h = {}
    if s["reduced"]:
        frame_type, show = 0, 1
    else:
        if b.f(1):
            raise _later("7e.8a.3", "an AV1 show_existing_frame (an image "
                         "sequence)")
        frame_type = b.f(2)
        show = b.f(1)
        if show and s["decoder_model"] and not s.get("equal_interval", 0):
            b.f(s["presentation_len"])
        if not show:
            b.f(1)
    if frame_type != 0 or not show:
        raise _later("7e.8a.3", "an AV1 frame other than a shown key frame "
                     "(an image sequence)")
    h["disable_cdf_update"] = b.f(1)
    sct = b.f(1) if s["force_sct"] == 2 else s["force_sct"]
    h["allow_sc"] = sct
    if sct and s["force_imv"] == 2:
        b.f(1)
    if s["frame_id"]:
        b.f(s["frame_id_len"])
    override = 0 if s["reduced"] else b.f(1)
    b.f(s["order_hint_bits"])
    if s["decoder_model"] and b.f(1):
        for idc, dm in zip(s["op_idc"], s["dm_present"]):
            if dm:
                in_t, in_s = (idc >> tid) & 1, (idc >> (sid + 8)) & 1
                if idc == 0 or (in_t and in_s):
                    b.f(s["removal_len"])
    # frame_size
    if override:
        w, hh = b.f(s["wbits"]) + 1, b.f(s["hbits"]) + 1
    else:
        w, hh = s["max_w"], s["max_h"]
    if s["superres"] and b.f(1):
        raise _later("7e.8a.2c.2", "AV1 superres")
    h["width"], h["height"] = w, hh
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((hh + 7) >> 3)
    h["mi_cols"], h["mi_rows"] = mi_cols, mi_rows
    if b.f(1):  # render_and_frame_size_different
        b.f(16)
        b.f(16)
    # allow_intrabc (read where superres is off, as it is here); an intra
    # block copy frame reads no delta lf, loop filter, CDEF or loop
    # restoration parameters, and its vectors are whole samples
    # (force_integer_mv is 1 in an intra frame)
    ibc = h["allow_intrabc"] = b.f(1) if sct else 0
    if not s["reduced"] and not h["disable_cdf_update"]:
        b.f(1)  # disable_frame_end_update_cdf
    # tile_info
    sb128 = s["sb128"]
    sb_cols = (mi_cols + 31) >> 5 if sb128 else (mi_cols + 15) >> 4
    sb_rows = (mi_rows + 31) >> 5 if sb128 else (mi_rows + 15) >> 4
    sb_shift = 5 if sb128 else 4
    sb_size = sb_shift + 2
    max_tile_w_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_w_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    col_starts, row_starts = [], []
    if b.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and b.f(1):
            cols_log2 += 1
        tw = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = [i << sb_shift for i in range(0, sb_cols, tw)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and b.f(1):
            rows_log2 += 1
        th = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = [i << sb_shift for i in range(0, sb_rows, th)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            col_starts.append(start << sb_shift)
            size = b.ns(min(sb_cols - start, max_tile_w_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(col_starts))
        area = ((sb_rows * sb_cols) >> (min_log2_tiles + 1)
                if min_log2_tiles > 0 else sb_rows * sb_cols)
        max_th = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            row_starts.append(start << sb_shift)
            start += b.ns(min(sb_rows - start, max_th)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    if len(col_starts) > 64 or len(row_starts) > 64:
        raise ValueError("corrupt AVIF: more than 64 AV1 tile columns or rows")
    h["col_starts"] = col_starts + [mi_cols]
    h["row_starts"] = row_starts + [mi_rows]
    h["tile_bits"] = cols_log2 + rows_log2
    h["tile_size_bytes"] = 4
    if cols_log2 or rows_log2:
        if b.f(cols_log2 + rows_log2) >= len(col_starts) * len(row_starts):
            raise ValueError("corrupt AVIF: an AV1 context_update_tile_id "
                             "past the frame's tiles (dav1d refuses it)")
        h["tile_size_bytes"] = b.f(2) + 1
    # quantization_params
    base_q = b.f(8)
    dq = [b.su(7) if b.f(1) else 0]
    if not s["mono"]:
        diff_uv = b.f(1) if s["separate_uv_dq"] else 0
        dq += [b.su(7) if b.f(1) else 0, b.su(7) if b.f(1) else 0]
        if diff_uv:
            dq += [b.su(7) if b.f(1) else 0, b.su(7) if b.f(1) else 0]
    qm = b.f(1)
    if qm:
        b.f(4)
        b.f(4)
        if s["separate_uv_dq"]:
            b.f(4)
    # segmentation_params
    seg = b.f(1)
    feat = [[None] * 8 for _ in range(8)]
    if seg:
        bits = (8, 6, 6, 6, 6, 3, 0, 0)
        limit = (255, 63, 63, 63, 63, 7, 0, 0)
        for i in range(8):
            for j in range(8):
                if b.f(1):
                    if j < 5:
                        feat[i][j] = max(-limit[j], min(limit[j],
                                                        b.su(1 + bits[j])))
                    else:
                        feat[i][j] = min(limit[j], b.f(bits[j]))
    last_active, preskip = 0, 0
    for i in range(8):
        for j in range(8):
            if feat[i][j] is not None:
                last_active = i
                if j >= 5:
                    preskip = 1
    # CodedLossless: every segment's qindex 0 and no delta q (then
    # delta_q_params, loop_filter_params, cdef_params, lr_params and
    # read_tx_mode read nothing; frame_reference_mode and skip_mode
    # nothing in an intra frame)
    qindex = [base_q if feat[i][0] is None else
              max(0, min(255, base_q + feat[i][0])) for i in range(8)]
    lossless = not any(qindex) and not any(dq)
    h["lossless"], h["base_q"] = int(lossless), base_q
    h["dq"] = (dq + dq[1:] if len(dq) == 3 else dq + [0] * (5 - len(dq)))
    h["tx_mode"], h["lf"] = 0, [0] * 4 + [0, 0] + [1, 0, 0, 0, -1, 0, -1, -1,
                                                   0, 0]
    # what the port leaves to a later sub-item, raised once the header is
    # read (dav1d's refusal of a truncated header comes first)
    later = None
    if not lossless:
        if any(feat[i][j] is not None for i in range(8) for j in range(5)):
            later = ("7e.8a.2b", "AV1 segments with alt-q or alt-lf features "
                     "in a lossy frame")
        if qm:
            later = later or ("7e.8a.2b", "AV1 quantiser matrices")
        # delta_q_params, delta_lf_params
        if base_q > 0 and b.f(1):
            b.f(2)
            if not ibc and b.f(1):
                b.f(3)
            later = later or ("7e.8a.2b", "AV1 delta q / delta lf")
        # loop_filter_params, from a key frame's default deltas
        lf = h["lf"]
        if not ibc:
            lf[0], lf[1] = b.f(6), b.f(6)
            if not s["mono"] and (lf[0] or lf[1]):
                lf[2], lf[3] = b.f(6), b.f(6)
            lf[4] = b.f(3)  # sharpness
            lf[5] = b.f(1)  # loop_filter_delta_enabled
            if lf[5] and b.f(1):  # loop_filter_delta_update
                for i in range(10):
                    if b.f(1):
                        lf[6 + i] = b.su(7)
        # cdef_params
        if s["enable_cdef"] and not ibc:
            b.f(2)  # cdef_damping_minus_3
            bits = b.f(2)
            strengths = [b.f(6 if s["mono"] else 12) for _ in range(1 << bits)]
            if bits or any(strengths):
                later = later or ("7e.8a.2b", "AV1 CDEF")
        # lr_params
        if s["enable_restoration"] and not ibc:
            types = [b.f(2) for _ in range(1 if s["mono"] else 3)]
            if any(types):
                later = later or ("7e.8a.2b", "AV1 loop restoration")
        # read_tx_mode: TX_MODE_SELECT or TX_MODE_LARGEST
        h["tx_mode"] = 2 if b.f(1) else 1
    h["reduced_tx_set"] = b.f(1)
    if s["film_grain"] and b.f(1):
        later = later or ("7e.8a.2c.2", "AV1 film grain")
    if later:
        raise _later(*later)
    h["seg"] = (seg, last_active, preskip,
                sum(1 << i for i in range(8) if feat[i][6] is not None))
    return h


def _tile_groups(data, obus_tg, h, hdr_end_bit):
    """(offset, size) of every tile, from the tile group OBUs."""
    n_tiles = (len(h["col_starts"]) - 1) * (len(h["row_starts"]) - 1)
    tiles = [None] * n_tiles
    for k, (start, end) in enumerate(obus_tg):
        b = _Bits(data, start, end)
        if k == 0 and hdr_end_bit is not None:
            b.bit = hdr_end_bit
        flag = b.f(1) if n_tiles > 1 else 0
        if flag:
            tg_start, tg_end = b.f(h["tile_bits"]), b.f(h["tile_bits"])
        else:
            tg_start, tg_end = 0, n_tiles - 1
        b.bit = (b.bit + 7) & ~7
        pos = b.bit >> 3
        if tg_end < tg_start or tg_end >= n_tiles:
            raise ValueError("corrupt AVIF: an AV1 tile group out of order")
        for t in range(tg_start, tg_end + 1):
            if t == tg_end:
                size = end - pos
            else:
                tsb = h["tile_size_bytes"]
                if pos + tsb > end:
                    raise ValueError("corrupt AVIF: a truncated AV1 tile size")
                size = int.from_bytes(data[pos:pos + tsb], "little") + 1
                pos += tsb
                if size > end - pos:
                    raise ValueError("corrupt AVIF: an AV1 tile past the end "
                                     "of its tile group")
            tiles[t] = (pos, size)
            pos += size
    if any(t is None for t in tiles):
        raise ValueError("corrupt AVIF: AV1 tiles missing from the frame")
    return tiles


def decode_av1(data, alpha=False):
    """One AV1 temporal unit holding an 8-bit key frame -> (planes
    [Y, U, V] uint8 (U, V None for 4:0:0), the sequence header's fields).
    An alpha item's frame (`alpha`) of another depth is refused, as libavif
    refuses an alpha plane unlike the (8-bit) colour planes."""
    data = bytes(data)
    seq, hdr, tg, hdr_end = None, None, [], None
    for typ, tid, sid, start, end in _obus(data):
        if typ == OBU_SEQUENCE_HEADER:
            seq = _sequence_header(_Bits(data, start, end))
            if seq["depth"] != 8:
                if alpha:
                    raise ValueError("AVIF refused: an alpha plane of "
                                     f"{seq['depth']} bits under 8-bit "
                                     "colour planes")
                raise _later("7e.8a.3", f"{seq['depth']}-bit AV1 samples")
        elif typ in (OBU_FRAME_HEADER, OBU_FRAME, OBU_REDUNDANT_FRAME_HEADER):
            if seq is None:
                raise ValueError("corrupt AVIF: an AV1 frame before its "
                                 "sequence header")
            if hdr is not None:
                continue
            b = _Bits(data, start, end)
            hdr = _frame_header(b, seq, tid, sid)
            if typ == OBU_FRAME:
                b.bit = (b.bit + 7) & ~7
                tg.append((start, end))
                hdr_end = b.bit
        elif typ == OBU_TILE_GROUP:
            if hdr is None:
                raise ValueError("corrupt AVIF: an AV1 tile group before "
                                 "its frame header (dav1d refuses it)")
            tg.append((start, end))
    if seq is None or hdr is None or not tg:
        raise ValueError("corrupt AVIF: no AV1 frame in the item's data")
    tiles = _tile_groups(data, tg, hdr, hdr_end)
    ssx, ssy, mono = seq["ssx"], seq["ssy"], seq["mono"]
    mc, mr = hdr["mi_cols"], hdr["mi_rows"]
    seg = hdr["seg"]
    prm = [mc, mr, ssx, ssy, mono, seq["sb128"], seq["filter_intra"],
           seq["edge_filter"], hdr["allow_sc"], hdr["disable_cdf_update"],
           seg[0], seg[1], seg[2], seg[3], hdr["lossless"], hdr["base_q"]]
    prm += hdr["dq"] + [hdr["tx_mode"], hdr["reduced_tx_set"]] + hdr["lf"]
    prm += [hdr["width"], hdr["height"], len(hdr["col_starts"]) - 1,
            len(hdr["row_starts"]) - 1]
    prm += hdr["col_starts"] + hdr["row_starts"] + [hdr["allow_intrabc"]]
    planes = native.av1_decode_frame(data, tiles, prm, mc * 4, mr * 4,
                                     ssx, ssy, mono)
    w, h = hdr["width"], hdr["height"]
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    out = [planes[0][:h, :w]]
    out += [None, None] if mono else [p[:ch, :cw] for p in planes[1:]]
    return out, seq


# ---------------------------------------------------------------------------
# The HEIF container, read as libavif 1.3.0's avifParse reads it. Its
# results BMFF_PARSE_FAILED, INVALID_FTYP, TRUNCATED_DATA and NO_CONTENT
# reach PIL as SyntaxError (`_Bmff`: the file passes on to the next plugin);
# the others (NOT_IMPLEMENTED, MISSING_IMAGE_ITEM, ...) as RuntimeError,
# PIL's refusal.

class _Bmff(Exception):
    """A parse result that PIL raises as SyntaxError."""


_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")
# libavif's imageSizeLimit and imageDimensionLimit defaults
_SIZE_LIMIT = 16384 * 16384
_DIM_LIMIT = 32768


class _Stream:
    def __init__(self, data, pos, end):
        self.d, self.pos, self.end = data, pos, end

    def left(self):
        return self.end - self.pos

    def take(self, n):
        if n < 0 or self.pos + n > self.end:
            raise _Bmff("a box field past the end of its box")
        v = self.d[self.pos:self.pos + n]
        self.pos += n
        return v

    def u(self, n):
        return int.from_bytes(self.take(n), "big")

    def string(self):
        i = self.d.find(b"\0", self.pos, self.end)
        if i < 0:
            raise _Bmff("a string without its terminating zero")
        v = self.d[self.pos:i]
        self.pos = i + 1
        return v

    def version_flags(self):
        vf = self.u(4)
        return vf >> 24, vf & 0xFFFFFF

    def box(self, top=False):
        """(type, start of contents, end) of the next box."""
        start = self.pos
        size = self.u(4)
        typ = self.take(4)
        if size == 1:
            size = self.u(8)
        if typ == b"uuid":
            self.take(16)
        hdr = self.pos - start
        if size == 0:
            if not top:
                raise _Bmff("a box of size 0 inside another")
            size = self.end - start
        if size < hdr:
            raise _Bmff("a box smaller than its header")
        if start + size > self.end:
            if top:
                raise _Bmff("a top-level box past the end of the file")
            raise _Bmff("a box past the end of its parent")
        self.pos = start + size
        return typ, start + hdr, start + size


class _Item:
    def __init__(self, iid):
        self.id = iid
        self.type = b""
        self.extents = []
        self.size = 0
        self.idat = False
        self.props = []           # (type, parsed value)
        self.unsupported_essential = False
        self.ipma_seen = False
        self.aux_for = self.thumb_for = self.prem_by = self.desc_for = 0

    def prop(self, typ):
        for t, v in self.props:
            if t == typ:
                return v
        return None


def _parse_property(typ, s):
    """One ipco property libavif parses; None for an opaque one."""
    if typ == b"ispe":
        if s.version_flags()[0] != 0:
            raise _Bmff("ispe version")
        return (s.u(4), s.u(4))
    if typ == b"auxC":
        if s.version_flags()[0] != 0:
            raise _Bmff("auxC version")
        return s.string()
    if typ == b"colr":
        kind = s.take(4)
        if kind == b"nclx":
            cp, tc, mc, fr = s.u(2), s.u(2), s.u(2), s.u(1)
            if fr & 0x7F:
                raise _Bmff("nclx reserved bits")
            return ("nclx", cp, tc, mc, fr >> 7)
        if kind in (b"rICC", b"prof"):
            return ("icc",)
        return ("other",)
    if typ == b"av1C":
        b = s.take(4)
        if b[0] >> 7 != 1 or b[0] & 0x7F != 1:
            raise _Bmff("av1C marker or version")
        hbd, twelve = (b[2] >> 6) & 1, (b[2] >> 5) & 1
        return {"profile": b[1] >> 5, "depth": 12 if twelve else
                10 if hbd else 8, "mono": (b[2] >> 4) & 1}
    if typ == b"pixi":
        if s.version_flags()[0] != 0:
            raise _Bmff("pixi version")
        n = s.u(1)
        if n > 4:
            raise ValueError("AVIF refused: pixi of more than 4 planes "
                             "(libavif: not implemented)")
        return [s.u(1) for _ in range(n)]
    if typ == b"irot":
        return s.u(1) & 3
    if typ == b"imir":
        return s.u(1) & 1
    if typ == b"pasp":
        return (s.u(4), s.u(4))
    if typ == b"clap":
        return tuple(s.u(4) for _ in range(8))
    if typ == b"a1op":
        return s.u(1)
    if typ == b"lsel":
        return s.u(2)
    if typ == b"a1lx":
        large = s.u(1) & 1
        return tuple(s.u(4 if large else 2) for _ in range(3))
    if typ == b"clli":
        return (s.u(2), s.u(2))
    return None


class _Meta:
    def __init__(self):
        self.items = {}
        self.primary = 0
        self.idat = None
        self.props = []

    def item(self, iid):
        if iid == 0:
            raise _Bmff("an item ID of 0")
        if iid not in self.items:
            self.items[iid] = _Item(iid)
        return self.items[iid]


def _parse_iloc(meta, s):
    version = s.version_flags()[0]
    if version > 2:
        raise _Bmff("iloc version")
    b = s.u(1)
    off_size, len_size = b >> 4, b & 15
    b = s.u(1)
    base_size, index_size = b >> 4, (b & 15) if version else 0
    for v in (off_size, len_size, base_size, index_size):
        if v not in (0, 4, 8):
            raise _Bmff("iloc field sizes")
    for _ in range(s.u(2) if version < 2 else s.u(4)):
        iid = s.u(2) if version < 2 else s.u(4)
        if iid == 0:
            raise _Bmff("an iloc item ID of 0")
        idat = False
        if version:
            method = s.u(2) & 15
            if method not in (0, 1):
                raise ValueError("AVIF refused: an iloc construction method "
                                 "libavif does not implement")
            idat = method == 1
        item = meta.item(iid)
        if item.extents:
            raise _Bmff("duplicate iloc extents")
        s.u(2)  # data_reference_index
        base = s.u(base_size)
        for _ in range(s.u(2)):
            off, length = s.u(off_size), s.u(len_size)
            item.extents.append((base + off, length))
            item.size += length
        item.idat = idat


def _parse_ipco(meta, s):
    while s.left() > 0:
        typ, a, b = s.box()
        meta.props.append((typ, _parse_property(typ, _Stream(s.d, a, b))))


def _parse_ipma(meta, s):
    version, flags = s.version_flags()
    prev = 0
    for _ in range(s.u(4)):
        iid = s.u(2) if version < 1 else s.u(4)
        if iid == 0:
            raise _Bmff("an ipma item ID of 0")
        if iid <= prev:
            raise _Bmff("ipma item IDs out of order")
        prev = iid
        item = meta.item(iid)
        if item.ipma_seen:
            raise _Bmff("a duplicate ipma entry")
        item.ipma_seen = True
        for _ in range(s.u(1)):
            if flags & 1:
                v = s.u(2)
                essential, index = v >> 15, v & 0x7FFF
            else:
                v = s.u(1)
                essential, index = v >> 7, v & 0x7F
            if index == 0:
                continue
            if index > len(meta.props):
                raise _Bmff("an ipma property index past ipco")
            typ, val = meta.props[index - 1]
            if val is not None:
                if essential and typ == b"a1lx":
                    raise _Bmff("an essential a1lx")
                if not essential and typ in (b"a1op", b"lsel"):
                    raise _Bmff("a non-essential a1op or lsel")
                item.props.append((typ, val))
            elif essential:
                item.unsupported_essential = True


def _parse_iprp(meta, s):
    typ, a, b = s.box()
    if typ != b"ipco":
        raise _Bmff("iprp without ipco first")
    _parse_ipco(meta, _Stream(s.d, a, b))
    seen = set()
    while s.left() > 0:
        typ, a, b = s.box()
        if typ != b"ipma":
            raise _Bmff("a box in iprp that is not ipma")
        vf = int.from_bytes(s.d[a:a + 4], "big") if b - a >= 4 else None
        if vf in seen:
            raise _Bmff("two ipma of one version and flags")
        seen.add(vf)
        _parse_ipma(meta, _Stream(s.d, a, b))


def _parse_iinf(meta, s):
    version = s.version_flags()[0]
    if version > 1:
        raise _Bmff("iinf version")
    for _ in range(s.u(2) if version == 0 else s.u(4)):
        typ, a, b = s.box()
        if typ != b"infe":
            raise _Bmff("a box in iinf that is not infe")
        e = _Stream(s.d, a, b)
        v = e.version_flags()[0]
        if v not in (2, 3):
            raise _Bmff("an infe version other than 2 or 3")
        iid = e.u(2) if v == 2 else e.u(4)
        if iid == 0:
            raise _Bmff("an infe item ID of 0")
        e.u(2)
        typ = e.take(4)
        e.string()  # item_name
        if typ == b"mime":
            e.string()
        meta.item(iid).type = typ


def _parse_iref(meta, s):
    version = s.version_flags()[0]
    while s.left() > 0:
        typ, a, b = s.box()
        if version > 1:
            break
        r = _Stream(s.d, a, b)
        n = 2 if version == 0 else 4
        frm = r.u(n)
        if frm == 0:
            raise _Bmff("an iref item ID of 0")
        for _ in range(r.u(2)):
            to = r.u(n)
            if to == 0:
                raise _Bmff("an iref item ID of 0")
            if typ == b"thmb":
                meta.item(frm).thumb_for = to
            elif typ == b"auxl":
                meta.item(frm).aux_for = to
            elif typ == b"prem":
                meta.item(frm).prem_by = to
            elif typ == b"cdsc":
                meta.item(frm).desc_for = to
            elif typ == b"dimg":
                meta.item(to)


def _parse_meta(s):
    if s.version_flags()[0] != 0:
        raise _Bmff("meta version")
    meta = _Meta()
    first, seen = True, set()
    while s.left() > 0:
        typ, a, b = s.box()
        c = _Stream(s.d, a, b)
        if first:
            if typ != b"hdlr":
                raise _Bmff("meta without hdlr first")
            if c.version_flags()[0] != 0 or c.u(4) != 0 or c.take(4) != b"pict":
                raise _Bmff("hdlr not of type pict")
            c.take(12)
            c.string()
            first = False
            continue
        if typ in seen and typ in (b"hdlr", b"iloc", b"pitm", b"idat",
                                   b"iprp", b"iinf", b"iref"):
            raise _Bmff("a duplicate unique box in meta")
        seen.add(typ)
        if typ == b"hdlr":
            raise _Bmff("a duplicate hdlr")
        if typ == b"iloc":
            _parse_iloc(meta, c)
        elif typ == b"pitm":
            version = c.version_flags()[0]
            meta.primary = c.u(2) if version == 0 else c.u(4)
        elif typ == b"idat":
            meta.idat = s.d[a:b]
        elif typ == b"iprp":
            _parse_iprp(meta, c)
        elif typ == b"iinf":
            _parse_iinf(meta, c)
        elif typ == b"iref":
            _parse_iref(meta, c)
    if first:
        raise _Bmff("an empty meta")
    return meta


def _parse(data):
    """The top-level boxes, as avifParse walks them -> the meta."""
    s = _Stream(data, 0, len(data))
    ftyp = meta = None
    needs_meta = False
    while s.left() > 0:
        if s.left() < 8:
            raise _Bmff("a truncated box header")
        typ, a, b = s.box(top=True)
        if ftyp is None and typ != b"ftyp":
            raise _Bmff("the first box is not ftyp")
        if typ == b"ftyp":
            if ftyp is not None:
                raise _Bmff("a second ftyp")
            if b - a < 8 or (b - a - 8) % 4:
                raise _Bmff("ftyp's compatible brands")
            brands = [data[a:a + 4]] + [data[i:i + 4]
                                        for i in range(a + 8, b, 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise _Bmff("ftyp without the avif or avis brand")
            ftyp = brands
            needs_meta = b"avif" in brands
            if b"avis" in brands:
                raise _later("7e.8a.3", "an AVIF image sequence (avis)")
        elif typ == b"meta":
            if meta is not None:
                raise _Bmff("a second meta")
            meta = _parse_meta(_Stream(data, a, b))
        if ftyp is not None and (not needs_meta or meta is not None):
            break
    if ftyp is None:
        raise _Bmff("no ftyp")
    if meta is None:
        raise _Bmff("no meta")
    return meta


def _item_data(data, meta, item):
    out = []
    for off, length in item.extents:
        src = meta.idat if item.idat else data
        if src is None:
            raise ValueError("AVIF refused: an item in a missing idat")
        if off + length > len(src):
            raise ValueError("AVIF refused: an item's extent past the end of "
                             "the file (libavif: truncated data)")
        out.append(src[off:off + length])
    return b"".join(out)


def _skipped(item):
    return (not item.size or item.unsupported_essential or
            item.type not in (b"av01", b"grid") or item.thumb_for)


def _validate(item, alpha=False):
    cfg = item.prop(b"av1C")
    if cfg is None:
        if alpha:
            raise _Bmff("an alpha item without av1C")
        raise ValueError("AVIF refused: an image item without av1C "
                         "(libavif: missing image item)")
    pixi = item.prop(b"pixi")
    if pixi:
        if any(d != pixi[0] for d in pixi):
            raise ValueError("AVIF refused: pixi planes of different depths "
                             "(libavif: not implemented)")
        if pixi[0] != cfg["depth"]:
            raise _Bmff("pixi depth unlike av1C's")
    return cfg


# ---------------------------------------------------------------------------
# libavif's YUV -> 8-bit RGB(A), as PIL asks for it (chroma upsampling
# automatic). libyuv runs where libavif finds its matrix: integer
# constants (YG, YB, UB, UG, VG, VR), bilinear chroma upsampling of 4:2:0
# (`ScaleRowUp2_Bilinear`) and linear of 4:2:2 (`ScaleRowUp2_Linear`).
# Elsewhere libavif's own float path runs.

_LIBYUV = {"I601": (18997, -1160, 128, 25, 52, 102),
           "JPEG": (16320, 32, 113, 22, 46, 90),
           "H709": (18997, -1160, 128, 14, 34, 115),
           "F709": (16320, 32, 119, 12, 30, 101),
           "2020": (19003, -1160, 128, 12, 42, 107),
           "V2020": (16320, 32, 120, 11, 37, 94)}
# matrix_coefficients -> libyuv's (full range, limited range) constants;
# 12 (chromaticity-derived) takes those of its colour primaries
_LIBYUV_MC = {1: ("F709", "H709"), 2: ("JPEG", "I601"), 5: ("JPEG", "I601"),
              6: ("JPEG", "I601"), 9: ("V2020", "2020")}
_CP_TO_MC = {1: 1, 2: 1, 5: 5, 6: 6, 9: 9}
# libavif's (kr, kb) of each matrix its own path converts
_KRB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
        6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}
_F = np.float32


def _libyuv_name(full, mc, cp):
    if mc == 12:
        mc = _CP_TO_MC.get(cp, -1)
    names = _LIBYUV_MC.get(mc)
    return None if names is None else names[0 if full else 1]


def _up_linear(c, w):
    """libyuv's ScaleRowUp2_Linear_Any_C along the last axis, to width w."""
    c = c.astype(np.int32)
    out = np.empty(c.shape[:-1] + (w,), np.int32)
    out[..., 0] = c[..., 0]
    k = np.arange(((w - 1) & ~1) // 2)
    out[..., 1 + 2 * k] = (3 * c[..., k] + c[..., k + 1] + 2) >> 2
    out[..., 2 + 2 * k] = (c[..., k] + 3 * c[..., k + 1] + 2) >> 2
    out[..., w - 1] = c[..., (w - 1) // 2]
    return out


def _up_bilinear(c, w, h):
    """libyuv's I420 bilinear chroma upsampling: the first row (and the
    last of an even height) linear, the rows between from two chroma rows
    (ScaleRowUp2_Bilinear_Any_C)."""
    c = c.astype(np.int32)
    out = np.empty((h, w), np.int32)
    out[0] = _up_linear(c[0], w)
    n = (h - 1) // 2
    if n:
        s, t = c[:n], c[1:n + 1]
        m = (w - 1) // 2
        j = np.arange(((w - 1) & ~1) // 2)
        da = np.empty((n, w), np.int32)
        db = np.empty((n, w), np.int32)
        da[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2
        db[:, 0] = (s[:, 0] + 3 * t[:, 0] + 2) >> 2
        s0, s1, t0, t1 = s[:, j], s[:, j + 1], t[:, j], t[:, j + 1]
        da[:, 1 + 2 * j] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
        da[:, 2 + 2 * j] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
        db[:, 1 + 2 * j] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
        db[:, 2 + 2 * j] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
        da[:, w - 1] = (3 * s[:, m] + t[:, m] + 2) >> 2
        db[:, w - 1] = (s[:, m] + 3 * t[:, m] + 2) >> 2
        out[1:2 * n + 1:2] = da
        out[2:2 * n + 2:2] = db
    if not h & 1:
        out[h - 1] = _up_linear(c[n], w)
    return out


def _libyuv_rgb(y, u, v, name):
    yg, yb, ub, ug, vg, vr = _LIBYUV[name]
    y1 = ((y.astype(np.int64) * 257 * yg) & 0xFFFFFFFF) >> 16
    if u is None:
        g = np.clip((y1 + yb) >> 6, 0, 255).astype(np.uint8)
        return np.stack([g, g, g], -1)
    u = u.astype(np.int64) - 128
    v = v.astype(np.int64) - 128
    r = np.clip((y1 + v * vr + yb) >> 6, 0, 255)
    g = np.clip((y1 - (u * ug + v * vg) + yb) >> 6, 0, 255)
    b = np.clip((y1 + u * ub + yb) >> 6, 0, 255)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _builtin_rgb(y, u, v, ssx, ssy, full, mc):
    """libavif's own path (avifImageYUV8ToRGB8Color / Mono,
    avifImageYUVAnyToRGBAnySlow with its bilinear chroma), in float32."""
    h, w = y.shape
    identity = mc == 0
    bias_y, range_y = (_F(0), _F(255)) if full else (_F(16), _F(219))
    bias_uv, range_uv = (_F(128), _F(255) if full else _F(224))
    if identity:
        bias_uv, range_uv = bias_y, range_y
    t_y = (np.arange(256, dtype=_F) - bias_y) / range_y
    t_uv = (np.arange(256, dtype=_F) - bias_uv) / range_uv
    yf = t_y[y]
    if u is None:
        r = g = b = yf
    else:
        if not ssx:
            cb, cr = t_uv[u], t_uv[v]
        else:
            i, j = np.arange(w), np.arange(h)
            ui, uj = i >> ssx, j >> ssy
            adj_c = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), 0,
                             np.where(i % 2 != 0, 1, -1))
            adj_r = np.zeros(h, np.int64) if not ssy else np.where(
                (j == 0) | ((j == h - 1) & (j % 2 != 0)), 0,
                np.where(j % 2 != 0, 1, -1))
            rows, cols = uj[:, None], ui[None, :]
            rows2, cols2 = (uj + adj_r)[:, None], (ui + adj_c)[None, :]

            def up(p):
                t = t_uv[p]
                return (t[rows, cols] * _F(9 / 16) + t[rows, cols2] *
                        _F(3 / 16) + t[rows2, cols] * _F(3 / 16) +
                        t[rows2, cols2] * _F(1 / 16))
            cb, cr = up(u), up(v)
        if identity:
            g, b, r = yf, cb, cr
        elif mc == 8:
            t = yf - cb
            g, b, r = yf + cb, t - cr, t + cr
        else:
            kr, kb = (_F(k) for k in _KRB.get(mc, (0.2126, 0.0722)))
            kg = _F(1) - kr - kb
            r = yf + (_F(2) * (_F(1) - kr)) * cr
            b = yf + (_F(2) * (_F(1) - kb)) * cb
            g = yf - ((_F(2) * ((kr * (_F(1) - kr) * cr) +
                                (kb * (_F(1) - kb) * cb))) / kg)
    return np.stack([(_F(0.5) + np.clip(c, _F(0), _F(1)) * _F(255)).astype(
        np.uint8) for c in (r, g, b)], -1)


def yuv_to_rgb(y, u, v, ssx, ssy, full, mc, cp, rgba):
    """libavif 1.3.0's avifImageYUVToRGB of 8-bit planes to 8-bit RGB (rgba
    False) or RGBA (True; the alpha is not returned): uint8 [H, W, 3].
    u, v None for 4:0:0. Raises ValueError where libavif's reformat
    fails."""
    if mc in (3, 10, 11, 13, 14) or mc > 16 or (mc == 8 and not full) or (
            mc == 0 and u is not None and ssx):
        raise ValueError(f"AVIF refused: libavif cannot convert matrix "
                         f"coefficients {mc} ({'full' if full else 'limited'}"
                         " range) to RGB")
    if mc in (15, 16) or (mc == 12 and cp not in _CP_TO_MC):
        raise _later("7e.8a.3", f"the YUV to RGB of matrix coefficients {mc}"
                     f" with colour primaries {cp}")
    name = _libyuv_name(full, mc, cp)
    if u is None:
        if rgba and not full and (mc == 0 or name in ("I601", "H709")):
            return _libyuv_rgb(y, None, None, "I601")
        return _builtin_rgb(y, None, None, 1, 1, full, mc)
    if name is None:
        return _builtin_rgb(y, u, v, ssx, ssy, full, mc)
    h, w = y.shape
    if ssx and ssy:
        u, v = _up_bilinear(u, w, h), _up_bilinear(v, w, h)
    elif ssx:
        u, v = _up_linear(u, w), _up_linear(v, w)
    return _libyuv_rgb(y, u, v, name)


# ---------------------------------------------------------------------------

def _decode_item(data, meta, item, alpha=False):
    planes, seq = decode_av1(_item_data(data, meta, item), alpha)
    ispe = item.prop(b"ispe")
    h, w = planes[0].shape
    if (w, h) != ispe:
        raise _later("7e.8a.3", f"an AV1 frame of {w}x{h} in an item of "
                     f"{ispe[0]}x{ispe[1]} (libavif scales it)")
    return planes, seq


def read(data):
    """What `PIL.Image.open(p).convert("RGB")` gives for an AVIF file on
    PIL's route: uint8 [H, W, 3]. Raises PassOn where PIL's AVIF plugin
    passes the file on (its SyntaxError), ValueError where PIL refuses it,
    NotImplementedError naming ROADMAP queue A's sub-item for what PIL
    decodes and this module does not yet."""
    data = bytes(data)
    try:
        meta = _parse(data)
        color = next((it for it in meta.items.values()
                      if not _skipped(it) and it.id == meta.primary), None)
        if any(not _skipped(it) and it.prop(b"ispe") is None
               for it in meta.items.values()):
            raise _Bmff("an image item without ispe")
        if color is not None:
            w, h = color.prop(b"ispe")
            if not w or not h or w > _DIM_LIMIT or h > _DIM_LIMIT or \
                    w * h > _SIZE_LIMIT:
                raise _Bmff("an image beyond libavif's size limits")
        for it in meta.items.values():
            # libavif's sanity check of the size hint, and its read of the
            # primary item's Exif / XMP metadata, at parse time
            if it is color or (color is not None and it.aux_for == color.id):
                if it.size > len(data):
                    raise _Bmff("an item larger than the file")
            elif color is not None and it.desc_for == color.id and \
                    it.type in (b"Exif", b"mime"):
                try:
                    _item_data(data, meta, it)
                except ValueError:
                    raise _Bmff("truncated metadata") from None
        if color is None:
            raise ValueError("AVIF refused: no primary image item libavif "
                             "decodes")
        if color.type == b"grid":
            raise _later("7e.8a.3", "a grid image item")
        alpha = next((it for it in meta.items.values() if not _skipped(it)
                      and it.aux_for == color.id and
                      it.prop(b"auxC") in _ALPHA_URNS), None)
        _validate(color)
        if alpha is not None:
            _validate(alpha, alpha=True)
    except _Bmff as e:
        raise PassOn(f"libavif cannot parse it: {e}") from None
    if alpha is not None:
        if alpha.type == b"grid":
            raise _later("7e.8a.3", "a grid alpha item")
        if color.prem_by == alpha.id:
            raise _later("7e.8a.3", "premultiplied alpha")
    planes, seq = _decode_item(data, meta, color)
    if alpha is not None:
        _decode_item(data, meta, alpha, alpha=True)
    nclx = next((v for t, v in color.props
                 if t == b"colr" and v[0] == "nclx"), None)
    if nclx is not None:
        _, cp, _, mc, full = nclx
    else:
        cp, _, mc = seq["cicp"]
        full = seq["full_range"]
    y, u, v = planes
    return yuv_to_rgb(y, u, v, seq["ssx"], seq["ssy"], full, mc, cp,
                      alpha is not None)
