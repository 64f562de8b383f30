"""WebP files without libwebp: the RIFF container here, the bitstreams in
the port's host library (`csrc/webp_codec.cpp`: lossless VP8L, the ALPH
chunk, lossy VP8 key frames).

The JAX package reads a WebP file through PIL under any name but ".hdr" /
".exr" (`Image.open(p).convert("RGB")`), and through OpenCV under those
(`cv2.imread`). Both go through libwebp:

  * PIL opens every WebP file, still or animated, with libwebp's
    `WebPAnimDecoder`: the demuxer (src/demux/demux.c) parses and checks the
    container, and frame 0 is decoded (`WebPDecode` of the frame's ALPH and
    VP8 / VP8L chunks) into a zero-filled RGBA canvas at its offset, not
    blended. `decode` follows both: what the demuxer or the decoder refuses
    raises ValueError. Its RGB is `convert("RGB")`'s: the alpha dropped,
    and black where frame 0 does not cover the canvas.
  * OpenCV (`decode_opencv`) reads the first 32 bytes' features, then
    decodes a still file with `WebPDecodeBGRInto` (src/dec/webp_dec.c: no
    demuxer, the image's data read to the end of the file) and an animated
    one through `WebPAnimDecoder`, as PIL does.

Each function returns (rgb uint8 [H, W, 3], alpha uint8 [H, W] or None).
"""
from __future__ import annotations

import struct

import numpy as np

from .. import native

RIFF_HEADER_SIZE = 12
CHUNK_HEADER_SIZE = 8
VP8X_CHUNK_SIZE = 10
ANIM_CHUNK_SIZE = 6
ANMF_CHUNK_SIZE = 16
MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - CHUNK_HEADER_SIZE - 1
MAX_IMAGE_AREA = 1 << 32
ANIMATION_FLAG, XMP_FLAG, EXIF_FLAG, ALPHA_FLAG, ICCP_FLAG = 2, 4, 8, 16, 32
ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | EXIF_FLAG | ICCP_FLAG | XMP_FLAG

# the demuxer's parse states and results
PARSING_HEADER, PARSED_HEADER, DONE = 0, 1, 2
PARSE_OK, NEED_MORE_DATA, PARSE_ERROR = 0, 1, 2
# the decoder's status codes that matter here
OK, BITSTREAM_ERROR, NOT_ENOUGH_DATA = 0, 3, 7


def is_webp(data):
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _le16(d, i):
    return d[i] | d[i + 1] << 8


def _le24(d, i):
    return d[i] | d[i + 1] << 8 | d[i + 2] << 16


def _le32(d, i):
    return struct.unpack_from("<I", d, i)[0]


def _refuse(name, why):
    return ValueError(f"'{name}': {why} (libwebp refuses it)")


# ---------------------------------------------------------------------------
# Bitstream headers (src/dec/webp_dec.c, vp8_dec.c VP8GetInfo,
# vp8l_dec.c VP8LGetInfo)
# ---------------------------------------------------------------------------

def _vp8_info(d, pos, size, chunk_size):
    """VP8GetInfo: (width, height) of the VP8 frame at d[pos:pos + size],
    or None."""
    if size < 10 or d[pos + 3:pos + 6] != b"\x9d\x01\x2a":
        return None
    bits = _le24(d, pos)
    w = _le16(d, pos + 6) & 0x3FFF
    h = _le16(d, pos + 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 \
            or bits >> 5 >= chunk_size or w == 0 or h == 0:
        return None
    return w, h


def _vp8l_info(d, pos, size):
    """VP8LGetInfo: (width, height, alpha hint) of the VP8L image at
    d[pos:pos + size], or None."""
    if size < 5 or d[pos] != 0x2F or d[pos + 4] >> 5 != 0:
        return None
    v = _le32(d, pos + 1)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


def _parse_headers(d, have_all_data, headers):
    """ParseHeadersInternal on d: a dict of the image's features (and, with
    `headers`, where its data starts), or a status code."""
    size = len(d)
    if size < RIFF_HEADER_SIZE:
        return NOT_ENOUGH_DATA
    pos, riff_size = 0, 0
    if d[:4] == b"RIFF":                                     # ParseRIFF
        if d[8:12] != b"WEBP":
            return BITSTREAM_ERROR
        s = _le32(d, 4)
        if s < 12 or s > MAX_CHUNK_PAYLOAD:
            return BITSTREAM_ERROR
        if have_all_data and s > size - CHUNK_HEADER_SIZE:
            return NOT_ENOUGH_DATA
        riff_size, pos = s, RIFF_HEADER_SIZE
    found_riff = riff_size > 0
    if size - pos < CHUNK_HEADER_SIZE:                       # ParseVP8X
        return NOT_ENOUGH_DATA
    found_vp8x, flags, canvas = False, 0, (0, 0)
    if d[pos:pos + 4] == b"VP8X":
        if _le32(d, pos + 4) != VP8X_CHUNK_SIZE:
            return BITSTREAM_ERROR
        if size - pos < CHUNK_HEADER_SIZE + VP8X_CHUNK_SIZE:
            return NOT_ENOUGH_DATA
        flags = _le32(d, pos + 8)
        canvas = (1 + _le24(d, pos + 12), 1 + _le24(d, pos + 15))
        if canvas[0] * canvas[1] >= MAX_IMAGE_AREA:
            return BITSTREAM_ERROR
        found_vp8x, pos = True, pos + CHUNK_HEADER_SIZE + VP8X_CHUNK_SIZE
    if not found_riff and found_vp8x:
        return BITSTREAM_ERROR
    feat = dict(width=canvas[0], height=canvas[1],
                has_alpha=bool(flags & ALPHA_FLAG),
                has_animation=bool(flags & ANIMATION_FLAG), alpha=None)
    if found_vp8x and feat["has_animation"] and not headers:
        return feat
    status = _image_header(d, pos, riff_size, have_all_data, found_riff,
                           found_vp8x, feat)
    if status == OK or (status == NOT_ENOUGH_DATA and found_vp8x
                        and not headers):
        feat["has_alpha"] |= feat["alpha"] is not None
        return feat
    return status


def _image_header(d, pos, riff_size, have_all_data, found_riff, found_vp8x,
                  feat):
    """The rest of ParseHeadersInternal from d[pos]: the optional chunks
    (ALPH kept), the VP8 / VP8L chunk header and the bitstream's header,
    into `feat`; returns a status."""
    size = len(d)
    if size - pos < 4:
        return NOT_ENOUGH_DATA
    if (found_riff and found_vp8x) or (not found_riff and not found_vp8x
                                       and d[pos:pos + 4] == b"ALPH"):
        total = 4 + CHUNK_HEADER_SIZE + VP8X_CHUNK_SIZE  # ParseOptionalChunks
        while True:
            if size - pos < CHUNK_HEADER_SIZE:
                return NOT_ENOUGH_DATA
            chunk_size = _le32(d, pos + 4)
            if chunk_size > MAX_CHUNK_PAYLOAD:
                return BITSTREAM_ERROR
            disk = (CHUNK_HEADER_SIZE + chunk_size + 1) & ~1
            total += disk
            if riff_size > 0 and total > riff_size:
                return BITSTREAM_ERROR
            if d[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if size - pos < disk:
                return NOT_ENOUGH_DATA
            if d[pos:pos + 4] == b"ALPH":
                feat["alpha"] = (pos + CHUNK_HEADER_SIZE, chunk_size)
            pos += disk
    if size - pos < CHUNK_HEADER_SIZE:                       # ParseVP8Header
        return NOT_ENOUGH_DATA
    tag = d[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        csize = _le32(d, pos + 4)
        if riff_size >= 12 and csize > riff_size - 12:
            return BITSTREAM_ERROR
        if have_all_data and csize > size - pos - CHUNK_HEADER_SIZE:
            return NOT_ENOUGH_DATA
        lossless = tag == b"VP8L"
        pos += CHUNK_HEADER_SIZE
    else:                                    # a raw bitstream, no chunk
        csize = size - pos
        lossless = size - pos >= 5 and d[pos] == 0x2F and d[pos + 4] >> 5 == 0
    if csize > MAX_CHUNK_PAYLOAD:
        return BITSTREAM_ERROR
    feat.update(lossless=lossless, offset=pos, compressed_size=csize)
    if not lossless:
        if size - pos < 10:
            return NOT_ENOUGH_DATA
        info = _vp8_info(d, pos, size - pos, csize)
        if info is None:
            return BITSTREAM_ERROR
        w, h = info
    else:
        if size - pos < 5:
            return NOT_ENOUGH_DATA
        info = _vp8l_info(d, pos, size - pos)
        if info is None:
            return BITSTREAM_ERROR
        w, h, a = info
        feat["has_alpha"] = bool(a)
    if found_vp8x and (feat["width"], feat["height"]) != (w, h):
        return BITSTREAM_ERROR
    feat["width"], feat["height"] = w, h
    return OK


def _decode_into(d, name):
    """DecodeInto (WebPDecode's decoding, the headers parsed with all the
    data at hand): d holds a still image's chunks, with or without the
    RIFF / VP8X header; its VP8 / VP8L data runs to d's end. Returns (rgb,
    alpha or None)."""
    feat = _parse_headers(d, True, True)
    if not isinstance(feat, dict):
        raise _refuse(name, "bad WebP headers")
    if feat["has_animation"]:
        raise _refuse(name, "an animation where a still image is decoded")
    w, h, pos = feat["width"], feat["height"], feat["offset"]
    try:
        if feat["lossless"]:
            argb = native.webp_vp8l_decode(d[pos:], w, h)
            return (np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF,
                              argb & 0xFF], -1).astype(np.uint8),
                    (argb >> 24).astype(np.uint8))
        rgb = native.webp_vp8_decode(d[pos:], w, h)
        alpha = None
        if feat["alpha"] is not None:
            apos, asize = feat["alpha"]
            alpha = native.webp_alph_decode(d[apos:apos + asize], w, h)
    except ValueError as e:
        raise _refuse(name, str(e)) from None
    return rgb, alpha


# ---------------------------------------------------------------------------
# The demuxer (src/demux/demux.c)
# ---------------------------------------------------------------------------

class _Frame:
    def __init__(self):
        self.x_offset = self.y_offset = self.width = self.height = 0
        self.has_alpha = self.complete = False
        self.frame_num = 0
        self.image = [0, 0]    # chunk offset, size (header and payload)
        self.alpha = [0, 0]


class _Demux:
    """WebPDemux of a whole file (partial data refused)."""

    def __init__(self, data):
        self.buf = data
        self.state = PARSING_HEADER
        self.loop_count = 1
        self.canvas_width = self.canvas_height = -1
        self.feature_flags = 0
        self.is_ext_format = False
        self.frames = []
        self.num_frames = 0

    # MemBuffer
    def data_size(self):
        return self.end - self.start

    def size_is_invalid(self, size):
        return size > self.riff_end - self.start

    def read_le32(self):
        v = _le32(self.buf, self.start)
        self.start += 4
        return v

    def parse(self):
        """The frames and canvas, or PARSE_ERROR where WebPDemux returns
        NULL."""
        d = self.buf
        self.start, self.end = 0, len(d)
        if len(d) < RIFF_HEADER_SIZE + CHUNK_HEADER_SIZE:   # ReadHeader
            return PARSE_ERROR
        if not is_webp(d):
            return PARSE_ERROR
        riff_size = _le32(d, 4)
        if riff_size < CHUNK_HEADER_SIZE or riff_size > MAX_CHUNK_PAYLOAD:
            return PARSE_ERROR    # and the raw-bitstream demuxer fails too
        self.riff_end = riff_size + CHUNK_HEADER_SIZE
        if self.end > self.riff_end:
            self.end = self.riff_end
        if self.end < self.riff_end:
            return PARSE_ERROR    # partial data
        self.start = RIFF_HEADER_SIZE
        tag = d[self.start:self.start + 4]
        if tag in (b"VP8 ", b"VP8L"):
            status, valid = self.parse_single_image(), self.valid_simple
        elif tag == b"VP8X":
            status, valid = self.parse_vp8x(), self.valid_extended
        else:
            return PARSE_ERROR
        if status == PARSE_OK:
            self.state = DONE
        if status == NEED_MORE_DATA:
            status = PARSE_ERROR
        if status != PARSE_ERROR and not valid():
            status = PARSE_ERROR
        return status

    def store_frame(self, frame_num, min_size, frame):
        if self.data_size() < CHUNK_HEADER_SIZE or self.data_size() < min_size:
            return NEED_MORE_DATA
        alpha_chunks = image_chunks = 0
        status = PARSE_OK
        while True:
            chunk_start = self.start
            fourcc = self.buf[self.start:self.start + 4]
            self.start += 4
            payload_size = self.read_le32()
            if payload_size > MAX_CHUNK_PAYLOAD:
                return PARSE_ERROR
            padded = payload_size + (payload_size & 1)
            available = min(padded, self.data_size())
            chunk_size = CHUNK_HEADER_SIZE + available
            if self.size_is_invalid(padded):
                return PARSE_ERROR
            if padded > self.data_size():
                status = NEED_MORE_DATA
            done = False
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = [chunk_start, chunk_size]
                frame.has_alpha = True
                frame.frame_num = frame_num
                self.start += available
            elif fourcc in (b"VP8L", b"VP8 ") and image_chunks == 0:
                if fourcc == b"VP8L" and alpha_chunks > 0:
                    return PARSE_ERROR    # VP8L has its own alpha
                feat = _parse_headers(
                    self.buf[chunk_start:chunk_start + chunk_size], False, False)
                if status == NEED_MORE_DATA and feat == NOT_ENOUGH_DATA:
                    return NEED_MORE_DATA
                if not isinstance(feat, dict):
                    return PARSE_ERROR
                image_chunks = 1
                frame.image = [chunk_start, chunk_size]
                frame.width, frame.height = feat["width"], feat["height"]
                frame.has_alpha |= feat["has_alpha"]
                frame.frame_num = frame_num
                frame.complete = status == PARSE_OK
                self.start += available
            elif fourcc == b"VP8L" and alpha_chunks > 0:
                return PARSE_ERROR
            else:
                self.start -= CHUNK_HEADER_SIZE   # not this frame's: rewind
                done = True
            if self.start == self.riff_end:
                done = True
            elif self.data_size() < CHUNK_HEADER_SIZE:
                status = NEED_MORE_DATA
            if done or status != PARSE_OK:
                return status

    def add_frame(self, frame):
        if self.frames and not self.frames[-1].complete:
            return False
        self.frames.append(frame)
        return True

    def parse_single_image(self):
        if self.frames:
            return PARSE_ERROR
        if self.size_is_invalid(CHUNK_HEADER_SIZE):
            return PARSE_ERROR
        if self.data_size() < CHUNK_HEADER_SIZE:
            return NEED_MORE_DATA
        frame = _Frame()
        status = self.store_frame(1, 0, frame)
        if status != PARSE_ERROR:
            if not self.feature_flags & ALPHA_FLAG and frame.alpha[1] > 0:
                frame.alpha = [0, 0]      # no alpha flag: the ALPH is ignored
                frame.has_alpha = False
            if not self.is_ext_format and frame.width > 0 and frame.height > 0:
                self.state = PARSED_HEADER
                self.canvas_width, self.canvas_height = frame.width, frame.height
                self.feature_flags |= ALPHA_FLAG if frame.has_alpha else 0
            if not self.add_frame(frame):
                status = PARSE_ERROR
            else:
                self.num_frames = 1
        return status

    def parse_vp8x(self):
        if self.data_size() < CHUNK_HEADER_SIZE:
            return NEED_MORE_DATA
        self.is_ext_format = True
        self.start += 4
        size = self.read_le32()
        if size > MAX_CHUNK_PAYLOAD or size < VP8X_CHUNK_SIZE:
            return PARSE_ERROR
        size += size & 1
        if self.size_is_invalid(size):
            return PARSE_ERROR
        if self.data_size() < size:
            return NEED_MORE_DATA
        d, s = self.buf, self.start
        self.feature_flags = d[s]
        self.canvas_width = 1 + _le24(d, s + 4)
        self.canvas_height = 1 + _le24(d, s + 7)
        if self.canvas_width * self.canvas_height >= MAX_IMAGE_AREA:
            return PARSE_ERROR
        self.start += size
        self.state = PARSED_HEADER
        if self.size_is_invalid(CHUNK_HEADER_SIZE):
            return PARSE_ERROR
        if self.data_size() < CHUNK_HEADER_SIZE:
            return NEED_MORE_DATA
        return self.parse_vp8x_chunks()

    def parse_vp8x_chunks(self):
        is_animation = bool(self.feature_flags & ANIMATION_FLAG)
        anim_chunks = 0
        status = PARSE_OK
        while True:
            fourcc = self.buf[self.start:self.start + 4]
            self.start += 4
            chunk_size = self.read_le32()
            if chunk_size > MAX_CHUNK_PAYLOAD:
                return PARSE_ERROR
            padded = chunk_size + (chunk_size & 1)
            if self.size_is_invalid(padded):
                return PARSE_ERROR
            if fourcc == b"VP8X":
                return PARSE_ERROR
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_animation:
                    return PARSE_ERROR   # frames of an animation are in ANMF
                self.start -= CHUNK_HEADER_SIZE
                status = self.parse_single_image()
            elif fourcc == b"ANIM":
                if padded < ANIM_CHUNK_SIZE:
                    return PARSE_ERROR
                if self.data_size() < padded:
                    status = NEED_MORE_DATA
                else:             # a second ANIM is skipped
                    if anim_chunks == 0:
                        anim_chunks = 1
                        self.loop_count = _le16(self.buf, self.start + 4)
                    self.start += padded
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return PARSE_ERROR   # ANIM comes first
                status = self.parse_animation_frame(padded)
            elif padded <= self.data_size():   # ICCP, EXIF, XMP, unknown
                self.start += padded
            else:
                status = NEED_MORE_DATA
            if self.start == self.riff_end:
                break
            if self.data_size() < CHUNK_HEADER_SIZE:
                status = NEED_MORE_DATA
            if status != PARSE_OK:
                break
        return status

    def parse_animation_frame(self, frame_chunk_size):
        is_animation = bool(self.feature_flags & ANIMATION_FLAG)
        anmf_payload_size = frame_chunk_size - ANMF_CHUNK_SIZE
        if self.size_is_invalid(ANMF_CHUNK_SIZE) \
                or frame_chunk_size < ANMF_CHUNK_SIZE:
            return PARSE_ERROR
        if self.data_size() < ANMF_CHUNK_SIZE:
            return NEED_MORE_DATA
        d, s = self.buf, self.start
        frame = _Frame()
        frame.x_offset = 2 * _le24(d, s)
        frame.y_offset = 2 * _le24(d, s + 3)
        frame.width = 1 + _le24(d, s + 6)
        frame.height = 1 + _le24(d, s + 9)
        self.start += ANMF_CHUNK_SIZE
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            return PARSE_ERROR
        start = self.start
        status = self.store_frame(self.num_frames + 1, anmf_payload_size,
                                  frame)
        if status != PARSE_ERROR and self.start - start > anmf_payload_size:
            status = PARSE_ERROR
        if status != PARSE_ERROR and is_animation and frame.frame_num > 0:
            if self.add_frame(frame):
                self.num_frames += 1
            else:
                status = PARSE_ERROR
        return status

    def valid_simple(self):
        if self.state == PARSING_HEADER:
            return True
        if self.canvas_width <= 0 or self.canvas_height <= 0:
            return False
        if self.state == DONE and not self.frames:
            return False
        f = self.frames[0]
        return f.width > 0 and f.height > 0

    def valid_extended(self):
        is_animation = bool(self.feature_flags & ANIMATION_FLAG)
        if self.state == PARSING_HEADER:
            return True
        if self.canvas_width <= 0 or self.canvas_height <= 0:
            return False
        if self.loop_count < 0:
            return False
        if self.state == DONE and not self.frames:
            return False
        if self.feature_flags & ~ALL_VALID_FLAGS:
            return False
        for i, f in enumerate(self.frames):
            if not is_animation and f.frame_num > 1:
                return False
            if f.complete:
                if f.alpha[1] == 0 and f.image[1] == 0:
                    return False
                if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                    return False
                if f.width <= 0 or f.height <= 0:
                    return False
            else:
                if self.state == DONE:
                    return False
                if f.alpha[1] > 0 and f.image[1] > 0 \
                        and f.alpha[0] > f.image[0]:
                    return False
                if i + 1 < len(self.frames):
                    return False
            if f.width > 0 and f.height > 0:
                if not is_animation:
                    if (f.x_offset, f.y_offset, f.width, f.height) != (
                            0, 0, self.canvas_width, self.canvas_height):
                        return False
                elif f.width + f.x_offset > self.canvas_width \
                        or f.height + f.y_offset > self.canvas_height:
                    return False
        return True

    def frame_payload(self, f):
        """GetFramePayload: the frame's ALPH (if any) through its image
        chunk."""
        start, size = f.image
        if f.alpha[1] > 0:
            inter = f.image[0] - (f.alpha[0] + f.alpha[1]) if f.image[0] > 0 \
                else 0
            start = f.alpha[0]
            size += f.alpha[1] + inter
        return self.buf[start:start + size]


def _anim_frame0(data, name, max_pixels):
    """WebPAnimDecoder's frame 0: RGBA [H, W, 4] on the canvas, zero where
    the frame does not reach, and whether the file declares alpha. A
    canvas of more than `max_pixels` is refused, as the caller's library
    refuses it. WebPAnimDecoderNew first checks the whole file with
    WebPGetFeatures (the decoder's header rules, stricter than the
    demuxer's: a VP8X chunk of exactly 10 bytes), whose alpha is the one
    PIL's mode follows."""
    feat = _parse_headers(data, False, False)
    if not isinstance(feat, dict):
        raise _refuse(name, "bad WebP headers")
    dmux = _Demux(data)
    if dmux.parse() != PARSE_OK:
        raise _refuse(name, "a WebP container the demuxer refuses")
    if dmux.canvas_width * dmux.canvas_height > max_pixels:
        raise ValueError(f"'{name}': a canvas of {dmux.canvas_width} x "
                         f"{dmux.canvas_height}, refused as too large")
    f = dmux.frames[0]
    # WebPDecode: its GetFeatures passes wherever DecodeInto's stricter
    # header parse (all the data at hand) does
    rgb, alpha = _decode_into(dmux.frame_payload(f), name)
    h, w = rgb.shape[:2]
    canvas = np.zeros((dmux.canvas_height, dmux.canvas_width, 4), np.uint8)
    canvas[f.y_offset:f.y_offset + h, f.x_offset:f.x_offset + w, :3] = rgb
    canvas[f.y_offset:f.y_offset + h, f.x_offset:f.x_offset + w, 3] = \
        255 if alpha is None else alpha
    return canvas, feat["has_alpha"]


PIL_MAX_PIXELS = 2 * 89478485     # PIL's decompression-bomb limit
OPENCV_MAX_PIXELS = 1 << 30       # OpenCV's CV_IO_MAX_IMAGE_PIXELS
OPENCV_MAX_SIDE = 1 << 20         # CV_IO_MAX_IMAGE_WIDTH / HEIGHT


def decode(data, name="webp"):
    """What `PIL.Image.open(p)` decodes from a WebP file: (rgb uint8 [H, W,
    3], alpha uint8 [H, W] or None when the file declares none). Raises
    ValueError where PIL (libwebp) refuses the file."""
    canvas, has_alpha = _anim_frame0(data, name, PIL_MAX_PIXELS)
    return canvas[..., :3], canvas[..., 3] if has_alpha else None


OPENCV_HEADER_SIZE = 32  # the bytes OpenCV's WebP reader checks first


def decode_opencv(data, name="webp"):
    """What `cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)` decodes from
    a WebP file, in RGB order: (rgb uint8 [H, W, 3], None). Raises
    ValueError where OpenCV reads nothing."""
    if len(data) < OPENCV_HEADER_SIZE:
        raise _refuse(name, "shorter than OpenCV's 32-byte WebP header")
    feat = _parse_headers(data[:OPENCV_HEADER_SIZE], False, False)
    if not isinstance(feat, dict):
        raise _refuse(name, "a header OpenCV's WebP reader refuses")
    if not (0 < feat["width"] <= OPENCV_MAX_SIDE
            and 0 < feat["height"] <= OPENCV_MAX_SIDE
            and feat["width"] * feat["height"] <= OPENCV_MAX_PIXELS):
        raise ValueError(f"'{name}': {feat['width']} x {feat['height']}, "
                         "outside OpenCV's image size limits")
    if feat["has_animation"]:
        return _anim_frame0(data, name, OPENCV_MAX_PIXELS)[0][..., :3], None
    rgb, _ = _decode_into(data, name)
    if rgb.shape[:2] != (feat["height"], feat["width"]):
        raise _refuse(name, "an image of another size than its header's")
    return rgb, None
