"""libtiff's SGILog conversions (tif_luv.c, uvcode.h), in float64 as
libtiff computes them, each result rounded as libtiff stores it:

  * `logl16_to_y` / `logl10_to_y`: LogL16toY (sign bit 15, L = 0 gives 0)
    and LogL10toY, exp(ln2 / 256 (Le + .5) - 64 ln2) and exp(ln2 / 64 (Le
    + .5) - 12 ln2). The exponentials come from tables filled on first use
    by `math.exp`, which is the C library's exp that libtiff calls (numpy's
    and torch's vectorised exp may differ from it in the last bit).
  * `logluv32_to_xyz` / `logluv24_to_xyz`: LogLuv32toXYZ and LogLuv24toXYZ
    -> float32 X, Y, Z; all three 0 where L <= 0 (the sign bit gives black).
    LogLuv24's 14-bit uv code is decoded by `uv_decode` over uvcode.h's
    `uv_row` table (`vision_tpu_torch/data/sgilog_uv.npz`, recovered from
    the pip cv2's decodes by `tools/gen_torch_sgilog.py`); a code past the
    table's 16,289 takes the neutral (U_NEU, V_NEU).
  * `l16_to_gry`: L16toGry, the 8-bit grey libtiff's RGBA reader makes of
    LogL: 0 for Y <= 0, 255 for Y >= 1, else (int)(256 sqrt(Y)).
"""
from __future__ import annotations

import math
import os

import numpy as np

_LN2 = math.log(2.0)
UVSCALE = 410.0
# uvcode.h's constants: the float ones as libtiff's (float) casts round them
UV_SQSIZ = float(np.float32(0.003500))
UV_VSTART = float(np.float32(0.016940))
UV_NDIVS = 16289
U_NEU = 0.210526316
V_NEU = 0.473684211
_DATA = os.path.join(os.path.dirname(__file__), "..", "data", "sgilog_uv.npz")

_tables = {}


def _exp_table(name, n, scale, offset):
    """exp(scale * (i + .5) - offset) for i < n, by the C library's exp."""
    t = _tables.get(name)
    if t is None:
        t = np.array([math.exp(scale * (i + .5) - offset) for i in range(n)])
        _tables[name] = t
    return t


def logl16_to_y(p16):
    """LogL16toY of int codes (bit 15 the sign) -> float64 Y."""
    p16 = np.asarray(p16, np.int64)
    le = p16 & 0x7FFF
    y = np.where(le == 0, 0.0, _exp_table("l16", 1 << 15, _LN2 / 256.0,
                                          _LN2 * 64.0)[le])
    return np.where(p16 & 0x8000, -y, y)


def logl10_to_y(p10):
    """LogL10toY of int codes -> float64 Y (0 for code 0)."""
    p10 = np.asarray(p10, np.int64)
    y = _exp_table("l10", 1 << 10, _LN2 / 64.0, _LN2 * 12.0)[p10]
    return np.where(p10 == 0, 0.0, y)


def _uv_to_xyz(L, u, v):
    """The shared tail of LogLuv32toXYZ / LogLuv24toXYZ -> float32 [..., 3]."""
    with np.errstate(all="ignore"):
        s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
        x = 9.0 * u * s
        y = 4.0 * v * s
        xyz = np.stack([x / y * L, L, (1.0 - x - y) / y * L], -1)
    xyz[L <= 0] = 0.0
    return xyz.astype(np.float32)


def logluv32_to_xyz(p):
    """LogLuv32toXYZ of uint32 codes (L in bits 31-16, u 15-8, v 7-0) ->
    float32 [..., 3] X, Y, Z."""
    p = np.asarray(p, np.int64)
    L = logl16_to_y(p >> 16)
    u = 1.0 / UVSCALE * (((p >> 8) & 0xFF) + 0.5)
    v = 1.0 / UVSCALE * ((p & 0xFF) + 0.5)
    return _uv_to_xyz(L, u, v)


def uv_table():
    """uvcode.h's `uv_row`: (ustart float32, nus int16, ncum int16), one
    entry a row of v."""
    t = _tables.get("uv")
    if t is None:
        with np.load(_DATA) as z:
            t = (z["ustart"].astype(np.float32), z["nus"].astype(np.int16),
                 z["ncum"].astype(np.int16))
        _tables["uv"] = t
    return t


def uv_decode(c):
    """uv_decode of 14-bit codes -> (u, v) float64; codes past UV_NDIVS
    give (U_NEU, V_NEU), as LogLuv24toXYZ takes them. The row is the last
    whose first code is at or below c (the binary search's answer for
    every code of the table)."""
    ustart, _, ncum = uv_table()
    c = np.asarray(c, np.int64)
    vi = np.searchsorted(ncum.astype(np.int64), c, side="right") - 1
    vi = np.clip(vi, 0, len(ncum) - 1)
    ui = c - ncum[vi]
    u = ustart[vi].astype(np.float64) + (ui + 0.5) * UV_SQSIZ
    v = UV_VSTART + (vi + 0.5) * UV_SQSIZ
    bad = (c < 0) | (c >= UV_NDIVS)
    return np.where(bad, U_NEU, u), np.where(bad, V_NEU, v)


def logluv24_to_xyz(p):
    """LogLuv24toXYZ of 24-bit codes (L in bits 23-14, uv in 13-0) ->
    float32 [..., 3] X, Y, Z."""
    p = np.asarray(p, np.int64)
    L = logl10_to_y((p >> 14) & 0x3FF)
    u, v = uv_decode(p & 0x3FFF)
    return _uv_to_xyz(L, u, v)


def l16_to_gry(p16):
    """L16toGry of LogL16 codes -> uint8 grey."""
    y = logl16_to_y(p16)
    with np.errstate(invalid="ignore"):
        g = np.floor(256.0 * np.sqrt(np.maximum(y, 0.0)))
    return np.where(y <= 0, 0, np.where(y >= 1, 255, g)).astype(np.uint8)
