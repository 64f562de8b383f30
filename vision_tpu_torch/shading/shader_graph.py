"""Shader-graph calculation nodes: fold and bake on the host.

Counterpart of `vision_tpu/shading/shader_graph.py`. Every calculation node
is a pure function of the surface uv, so a node tree whose leaves are
images or constants is baked at load time: constants fold on the host, an
image-valued subtree is rasterised into one atlas texture at its largest
leaf's resolution (nearest-index resampling). Shading then costs one
bilinear texture lookup, whatever the tree.

Node types: number (a constant), image (a texture leaf), add / subtract /
multiply / divide, lerp / mix (t, A, B), scale, clamp; a channel swizzle
("channels": "xyz", "x", "wxy", ...) applies to any node's result.

Two context-dependent nodes are evaluated at shade time instead, staged on
the material row by `materials.py`: a fresnel-driven mix
(`detect_fresnel_mix`: the colour blends A..B by the dielectric Fresnel
term of |n.wo|) and a `vector_mapping` uv transform (`detect_uv_mapping`).
Normal maps do not bake either: the material's `bump` slot keeps the map's
atlas id and `integrator/pt.py` perturbs the shading normal. Any other
context-dependent node folds to a neutral 1.0 with a warning, as in the
JAX package.

A slot whose image cannot be read takes the slot's default with a warning,
as in the JAX package; an image format or variant this package does not
decode (luminance-chroma and UINT OpenEXR, the rarer TIFF codecs, ICO,
PSD and the other formats of ROADMAP 7e) raises NotImplementedError.
"""
from __future__ import annotations

import os
import warnings

import numpy as np

from ..scene.desc import parse_slot
from ..scene.texture import load_image

_SWZ = {"x": 0, "y": 1, "z": 2, "w": 3,
        "r": 0, "g": 1, "b": 2, "a": 3}

_BINARY = {
    "add": np.add, "subtract": np.subtract, "sub": np.subtract,
    "multiply": np.multiply, "mul": np.multiply,
    "divide": lambda a, b: np.divide(a, np.where(np.abs(b) < 1e-9, 1e-9, b)),
}
_BINARY["div"] = _BINARY["divide"]


class SlotValue:
    """A folded slot: a constant vector or an image [H, W, C]."""

    def __init__(self, const=None, image=None):
        self.const = None if const is None else np.atleast_1d(
            np.asarray(const, np.float32))
        self.image = None if image is None else np.asarray(image, np.float32)

    @property
    def is_const(self):
        return self.image is None

    def channels(self):
        return (self.const.shape[-1] if self.is_const
                else self.image.shape[-1])

    def as_image(self, h, w):
        """This value at h x w: a constant broadcast, an image resampled by
        nearest index."""
        if self.image is None:
            return np.broadcast_to(self.const, (h, w, self.const.shape[-1]))
        if self.image.shape[:2] == (h, w):
            return self.image
        yi = np.arange(h) * self.image.shape[0] // h
        xi = np.arange(w) * self.image.shape[1] // w
        return self.image[yi][:, xi]

    def swizzle(self, channels):
        if not channels:
            return self
        idx = [_SWZ[c] for c in channels.lower() if c in _SWZ]
        if not idx:
            return self

        def pick(arr):
            return arr[..., [min(i, arr.shape[-1] - 1) for i in idx]]

        if self.is_const:
            return SlotValue(const=pick(self.const))
        return SlotValue(image=pick(self.image))


def _broadcast_op(a, b, op):
    """op over two SlotValues, baked to an image if either is one."""
    if a.is_const and b.is_const:
        n = max(a.const.shape[-1], b.const.shape[-1])

        def pad(v):
            return np.concatenate([v, np.repeat(v[-1:], n - v.shape[-1])]) \
                if v.shape[-1] < n else v
        return SlotValue(const=op(pad(a.const), pad(b.const)))
    h = max(x.image.shape[0] for x in (a, b) if not x.is_const)
    w = max(x.image.shape[1] for x in (a, b) if not x.is_const)
    c = max(a.channels(), b.channels())

    def im(x):
        img = x.as_image(h, w)
        if img.shape[-1] < c:
            img = np.concatenate(
                [img, np.repeat(img[..., -1:], c - img.shape[-1], -1)], -1)
        return img
    return SlotValue(image=op(im(a), im(b)))


def fold_slot(raw, scene_dir=".", default_cs="srgb"):
    """Fold a slot description -> SlotValue. `default_cs` is the colour
    space of an image leaf that names none (scalar slots pass "linear").
    Raises on a slot it cannot parse or an image it cannot read."""
    kind, payload, channels = parse_slot(raw)
    if kind == "const":
        return SlotValue(const=payload).swizzle(channels)
    if kind == "image":
        img = load_image(os.path.join(scene_dir, payload.get("fn")),
                         payload.get("color_space", default_cs))
        s = payload.get("scale", 1.0)
        if s != 1.0:
            img = img * float(s)
        return SlotValue(image=img).swizzle(channels)
    if kind in _BINARY:
        lhs = fold_slot(payload.get("lhs", 0.0), scene_dir, default_cs)
        rhs = fold_slot(payload.get("rhs", 0.0), scene_dir, default_cs)
        return _broadcast_op(lhs, rhs, _BINARY[kind]).swizzle(channels)
    if kind in ("lerp", "mix"):
        t = fold_slot(payload.get("t", 0.5), scene_dir, default_cs)
        A = fold_slot(payload.get("A", payload.get("lhs", 0.0)), scene_dir,
                      default_cs)
        B = fold_slot(payload.get("B", payload.get("rhs", 1.0)), scene_dir,
                      default_cs)
        am = _broadcast_op(A, t, lambda a, tt: a * (1.0 - tt))
        bm = _broadcast_op(B, t, lambda b, tt: b * tt)
        return _broadcast_op(am, bm, np.add).swizzle(channels)
    if kind == "scale":
        v = fold_slot(payload.get("value", payload.get("node", 1.0)),
                      scene_dir, default_cs)
        s = float(np.atleast_1d(payload.get("scale", 1.0))[0])
        if v.is_const:
            return SlotValue(const=v.const * s).swizzle(channels)
        return SlotValue(image=v.image * s).swizzle(channels)
    if kind == "clamp":
        v = fold_slot(payload.get("value", 0.0), scene_dir, default_cs)
        lo = float(payload.get("lower", 0.0))
        hi = float(payload.get("upper", 1.0))
        arr = np.clip(v.const if v.is_const else v.image, lo, hi)
        return (SlotValue(const=arr) if v.is_const
                else SlotValue(image=arr)).swizzle(channels)
    # context-dependent (a nested fresnel, normal_map, ...): not bakeable
    warnings.warn(f"shader node '{kind}' is context-dependent; "
                  f"using neutral 1.0")
    return SlotValue(const=[1.0, 1.0, 1.0]).swizzle(channels)


def _fold_or_warn(raw, scene_dir, default_cs):
    """fold_slot, or None with a warning where the JAX package takes the
    slot's default; an undecoded image format still raises."""
    try:
        return fold_slot(raw, scene_dir, default_cs)
    except NotImplementedError:
        raise
    except Exception as e:
        warnings.warn(f"slot fold failed ({e}); using default")
        return None


def resolve_rgb(raw, atlas_builder, scene_dir=".", default=(1.0, 1.0, 1.0)):
    """Fold a colour slot -> (rgb_const [3], tex_id). An image-valued
    result is baked into the atlas and its constant is white."""
    v = _fold_or_warn(raw, scene_dir, "srgb")
    if v is None:
        return list(default), -1
    if v.is_const:
        c = list(v.const) + [float(v.const[-1])] * max(0, 3 - v.const.shape[-1])
        return [float(c[0]), float(c[1]), float(c[2])], -1
    img = v.image
    if img.shape[-1] < 3:
        img = np.concatenate([img, np.repeat(img[..., -1:],
                                             3 - img.shape[-1], -1)], -1)
    return [1.0, 1.0, 1.0], atlas_builder.add_array(img[..., :3])


def resolve_scalar(raw, atlas_builder, scene_dir=".", default=0.0):
    """Fold a scalar slot -> (scalar_const, tex_id)."""
    v = _fold_or_warn(raw, scene_dir, "linear")
    if v is None:
        return float(default), -1
    if v.is_const:
        return float(v.const[0]), -1
    img = v.image
    if img.shape[-1] < 3:
        img = np.repeat(img[..., :1], 3, -1)
    return float(default), atlas_builder.add_array(img[..., :3])


def _const_scalar(raw, default):
    try:
        v = fold_slot(raw, default_cs="linear")
        if v.is_const:
            return float(v.const.reshape(-1)[0])
    except NotImplementedError:
        raise
    except Exception:
        pass
    return float(default)


def _const_rgb(raw, scene_dir):
    v = fold_slot(raw, scene_dir, "srgb")
    if v.is_const:
        c = v.const.reshape(-1)
    else:
        c = v.image.reshape(-1, v.image.shape[-1]).mean(0)
    c = np.concatenate([c, np.repeat(c[-1:], 3)])[:3]
    return [float(x) for x in c]


def detect_fresnel_mix(raw, scene_dir="."):
    """A shade-time fresnel node: (ior, A, B) when the slot is
    `fresnel(ior)` (A = 0, B = 1) or a mix / lerp whose t is a fresnel
    node (a constant A and B; an image one enters as its mean); else
    None."""
    try:
        kind, payload, _ = parse_slot(raw)
    except Exception:
        return None
    if kind == "fresnel":
        ior = _const_scalar(payload.get("ior", 1.5), 1.5)
        return ior, [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]
    if kind in ("mix", "lerp"):
        t = payload.get("t")
        if t is None:
            return None
        try:
            kt, pt, _ = parse_slot(t)
        except Exception:
            return None
        if kt != "fresnel":
            return None
        ior = _const_scalar(pt.get("ior", 1.5), 1.5)
        A = _const_rgb(payload.get("A", payload.get("lhs", 0.0)), scene_dir)
        B = _const_rgb(payload.get("B", payload.get("rhs", 1.0)), scene_dir)
        return ior, A, B
    return None


def detect_uv_mapping(raw):
    """A shade-time vector_mapping node: a TRS over the lookup uv feeding
    the inner node. Returns (affine [a b tx c d ty], inner slot) or None.
    The rotation is the z Euler angle in degrees (the u-v plane); scale and
    location take their x and y components."""
    try:
        kind, payload, channels = parse_slot(raw)
    except Exception:
        return None
    if kind != "vector_mapping":
        return None
    s = np.atleast_1d(np.asarray(payload.get("scale", [1.0, 1.0, 1.0]),
                                 np.float64))
    r = np.atleast_1d(np.asarray(payload.get("rotation", [0.0, 0.0, 0.0]),
                                 np.float64))
    t = np.atleast_1d(np.asarray(payload.get("location", [0.0, 0.0, 0.0]),
                                 np.float64))
    sx = s[0] if s.size else 1.0
    sy = s[1] if s.size > 1 else sx
    rz = np.deg2rad(r[2] if r.size > 2 else (r[0] if r.size == 1 else 0.0))
    c_, s_ = np.cos(rz), np.sin(rz)
    # uv' = Rz @ diag(s) @ uv + t
    affine = [c_ * sx, -s_ * sy, float(t[0]),
              s_ * sx, c_ * sy, float(t[1] if t.size > 1 else 0.0)]
    inner = payload.get("node", payload.get("vector", 0.5))
    if channels:
        inner = {"channels": channels, "node": inner}
    return [float(x) for x in affine], inner
