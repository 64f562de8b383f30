"""Spectrum models: 3-channel sRGB passthrough and hero-wavelength spectral.

Counterpart of `vision_tpu/spectra/spectrum.py`. One model drives both
modes:

  * srgb: S = 3, decode = identity, to_srgb = identity, no wavelength is
    sampled and no random number drawn;
  * hero: S = `dims` wavelengths per path, the hero drawn by importance over
    the visible range from one random number and the others at stratified
    offsets; sRGB -> spectrum by the sigmoid-polynomial table
    (`srgb2spec.npz`, trilinear in the JAX package's coordinates, with its
    grayscale special case); CIE XYZ integration back to linear sRGB, where
    a dispersive scatter has terminated the secondary wavelengths.

Tables come from this package's `data/` (`cie.npz`, `srgb2spec.npz`).

A colour that is constant per table row (a material slot without a
texture, a medium's sigma) can be decoded in two steps: `row_coeffs` once
per row at first use, `eval_coeffs` per lane. Both are the per-lane
decode's own float32 operations in its order, so the result is the same;
the per-lane `decode_*` stays for textured slots.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core import rng
from ..core.math import asin0, clip, safe_div, sqr
from . import spd

XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float32)

KIND_SRGB = 0
KIND_HERO = 1


@dataclass
class SampledWavelengths:
    """Per-lane wavelength set: lam [..., S], pdf [..., S], and whether the
    secondaries are still alive (a dispersive scatter kills all but the
    hero)."""
    lam: torch.Tensor
    pdf: torch.Tensor
    secondary_alive: torch.Tensor  # [...] bool

    def terminate_secondary(self, mask):
        """Kill the secondary wavelengths where mask (dispersive scatter)."""
        return replace(self, secondary_alive=self.secondary_alive & ~mask)


@dataclass
class SpectrumModel:
    kind: int
    dims: int
    coeffs: torch.Tensor    # [3, res, res, res, 3] sigmoid-poly table
    cie_x: torch.Tensor     # [471]
    cie_y: torch.Tensor
    cie_z: torch.Tensor
    d65n: torch.Tensor      # normalized D65 (integrates to white)

    def __post_init__(self):
        # device constants, made once: a tensor built from host data inside
        # a render would synchronise the card at every call
        res = self.coeffs.shape[1]
        dev = self.coeffs.device
        self._corners = torch.tensor(
            [(dz * res + dy) * res + dx for dz in (0, 1) for dy in (0, 1)
             for dx in (0, 1)], device=dev)
        self._xyz_to_srgb_t = torch.as_tensor(XYZ_TO_SRGB.T.copy(), device=dev)

    @classmethod
    def make(cls, kind="srgb", dims=3, device="cuda"):
        """The srgb model, or the hero model of `dims` wavelengths."""
        cie = np.load(os.path.join(spd.DATA_DIR, "cie.npz"))
        tbl = np.load(os.path.join(spd.DATA_DIR, "srgb2spec.npz"))
        y_int = float(cie["Y"].sum())
        d65n = cie["D65"] * (y_int / float((cie["Y"] * cie["D65"]).sum()))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(kind=KIND_SRGB if kind == "srgb" else KIND_HERO,
                   dims=3 if kind == "srgb" else int(dims),
                   coeffs=t(tbl["coeffs"]), cie_x=t(cie["X"]),
                   cie_y=t(cie["Y"]), cie_z=t(cie["Z"]), d65n=t(d65n))

    @property
    def hero(self):
        return self.kind == KIND_HERO

    # ---- wavelength sampling ----

    def sample_wavelengths(self, state):
        """(state, SampledWavelengths). The srgb mode returns the peak
        wavelengths and draws nothing."""
        shape = state.shape
        dev = state.device
        if not self.hero:
            lam = torch.tensor(spd.RGB_PEAK_WAVELENGTHS, dtype=torch.float32,
                               device=dev).expand(shape + (3,))
            return state, SampledWavelengths(
                lam=lam, pdf=torch.ones(shape + (3,), device=dev),
                secondary_alive=torch.ones(shape, dtype=torch.bool, device=dev))
        n = self.dims
        state, u = rng.next_1d(state)
        offs = torch.arange(n, dtype=torch.float32, device=dev) / n
        up = torch.remainder(u[..., None] + offs, 1.0)
        # visible-wavelength importance sample
        lam = 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * up)
        pdf = 0.0039398042 / sqr(torch.cosh(0.0072 * (lam - 538.0)))
        return state, SampledWavelengths(
            lam=lam, pdf=pdf,
            secondary_alive=torch.ones(shape, dtype=torch.bool, device=dev))

    # ---- rgb -> spectrum ----

    def _poly_coeffs(self, rgb):
        """Trilinear lookup of the sigmoid-poly coefficients [..., 3] for
        rgb [..., 3] in [0, 1]^3, with the grayscale special case."""
        res = self.coeffs.shape[1]
        rgb = clip(rgb, 0.0, 1.0)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        maxc = torch.where(r > g, torch.where(r > b, 0, 2),
                           torch.where(g > b, 1, 2))
        idx = torch.stack([maxc, (maxc + 1) % 3, (maxc + 2) % 3], -1)
        zxy = torch.gather(rgb, -1, idx)
        z = zxy[..., 0]
        zs = torch.clamp_min(z, 1e-6)
        x = zxy[..., 1] / zs
        y = zxy[..., 2] / zs

        def ism(t):
            return 0.5 - torch.sin(
                asin0(1.0 - 2.0 * torch.clamp(t, 0.0, 1.0)) / 3.0)

        zz = ism(ism(z))
        fx = x * (res - 1)
        fy = y * (res - 1)
        fz = zz * (res - 1)
        xi = torch.clamp(fx.to(torch.int32), 0, res - 2)
        yi = torch.clamp(fy.to(torch.int32), 0, res - 2)
        zi = torch.clamp(fz.to(torch.int32), 0, res - 2)
        dx = (fx - xi)[..., None]
        dy = (fy - yi)[..., None]
        dz = (fz - zi)[..., None]
        # the eight corners in one gather: flat row of (maxc, z, y, x)
        base = ((maxc.long() * res + zi) * res + yi) * res + xi
        co = self.coeffs.reshape(-1, 3)[base[..., None] + self._corners]

        def c(ddx, ddy, ddz):
            return co[..., ddz * 4 + ddy * 2 + ddx, :]

        cf = ((1 - dz) * ((1 - dy) * ((1 - dx) * c(0, 0, 0) + dx * c(1, 0, 0))
                          + dy * ((1 - dx) * c(0, 1, 0) + dx * c(1, 1, 0)))
              + dz * ((1 - dy) * ((1 - dx) * c(0, 0, 1) + dx * c(1, 0, 1))
                      + dy * ((1 - dx) * c(0, 1, 1) + dx * c(1, 1, 1))))
        # grayscale: a flat sigmoid at the value
        sg = (r - 0.5) * torch.rsqrt(torch.clamp_min(r * (1.0 - r), 1e-9))
        zero = torch.zeros_like(sg)
        gray = torch.stack([zero, zero, sg], -1)
        is_gray = (torch.abs(r - g) < 1e-6) & (torch.abs(g - b) < 1e-6)
        return torch.where(is_gray[..., None], gray, cf)

    def _poly_eval(self, c, lam):
        """sigmoid(c0 x^2 + c1 x + c2) at wavelengths lam [..., S]."""
        xn = (lam - 360.0) / (830.0 - 360.0) * 2.0 - 1.0
        f = c[..., 0:1] * xn * xn + c[..., 1:2] * xn + c[..., 2:3]
        return 0.5 * (f * torch.rsqrt(f * f + 1.0) + 1.0)

    @staticmethod
    def _unbound_scale(rgb):
        rgb = torch.clamp_min(rgb, 0.0)
        scale = 2.0 * torch.amax(rgb, -1, keepdim=True)
        safe = torch.where(scale > 0.0, rgb / torch.clamp_min(scale, 1e-12),
                           0.0)
        return safe, scale

    def decode_albedo(self, rgb, swl=None):
        """Reflectance spectrum [..., S] for rgb [..., 3]."""
        if not self.hero:
            return rgb
        return self._poly_eval(self._poly_coeffs(rgb), swl.lam)

    def decode_unbound(self, rgb, swl=None):
        if not self.hero:
            return rgb
        safe, scale = self._unbound_scale(rgb)
        return self._poly_eval(self._poly_coeffs(safe), swl.lam) * scale

    def decode_illumination(self, rgb, swl=None):
        """Emission spectrum: the unbound decode times normalized D65."""
        if not self.hero:
            return rgb
        d65 = spd.spd_eval(self.d65n, swl.lam)
        return self.decode_unbound(rgb, swl) * d65

    def row_coeffs(self, rgb, unbound=False):
        """The lane-independent half of `decode_albedo` (or, with
        `unbound`, of `decode_unbound`) for rows rgb [N, 3]: coefficients
        [N, 3], and for `unbound` the scale [N, 1] too."""
        if not unbound:
            return self._poly_coeffs(rgb)
        safe, scale = self._unbound_scale(rgb)
        return self._poly_coeffs(safe), scale

    def eval_coeffs(self, c, swl, scale=None):
        """The per-lane half: coefficients [..., 3] (and scale [..., 1])
        gathered for each lane -> spectrum [..., S] at swl.lam."""
        sp = self._poly_eval(c, swl.lam)
        return sp if scale is None else sp * scale

    # ---- spectrum -> display ----

    def to_srgb(self, sp, swl=None):
        """[..., S] spectral radiance -> linear sRGB [..., 3]: dead
        secondaries weigh 0, the hero 1, normalised by the live count."""
        if not self.hero:
            return sp
        alive = swl.secondary_alive
        w = safe_div(1.0, swl.pdf)
        mask = torch.cat([torch.ones_like(alive[..., None]),
                          alive[..., None].expand(sp[..., 1:].shape)], -1)
        w = w * mask
        n_valid = torch.sum(mask, -1)
        cx = spd.spd_eval(self.cie_x, swl.lam)
        cy = spd.spd_eval(self.cie_y, swl.lam)
        cz = spd.spd_eval(self.cie_z, swl.lam)
        y_int = torch.sum(self.cie_y)
        f = safe_div(1.0, n_valid * y_int)
        X = torch.sum(cx * sp * w, -1) * f
        Y = torch.sum(cy * sp * w, -1) * f
        Z = torch.sum(cz * sp * w, -1) * f
        xyz = torch.stack([X, Y, Z], -1)
        return xyz @ self._xyz_to_srgb_t
