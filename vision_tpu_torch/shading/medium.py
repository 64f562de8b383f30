"""Participating media: homogeneous medium table + Henyey-Greenstein phase.

Counterpart of `vision_tpu/shading/medium.py`. Media live in one table of
rows (sigma_a, sigma_s with the scale folded in, g); a lane carries the id
of the medium it travels in (-1 for none). Distance sampling is analytic
per channel: a channel picked uniformly, its exponential sampled, the pdf
averaged over channels. Named presets (`medium_name`, e.g. "Skin1") come
from the measured table `data/measured_ss.npz`; an unknown name takes its
first row.

Under a hero spectrum a lane's sigma_t and sigma_s decode to spectra at its
wavelengths (the unbound decode); the lane-independent half of that decode
is made once per medium row (`MediumTable.hero_rows`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import rng
from ..core.math import (Inv4Pi, TwoPi, coordinate_system, normalize,
                         safe_div, sqr, to_world, vec3)
from ..core.rows import PackedRows
from ..scene.desc import ParameterSet
from ..spectra.spd import DATA_DIR


def measured_ss(name):
    """(sigma_s [3], sigma_a [3]) of a measured preset; the table's first
    row for an unknown name."""
    tbl = np.load(os.path.join(DATA_DIR, "measured_ss.npz"))
    names = [str(n) for n in tbl["names"]]
    if name not in names:
        name = names[0]
    i = names.index(name)
    return tbl["sigma_s"][i], tbl["sigma_a"][i]


@dataclass
class MediumTable:
    sigma_a: torch.Tensor  # [Md, 3] (x scale folded in)
    sigma_s: torch.Tensor  # [Md, 3]
    g: torch.Tensor        # [Md]
    packed: PackedRows = field(default=None, repr=False)
    _hero: PackedRows = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.packed = PackedRows(
            dict(sigma_t=self.sigma_t, sigma_s=self.sigma_s, g=self.g),
            (("sigma_t", 3), ("sigma_s", 3), ("g", 1)))

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s

    def hero_rows(self, spectrum):
        """Per-row sigmoid coefficients and scales of the unbound decode of
        sigma_t and sigma_s, packed with g; made at the first call."""
        if self._hero is None:
            ct, st = spectrum.row_coeffs(self.sigma_t, unbound=True)
            cs, ss = spectrum.row_coeffs(self.sigma_s, unbound=True)
            self._hero = PackedRows(
                dict(ct=ct, st=st, cs=cs, ss=ss, g=self.g),
                (("ct", 3), ("st", 1), ("cs", 3), ("ss", 1), ("g", 1)))
        return self._hero


class MediumBuilder:
    def __init__(self):
        self.rows = []
        self.by_name = {}

    def add(self, desc):
        """One `mediums.list` entry (a homogeneous medium); returns its
        id."""
        p = ParameterSet(desc.get("param", {}))
        name = desc.get("name")
        scale = p.as_float("scale", 1.0)
        mname = p.as_str("medium_name", "")
        if mname:
            ss, sa = measured_ss(mname)
        else:
            ss = np.asarray(p.as_float3("sigma_s", (1, 1, 1)), np.float32)
            sa = np.asarray(p.as_float3("sigma_a", (0, 0, 0)), np.float32)
        g = float(np.clip(p.as_float("g", 0.0), -0.99, 0.99))
        mid = len(self.rows)
        self.rows.append((ss * scale, sa * scale, g))
        if name:
            self.by_name[name] = mid
        return mid

    def get(self, name):
        return self.by_name.get(name, -1)

    def build(self, device):
        rows = self.rows or [(np.zeros(3, np.float32), np.zeros(3, np.float32),
                              0.0)]

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return MediumTable(sigma_a=t(np.stack([r[1] for r in rows])),
                           sigma_s=t(np.stack([r[0] for r in rows])),
                           g=t([r[2] for r in rows]))


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function
# ---------------------------------------------------------------------------

def hg_phase(cos_theta, g):
    denom = 1.0 + sqr(g) + 2.0 * g * cos_theta
    return Inv4Pi * (1.0 - sqr(g)) / (
        denom * torch.sqrt(torch.clamp_min(denom, 1e-8)))


def hg_sample(wo, g, u2):
    """Sample wi from HG, wo pointing away from the scatter point: returns
    (wi, pdf)."""
    g = torch.where(torch.abs(g) < 1e-3,
                    torch.full_like(g, 1e-3) * torch.sign(g + 1e-9), g)
    sqr_term = (1.0 - sqr(g)) / (1.0 + g - 2.0 * g * u2[..., 0])
    cos_theta = -(1.0 + sqr(g) - sqr(sqr_term)) / (2.0 * g)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - sqr(cos_theta), 0.0))
    phi = TwoPi * u2[..., 1]
    t, b = coordinate_system(wo)
    wi_local = vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                    cos_theta)
    wi = to_world(t, b, wo, wi_local)
    return normalize(wi), hg_phase(cos_theta, g)


def gather_spectral(table, mid, spectrum, swl):
    """(sigma_t [..., S], sigma_s [..., S], g [...]) for lanes with medium
    id `mid` (clamped; callers mask by mid >= 0); the unbound decode under
    a hero spectrum."""
    m = torch.clamp(mid.long(), 0, table.g.shape[0] - 1)
    if spectrum is not None and spectrum.hero:
        h = table.hero_rows(spectrum).fetch(m)
        return (spectrum.eval_coeffs(h("ct"), swl, h("st")[..., None]),
                spectrum.eval_coeffs(h("cs"), swl, h("ss")[..., None]), h("g"))
    r = table.packed.fetch(m)
    return r("sigma_t"), r("sigma_s"), r("g")


def sample_distance(state, sigma_t, t_surf, S):
    """Analytic distance sampling: pick a channel uniformly, sample
    exp(-sigma_t_c d). Two draws, the channel's first. Returns (state, t,
    sampled-in-medium mask, weight_surface, weight_medium): the
    throughput ratios tr / pdf of a surface event and tr / pdf of a medium
    event (whose sigma_s factor the caller applies)."""
    state, u_c = rng.next_1d(state)
    state, u_d = rng.next_1d(state)
    ch = torch.clamp_max((u_c * S).to(torch.int64), S - 1)
    s_ch = torch.gather(sigma_t, -1, ch[..., None])[..., 0]
    dist = (-torch.log(torch.clamp_min(1.0 - u_d, 1e-9))
            / torch.clamp_min(s_ch, 1e-9))
    t = torch.minimum(dist, t_surf)
    sampled_medium = (dist < t_surf) & (s_ch > 0.0)
    tr = torch.exp(-sigma_t * t[..., None])
    density_m = torch.mean(sigma_t * tr, -1)
    density_s = torch.mean(tr, -1)
    w_medium = tr * safe_div(1.0, density_m)[..., None]
    w_surface = tr * safe_div(1.0, density_s)[..., None]
    return state, t, sampled_medium, w_surface, w_medium


def transmittance(sigma_t, dist, in_medium):
    """Shadow-ray transmittance for lanes inside a homogeneous medium."""
    tr = torch.exp(-sigma_t * dist[..., None])
    return torch.where(in_medium[..., None], tr, torch.ones_like(tr))
