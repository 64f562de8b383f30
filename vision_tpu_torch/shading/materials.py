"""Material compilation: JSON material descs -> flat material table rows.

Counterpart of `vision_tpu/shading/materials.py`. Each material type maps
to parameters of the uber-BSDF (bsdf.py): diffuse (Oren-Nayar through
`sigma`), mirror, metal, metallic, glass, substrate, plastic,
principled_bsdf, subsurface (a rough dielectric row whose interior medium
the scene attaches), emission, black_body, and the mixtures mix, add and
multi_layered (a second row and two weights); an unknown type becomes grey
diffuse. The table carries every column of the JAX package's
`MaterialTable`, in its units, so both packages gather the same rows,
the spectral ones included (`glass_coeffs`, `metal_*_spd`,
`dispersive_id`, `metal_id`).

A slot is a constant, an image or a tree of calculation nodes over them,
folded or baked into the texture atlas on the host (`shader_graph.py`); an
image that cannot be read takes the slot's default, as in the JAX package.
Two nodes are staged on the row for shade time: a fresnel-driven colour
mix (`fres_ior`, `fres_a`, `fres_b`; the row's static colour is the mean of
the two ends) and a uv `vector_mapping` (`uv_xform`). The `bump` slot
holds a tangent-space normal map (`normal_tex`, `bump_scale`), which
`integrator/pt.py` applies.

At shade time `gather_params` reads a lane's row in one indexing of the
packed columns (`core/rows.py`), moves the lookup uv by the row's uv
transform, resolves the kd / spec / rough / frac texture slots against the
atlas and blends a fresnel-driven kd by the lane's |cos wo|. Under the
hero spectrum the colour slots
decode to spectra at the lane's wavelengths, a dispersive glass takes its
Sellmeier IOR per wavelength and a named metal its measured eta / k; a
slot without a texture decodes from sigmoid coefficients computed once per
row (`MaterialTable.hero_rows`), the same float32 operations as the
per-lane decode, which textured slots keep.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from ..core.rows import PackedRows
from ..scene.desc import ParameterSet, parse_slot
from ..spectra import spd
from ..spectra.spd import DATA_DIR
from . import bsdf
from . import fresnel as frs
from . import shader_graph as sg
from .microfacet import calculate_alpha, roughness_to_alpha


@dataclass
class MaterialTable:
    """[M, ...] rows of uber-BSDF parameters + texture slot ids (-1 =
    const), the JAX package's columns in its order."""
    kd: torch.Tensor            # [M, 3]
    kd_tex: torch.Tensor        # [M]
    sigma: torch.Tensor
    diffuse_kind: torch.Tensor
    diffuse_weight: torch.Tensor
    spec_tint: torch.Tensor     # [M, 3]
    spec_tex: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    rough_tex: torch.Tensor     # scalar roughness texture (remapped at shade time)
    rough_remap: torch.Tensor
    anisotropic: torch.Tensor
    fr_mode: torch.Tensor
    eta: torch.Tensor           # [M] scalar dielectric ior
    eta3: torch.Tensor          # [M, 3] conductor eta / Schlick F0 / F82 F0
    k3: torch.Tensor            # [M, 3] conductor k / F82 b
    spec_weight: torch.Tensor
    trans_weight: torch.Tensor
    cc_weight: torch.Tensor
    cc_alpha: torch.Tensor
    sheen_weight: torch.Tensor
    sheen_tint: torch.Tensor    # [M, 3]
    flatness: torch.Tensor
    metallic: torch.Tensor
    dispersive_id: torch.Tensor  # glass_coeffs row (-1 none)
    metal_id: torch.Tensor       # metal SPD row (-1 none)
    mix_b: torch.Tensor          # second row of a mixture (-1 plain)
    mix_wa: torch.Tensor
    mix_wb: torch.Tensor
    frac_tex: torch.Tensor       # textured mix fraction (-1 const)
    normal_tex: torch.Tensor     # normal map (-1 none)
    bump_scale: torch.Tensor
    glass_coeffs: torch.Tensor   # [G, 6] Sellmeier B1 C1 B2 C2 B3 C3
    metal_eta_spd: torch.Tensor  # [Mt, 95]
    metal_k_spd: torch.Tensor    # [Mt, 95]
    fres_ior: torch.Tensor       # [M] shade-time fresnel mix (0 = none)
    fres_a: torch.Tensor         # [M, 3]
    fres_b: torch.Tensor         # [M, 3]
    uv_xform: torch.Tensor       # [M, 6] shade-time uv TRS
    sheen_rough: torch.Tensor    # [M] sheen LTC roughness
    feats: tuple = ()
    ems_E: torch.Tensor = None       # GGX energy LUT (ggx_energy.npz)
    ems_Eavg: torch.Tensor = None
    sheen_ltc: torch.Tensor = None   # [32, 32, 3] (sheen_ltc.npz)
    # set by __post_init__: the packed gather rows and the static facts
    # the shading code branches on
    packed: PackedRows = field(default=None, repr=False)
    fr_modes: tuple = ()
    tex_slots: tuple = ()
    has_dispersive: bool = False
    has_metal_spd: bool = False
    _hero: PackedRows = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.packed = PackedRows(self, PACKED)
        self.fr_modes = tuple(int(m) for m in torch.unique(self.fr_mode).cpu())
        self.tex_slots = tuple(
            s for s, k in (("kd", "kd_tex"), ("spec", "spec_tex"),
                           ("rough", "rough_tex"), ("frac", "frac_tex"))
            if bool((getattr(self, k) >= 0).any()))
        self.has_dispersive = bool((self.dispersive_id >= 0).any())
        self.has_metal_spd = bool((self.metal_id >= 0).any())

    def hero_rows(self, spectrum):
        """The sigmoid coefficients of every row's colour slots
        (`HERO_SLOTS`), packed for one gather per lane; computed at the
        first call (a table serves one scene, whose spectrum's table is the
        same data in every model). `dataclasses.replace` leaves it unset,
        so a table with new parameter leaves computes it from them."""
        if self._hero is None:
            cols = {k: spectrum.row_coeffs(getattr(self, k)) for k in HERO_SLOTS}
            self._hero = PackedRows(cols, tuple((k, 3) for k in HERO_SLOTS))
        return self._hero


# colour slots a hero lane decodes (the non-metal eta3 / k3 included)
HERO_SLOTS = ("kd", "spec_tint", "sheen_tint", "eta3", "k3")


INT_COLUMNS = ("kd_tex", "spec_tex", "rough_tex", "rough_remap",
               "diffuse_kind", "fr_mode", "dispersive_id", "metal_id",
               "mix_b", "frac_tex", "normal_tex")
# the table's columns (every dataclass field but the static ones and the
# LUTs, which are present only when a material needs them)
COLUMNS = tuple(f.name for f in fields(MaterialTable)
                if f.name not in ("feats", "ems_E", "ems_Eavg", "sheen_ltc",
                                  "packed", "fr_modes", "tex_slots",
                                  "has_dispersive", "has_metal_spd",
                                  "_hero"))
OPTIONAL = ("ems_E", "ems_Eavg", "sheen_ltc")
# the per-row columns a shading lane reads, packed in this order
PACKED = (("kd", 3), ("kd_tex", 1), ("spec_tint", 3), ("spec_tex", 1),
          ("ax", 1), ("ay", 1), ("rough_tex", 1), ("rough_remap", 1),
          ("eta", 1), ("eta3", 3), ("k3", 3), ("sigma", 1),
          ("diffuse_kind", 1), ("diffuse_weight", 1), ("fr_mode", 1),
          ("spec_weight", 1), ("trans_weight", 1), ("cc_weight", 1),
          ("cc_alpha", 1), ("sheen_weight", 1), ("sheen_tint", 3),
          ("flatness", 1), ("metallic", 1), ("sheen_rough", 1),
          ("mix_b", 1), ("mix_wa", 1), ("mix_wb", 1), ("frac_tex", 1),
          ("dispersive_id", 1), ("metal_id", 1), ("uv_xform", 6),
          ("fres_ior", 1), ("fres_a", 3), ("fres_b", 3))


def _default_row():
    return dict(
        kd=[0.0, 0.0, 0.0], kd_tex=-1, sigma=0.0,
        diffuse_kind=bsdf.DIFF_LAMBERT, diffuse_weight=0.0,
        spec_tint=[1.0, 1.0, 1.0], spec_tex=-1,
        ax=1e-4, ay=1e-4, rough_tex=-1, rough_remap=1, anisotropic=0.0,
        fr_mode=frs.FR_DIELECTRIC, eta=1.5,
        eta3=[1.0, 1.0, 1.0], k3=[0.0, 0.0, 0.0],
        spec_weight=0.0, trans_weight=0.0,
        cc_weight=0.0, cc_alpha=0.01,
        sheen_weight=0.0, sheen_tint=[0.0, 0.0, 0.0], sheen_rough=0.5,
        flatness=0.0, metallic=0.0,
        dispersive_id=-1, metal_id=-1,
        mix_b=-1, mix_wa=1.0, mix_wb=0.0, frac_tex=-1,
        normal_tex=-1, bump_scale=1.0,
        fres_ior=0.0, fres_a=[0.0, 0.0, 0.0], fres_b=[1.0, 1.0, 1.0],
        uv_xform=[1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    )


class MaterialCompiler:
    """Accumulates material rows; dedups by name. Textured slots bake into
    `atlas_builder` (`shader_graph.py`)."""

    def __init__(self, atlas_builder, scene_dir="."):
        self.rows = []
        self.by_name = {}
        self.atlas = atlas_builder
        self.scene_dir = scene_dir
        # material id -> its interior-medium request (subsurface materials;
        # the scene attaches it as the shape's inside medium)
        self.sss = {}
        # shade-time nodes the slots of the row being compiled staged
        self._pending_fresnel = None
        self._pending_uvmap = None

    # ---- slot helpers ----

    def _slot_rgb(self, pset, key, default):
        """A colour slot -> (rgb [3], tex id). Calculation node trees fold
        or bake (`shader_graph.py`); a fresnel-driven mix or a uv
        vector_mapping is staged on the row being compiled for shade time.
        A fresnel mix's static colour is the mean of its two ends."""
        if key not in pset:
            return list(default), -1
        raw = pset.raw(key)
        dyn = sg.detect_fresnel_mix(raw, self.scene_dir)
        if dyn is not None:
            ior, A, B = dyn
            self._pending_fresnel = (ior, A, B)
            return [0.5 * (a + b) for a, b in zip(A, B)], -1
        uvm = sg.detect_uv_mapping(raw)
        if uvm is not None:
            self._pending_uvmap, raw = uvm
        return sg.resolve_rgb(raw, self.atlas, self.scene_dir, default)

    def _slot_scalar(self, pset, key, default):
        if key not in pset:
            return float(default), -1
        return sg.resolve_scalar(pset.raw(key), self.atlas, self.scene_dir,
                                 default)

    def _slot_rough2(self, pset, key, default):
        """Roughness may be scalar, [rx, ry] or an image (linear, remapped
        at shade time); an unreadable image takes the default."""
        kind, payload, _ = parse_slot(pset.raw(key, default))
        if kind == "const":
            if len(payload) >= 2:
                return float(payload[0]), float(payload[1]), -1
            return float(payload[0]), float(payload[0]), -1
        if kind == "image":
            try:
                tex = self.atlas.add_image(
                    os.path.join(self.scene_dir, payload.get("fn")), "linear")
            except NotImplementedError:
                raise
            except Exception as e:
                warnings.warn(f"roughness image unusable ({e}); using default")
                return float(default), float(default), -1
            return float(default), float(default), tex
        return float(default), float(default), -1

    # ---- compile entry ----

    def _row_with_dynamic(self, desc):
        """_compile_row, then the shade-time nodes its slots staged: the
        fresnel mix's IOR (at least 1.0001) and ends, the uv transform."""
        saved = (self._pending_fresnel, self._pending_uvmap)
        self._pending_fresnel = self._pending_uvmap = None
        row = self._compile_row(desc)
        if self._pending_fresnel is not None:
            ior, A, B = self._pending_fresnel
            row.update(fres_ior=float(max(ior, 1.0001)), fres_a=list(A),
                       fres_b=list(B))
        if self._pending_uvmap is not None:
            row["uv_xform"] = list(self._pending_uvmap)
        self._pending_fresnel, self._pending_uvmap = saved
        return row

    def compile(self, desc):
        """Compile one material desc; returns the material id."""
        name = desc.get("name")
        if name and name in self.by_name:
            return self.by_name[name]
        row = self._row_with_dynamic(desc)
        mid = len(self.rows)
        sss = row.pop("_sss", None)
        if sss is not None:
            self.sss[mid] = sss
        self.rows.append(row)
        if name:
            self.by_name[name] = mid
        return mid

    def _append_child(self, desc):
        """A sub-material of a mixture, in its own anonymous row."""
        row = self._row_with_dynamic(desc)
        row.pop("_sss", None)
        self.rows.append(row)
        return len(self.rows) - 1

    def get(self, name):
        return self.by_name.get(name, -1)

    def _alpha_from(self, pset, lo=0.0001):
        rx, ry, rtex = self._slot_rough2(pset, "roughness", 0.5)
        aniso = self._slot_scalar(pset, "anisotropic", 0.0)[0]
        aniso = float(np.clip(aniso, -0.9, 0.9))
        remap = pset.as_bool("remapping_roughness", True)
        rx = float(np.clip(rx, lo, 1.0))
        ry = float(np.clip(ry, lo, 1.0))
        if remap:
            ax_s, ay_s = roughness_to_alpha(rx), roughness_to_alpha(ry)
        else:
            ax_s, ay_s = rx, ry
        if abs(aniso) > 1e-4 and rx == ry:
            ax_s, ay_s = calculate_alpha(np.float32(ax_s), np.float32(aniso))
            ax_s, ay_s = float(ax_s), float(ay_s)
        return max(ax_s, 1e-6), max(ay_s, 1e-6), rtex, (1 if remap else 0), aniso

    def _compile_row(self, desc):
        mtype = desc.get("type", "diffuse")
        p = ParameterSet(desc.get("param", {}))
        row = _default_row()
        fn = getattr(self, f"_mat_{mtype}", None)
        if fn is None:
            # unknown material -> grey diffuse
            row.update(diffuse_weight=1.0, kd=[0.5, 0.5, 0.5])
            return row
        fn(row, p)
        # the bump slot: a tangent-space normal map, applied at shade time
        # (`integrator/pt.py` compute_interaction)
        if p.raw("bump", None) is not None:
            _, btex = self._slot_rgb(p, "bump", [0.5, 0.5, 1.0])
            row.update(normal_tex=btex,
                       bump_scale=p.as_float("bump_scale", 1.0))
        return row

    # ---- per-type compilers ----

    def _mat_diffuse(self, row, p):
        kd, tex = self._slot_rgb(p, "color", [0.5, 0.5, 0.5])
        row.update(kd=kd, kd_tex=tex, diffuse_weight=1.0,
                   sigma=self._slot_scalar(p, "sigma", 0.0)[0])

    def _mat_mirror(self, row, p):
        tint, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        row.update(spec_tint=tint, spec_tex=tex, ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso,
                   fr_mode=frs.FR_CONSTANT, spec_weight=1.0)

    def _mat_metal(self, row, p):
        name = p.as_str("material_name", "Ag")
        eta, k = spd.metal_ior_rgb(name)
        if name not in spd.METAL_NAMES:
            name = "Ag"
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        row.update(fr_mode=frs.FR_CONDUCTOR, eta3=list(map(float, eta)),
                   k3=list(map(float, k)), ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso, spec_weight=1.0,
                   metal_id=spd.METAL_NAMES.index(name))

    def _mat_metallic(self, row, p):
        color, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        edge, _ = self._slot_rgb(p, "edge_tint", [1.0, 1.0, 1.0])
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.01)
        f0 = np.asarray(color, np.float32)
        b = frs.f82_b_from_edge_tint(f0, np.asarray(edge, np.float32))
        row.update(fr_mode=frs.FR_F82, eta3=list(map(float, f0)),
                   k3=list(map(float, np.asarray(b))), spec_tex=tex,
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0)

    def _mat_glass(self, row, p):
        """A named glass is a scalar IOR at the R peak in the sRGB mode."""
        tint, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        name = p.as_str("material_name", "")
        if name:
            eta = spd.glass_ior_scalar(name)
            disp = spd.GLASS_NAMES.index(name if name in spd.GLASS_NAMES
                                         else "BK7")
        else:
            eta = self._slot_scalar(p, "ior", 1.5)[0]
            disp = -1
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.01)
        row.update(spec_tint=tint, spec_tex=tex, fr_mode=frs.FR_DIELECTRIC,
                   eta=float(eta), ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso,
                   spec_weight=1.0, trans_weight=1.0, dispersive_id=disp)

    def _mat_substrate(self, row, p):
        kd, kdtex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        rs, _ = self._slot_rgb(p, "spec", [0.05, 0.05, 0.05])
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        if remap:  # substrate double-remaps alpha
            ax, ay = ax * ax, ay * ay
        ax, ay = float(np.clip(ax, 1e-4, 1.0)), float(np.clip(ay, 1e-4, 1.0))
        row.update(kd=kd, kd_tex=kdtex, diffuse_kind=bsdf.DIFF_FRESNEL_BLEND,
                   diffuse_weight=1.0, eta3=rs, fr_mode=frs.FR_SCHLICK,
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0, eta=1.5)

    def _mat_plastic(self, row, p):
        kd, kdtex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        rs, _ = self._slot_rgb(p, "spec", [0.05, 0.05, 0.05])
        ior = self._slot_scalar(p, "ior", 1.3)[0]
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        if remap:  # plastic double-remaps alpha too
            ax, ay = ax * ax, ay * ay
        ax, ay = float(np.clip(ax, 1e-4, 1.0)), float(np.clip(ay, 1e-4, 1.0))
        f0 = float(frs.schlick_F0_from_ior(np.float32(ior)))
        row.update(kd=kd, kd_tex=kdtex, diffuse_weight=1.0,
                   fr_mode=frs.FR_SCHLICK,
                   eta3=[f0 * rs[0], f0 * rs[1], f0 * rs[2]],
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0, eta=float(ior))

    def _mat_principled_bsdf(self, row, p):
        """Disney-style uber material."""
        kd, kdtex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        ior = self._slot_scalar(p, "ior", 1.5)[0]
        metallic = self._slot_scalar(p, "metallic", 0.0)[0]
        spec_trans = self._slot_scalar(p, "spec_trans", 0.0)[0]
        sheen = self._slot_scalar(p, "sheen",
                                  p.as_float("sheen_weight", 0.0))[0]
        sheen_tint = self._slot_scalar(p, "sheen_tint", 0.0)[0]
        sheen_rough = self._slot_scalar(p, "sheen_roughness", 0.5)[0]
        cc = self._slot_scalar(p, "clearcoat", 0.0)[0]
        cc_alpha = self._slot_scalar(p, "clearcoat_alpha", 0.1)[0]
        flatness = self._slot_scalar(p, "flatness", 0.0)[0]
        spec_tint_amt = self._slot_scalar(p, "spec_tint", 0.0)[0]
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.001)

        lum = 0.212671 * kd[0] + 0.715160 * kd[1] + 0.072169 * kd[2]
        ctint = [c / lum if lum > 0 else 1.0 for c in kd]
        f0d = float(frs.schlick_F0_from_ior(np.float32(ior)))
        f0 = [f0d * ((1 - spec_tint_amt) + spec_tint_amt * c) for c in ctint]
        f0 = [(1 - metallic) * f + metallic * c for f, c in zip(f0, kd)]
        stint = [(1 - sheen_tint) + sheen_tint * c for c in ctint]

        diff_w = (1.0 - metallic) * (1.0 - spec_trans)
        row.update(kd=kd, kd_tex=kdtex, diffuse_kind=bsdf.DIFF_DISNEY,
                   diffuse_weight=diff_w,
                   fr_mode=frs.FR_SCHLICK, eta3=f0, eta=float(ior),
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0,
                   trans_weight=(1.0 - metallic) * spec_trans,
                   spec_tint=kd if spec_trans > 0 else [1.0, 1.0, 1.0],
                   cc_weight=cc, cc_alpha=max(float(cc_alpha), 1e-3),
                   sheen_weight=sheen * (1.0 - metallic),
                   sheen_tint=stint, sheen_rough=float(np.clip(
                       sheen_rough, 1.0 / 32, 1.0)),
                   flatness=flatness, metallic=metallic)

    def _mat_subsurface(self, row, p):
        """A rough dielectric interface; its sigma_a / sigma_s (times
        `sigma_scale`), g or `medium_name` become the shape's interior
        medium, which the scene attaches."""
        tint, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        ior = self._slot_scalar(p, "ior", 1.5)[0]
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.01)
        row.update(spec_tint=tint, spec_tex=tex, fr_mode=frs.FR_DIELECTRIC,
                   eta=float(ior), ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso,
                   spec_weight=1.0, trans_weight=1.0)
        sigma_a = p.as_float3("sigma_a", (0.0011, 0.0024, 0.014))
        sigma_s = p.as_float3("sigma_s", (2.55, 3.21, 3.77))
        scale = p.as_float("sigma_scale", 1.0)
        row["_sss"] = dict(sigma_a=[c * scale for c in sigma_a],
                           sigma_s=[c * scale for c in sigma_s],
                           g=p.as_float("g", 0.0),
                           medium_name=p.as_str("medium_name", ""))

    def _mat_emission(self, row, p):
        row.update(diffuse_weight=0.0)

    def _mat_black_body(self, row, p):
        row.update(diffuse_weight=0.0)

    def _mix_parent(self, row, id0, id1, wa, wb, frac_tex=-1):
        """`row` as a LobeSet mixture: mat0's full parameters, mix_b at
        mat1's row, weights (wa, wb). One nesting level: a deeper nest
        collapses to its first side, with the JAX package's warning."""
        r0, r1 = self.rows[id0], self.rows[id1]
        if r0["mix_b"] >= 0 or r1["mix_b"] >= 0:
            warnings.warn("nested material mixtures flatten to one level")
        row.update(r0)
        row.update(mix_b=id1, mix_wa=float(wa), mix_wb=float(wb),
                   frac_tex=frac_tex)

    def _mat_mix(self, row, p):
        fkey = "frac" if "frac" in p else "scale"
        frac, ftex = self._slot_scalar(p, fkey, 0.5)
        id0 = self._append_child(p.raw("mat0", {}))
        id1 = self._append_child(p.raw("mat1", {}))
        # mat0 weighted by frac
        self._mix_parent(row, id0, id1, frac, 1.0 - frac, ftex)

    def _mat_add(self, row, p):
        id0 = self._append_child(p.raw("mat0", {}))
        id1 = self._append_child(p.raw("mat1", {}))
        self._mix_parent(row, id0, id1, 1.0, 1.0)

    def _mat_multi_layered(self, row, p):
        # bottom + top as an additive lobe set, as the JAX package does
        id0 = self._append_child(p.raw("mat0", p.raw("bottom", {})))
        id1 = self._append_child(p.raw("mat1", p.raw("top", {})))
        self._mix_parent(row, id0, id1, 1.0, 1.0)

    def build(self, device):
        rows = self.rows or [_default_row()]

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        arrs = {k: t([r[k] for r in rows],
                     torch.int32 if k in INT_COLUMNS else torch.float32)
                for k in _default_row()}
        arrs["glass_coeffs"] = t([spd._SELLMEIER[n] for n in spd.GLASS_NAMES])
        ek = [spd.metal_complex_ior(n) for n in spd.METAL_NAMES]
        arrs["metal_eta_spd"] = t(np.stack([e for e, _ in ek]))
        arrs["metal_k_spd"] = t(np.stack([k for _, k in ek]))
        feats = []
        if any(r["diffuse_weight"] > 0 for r in rows):
            feats.append("diff")
        if any(r["spec_weight"] > 0 for r in rows):
            feats.append("spec")
        if any(r["trans_weight"] > 0 for r in rows):
            feats.append("trans")
        if any(r["cc_weight"] > 0 for r in rows):
            feats.append("cc")
        if any(r["sheen_weight"] > 0 for r in rows):
            feats.append("sheen")
            ltc_path = os.path.join(DATA_DIR, "sheen_ltc.npz")
            if os.path.exists(ltc_path):
                arrs["sheen_ltc"] = t(np.load(ltc_path)["table"])
        if any(r["sigma"] > 0 for r in rows):
            feats.append("oren")
        if any(r["diffuse_kind"] == bsdf.DIFF_FRESNEL_BLEND for r in rows):
            feats.append("blend")
        if any(r["diffuse_kind"] == bsdf.DIFF_DISNEY for r in rows):
            feats.append("disney")
        if any(r["mix_b"] >= 0 for r in rows):
            feats.append("mix2")
        if any(r["normal_tex"] >= 0 for r in rows):
            feats.append("nmap")     # shade-time normal mapping
        if any(r["fres_ior"] > 0 for r in rows):
            feats.append("fresmix")  # shade-time fresnel-driven colour
        if any(r["uv_xform"] != [1.0, 0.0, 0.0, 0.0, 1.0, 0.0] for r in rows):
            feats.append("uvmap")    # shade-time vector_mapping uv TRS
        # rough conductors and mirrors: the multiple-scattering lobe
        lut_path = os.path.join(DATA_DIR, "ggx_energy.npz")
        metalish = {frs.FR_CONSTANT, frs.FR_CONDUCTOR, frs.FR_F82}
        if os.path.exists(lut_path) and any(
                r["spec_weight"] > 0 and r["fr_mode"] in metalish
                and max(r["ax"], r["ay"]) > 0.02 for r in rows):
            feats.append("ems")
            lut = np.load(lut_path)
            arrs["ems_E"] = t(lut["E"])
            arrs["ems_Eavg"] = t(lut["E_avg"])
        return MaterialTable(feats=tuple(feats), **arrs)


def _sellmeier_eta(coeffs, lam_nm):
    """coeffs [..., 6] (B1 C1 B2 C2 B3 C3), lam [..., S] (nm) -> eta
    [..., S]."""
    l2 = (lam_nm / 1000.0) ** 2
    b1, c1 = coeffs[..., 0:1], coeffs[..., 1:2]
    b2, c2 = coeffs[..., 2:3], coeffs[..., 3:4]
    b3, c3 = coeffs[..., 4:5], coeffs[..., 5:6]
    f = b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2) + b3 * l2 / (l2 - c3)
    return torch.sqrt(torch.clamp_min(f + 1.0, 1.0))


def gather_params(table, atlas, mat_id, uv, spectrum=None, swl=None,
                  cos_wo=None):
    """Per-lane LobeParams from the table, the textured slots resolved
    against the atlas at the row's transformed uv. mat_id [...] int
    (clamped; invalid lanes get row 0 with zero weights). `cos_wo` is
    |n.wo| per lane for a fresnel-driven colour (without it the row's
    static colour stands). A mixture row brings its second row as
    `params.mix_b`. With a hero `spectrum`, colours decode to spectra at
    swl.lam, a named metal's eta / k come from its SPD rows and a
    dispersive glass's eta from its Sellmeier curve per wavelength. Returns
    (LobeParams, dispersive mask [...], a dispersive row on a valid lane;
    nothing is dispersive in the sRGB mode, which issues no operation of
    the hero branch)."""
    valid = mat_id >= 0
    M = table.kd.shape[0]
    mid = torch.clamp(mat_id.long(), 0, M - 1)
    wvalid = valid.to(torch.float32)
    slots = table.tex_slots if atlas.has_textures else ()
    hero = spectrum is not None and spectrum.hero
    hrows = table.hero_rows(spectrum) if hero else None

    def one(mid):
        g = table.packed.fetch(mid)
        h = hrows.fetch(mid) if hero else None

        def colour(key, col, textured):
            """A colour slot as its row holds it (rgb) or decoded."""
            if not hero:
                return col
            if textured:
                return spectrum.decode_albedo(col, swl)
            return spectrum.eval_coeffs(h(key), swl)

        # the row's vector_mapping: uv' = [a b; c d] uv + (tx, ty)
        uv_l = uv
        if "uvmap" in table.feats:
            x = g("uv_xform")
            uv_l = torch.stack(
                [x[..., 0] * uv[..., 0] + x[..., 1] * uv[..., 1] + x[..., 2],
                 x[..., 3] * uv[..., 0] + x[..., 4] * uv[..., 1] + x[..., 5]],
                -1)
        kd = g("kd")
        if "kd" in slots:
            kd_tex = g("kd_tex").to(torch.int32)
            kd = torch.where((kd_tex >= 0)[..., None],
                             atlas.sample(kd_tex, uv_l), kd)
        fres = "fresmix" in table.feats and cos_wo is not None
        if fres:
            # a fresnel-driven colour: A..B by the dielectric Fresnel term
            fi = g("fres_ior")
            F = frs.fresnel_dielectric(torch.abs(cos_wo),
                                       torch.clamp_min(fi, 1.0001))
            fa = g("fres_a")
            kd = torch.where((fi > 0.0)[..., None],
                             fa + F[..., None] * (g("fres_b") - fa), kd)
        kd = colour("kd", kd, "kd" in slots or fres)
        spec_tint = g("spec_tint")
        if "spec" in slots:
            spec_tex = g("spec_tex").to(torch.int32)
            spec_tint = torch.where((spec_tex >= 0)[..., None],
                                    atlas.sample(spec_tex, uv_l), spec_tint)
        spec_tint = colour("spec_tint", spec_tint, "spec" in slots)
        ax, ay = g("ax"), g("ay")
        if "rough" in slots:
            rough_tex = g("rough_tex").to(torch.int32)
            r = atlas.sample(rough_tex, uv_l)[..., 0]
            r_alpha = torch.where(g("rough_remap") > 0, r * r, r)
            ax = torch.where(rough_tex >= 0, torch.clamp_min(r_alpha, 1e-6), ax)
            ay = torch.where(rough_tex >= 0, torch.clamp_min(r_alpha, 1e-6), ay)
        # dielectric eta: one IOR, or Sellmeier per wavelength where a
        # dispersive glass meets the hero spectrum
        eta = g("eta")[..., None]
        dispersive = None
        eta3, k3 = g("eta3"), g("k3")
        if hero:
            S = swl.lam.shape[-1]
            if table.has_dispersive:
                disp_id = g("dispersive_id").long()
                gc = table.glass_coeffs[
                    torch.clamp(disp_id, 0, table.glass_coeffs.shape[0] - 1)]
                dispersive = disp_id >= 0
                eta = torch.where(dispersive[..., None],
                                  _sellmeier_eta(gc, swl.lam), eta)
            else:
                eta = eta.expand(eta.shape[:-1] + (S,))
            # conductor eta / k: the metal's SPD rows at swl, else decoded
            eta3 = colour("eta3", eta3, False)
            k3 = colour("k3", k3, False)
            if table.has_metal_spd:
                metal_id = g("metal_id").long()
                mrow = torch.clamp(metal_id, 0, table.metal_eta_spd.shape[0] - 1)
                is_metal = (metal_id >= 0)[..., None]
                eta3 = torch.where(is_metal, spd.spd_eval_rows(
                    table.metal_eta_spd, mrow, swl.lam), eta3)
                k3 = torch.where(is_metal, spd.spd_eval_rows(
                    table.metal_k_spd, mrow, swl.lam), k3)
        params = bsdf.LobeParams(
            kd=kd, sigma=g("sigma"),
            diffuse_kind=g("diffuse_kind").to(torch.int32),
            diffuse_weight=g("diffuse_weight") * wvalid,
            spec_tint=spec_tint, ax=ax, ay=ay,
            fr_mode=g("fr_mode").to(torch.int32), eta=eta,
            eta3=eta3, k3=k3,
            spec_weight=g("spec_weight") * wvalid,
            trans_weight=g("trans_weight") * wvalid,
            cc_weight=g("cc_weight") * wvalid, cc_alpha=g("cc_alpha"),
            sheen_weight=g("sheen_weight") * wvalid,
            sheen_tint=colour("sheen_tint", g("sheen_tint"), False),
            flatness=g("flatness"), metallic=g("metallic"),
            feats=table.feats, fr_modes=table.fr_modes,
            ems_E=table.ems_E, ems_Eavg=table.ems_Eavg,
            sheen_ltc=table.sheen_ltc, sheen_alpha=g("sheen_rough"))
        return params, g, dispersive

    params, g, dispersive = one(mid)
    if "mix2" in table.feats:
        midb_raw = g("mix_b")
        has_b = midb_raw >= 0
        params_b, _, disp_b = one(torch.clamp(midb_raw.long(), 0, M - 1))
        wa, wb = g("mix_wa"), g("mix_wb")
        if "frac" in slots:
            ftex = g("frac_tex").to(torch.int32)
            frac_t = atlas.sample(ftex, uv)[..., 0]
            wa = torch.where(ftex >= 0, frac_t, wa)
            wb = torch.where(ftex >= 0, 1.0 - frac_t, wb)
        params = replace(params, mix_b=params_b,
                         mix_wa=torch.where(has_b, wa, 1.0),
                         mix_wb=torch.where(has_b, wb, 0.0))
        if dispersive is not None:
            dispersive = dispersive | (disp_b & has_b)
    if dispersive is None:
        return params, torch.zeros_like(valid)
    return params, dispersive & valid
