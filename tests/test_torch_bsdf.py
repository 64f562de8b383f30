"""Parity of the port's uber-BSDF (`vision_tpu_torch/shading/bsdf.py`) with
the JAX package on the same seeded inputs: every lobe and diffuse variant,
the five-way lobe weights, `evaluate` / `albedo` / `sample` for each
material type (mixtures included), and the port's counterparts of
tests/test_bsdf.py (white furnace, sample-vs-eval pdf) and
tests/test_mixtures.py."""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_materials import (NAMES, build_tables, gather_both, uniform,
                                   unit)
from tests.torch_parity import mostly_close, np_, tt
from vision_tpu.shading import bsdf as jb
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.core.math import normalize, vec3
from vision_tpu_torch.shading import bsdf as tb
from vision_tpu_torch.shading import fresnel as tfr

torch.set_num_threads(2)

# the tolerances of tests/test_torch_shading.py: float32 shading math in
# another op order on the two backends; atol scaled to the value range for
# D-like values and pdfs, which reach 1e3-1e7 near a smooth lobe's peak
RTOL = 1e-4
ATOL = 1e-6
N = 4096


def close(b, a, rtol=RTOL, atol=ATOL, scaled=False):
    a = np.asarray(a)
    if scaled:
        atol = atol * max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(np_(b), a, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def tables():
    return build_tables()


def _lanes(tables, seed, names=None):
    """Params of N lanes over the rows of `names` (every row by default,
    and some invalid lanes)."""
    jt, pt_, ids = tables
    g = np.random.default_rng(seed)
    rows = [ids[n] for n in (names or NAMES)]
    mid = g.choice(rows + ([-1] if names is None else []), N).astype(np.int32)
    return gather_both(jt, pt_, mid, uniform(N, 2, seed + 1))


def _with(p, **kw):
    """A copy of LobeParams `p` (either package's) with fields changed."""
    return p.replace(**kw) if hasattr(p, "replace") else replace(p, **kw)


def _single(p):
    """A mixture's first row as a plain row (the per-lobe functions take
    one row)."""
    return _with(p, mix_b=None, mix_wa=None, mix_wb=None)


LOBES = {
    "diffuse": lambda m, p, wo, wi, u: m._eval_diffuse(p, wo, wi),
    "pdf_diffuse": lambda m, p, wo, wi, u: m._pdf_diffuse(p, wo, wi),
    "spec_reflect": lambda m, p, wo, wi, u: m._eval_spec_reflect(p, wo, wi),
    "spec_transmit": lambda m, p, wo, wi, u: m._eval_spec_transmit(p, wo, -wi),
    "clearcoat": lambda m, p, wo, wi, u: m._eval_clearcoat(p, wo, wi),
    "sheen_ltc": lambda m, p, wo, wi, u: m._eval_sheen(p, wo, wi),
    "sheen_burley": lambda m, p, wo, wi, u: m._eval_sheen(
        _with(p, sheen_ltc=None), wo, wi),
    "sample_sheen_ltc": lambda m, p, wo, wi, u: m._sample_sheen_ltc(p, wo, u),
    "sheen_ltc_coeffs": lambda m, p, wo, wi, u: m._sheen_ltc_coeffs(p, wo),
    "ems": lambda m, p, wo, wi, u: m._eval_ems(p, wo, wi),
    "lut_E": lambda m, p, wo, wi, u: m._lut_E(p, p.ax, wo[..., 2]),
    "lobe_weights": lambda m, p, wo, wi, u: m._lobe_weights(p, wo),
    "fresnel": lambda m, p, wo, wi, u: m._eval_fresnel(p, wo[..., 2]),
    "dielectric_F0": lambda m, p, wo, wi, u: m._dielectric_F0(p, wo),
    "hemi_eta": lambda m, p, wo, wi, u: m._hemi_eta(p, wo),
}


@pytest.mark.parametrize("lobe", sorted(LOBES))
def test_lobe(tables, lobe):
    """Each lobe on lanes over every material row, wo on both sides."""
    pa, pb = _lanes(tables, 10)
    pa, pb = _single(pa), _single(pb)
    wo, wi, u = unit(N, 11), unit(N, 12), uniform(N, 2, 13)
    wi = np.where((wo[:, 2] * wi[:, 2] < 0)[:, None], -wi, wi)  # same side
    a = LOBES[lobe](jb, pa, jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(u))
    b = LOBES[lobe](tb, pb, tt(wo), tt(wi), tt(u))
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        close(y, x, scaled=True)
    assert any(np.abs(np.asarray(x)).max() > 0 for x in a)


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_and_albedo(tables, name):
    """evaluate / albedo on lanes of one material type."""
    pa, pb = _lanes(tables, 20, [name])
    wo, wi = unit(N, 21), unit(N, 22)
    ea = jb.evaluate(pa, jnp.asarray(wo), jnp.asarray(wi))
    eb = tb.evaluate(pb, tt(wo), tt(wi))
    close(eb.f, ea.f, scaled=True)
    close(eb.pdf, ea.pdf, scaled=True)
    close(tb.albedo(pb, tt(wo)), jb.albedo(pa, jnp.asarray(wo)))


# A sampled GGX direction goes through a square root near 0
# (`sample_wh_ggx`'s pz) and, at a glossy lobe's peak, through D at a half
# vector whose float32 rounding moves D by up to several percent (by orders
# of magnitude at alpha 1e-6): f and pdf there are ill-conditioned, while
# the throughput f |cos| / pdf the integrator uses is not. So on sampled
# directions the test holds the throughput to rtol 1e-4 and wi to atol
# 1e-5, each on at least 99% of the lanes, the rest within 1e-2 / 1e-3
# (measured: at most 0.05% of lanes, 3.3e-4 and 8.7e-5); test_evaluate
# holds f and pdf themselves on directions away from the peaks.

@pytest.mark.parametrize("name", NAMES)
def test_sample(tables, name):
    """Same RNG state in -> same state, validity, lobe, direction,
    throughput and eta scale out."""
    pa, pb = _lanes(tables, 30, [name])
    wo = unit(N, 31)
    st = np.random.default_rng(32).integers(0, 2 ** 32, N, dtype=np.uint64)
    sa, ba = jb.sample(pa, jnp.asarray(wo), jnp.asarray(st.astype(np.uint32)))
    sb, bb = tb.sample(pb, tt(wo), tt(st.astype(np.int64)))
    assert np.array_equal(np.asarray(sa).astype(np.int64), np_(sb))
    assert np.array_equal(np.asarray(ba.valid), np_(bb.valid))
    mostly_close(bb.wi, ba.wi, 0.0, 1e-5, 1e-3)
    close(bb.eta_scale, ba.eta_scale)

    def thr(b):
        f, pdf, wi = np_(b.ev.f), np_(b.ev.pdf), np_(b.wi)
        return np.where(np_(b.valid)[..., None], f * np.abs(wi[..., 2:3])
                        / np.maximum(pdf, 1e-30)[..., None], 0.0)
    mostly_close(thr(bb), thr(ba), RTOL, ATOL, 1e-2)
    assert np.asarray(ba.valid).any() or name in ("emission", "black_body")


def test_diffuse_only_table_takes_the_short_path(tables):
    """A Lambert-only table: the five-lobe code never runs, and the short
    path gives the JAX package's values."""
    pa, pb = _lanes(tables, 40, ["lambert"])
    pa, pb = (_with(_single(p), feats=("diff",)) for p in (pa, pb))
    assert tb._diffuse_only(pb)
    wo, wi = unit(N, 41), unit(N, 42)
    close(tb.evaluate(pb, tt(wo), tt(wi)).f,
          jb.evaluate(pa, jnp.asarray(wo), jnp.asarray(wi)).f)


# ---- the port's counterparts of tests/test_bsdf.py and test_mixtures.py

def make_params(n, **kw):
    """tests/test_bsdf.py make_params, as port LobeParams."""
    d = dict(kd=torch.zeros((n, 3)), sigma=torch.zeros(n),
             diffuse_kind=torch.zeros(n, dtype=torch.int32),
             diffuse_weight=torch.zeros(n), spec_tint=torch.ones((n, 3)),
             ax=torch.full((n,), 0.01), ay=torch.full((n,), 0.01),
             fr_mode=torch.zeros(n, dtype=torch.int32),
             eta=torch.full((n, 1), 1.5), eta3=torch.ones((n, 3)),
             k3=torch.zeros((n, 3)), spec_weight=torch.zeros(n),
             trans_weight=torch.zeros(n), cc_weight=torch.zeros(n),
             cc_alpha=torch.full((n,), 0.01), sheen_weight=torch.zeros(n),
             sheen_tint=torch.zeros((n, 3)), flatness=torch.zeros(n),
             metallic=torch.zeros(n))
    for k, v in kw.items():
        d[k] = torch.full(d[k].shape, v, dtype=d[k].dtype) \
            if np.isscalar(v) else v
    return tb.LobeParams(**d, feats=("diff", "spec", "trans", "cc", "sheen",
                                     "oren", "blend", "disney"))


def furnace(params_fn, n=200_000, wo_z=0.7, seed=3):
    """Mean of f |cos| / pdf over BSDF samples (tests/test_bsdf.py)."""
    p = params_fn(n)
    wo = normalize(vec3(torch.tensor(np.sqrt(1 - wo_z ** 2)),
                        torch.tensor(0.0), torch.tensor(wo_z))).float()
    wo = wo.expand(n, 3)
    st = trng.seed(torch.arange(n), seed)
    st, bs = tb.sample(p, wo, st)
    thr = (bs.ev.f * torch.abs(bs.wi[..., 2:3])
           / torch.clamp_min(bs.ev.pdf, 1e-12)[..., None])
    return float(torch.where(bs.valid[..., None], thr, 0.0)[..., 0].mean())


def _mix(pa, pb, wa, wb):
    n = pa.kd.shape[0]
    return replace(pa, mix_b=pb, mix_wa=torch.full((n,), wa),
                   mix_wb=torch.full((n,), wb), feats=pa.feats + ("mix2",))


FURNACE = {
    # name: (params, lower, upper), the bounds of tests/test_bsdf.py and
    # tests/test_mixtures.py
    "lambert": (lambda n: make_params(n, diffuse_weight=1.0,
                                      kd=torch.ones((n, 3))), 0.99, 1.01),
    "lambert_half": (lambda n: make_params(n, diffuse_weight=1.0,
                                           kd=torch.full((n, 3), 0.5)),
                     0.49, 0.51),
    "oren_nayar": (lambda n: make_params(n, diffuse_weight=1.0,
                                         kd=torch.ones((n, 3)), sigma=0.5),
                   0.8, 1.0),
    "mirror_smooth": (lambda n: make_params(n, spec_weight=1.0, fr_mode=3,
                                            ax=1e-4, ay=1e-4), 0.97, 1.0001),
    "conductor_rough": (lambda n: make_params(n, spec_weight=1.0, fr_mode=3,
                                              ax=0.5, ay=0.5), 0.5, 1.0),
    "glass_eta_one": (lambda n: make_params(
        n, spec_weight=1.0, trans_weight=1.0, fr_mode=0,
        eta=torch.full((n, 1), 1.0001), ax=0.02, ay=0.02), 0.97, 1.03),
    "mix_identical": (lambda n: _mix(
        make_params(n, diffuse_weight=1.0, kd=torch.full((n, 3), 0.6)),
        make_params(n, diffuse_weight=1.0, kd=torch.full((n, 3), 0.6)),
        0.3, 0.7), 0.59, 0.61),
    "mix_weights": (lambda n: _mix(
        make_params(n, diffuse_weight=1.0, kd=torch.ones((n, 3))),
        make_params(n, diffuse_weight=1.0, kd=torch.zeros((n, 3))),
        0.25, 0.75), 0.23, 0.27),
    "add_halves": (lambda n: _mix(
        make_params(n, diffuse_weight=1.0, kd=torch.full((n, 3), 0.5)),
        make_params(n, diffuse_weight=1.0, kd=torch.full((n, 3), 0.5)),
        1.0, 1.0), 0.99, 1.01),
}


@pytest.mark.parametrize("name", sorted(FURNACE))
def test_furnace(name):
    make, lo, hi = FURNACE[name]
    e = furnace(make)
    assert lo < e < hi, e


def test_glass_single_interface_radiance_budget():
    """Entering glass integrates to F + (1 - F) / eta^2 (radiance mode)."""
    e = furnace(lambda n: make_params(n, spec_weight=1.0, trans_weight=1.0,
                                      fr_mode=0, ax=0.01, ay=0.01))
    F0 = float(tfr.fresnel_dielectric(torch.tensor(0.7), torch.tensor(1.5)))
    expected = F0 + (1.0 - F0) / 1.5 ** 2
    assert abs(e - expected) < 0.03, (e, expected)


@pytest.mark.parametrize("cfg", [
    dict(diffuse_weight=1.0),
    dict(spec_weight=1.0, fr_mode=3, ax=0.1, ay=0.1),
    dict(diffuse_weight=1.0, spec_weight=1.0, fr_mode=2, ax=0.05, ay=0.05),
])
def test_sample_pdf_matches_eval_pdf(cfg):
    n = 4096
    p = make_params(n, kd=torch.ones((n, 3)), **cfg)
    wo = normalize(torch.tensor([[0.3, -0.2, 0.93]])).expand(n, 3)
    st = trng.seed(torch.arange(n), 11)
    _, bs = tb.sample(p, wo, st)
    ev = tb.evaluate(p, wo, bs.wi)
    m = bs.valid
    np.testing.assert_allclose(np_(ev.pdf[m]), np_(bs.ev.pdf[m]), rtol=1e-4)
    np.testing.assert_allclose(np_(ev.f[m]), np_(bs.ev.f[m]), rtol=1e-4)


def test_mix_glass_diffuse_not_param_lerp():
    """Half glass + half diffuse keeps a real transmission component and a
    real Lambert component (tests/test_mixtures.py)."""
    n = 100_000
    pa = make_params(n, spec_weight=1.0, trans_weight=1.0, fr_mode=0,
                     ax=0.01, ay=0.01)
    pb = make_params(n, diffuse_weight=1.0, kd=torch.ones((n, 3)))
    p = _mix(pa, pb, 0.5, 0.5)
    wo = normalize(torch.tensor([[0.4, 0.0, 0.9]])).expand(n, 3)
    _, bs = tb.sample(p, wo, trng.seed(torch.arange(n), 7))
    below = (bs.valid & (bs.wi[..., 2] < 0.0)).float().mean()
    assert 0.2 < float(below) < 0.5
    assert float((bs.valid & (bs.wi[..., 2] > 0.0)).float().mean()) > 0.4
    wi = normalize(torch.tensor([[-0.3, 0.5, 0.8]])).expand(n, 3)
    lam = 0.5 / np.pi
    assert abs(float(tb.evaluate(p, wo, wi).f[0, 0]) - lam) / lam < 0.15


def test_mixture_pdf_matches_sampling():
    """E[1/pdf] over sampled directions lies within the sampled support
    (tests/test_mixtures.py)."""
    n = 200_000
    p = _mix(make_params(n, diffuse_weight=1.0, kd=torch.ones((n, 3))),
             make_params(n, spec_weight=1.0, fr_mode=3, ax=0.2, ay=0.2),
             0.5, 0.5)
    wo = normalize(torch.tensor([[0.3, 0.0, 0.95]])).expand(n, 3)
    _, bs = tb.sample(p, wo, trng.seed(torch.arange(n), 11))
    inv = torch.where(bs.valid, 1.0 / torch.clamp_min(bs.ev.pdf, 1e-9), 0.0)
    assert np.pi < float(inv.mean()) < 4.0 * np.pi
