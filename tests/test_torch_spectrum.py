"""Parity of the port's hero-wavelength spectrum with the JAX package:
wavelength sampling, the sRGB -> spectrum decodes and the CIE conversion
back (`spectra/spectrum.py`), the device SPD and IOR curves
(`spectra/spd.py`), the spectral gather of the material table, the lights'
illumination decode, and the hero cornell box per lane and through the
regeneration wavefront. Inputs come from numpy seeds and go through both
packages. Also: the port reads its tables from its own `data/`, whose
files equal the JAX package's byte for byte, and srgb scenes issue no
spectral or medium operation."""
import filecmp
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_materials import build_tables, uniform
from tests.torch_parity import (assert_radiance_close, assert_wave_close,
                                cbox, jax_wave, mostly_close, np_,
                                radiance_both, tt)
from tests.torch_scenes import HERO, cbox_zoo
from vision_tpu.core import rng as jrng
from vision_tpu.lights import lights as jlt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu.shading import materials as jmat
from vision_tpu.spectra import spd as jspd
from vision_tpu.spectra.spectrum import SpectrumModel as JSpectrum
from vision_tpu_torch.lights import lights as tlt
from vision_tpu_torch.shading import materials as tmat
from vision_tpu_torch.spectra import spd as tspd
from vision_tpu_torch.spectra.spectrum import (SampledWavelengths,
                                               SpectrumModel as TSpectrum)

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DATA_FILES = ("cie.npz", "srgb2spec.npz", "metal_ior.npz", "ggx_energy.npz",
              "sheen_ltc.npz", "measured_ss.npz")
N = 8192
# decodes: per element within 1e-5 (relative above 1), but for at most
# 0.1% of elements where a colour on a cell edge of the coefficient table
# lands in the neighbouring cell (arcsin / sin and the truncating casts
# round differently in XLA and torch); those within 1e-3
DEC_ATOL = 1e-5
DEC_SHARE = 1e-3
DEC_LOOSE = 1e-3


@pytest.mark.parametrize("name", DATA_FILES)
def test_data_copy_is_identical(name):
    """The port's copy of each table the JAX package reads equals it byte
    for byte (a change to one must be made to both)."""
    assert filecmp.cmp(os.path.join(ROOT, "vision_tpu", "data", name),
                       os.path.join(ROOT, "vision_tpu_torch", "data", name),
                       shallow=False)


def test_port_reads_only_its_data():
    """The port's table directory is its own `data/`, and no module that
    reads a table names the JAX package's directory."""
    from vision_tpu_torch.shading import materials, medium
    from vision_tpu_torch.spectra import spectrum
    port = os.path.realpath(os.path.join(ROOT, "vision_tpu_torch"))
    assert os.path.realpath(tspd.DATA_DIR) == os.path.join(port, "data")
    for mod in (tspd, spectrum, materials, medium):
        assert "\"vision_tpu\"" not in open(mod.__file__).read()


def _states(n, seed):
    st = jrng.seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(seed))
    return st, tt(np.asarray(st).astype(np.int64))


def _models(dims):
    return JSpectrum.make("hero", dims), TSpectrum.make("hero", dims, "cpu")


def _swl(n, dims, seed=5):
    jm, tm = _models(dims)
    jst, tst = _states(n, seed)
    _, jswl = jm.sample_wavelengths(jst)
    tswl = SampledWavelengths(lam=tt(jswl.lam), pdf=tt(jswl.pdf),
                              secondary_alive=tt(jswl.secondary_alive))
    return jm, tm, jswl, tswl


@pytest.mark.parametrize("dims", [1, 4, 8])
def test_sample_wavelengths_match_jax(dims):
    """The same states give the same wavelengths (rtol 1e-6) and the same
    next state; the pdf is the JAX formula at the port's wavelengths (rtol
    1e-6: a 1-ulp arctanh moves lam by up to 6e-5 nm, which the pdf's
    cosh^-2 turns into ~1e-6 of its value, so each is held on its own
    input). The wavelengths lie in the visible range and E[1/pdf] is its
    width."""
    jm, tm = _models(dims)
    jst, tst = _states(N, 5)
    js2, a = jm.sample_wavelengths(jst)
    ts2, b = tm.sample_wavelengths(tst)
    np.testing.assert_array_equal(np_(ts2), np.asarray(js2).astype(np.int64))
    np.testing.assert_allclose(np_(b.lam), np.asarray(a.lam), rtol=1e-6)
    lam = jnp.asarray(np_(b.lam))
    pdf_j = 0.0039398042 / jnp.square(jnp.cosh(0.0072 * (lam - 538.0)))
    np.testing.assert_allclose(np_(b.pdf), np.asarray(pdf_j), rtol=1e-6)
    assert b.lam.shape == (N, dims) and bool(b.secondary_alive.all())
    assert float(b.lam.min()) > 359.0 and float(b.lam.max()) < 831.0
    assert abs(float(torch.mean(1.0 / b.pdf)) - 470.0) / 470.0 < 0.03


def test_srgb_mode_takes_no_draw():
    """The srgb model draws nothing, returns the peak wavelengths, and its
    conversions are the identity."""
    m = TSpectrum.make("srgb", device="cpu")
    _, st = _states(8, 0)
    st2, swl = m.sample_wavelengths(st)
    assert torch.equal(st2, st)
    np.testing.assert_array_equal(np_(swl.lam[0]), np.float32(
        jspd.RGB_PEAK_WAVELENGTHS))
    c = tt(np.full((8, 3), [0.2, 0.5, 0.7], np.float32))
    for f in (m.decode_albedo, m.decode_unbound, m.decode_illumination,
              m.to_srgb):
        assert f(c, swl) is c


def _colours(n, seed):
    """Seeded rgb rows: random, greys, exact ties between channels, cell
    edges of the table, zeros, and unbound (> 1) colours."""
    g = np.random.default_rng(seed)
    rgb = g.random((n, 3), dtype=np.float32)
    k = n // 8
    rgb[:k] = rgb[:k, :1]                               # grey
    rgb[k:2 * k, 1] = rgb[k:2 * k, 0]                   # r == g
    rgb[2 * k:3 * k] = np.round(rgb[2 * k:3 * k] * 63) / 63   # cell edges
    rgb[3 * k:3 * k + 8] = 0.0
    rgb[4 * k:5 * k] *= 17.0
    return rgb.astype(np.float32)


@pytest.mark.parametrize("fn", ["decode_albedo", "decode_unbound",
                                "decode_illumination"])
def test_decode_matches_jax(fn):
    jm, tm, jswl, tswl = _swl(N, 4)
    rgb = _colours(N, 11)
    a = jax.jit(lambda r: getattr(jm, fn)(r, jswl))(jnp.asarray(rgb))
    b = getattr(tm, fn)(tt(rgb), tswl)
    scale = np.maximum(np.abs(np.asarray(a)), 1.0)
    mostly_close(b / torch.as_tensor(scale), np.asarray(a) / scale, 0.0,
                 DEC_ATOL, DEC_LOOSE, DEC_SHARE)


def test_to_srgb_matches_jax():
    """CIE integration of spectra with a third of the lanes' secondaries
    dead: the same sRGB per element (relative above 1: the weights 1 / pdf
    bring values to ~20)."""
    jm, tm, jswl, tswl = _swl(N, 4)
    g = np.random.default_rng(12)
    alive = g.random(N) > 0.33
    sp = (g.random((N, 4), dtype=np.float32) * 3.0).astype(np.float32)
    jswl = jswl.replace(secondary_alive=jnp.asarray(alive))
    tswl = SampledWavelengths(lam=tswl.lam, pdf=tswl.pdf,
                              secondary_alive=tt(alive))
    a = np.asarray(jax.jit(lambda s: jm.to_srgb(s, jswl))(jnp.asarray(sp)))
    b = tm.to_srgb(tt(sp), tswl)
    scale = np.maximum(np.abs(a), 1.0)
    mostly_close(b / torch.as_tensor(scale), a / scale, 0.0, DEC_ATOL,
                 DEC_LOOSE, DEC_SHARE)


def test_round_trip_and_albedo_bound():
    """The port's own counterparts of tests/test_spectrum.py TestDecode:
    illumination decoded and integrated back gives the colour (5%), and a
    decoded albedo stays in [0, 1]."""
    _, tm, _, tswl = _swl(4096, 8)
    for rgb in ([1.0, 1.0, 1.0], [0.8, 0.2, 0.1], [0.1, 0.5, 0.9],
                [17.0, 12.0, 4.0]):
        c = tt(np.broadcast_to(np.float32(rgb), (4096, 3)).copy())
        back = np_(tm.to_srgb(tm.decode_illumination(c, tswl), tswl)).mean(0)
        np.testing.assert_allclose(back, rgb, atol=0.05 * max(max(rgb), 1.0))
    sp = np_(tm.decode_albedo(tt(np.float32([[0.9, 0.4, 0.1]] * 4096)), tswl))
    assert (sp >= 0.0).all() and (sp <= 1.001).all()


@pytest.mark.parametrize("unbound", [False, True])
def test_row_coeffs_equal_per_lane_decode(unbound):
    """A table row's coefficients made once and gathered per lane decode
    to the very floats of the per-lane decode (the material and medium
    tables use them for constant slots)."""
    _, tm, _, tswl = _swl(N, 4)
    rows = tt(_colours(512, 13))
    idx = torch.as_tensor(np.random.default_rng(14).integers(0, 512, N))
    if unbound:
        c, s = tm.row_coeffs(rows, unbound=True)
        got = tm.eval_coeffs(c[idx], tswl, s[idx])
        want = tm.decode_unbound(rows[idx], tswl)
    else:
        got = tm.eval_coeffs(tm.row_coeffs(rows)[idx], tswl)
        want = tm.decode_albedo(rows[idx], tswl)
    assert torch.equal(got, want)


def test_spd_eval_matches_jax():
    """spd_eval (the CIE Y curve) and spd_eval_rows (metal eta / k rows)
    per element, rtol 1e-6, wavelengths inside and outside [360, 830]."""
    g = np.random.default_rng(15)
    lam = g.uniform(340.0, 850.0, (N, 4)).astype(np.float32)
    y = tspd.CIE_Y.astype(np.float32)
    np.testing.assert_allclose(
        np_(tspd.spd_eval(tt(y), tt(lam))),
        np.asarray(jspd.spd_eval(jnp.asarray(y), jnp.asarray(lam))), rtol=1e-6)
    assert tspd.CIE_Y_INTEGRAL == jspd.CIE_Y_INTEGRAL
    for k in ("CIE_X", "CIE_Y", "CIE_Z", "CIE_D65"):
        np.testing.assert_array_equal(getattr(tspd, k), getattr(jspd, k))
    table = np.stack([jspd.metal_complex_ior(n)[0] for n in jspd.METAL_NAMES]
                     ).astype(np.float32)
    rows = g.integers(0, table.shape[0], N)
    np.testing.assert_allclose(
        np_(tspd.spd_eval_rows(tt(table), tt(rows), tt(lam))),
        np.asarray(jspd.spd_eval_rows(jnp.asarray(table), jnp.asarray(rows),
                                      jnp.asarray(lam))), rtol=1e-6)


def test_glass_ior_and_sellmeier_match_jax():
    """glass_ior per wavelength for each named glass and an unknown name,
    and the table's Sellmeier eta per row, rtol 1e-6."""
    lam = np.random.default_rng(16).uniform(360.0, 830.0, (N, 4)).astype(
        np.float32)
    for name in jspd.GLASS_NAMES + ["NoSuchGlass"]:
        np.testing.assert_allclose(
            np_(tspd.glass_ior(name, tt(lam))),
            np.asarray(jspd.glass_ior(name, jnp.asarray(lam))), rtol=1e-6)
    coeffs = np.asarray([jspd._SELLMEIER[n] for n in jspd.GLASS_NAMES],
                        np.float32)[np.arange(N) % 2]
    np.testing.assert_allclose(
        np_(tmat._sellmeier_eta(tt(coeffs), tt(lam))),
        np.asarray(jmat._sellmeier_eta(jnp.asarray(coeffs), jnp.asarray(lam))),
        rtol=1e-6)


LOBE_FIELDS = ("kd", "spec_tint", "sheen_tint", "eta", "eta3", "k3",
               "diffuse_weight", "spec_weight", "trans_weight", "ax", "ay")


def test_gather_params_hero_matches_jax():
    """The hero gather on a table of every material type (mixtures' second
    rows and invalid lanes included): decoded colours, Sellmeier eta of
    the dispersive BK7 rows, metal eta / k from their SPD rows, and the
    dispersive mask, per element (rtol 1e-5, atol 1e-6)."""
    jt, pt_, _ = build_tables()
    assert pt_.has_dispersive and pt_.has_metal_spd
    jm, tm, jswl, tswl = _swl(N, 4)
    mid = np.random.default_rng(17).integers(-1, jt.kd.shape[0], N).astype(
        np.int32)
    uv = uniform(N, 2, 18)
    from vision_tpu.scene.texture import AtlasBuilder as JA
    from vision_tpu_torch.scene.texture import AtlasBuilder as TA
    pa, da = jmat.gather_params(jt, JA().build(), jnp.asarray(mid),
                                jnp.asarray(uv), jm, jswl)
    pb, db = tmat.gather_params(pt_, TA().build("cpu"), tt(mid), tt(uv), tm,
                                tswl)
    np.testing.assert_array_equal(np_(db), np.asarray(da))
    assert np.asarray(da).any()
    for p, q in ((pa, pb), (pa.mix_b, pb.mix_b)):
        for f in LOBE_FIELDS:
            a, b = np.asarray(getattr(p, f)), np_(getattr(q, f))
            assert b.shape == a.shape, f
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.fixture(scope="module")
def zoo_hero():
    s = cbox_zoo(16, sub_div=40)
    s["spectrum"] = dict(HERO)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JScene(s), vt.load_scene(s, device="cpu")


def test_lights_decode_hero(zoo_hero):
    """sample_wi and eval_hit_area under the hero spectrum, on the area,
    point, spot and projector lights of cbox_zoo: radiance decoded at the
    lanes' wavelengths (rtol 1e-4 as tests/test_torch_shading.py; pdfs
    unchanged)."""
    js, ps = zoo_hero
    jm, tm, jswl, tswl = _swl(N, 4)
    jm, tm = js.data.spectrum, ps.data.spectrum
    g = np.random.default_rng(19)
    ref = (g.random((N, 3)) * [1.6, 1.6, 1.6] - [0.8, -0.1, 0.8]).astype(
        np.float32)
    u_sel, u2 = g.random(N, dtype=np.float32), g.random((N, 2), dtype=np.float32)
    n = np.tile(np.float32([[0.0, 1.0, 0.0]]), (N, 1))
    la = jlt.sample_wi(js.data.lights, js.data.atlas, js.data.tri_pack,
                       jnp.asarray(ref), jnp.asarray(n), jnp.asarray(u_sel),
                       jnp.asarray(u2), js.data.world_radius, jm, jswl)
    lb = tlt.sample_wi(ps.data.lights, ps.data.atlas, ps.data.tri_pack,
                       tt(ref), tt(n), tt(u_sel), tt(u2),
                       ps.data.world_radius, tm, tswl)
    assert lb.L.shape == (N, 4)
    np.testing.assert_allclose(np_(lb.L), np.asarray(la.L), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np_(lb.pdf), np.asarray(la.pdf), rtol=1e-4,
                               atol=1e-5)
    tri = np.where(np.asarray(js.data.tri_pack)[:, 26] >= 0)[0]
    rows = np.asarray(js.data.tri_pack)[g.choice(tri, N)]
    hit = rows[:, 0:3] + 0.25 * rows[:, 3:6] + 0.25 * rows[:, 6:9]
    ng = np.cross(rows[:, 3:6], rows[:, 6:9])
    ng = (ng / np.linalg.norm(ng, axis=-1, keepdims=True)).astype(np.float32)
    lid = rows[:, 26].astype(np.int32)
    Ea, _ = jlt.eval_hit_area(js.data.lights, jnp.asarray(lid), None, None,
                              jnp.asarray(ref), jnp.asarray(hit),
                              jnp.asarray(ng), None, js.data.atlas, jm, jswl)
    Eb, _ = tlt.eval_hit_area(ps.data.lights, tt(lid), tt(ref), tt(hit),
                              tt(ng), None, ps.data.atlas, tm, tswl)
    assert (np.asarray(Ea).max(-1) > 0).any()
    np.testing.assert_allclose(np_(Eb), np.asarray(Ea), rtol=1e-4, atol=1e-5)
    env_b = tlt.env_radiance(ps.data.lights, ps.data.atlas, tt(n), tm, tswl)
    assert env_b.shape == (N, 4) and not bool(env_b.any())


RES = 32


@pytest.fixture(scope="module")
def hero_cbox():
    s = cbox(RES, spectrum=dict(HERO))
    return JScene(s), vt.load_scene(s, device="cpu")


def test_hero_cbox_radiance_per_lane(hero_cbox):
    """Per-lane radiance at depth 3 on the same rays and states, under the
    thresholds of tests/test_torch_render_materials.py (at most 1% of
    lanes diverge, means within 0.5%)."""
    js, ps = hero_cbox
    assert ps.data.spectrum.hero and ps.data.spectrum.dims == 4
    assert_radiance_close(*radiance_both(js, ps, RES))


def test_hero_cbox_render_wave(hero_cbox):
    """The regeneration wavefront at 32^2, 4 spp: block error <= 0.01,
    equal sample counts."""
    js, ps = hero_cbox
    assert_wave_close(ps, jax_wave(js))


def test_srgb_scenes_run_no_spectral_or_medium_op(monkeypatch):
    """The srgb cbox (K1) and cbox_zoo (K2) render without calling any
    function of the hero spectrum, the spectral columns or the media."""
    from vision_tpu_torch.integrator import pt as tpt
    from vision_tpu_torch.shading import medium as tmd

    def boom(*a, **k):
        raise AssertionError("a slice-4 branch ran on an srgb scene")

    for obj, names in ((TSpectrum, ("_poly_coeffs", "_poly_eval",
                                    "row_coeffs", "eval_coeffs",
                                    "sample_wavelengths")),
                       (tspd, ("spd_eval", "spd_eval_rows")),
                       (tmat, ("_sellmeier_eta",)),
                       (tmd, ("gather_spectral", "sample_distance",
                              "transmittance", "hg_phase", "hg_sample"))):
        for n in names:
            monkeypatch.setattr(obj, n, boom)
    for s in (cbox(16), cbox_zoo(16, sub_div=40)):
        ps = vt.load_scene(s, device="cpu")
        assert not ps.data.spectrum.hero and not ps.data.has_media
        img, _ = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 1,
                                 ps.max_depth, ps.min_depth, ps.rr_threshold)
        assert float(img.mean()) > 0.0


@pytest.mark.cuda
def test_hero_renders_launch_the_dense_sweep():
    """On the card the hero cbox and hero cbox_glass render through K1's
    kernels (dense_sweep_kernel), finite and lit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tests.torch_scenes import cbox_glass_hero
    from vision_tpu_torch.accel import dense_isect as di
    for s in (cbox(64, spectrum=dict(HERO)), cbox_glass_hero(64)):
        sc = vt.load_scene(s)
        n0 = dict(di.LAUNCHES)
        img = vt.render(sc, spp=2)
        assert di.LAUNCHES["closest"] > n0["closest"]
        assert di.LAUNCHES["anyhit"] > n0["anyhit"]
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
