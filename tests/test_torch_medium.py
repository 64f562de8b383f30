"""Parity of the port's participating media (`shading/medium.py`) with the
JAX package: the Henyey-Greenstein phase function and its sampling, the
analytic distance sampling and the shadow transmittance on the same RNG
states, the medium tables the loaders build (a global fog, measured
presets, a subsurface material's interior medium), and the fog cornell box
(srgb) and the subsurface box (hero spectrum) per lane and through the
regeneration wavefront. Inputs come from numpy seeds and go through both
packages."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import (assert_radiance_close, assert_wave_close,
                                cbox, jax_scene_arrays, jax_wave, np_,
                                radiance_both, tt)
from tests.torch_scenes import cbox_sss, fog_cbox
from vision_tpu.core import rng as jrng
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu.shading import medium as jmd
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.scene.scene import scene_from_arrays
from vision_tpu_torch.shading import medium as tmd

torch.set_num_threads(2)

N = 8192
RTOL = 1e-5


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _states(n, seed):
    st = jrng.seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(seed))
    return st, tt(np.asarray(st).astype(np.int64))


def test_hg_phase_matches_jax():
    g = np.random.default_rng(1)
    c = g.uniform(-1.0, 1.0, N).astype(np.float32)
    gg = g.uniform(-0.99, 0.99, N).astype(np.float32)
    np.testing.assert_allclose(np_(tmd.hg_phase(tt(c), tt(gg))),
                               np.asarray(jmd.hg_phase(jnp.asarray(c),
                                                       jnp.asarray(gg))),
                               rtol=RTOL)


def test_hg_sample_matches_jax():
    """Directions and pdfs at rtol 1e-5 for |g| >= 0.05. Near g = 0 the
    sampler clamps g to 1e-3 and cos_theta = -(1 + g^2 - s^2) / 2g cancels
    to ~5e-5 absolute; there the directions agree within 1e-3 and the pdf
    (1 / 4 pi to 1e-3) within 1e-5."""
    g = np.random.default_rng(2)
    wo = _unit(N, 3)
    u2 = g.random((N, 2), dtype=np.float32)
    gg = (g.uniform(0.05, 0.95, N) * np.sign(g.uniform(-1, 1, N))).astype(
        np.float32)
    wa, pa = jmd.hg_sample(jnp.asarray(wo), jnp.asarray(gg), jnp.asarray(u2))
    wb, pb = tmd.hg_sample(tt(wo), tt(gg), tt(u2))
    np.testing.assert_allclose(np_(wb), np.asarray(wa), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(np_(pb), np.asarray(pa), rtol=RTOL)
    g0 = np.zeros(N, np.float32)
    wa, pa = jmd.hg_sample(jnp.asarray(wo), jnp.asarray(g0), jnp.asarray(u2))
    wb, pb = tmd.hg_sample(tt(wo), tt(g0), tt(u2))
    np.testing.assert_allclose(np_(wb), np.asarray(wa), atol=1e-3)
    np.testing.assert_allclose(np_(pb), np.asarray(pa), rtol=RTOL)
    # the sample follows the phase function: mean cos(-wo, wi) ~ g
    wb, _ = tmd.hg_sample(tt(wo), torch.full((N,), 0.6), tt(u2))
    assert abs(float((-tt(wo) * wb).sum(-1).mean()) - 0.6) < 0.02


@pytest.mark.parametrize("S", [3, 4])
def test_sample_distance_matches_jax(S):
    """The same states: the same two draws (channel, then distance), the
    same scatter decisions, distances and weights at rtol 1e-5; lanes
    with zero sigma never scatter."""
    g = np.random.default_rng(4 + S)
    sig = g.uniform(0.0, 3.0, (N, S)).astype(np.float32)
    sig[: N // 16] = 0.0
    t_surf = g.uniform(0.01, 6.0, N).astype(np.float32)
    jst, tst = _states(N, 9)
    a = jax.jit(lambda s, x, t: jmd.sample_distance(s, x, t, S))(
        jst, jnp.asarray(sig), jnp.asarray(t_surf))
    b = tmd.sample_distance(tst, tt(sig), tt(t_surf), S)
    np.testing.assert_array_equal(np_(b[0]), np.asarray(a[0]).astype(np.int64))
    np.testing.assert_array_equal(np_(b[2]), np.asarray(a[2]))
    assert not np_(b[2])[: N // 16].any() and np_(b[2]).any()
    for i in (1, 3, 4):
        np.testing.assert_allclose(np_(b[i]), np.asarray(a[i]), rtol=RTOL,
                                   atol=1e-7)


def test_transmittance_matches_jax():
    g = np.random.default_rng(6)
    sig = g.uniform(0.0, 2.0, (N, 4)).astype(np.float32)
    dist = g.uniform(0.0, 5.0, N).astype(np.float32)
    inside = g.random(N) < 0.5
    np.testing.assert_allclose(
        np_(tmd.transmittance(tt(sig), tt(dist), tt(inside))),
        np.asarray(jmd.transmittance(jnp.asarray(sig), jnp.asarray(dist),
                                     jnp.asarray(inside))), rtol=RTOL)


def _media_scene(edit):
    s = cbox(16)
    edit(s)
    return s


def _presets(s):
    s["mediums"] = {"process": True, "global": "skin", "list": [
        {"type": "homogeneous", "name": "skin",
         "param": {"medium_name": "Skin1", "scale": 2.0, "g": 0.3}},
        {"type": "homogeneous", "name": "unknown",
         "param": {"medium_name": "NoSuchThing", "g": 1.5}}]}
    s["shapes"][6]["param"]["medium"] = {"inside": "unknown",
                                         "outside": "skin"}


MEDIA_SCENES = {
    "fog": lambda: fog_cbox(16),
    "measured_presets": lambda: _media_scene(_presets),
    "subsurface": lambda: cbox_sss(16),
    "subsurface_named": lambda: _media_scene(lambda s: (
        s["materials"].append({"type": "subsurface", "name": "Skin",
                               "param": {"medium_name": "Ketchup",
                                         "g": 0.2}}),
        s["shapes"][5]["param"].update(material="Skin"),
        s["shapes"][6]["param"].update(material="Skin"))),
    "listed_not_processed": lambda: _media_scene(lambda s: s.update(
        mediums={"list": [{"type": "homogeneous", "name": "fog",
                           "param": {}}], "global": "fog"})),
}


@pytest.mark.parametrize("name", sorted(MEDIA_SCENES))
def test_medium_tables_match_jax(name):
    """The medium rows, each instance's inside / outside medium, the
    camera's medium and has_media equal the JAX loader's bit for bit, and
    scene_from_arrays carries them across."""
    s = MEDIA_SCENES[name]()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = JScene(s)
        ps = vt.load_scene(s, device="cpu")
    ref = jax_scene_arrays(js)
    carried, _, _ = scene_from_arrays(ref, "cpu")
    for d in (ps.data, carried):
        for k in ("sigma_a", "sigma_s", "g"):
            np.testing.assert_array_equal(np_(getattr(d.mediums, k)),
                                          ref[f"mediums.{k}"])
        for k in ("inst_in_medium", "inst_out_medium"):
            np.testing.assert_array_equal(np_(getattr(d, k)), ref[k])
        assert d.has_media == bool(ref["has_media"])
        assert d.camera_medium == int(ref["camera_medium"])
    assert ps.data.has_media == (name != "listed_not_processed")


def test_measured_presets():
    ss, sa = tmd.measured_ss("Skin1")
    assert ss.shape == (3,) and (ss > 0).all()
    for name in ("Skin1", "NoSuchThing"):
        for x, y in zip(tmd.measured_ss(name), jmd.measured_ss(name)):
            np.testing.assert_array_equal(x, y)


RES = 32
SCENES = {"fog_cbox": fog_cbox, "cbox_sss": cbox_sss}


@pytest.fixture(scope="module")
def scenes():
    return {k: (JScene(f(RES)), vt.load_scene(f(RES), device="cpu"))
            for k, f in SCENES.items()}


def test_fog_radiance_per_lane(scenes):
    """Per-lane radiance at depth 3 in the global fog, under the
    thresholds of tests/test_torch_render_materials.py, with Russian
    roulette off and at its default. In a grey medium a surface event's
    weight tr / mean(tr) is 1 in exact arithmetic; XLA rounds it to 1 or
    to 1 - 2^-23 depending on its exp, which differs from torch's in the
    last bit on ~10% of arguments, and Russian roulette compares the
    throughput with 1. So with roulette off at most 1% of lanes diverge;
    with it on, the lanes that diverge are those knife-edge decisions (at
    most 3%), and the means still agree within 0.5%."""
    js, ps = scenes["fog_cbox"]
    assert ps.data.has_media and ps.data.camera_medium == 0
    assert_radiance_close(*radiance_both(js, ps, RES, rr_threshold=0.0))
    assert_radiance_close(*radiance_both(js, ps, RES), share=0.03)


def test_sss_radiance_per_lane(scenes):
    """Per-lane radiance at depth 3 on the subsurface box under the hero
    spectrum (interior sigmas decoded per wavelength, the medium entered
    through inst_in_medium), under the same thresholds."""
    js, ps = scenes["cbox_sss"]
    assert ps.data.has_media and ps.data.spectrum.hero
    assert ps.data.camera_medium == -1
    assert int(ps.data.inst_in_medium[6]) == 0
    assert_radiance_close(*radiance_both(js, ps, RES))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_wave_matches_jax(scenes, name):
    """The regeneration wavefront at 32^2, 4 spp (the camera's medium on
    every regenerated lane): block error <= 0.01, equal sample counts."""
    js, ps = scenes[name]
    assert_wave_close(ps, jax_wave(js))


def test_media_change_nothing_without_media(monkeypatch):
    """A scene whose mediums are listed but not processed takes no medium
    branch: its render equals the same scene's without the block."""
    s = MEDIA_SCENES["listed_not_processed"]()
    ps = vt.load_scene(s, device="cpu")
    plain = vt.load_scene(cbox(16), device="cpu")
    a, _ = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 1, 8)
    b, _ = tpt.render_wave(plain.data, plain.camera, plain.filter, 0, 1, 8)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_media_renders_launch_the_dense_sweep():
    """On the card the fog cbox and the subsurface box render through K1's
    kernels (dense_sweep_kernel), finite and lit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from vision_tpu_torch.accel import dense_isect as di
    for s in (fog_cbox(64), cbox_sss(64)):
        sc = vt.load_scene(s)
        n0 = dict(di.LAUNCHES)
        img = vt.render(sc, spp=2)
        assert di.LAUNCHES["closest"] > n0["closest"]
        assert di.LAUNCHES["anyhit"] > n0["anyhit"]
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
