"""The port's adaptive sampling and light-field frame buffer (slice 4d)
against the JAX package: the convergence inspector
(tests/test_subsystems.py:75-90), `render_adaptive` on the cbox (the
per-chunk budgets and the image), `render_light_field` tile by tile, and
the light-field checks of tests/test_subsystems.py:167-219 (parallax,
mosaic, refocus, pinhole views, the frame-buffer switch)."""
import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.fixtures import CBOX_JSON
from tests.torch_parity import cbox, np_, tt
from tests.torch_scenes import lf_cbox
from vision_tpu.integrator import adaptive as jad
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu.sensor import light_field as jlf
from vision_tpu_torch.integrator import adaptive as tad
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.sensor import light_field as tlf

torch.set_num_threads(2)

jrender = importlib.import_module("vision_tpu.render")
trender = importlib.import_module("vision_tpu_torch.render")


def _same_state(a, b):
    for k in ("mean", "m2", "count"):
        np.testing.assert_allclose(np_(getattr(b, k)),
                                   np.asarray(getattr(a, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_variance_tracking():
    """32 Welford updates: a constant and a dim pixel converge, a noisy one
    does not, and the state is the JAX package's."""
    ja, ta = jad.InspectorState.initial(4), tad.InspectorState.initial(4, "cpu")
    rs = np.random.RandomState(0)
    for _ in range(32):
        rgb = np.zeros((4, 3), np.float32)
        rgb[0] = 0.5
        rgb[1] = 0.5 + rs.randn() * 0.4
        rgb[2] = 0.1
        rgb[3] = rs.rand()
        ja = jad.update(ja, jnp.asarray(rgb))
        ta = tad.update(ta, tt(rgb))
    _same_state(ja, ta)
    conv = np_(tad.is_converged(ta, threshold=0.05))
    assert conv[0] and conv[2] and not conv[1]
    np.testing.assert_array_equal(
        conv, np.asarray(jad.is_converged(ja, threshold=0.05)))
    assert float(tad.active_fraction(ta, 0.05)) == float(
        jad.active_fraction(ja, 0.05))


def test_update_where():
    """Updates only where a pixel sampled, from colours or luminances."""
    g = np.random.default_rng(1)
    ja, ta = jad.InspectorState.initial(64), tad.InspectorState.initial(64, "cpu")
    for i in range(6):
        x = g.random((64, 3)).astype(np.float32)
        took = g.random(64) < 0.7
        if i % 2:
            x = x[:, 0]
        ja = jad.update_where(ja, jnp.asarray(x), jnp.asarray(took))
        ta = tad.update_where(ta, tt(x), tt(took))
    _same_state(ja, ta)
    for thr, mins in ((0.3, 2.0), (0.05, 3.0)):
        np.testing.assert_array_equal(
            np_(tad.is_converged(ta, thr, mins)),
            np.asarray(jad.is_converged(ja, thr, mins)))


@pytest.fixture(scope="module")
def adaptive_pair():
    s = cbox(32)
    js, ps = JScene(s), vt.load_scene(s, device="cpu")
    return jrender.render_adaptive(js, 64), trender.render_adaptive(ps, 64)


def test_render_adaptive_matches_jax(adaptive_pair):
    """The cbox at 32^2, 64 spp in chunks of 8 after 3: the image agrees
    with the JAX package's at every pixel (a pixel given another chunk
    budget would differ), the mean sample count within 1%, the active
    share and the ray count too; converged pixels took fewer samples
    (mean_spp < 64)."""
    (ia, sa), (ib, sb) = adaptive_pair
    assert sb["mean_spp"] < 64.0
    assert abs(sb["mean_spp"] - sa["mean_spp"]) <= 0.01 * 64
    assert abs(sb["active_frac"] - sa["active_frac"]) <= 0.01
    assert abs(sb["nrays"] / sa["nrays"] - 1.0) < 0.01
    ib = np_(ib)
    np.testing.assert_allclose(ib, ia, rtol=1e-4, atol=1e-5)
    assert np.isfinite(ib).all() and ib.shape == (32, 32, 3)


def test_render_wave_budget():
    """`spp_budget`: a pixel with budget 0 starts dead and takes no sample,
    the others take theirs; the lanes that sample agree with the JAX
    package's render of the same budgets."""
    s = cbox(16)
    js, ps = JScene(s), vt.load_scene(s, device="cpu")
    budget = (np.arange(256) % 5).astype(np.int32)
    ia, aa = jrender._wave_pass(js.data, js.camera, js.filter, jnp.uint32(0),
                                4, js.max_depth, js.min_depth,
                                jnp.float32(js.rr_threshold),
                                spp_budget=jnp.asarray(budget))
    ib, ab = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 4,
                             ps.max_depth, ps.min_depth, ps.rr_threshold,
                             spp_budget=tt(budget))
    np.testing.assert_array_equal(np_(ab["smp"]), np.minimum(budget, 4))
    np.testing.assert_array_equal(np_(ab["smp"]), np.asarray(aa["smp"]))
    np.testing.assert_allclose(np_(ib), np.asarray(ia), rtol=1e-4, atol=1e-5)
    assert int(ab["nrays"]) == int(float(aa["nrays"]))


def test_render_light_field_matches_jax():
    """The light field at 16^2, grid 2, 4 spp: every tile within 1e-5 of
    the JAX package's."""
    s = lf_cbox(16, grid=2)
    js, ps = JScene(s), vt.load_scene(s, device="cpu")
    ta = np.asarray(jrender.render_light_field(js, spp=4))
    tb = np_(trender.render_light_field(ps, spp=4))
    assert tb.shape == ta.shape == (2, 2, 16, 16, 3)
    for j in range(2):
        for i in range(2):
            np.testing.assert_allclose(tb[j, i], ta[j, i], rtol=1e-4,
                                       atol=1e-5, err_msg=f"tile {j} {i}")


def test_subaperture_views_parallax_and_refocus():
    s = copy.deepcopy(CBOX_JSON)
    cam = s["camera"]["param"]
    cam["radiance_collector"]["param"]["resolution"] = [24, 24]
    cam["lens_radius"] = 0.35
    cam["focal_distance"] = 6.0
    ps = vt.load_scene(s, device="cpu")
    t = trender.render_light_field(ps, spp=4, grid=2)
    assert t.shape == (2, 2, 24, 24, 3)
    tn = np_(t)
    assert np.isfinite(tn).all() and tn.mean() > 0
    assert np.abs(tn[0, 0] - tn[1, 1]).mean() > 1e-4
    m = tlf.mosaic(t)
    assert m.shape == (48, 48, 3)
    np.testing.assert_array_equal(np_(m), np.asarray(jlf.mosaic(
        jnp.asarray(tn))))
    r = np_(tlf.refocus(t, 0.0))
    assert r.shape == (24, 24, 3)
    assert np.allclose(r, tn.mean(axis=(0, 1)), atol=1e-6)
    for shift in (3.0, -5.0):
        np.testing.assert_allclose(
            np_(tlf.refocus(t, shift)),
            np.asarray(jlf.refocus(jnp.asarray(tn), shift)), atol=1e-6)


def test_pinhole_views_generate_identical_rays():
    """Zero aperture: every view's rays are the pinhole's; the rays equal
    the JAX camera's."""
    s = cbox(16)
    js, ps = JScene(s), vt.load_scene(s, device="cpu")
    cam = tlf.light_field_camera(ps.camera, 2)
    pix = np.arange(4 * 256)
    p = np.stack([pix % 16 + 0.5, pix // 16 + 0.5], -1).astype(np.float32)
    ray = cam.generate_ray(tt(p))
    d = np_(ray.direction).reshape(4, 256, 3)
    o = np_(ray.origin).reshape(4, 256, 3)
    for v in range(1, 4):
        assert np.allclose(d[0], d[v], atol=1e-6)
        assert np.allclose(o[0], o[v], atol=1e-6)
    jray = jlf.light_field_camera(js.camera, 2).generate_ray(jnp.asarray(p))
    np.testing.assert_allclose(np_(ray.direction), np.asarray(jray.direction),
                               atol=1e-6)


def test_scene_framebuffer_plugin_routes():
    """The light_field frame buffer: `render` returns the mosaic."""
    s = cbox(16)
    s["pipeline"] = {"param": {"frame_buffer": {"type": "light_field",
                                                "param": {"grid": 2}}}}
    ps = vt.load_scene(s, device="cpu")
    assert ps.framebuffer_type == "light_field" and ps.lf_grid == 2
    img = vt.render(ps, spp=2)
    assert isinstance(img, torch.Tensor) and img.shape == (32, 32, 3)
    ia = jrender.render(JScene(s), spp=2)
    np.testing.assert_allclose(np_(img), ia, rtol=1e-4, atol=1e-5)
