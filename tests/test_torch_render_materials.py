"""The port's integrator against the JAX package on the scenes of slice 1b:
`cbox_glass` (glass and mirror boxes, K1's plain sweep), `cbox_zoo` (every
material family under area, point, spot and projector lights; 6,276
triangles through the plain K2) and `cbox_sky` (a substitute sky through
the open front), and of slice 4: both of the first two under the hero
spectrum (`cbox_glass_hero`, dispersive BK7; `cbox_zoo_hero`, every
colour slot decoded, the copper's measured eta / k): per-lane `radiance`
on the same rays and RNG states and
the regeneration wavefront on the same pixels and seeds, under the
thresholds of tests/test_torch_render.py. The JAX renders are made once
per module. Last, a Lambert-only scene under an area light runs none of
the new lobe or light branches."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import block_err, cbox, np_, tt
from tests.torch_scenes import HERO, cbox_glass, cbox_glass_hero, cbox_sky, cbox_zoo
from vision_tpu.core import rng as jrng
from vision_tpu.integrator import pt as jpt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.integrator import pt as tpt

torch.set_num_threads(2)

RES = 32
SCENES = {"cbox_glass": cbox_glass, "cbox_zoo": lambda r: cbox_zoo(r, 40),
          "cbox_sky": cbox_sky, "cbox_glass_hero": cbox_glass_hero,
          "cbox_zoo_hero": lambda r: dict(cbox_zoo(r, 40),
                                          spectrum=dict(HERO))}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, make in SCENES.items():
            s = make(RES)
            out[name] = (JScene(s), vt.load_scene(s, device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_waves(scenes):
    """The JAX package's 4-spp regeneration wavefront of each scene."""
    from vision_tpu.render import _wave_pass
    out = {}
    for name, (js, _) in scenes.items():
        img, aov = _wave_pass(js.data, js.camera, js.filter, jnp.uint32(0), 4,
                              js.max_depth, js.min_depth,
                              jnp.float32(js.rr_threshold))
        out[name] = (np.asarray(img), {k: np.asarray(v) for k, v in aov.items()})
    return out


def test_scene_paths(scenes):
    """cbox_glass and cbox_sky take the dense sweep, cbox_zoo the BVH; the
    hero twins carry the hero spectrum of dimension 4."""
    for name, (js, ps) in scenes.items():
        assert (ps.data.pbvh is not None) == name.startswith("cbox_zoo")
        assert ps.data.spectrum.dims == (4 if name.endswith("hero") else 3)
        assert ps.data.materials.feats == js.data.materials.feats
        assert ps.data.lights.feats == js.data.lights.feats
    assert scenes["cbox_sky"][1].data.lights.env_index == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_radiance_per_lane(scenes, name, monkeypatch):
    """Per-lane radiance at depth 3 on the same camera rays and RNG states.
    A lane whose path meets a rounding-level decision (Russian roulette at
    u ~ q, a lobe pick at u ~ a cdf step, an exact-t tie) may take another
    path: at most 1% of lanes diverge and the means agree within 0.5%. The
    JAX package runs its packet path on the BVH scene (VT_PACKET=1,
    interpret mode), whose ray count skips gated shadow lanes as the
    port's does."""
    js, ps = scenes[name]
    if name.startswith("cbox_zoo"):
        monkeypatch.setenv("VT_PACKET", "1")
    R = RES * RES
    g = np.random.default_rng(0)
    p_film = (np.stack([np.arange(R) % RES, np.arange(R) // RES], -1)
              + g.random((R, 2))).astype(np.float32)
    seeds = g.integers(0, 2 ** 32, R, dtype=np.uint64)
    jray = js.camera.generate_ray(jnp.asarray(p_film))
    jst = jrng.seed(jnp.arange(R, dtype=jnp.uint32),
                    jnp.asarray(seeds.astype(np.uint32)))
    La, aa = jax.jit(lambda d, r, s: jpt.radiance(d, r, s, max_depth=3))(
        js.data, jray, jst)
    La = np.asarray(La)
    Lb, ab = tpt.radiance(ps.data, ps.camera.generate_ray(tt(p_film)),
                          trng.seed(torch.arange(R), tt(seeds.astype(np.int64))),
                          max_depth=3)
    Lb = np_(Lb)
    bad = (np.abs(La - Lb) > 1e-4 + 1e-3 * np.abs(La)).any(-1)
    assert bad.mean() <= 0.01, bad.sum()
    assert La.mean() > 0.01
    assert abs(Lb.mean() / La.mean() - 1.0) < 0.005
    np.testing.assert_allclose(np_(ab["albedo"])[~bad],
                               np.asarray(aa["albedo"])[~bad], atol=1e-5)
    np.testing.assert_allclose(np_(ab["normal"])[~bad],
                               np.asarray(aa["normal"])[~bad], atol=1e-4)
    assert abs(int(ab["nrays"]) - float(aa["nrays"])) <= 0.01 * R


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_wave_matches_jax(scenes, jax_waves, name):
    """The regeneration wavefront at 32^2, 4 spp from the same seeds: 8x8
    block error <= 0.01, equal sample counts, loop counts within 2. The
    ray count is compared on the dense scenes (on the CPU the JAX
    package's BVH fallback counts gated shadow lanes, the port does not)."""
    js, ps = scenes[name]
    ia, aa = jax_waves[name]
    ib, ab = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 4,
                             ps.max_depth, ps.min_depth, ps.rr_threshold)
    werr, bias = block_err(np_(ib), ia)
    assert werr <= 0.01 and abs(bias) <= 0.01, (werr, bias)
    assert np.array_equal(np_(ab["smp"]), aa["smp"])
    assert abs(ab["iters"] - int(aa["iters"])) <= 2
    if ps.data.pbvh is None:
        assert abs(int(ab["nrays"]) / float(aa["nrays"]) - 1.0) < 0.01


def test_diffuse_only_scene_runs_no_new_branch(monkeypatch):
    """The cornell box (Lambert materials, one area light) renders without
    entering any lobe, Fresnel, mixture or light branch of slice 1b."""
    from vision_tpu_torch.lights import lights as tlt
    from vision_tpu_torch.shading import bsdf as tb

    def boom(*a, **k):
        raise AssertionError("a slice-1b branch ran on a diffuse-only scene")

    for mod, names in ((tb, ("_eval_fresnel", "_dielectric_F0", "_eta_dir",
                             "_oren_nayar_AB", "_eval_spec_reflect",
                             "_eval_spec_transmit", "_eval_clearcoat",
                             "_eval_sheen", "_sample_sheen_ltc",
                             "_sheen_ltc_coeffs", "_eval_ems", "_lut_E",
                             "_hemi_eta")),
                       (tlt, ("_falloff_spot", "_sample_env_tex",
                              "_env_angles", "_any"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    monkeypatch.setattr(tb.mf, "sample_wh_ggx", boom)
    ps = vt.load_scene(cbox(16), device="cpu")
    assert ps.data.materials.feats == ("diff",)
    assert ps.data.lights.feats == ("area",)
    img, _ = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 2,
                             ps.max_depth, ps.min_depth, ps.rr_threshold)
    assert float(img.mean()) > 0.0
