"""The port's integrator against the JAX package on the scenes of slices
4c and 7a: `cbox_tex` (a baked image node, a uv-mapped texture, a normal
map, a fresnel-driven colour, an IES spot and a textured emitter; K1's
plain sweep) and `env_sphere` (a checkered sphere under the `mix` of two
.hdr skies and a projector image; 6,242 triangles through the plain K2):
and `cbox_tex_hero`, `cbox_tex` under the hero spectrum of dimension 4
(the textured, fresnel-driven and emission colours decoded per lane):
per-lane `radiance` on the same rays and RNG states and the regeneration
wavefront on the same pixels and seeds, under the thresholds of
tests/test_torch_render_materials.py (the albedo AOV within 1e-4 where a
texture is tiled: tests/test_torch_shader_graph.py). The JAX renders are
made once per module."""
import warnings

import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.test_torch_shader_graph import TEXTURED_ALBEDO_ATOL
from tests.torch_parity import (assert_radiance_close, assert_wave_close,
                                jax_wave, radiance_both)
from tests.torch_scenes import HERO, cbox_tex, env_sphere
from vision_tpu.scene.scene import Scene as JScene

torch.set_num_threads(2)

SCENES = {"cbox_tex": (cbox_tex, 32), "env_sphere": (env_sphere, 24),
          "cbox_tex_hero": (lambda r: dict(cbox_tex(r), spectrum=dict(HERO)),
                            24)}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, (make, res) in SCENES.items():
            s = make(res)
            out[name] = (JScene(s), vt.load_scene(s, device="cpu"), res)
    return out


def test_scene_paths(scenes):
    """cbox_tex takes the dense sweep with every new material and light
    feature; env_sphere the BVH with the environment and a textured
    projector."""
    js, ps, _ = scenes["cbox_tex"]
    assert ps.data.pbvh is None
    assert {"nmap", "fresmix", "uvmap"} <= set(ps.data.materials.feats)
    assert {"ies", "tex", "spot", "area"} <= set(ps.data.lights.feats)
    assert scenes["cbox_tex_hero"][1].data.spectrum.hero
    js, ps, _ = scenes["env_sphere"]
    assert ps.data.pbvh is not None and ps.data.lights.env_index >= 0
    assert {"env", "proj", "tex"} <= set(ps.data.lights.feats)
    assert ps.data.atlas.n_real == js.data.atlas.n_real == 3


@pytest.mark.parametrize("name", sorted(SCENES))
def test_radiance_per_lane(scenes, name):
    js, ps, res = scenes[name]
    assert_radiance_close(*radiance_both(js, ps, res),
                          albedo_atol=TEXTURED_ALBEDO_ATOL,
                          count_rays=name != "env_sphere")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_wave(scenes, name):
    """4 spp through the regeneration wavefront: block error and bias
    within 0.01, equal sample counts; ray counts within 1% on the dense
    scenes (the JAX package's CPU BVH walk counts every gated shadow lane,
    the port only those it traces)."""
    js, ps, _ = scenes[name]
    assert_wave_close(ps, jax_wave(js), count_rays=name != "env_sphere")
