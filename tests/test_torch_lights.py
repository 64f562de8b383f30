"""Parity of the port's light table (`vision_tpu_torch/lights/lights.py`)
with the JAX package on the same seeded inputs, for every light type:
area (textured emission included), point, spot, projector (with a texture
from the atlas), spherical environment (an array-backed image) and
directional, spot and projector shaped by an IES profile, and the
sentinel of a scene without lights. The JAX tables come across through
`scene_from_arrays`. Then the port's counterparts of
tests/test_lights.py:67,94 (the directional light)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_materials import uniform, unit
from tests.torch_parity import cbox, jax_scene_arrays, mostly_close, np_, tt
from tests.torch_scenes import asset
from vision_tpu.lights import lights as jlt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.core import transform as xf
from vision_tpu_torch.lights import lights as tlt
from vision_tpu_torch.scene.scene import scene_from_arrays

torch.set_num_threads(2)

# the tolerances of tests/test_torch_shading.py: rtol 1e-4, atol 1e-6;
# positions, directions and pdfs (~ r^2 / cos) with atol 1e-5
RTOL = 1e-4
ATOL = 1e-6
N = 4096

# lights added to the cornell box's own area light, by type
O2W_PROJ = xf.look_at([-0.7, 1.7, 1.2], [-0.3, 0.8, -0.6], [0, 1, 0])
O2W_ENV = xf.rotation_x(-90.0) @ xf.rotation_y(30.0)


def _add(kind, jb, ja, g):
    """Add a light of `kind` to the JAX builder `jb` (textures into the JAX
    atlas builder `ja`)."""
    if kind == "point":
        jb.add_point([0.9, 0.8, 0.7], [-0.55, 1.55, 0.6])
    elif kind == "spot":
        jb.add_spot([2.5, 2.0, 1.5], [0.3, 1.85, 1.1], [0.0, -0.9, -0.7],
                    30.0, 10.0)
    elif kind == "proj":
        tex = ja.add_array(g.random((6, 9, 3), dtype=np.float32))
        jb.add_projector([0.4, 0.7, 1.0], O2W_PROJ, 25.0, 1.3, tex)
    elif kind == "env":
        img = (g.random((8, 16, 3), dtype=np.float32) * 2.0
               + np.linspace(0, 1, 8, dtype=np.float32)[:, None, None])
        jb.add_spherical([1.5, 1.2, 1.0], O2W_ENV, ja.add_array(img), img)
    elif kind == "dir":
        jb.add_directional([1.0, 0.9, 0.8], [0.3, -1.0, -0.2])
    elif kind == "ies":
        # a spot and a projector shaped by the committed IES profile
        from vision_tpu.lights.ies import IESProfile
        prof = jb.add_ies_profile(np.asarray(
            IESProfile.load(asset("spot.ies")).to_table()))
        jb.add_spot([2.5, 2.0, 1.5], [0.3, 1.85, 1.1], [0.0, -0.9, -0.7],
                    70.0, 10.0, ies=prof)
        tex = ja.add_array(g.random((6, 9, 3), dtype=np.float32))
        jb.add_projector([0.4, 0.7, 1.0], O2W_PROJ, 35.0, 1.3, tex, ies=prof)


TABLES = {
    # name: (types added to the cbox, keep its area light, light sampler)
    "area": ((), True, "uniform"),
    "area_textured": (("tex",), True, "power"),
    "point": (("point",), False, "uniform"),
    "spot": (("spot",), False, "uniform"),
    "proj": (("proj",), False, "uniform"),
    "env": (("env",), False, "uniform"),
    "dir": (("dir",), False, "uniform"),
    "sentinel": ((), False, "uniform"),
    "every_type": (("tex", "point", "spot", "proj", "env", "dir"), True,
                   "power"),
    "every_type_uniform": (("point", "spot", "proj", "env", "dir"), True,
                           "uniform"),
    "ies": (("ies",), True, "uniform"),
}


def _scenes(name):
    """(JAX scene, the port's SceneData carried across) for TABLES[name]."""
    from vision_tpu.lights.lights import LightBuilder
    kinds, keep_area, sampler = TABLES[name]
    js = JScene(cbox(16))
    g = np.random.default_rng(5)
    jb = LightBuilder(sampler_type=sampler, env_prob=0.3)
    if keep_area:
        jb.rows = copy.deepcopy(js.light_builder.rows)
        jb.area_weights = list(js.light_builder.area_weights)
    if "tex" in kinds:
        img = g.random((4, 4, 3), dtype=np.float32) + 0.5
        jb.rows[0]["color_tex"] = js.atlas_builder.add_array(img)
    for k in kinds:
        _add(k, jb, js.atlas_builder, g)
    js.data = js.data.replace(lights=jb.build(), atlas=js.atlas_builder.build())
    data, _, _ = scene_from_arrays(jax_scene_arrays(js), "cpu")
    return js, data


@pytest.fixture(scope="module", params=sorted(TABLES))
def scenes(request):
    return request.param, _scenes(request.param)


def _ref_points(n, seed):
    """Points inside the cornell box (x, z in [-1, 1], y in [0, 2])."""
    p = uniform(n, 3, seed)
    return (p * np.array([2.0, 1.9, 2.0], np.float32)
            - np.array([1.0, 0.0, 1.0], np.float32))


def close(b, a, atol=ATOL):
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=RTOL, atol=atol)


def test_table(scenes):
    """The table carried across: the feats, statics and packed rows."""
    name, (js, data) = scenes
    jl, tl = js.data.lights, data.lights
    assert tl.feats == jl.feats
    assert (tl.n_lights, tl.env_index, tl.env_prob) == (
        jl.n_lights, jl.env_index, jl.env_prob)
    if name == "sentinel":
        assert tl.feats == ("point",) and float(tl.color.abs().sum()) == 0.0


def test_select_light(scenes):
    _, (js, data) = scenes
    u = uniform(N, 1, 60)[:, 0]
    a = jlt.select_light(js.data.lights, jnp.asarray(u))
    b = tlt.select_light(data.lights, tt(u))
    np.testing.assert_array_equal(np_(b[0]), np.asarray(a[0]))
    close(b[1], a[1])
    close(b[2], a[2], atol=1e-5)
    lid = np.random.default_rng(61).integers(-1, data.lights.n_lights, N)
    close(tlt.light_pmf(data.lights, tt(lid)),
          jlt.light_pmf(js.data.lights, jnp.asarray(lid.astype(np.int32))))


def test_sample_wi(scenes):
    name, (js, data) = scenes
    ref, ng = _ref_points(N, 62), unit(N, 63)
    u_sel, u2 = uniform(N, 1, 64)[:, 0], uniform(N, 2, 65)
    la = jlt.sample_wi(js.data.lights, js.data.atlas, js.data.tri_pack,
                       jnp.asarray(ref), jnp.asarray(ng), jnp.asarray(u_sel),
                       jnp.asarray(u2), js.data.world_radius)
    lb = tlt.sample_wi(data.lights, data.atlas, data.tri_pack, tt(ref), tt(ng),
                       tt(u_sel), tt(u2), data.world_radius)
    for f in ("p_light", "wi", "L", "dist"):
        close(getattr(lb, f), getattr(la, f), atol=1e-5)
    close(lb.pdf, la.pdf, atol=1e-5)
    assert (np.asarray(la.L).max(-1) > 0).any() or name == "sentinel"
    if name in ("point", "spot", "proj", "dir"):
        assert (np_(lb.pdf) < 0).all()  # delta: pdf = -pmf


def test_env_radiance_and_pdf(scenes):
    _, (js, data) = scenes
    d = unit(N, 66)
    close(tlt.env_radiance(data.lights, data.atlas, tt(d)),
          jlt.env_radiance(js.data.lights, js.data.atlas, jnp.asarray(d)))
    # near the env's pole arccos of a float32 z ~ 1 amplifies the rotation's
    # rounding (1.6e-4 relative at theta = 0.019 on one lane of 4096)
    mostly_close(tlt.env_pdf_wi(data.lights, tt(d)),
                 jlt.env_pdf_wi(js.data.lights, jnp.asarray(d)), RTOL, 1e-5,
                 1e-3, share=0.001)


def test_eval_hit_area(scenes):
    """A scatter ray hitting the emitter quad: textured emission at the hit
    uv, the environment's share taken out of the selection pmf."""
    name, (js, data) = scenes
    tp = np.asarray(js.data.tri_pack)
    light_tris = np.where(tp[:, 26] >= 0)[0]
    g = np.random.default_rng(70)
    tri = g.choice(light_tris, N)
    b = uniform(N, 2, 71) * 0.5
    rows = tp[tri]
    hit_pos = rows[:, 0:3] + b[:, 0:1] * rows[:, 3:6] + b[:, 1:2] * rows[:, 6:9]
    ng = np.cross(rows[:, 3:6], rows[:, 6:9])
    ng = (ng / np.linalg.norm(ng, axis=-1, keepdims=True)).astype(np.float32)
    uv = ((1 - b.sum(1, keepdims=True)) * rows[:, 18:20]
          + b[:, 0:1] * rows[:, 20:22] + b[:, 1:2] * rows[:, 22:24])
    lid = np.where(g.random(N) < 0.8, 0, -1).astype(np.int32)
    ref = _ref_points(N, 72)
    La, pa = jlt.eval_hit_area(js.data.lights, jnp.asarray(lid),
                               jnp.asarray(tri), None, jnp.asarray(ref),
                               jnp.asarray(hit_pos), jnp.asarray(ng),
                               jnp.asarray(uv), js.data.atlas)
    Lb, pb = tlt.eval_hit_area(data.lights, tt(lid), tt(ref), tt(hit_pos),
                               tt(ng), tt(uv), data.atlas)
    close(Lb, La)
    close(pb, pa, atol=1e-5)


def test_builder_matches_jax():
    """The port's LightBuilder on the same lights builds the JAX package's
    table (bit for bit: numpy on the host in both)."""
    from vision_tpu.lights.lights import LightBuilder as JLB
    from vision_tpu.scene.texture import AtlasBuilder as JA
    from vision_tpu_torch.scene.texture import AtlasBuilder as TA
    g = np.random.default_rng(5)
    jb, tb_ = JLB("power", 0.3), tlt.LightBuilder("power", 0.3)
    ja, ta = JA(), TA()
    areas = g.random(7) + 0.1
    for b in (jb, tb_):
        b.add_area([4.0, 3.0, 2.0], 3, 10, areas, two_sided=True)
    for kind in ("point", "spot", "proj", "env", "dir"):
        state = g.bit_generator.state
        _add(kind, jb, ja, g)
        g.bit_generator.state = state
        _add(kind, tb_, ta, g)
    jt, tt_ = jb.build(), tb_.build("cpu")
    for f in ("ltype", "color", "color_tex", "position", "direction",
              "cos_angle", "cos_falloff", "tan_xy", "w2o", "two_sided",
              "inst_id", "total_area", "tri_offset", "tri_count", "a_prob",
              "a_alias", "a_pmf", "tri_base", "env_tex", "e_prob", "e_alias",
              "e_pmf", "sel_prob", "sel_alias", "sel_pmf", "ies_id",
              "ies_profiles"):
        np.testing.assert_array_equal(np_(getattr(tt_, f)),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert (tt_.feats, tt_.env_index, tt_.env_prob, tt_.env_w, tt_.env_h) == (
        jt.feats, jt.env_index, jt.env_prob, int(jt.env_w), int(jt.env_h))


# ---- tests/test_lights.py:67,94: the directional light

def test_directional_sample_wi_is_delta_and_correct():
    b = tlt.LightBuilder()
    b.add_directional([2.0, 3.0, 4.0], direction=[0.0, -1.0, 0.0])
    table = b.build("cpu")
    from vision_tpu_torch.scene.texture import AtlasBuilder
    ref = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.5, -1.0]])
    ls = tlt.sample_wi(table, AtlasBuilder().build("cpu"), torch.zeros((1, 32)),
                       ref, torch.tensor([[0.0, 1.0, 0.0]] * 2),
                       torch.tensor([0.3, 0.7]), torch.tensor([[0.1, 0.9]] * 2),
                       10.0)
    assert (np_(ls.pdf) < 0.0).all()
    np.testing.assert_allclose(np_(ls.wi), np.tile([0.0, 1.0, 0.0], (2, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(np_(ls.L), np.tile([2.0, 3.0, 4.0], (2, 1)),
                               atol=1e-6)
    assert (np_(ls.dist) >= 10.0).all()


def test_directional_renders_analytic_floor():
    """A white-ish floor under a straight-down directional light: L_out =
    albedo / pi (tests/test_lights.py)."""
    from vision_tpu_torch.integrator import pt as tpt
    scene = {
        "shapes": [{"type": "quad", "name": "floor",
                    "param": {"width": 2.0, "height": 2.0,
                              "material": "White"}}],
        "materials": [{"type": "diffuse", "name": "White",
                       "param": {"color": [0.8, 0.8, 0.8]}}],
        "camera": {"type": "thin_lens", "param": {
            "fov_y": 40,
            "transform": {"type": "look_at", "param": {
                "position": [0, 2.0, 0.01], "up": [0, 0, 1],
                "target_pos": [0, 0, 0]}},
            "radiance_collector": {"type": "normal",
                                   "param": {"resolution": [64, 64]}},
            "filter": {"type": "box", "param": {"radius": [0.5, 0.5]}}}},
        "integrator": {"type": "pt", "param": {"max_depth": 2}},
        "spectrum": {"type": "srgb", "param": {"dimension": 3}},
        "light_sampler": {"type": "uniform", "param": {"lights": [
            {"type": "directional",
             "param": {"color": [1, 1, 1], "direction": [0, -1, 0]}}]}},
        "output": {"spp": 4, "fn": "t.png"},
    }
    sc = vt.load_scene(scene, device="cpu")
    acc = 0.0
    for i in range(4):
        img, _ = tpt.render_sample(sc.data, sc.camera, sc.filter, i,
                                   max_depth=2)
        acc = acc + np_(img)
    c = (acc / 4)[24:40, 24:40].mean(axis=(0, 1))
    np.testing.assert_allclose(c, 0.8 / np.pi, rtol=0.05)
