"""The port's image-backed and IES-shaped lights against the JAX package,
the counterparts of tests/test_lights.py:106, 151, 192 and 233 and
tests/test_subsystems.py TestIES: textured emission seen by camera rays and
by NEE, the `mix` environment combined at load time, and IES profiles
parsed, tabulated (bit for bit), evaluated and applied to a spot light."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.fixtures import CBOX_JSON
from tests.torch_parity import np_, tt
from tests.torch_scenes import asset
from vision_tpu.integrator import pt as jpt
from vision_tpu.lights import ies as jies
from vision_tpu.lights import lights as jlt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.lights import ies as ties
from vision_tpu_torch.lights import lights as tlt
from vision_tpu_torch.scene.scene import Scene as TScene

torch.set_num_threads(2)


def _floor_scene(lights, size=64):
    """A diffuse floor quad (y = 0, 2x2) seen from above
    (tests/test_lights.py `_floor_scene`)."""
    return {
        "shapes": [{"type": "quad", "name": "floor", "param": {
            "width": 2.0, "height": 2.0, "material": "White"}}],
        "materials": [{"type": "diffuse", "name": "White",
                       "param": {"color": [0.8, 0.8, 0.8]}}],
        "camera": {"type": "thin_lens", "param": {
            "fov_y": 40, "transform": {"type": "look_at", "param": {
                "position": [0, 2.0, 0.01], "up": [0, 0, 1],
                "target_pos": [0, 0, 0]}},
            "radiance_collector": {"type": "normal",
                                   "param": {"resolution": [size, size]}},
            "filter": {"type": "box", "param": {"radius": [0.5, 0.5]}}}},
        "integrator": {"type": "pt", "param": {"max_depth": 2}},
        "spectrum": {"type": "srgb", "param": {"dimension": 3}},
        "light_sampler": {"type": "uniform", "param": {"lights": lights}},
        "output": {"spp": 4, "fn": "t.png"},
    }


def _render_both(s, scene_dir, spp, max_depth=2):
    """render_sample averaged over frames 0..spp-1 in both packages."""
    js = JScene(s, scene_dir=scene_dir)
    ps = TScene(s, "cpu", scene_dir=scene_dir)
    fn = jax.jit(lambda d, c, f, i: jpt.render_sample(
        d, c, f, i, max_depth=max_depth)[0])
    a = sum(np.asarray(fn(js.data, js.camera, js.filter, jnp.uint32(i)))
            for i in range(spp)) / spp
    b = sum(np_(tpt.render_sample(ps.data, ps.camera, ps.filter, i,
                                  max_depth=max_depth)[0])
            for i in range(spp)) / spp
    return a, b


def _emit_png(tmp_path):
    arr = np.zeros((8, 8, 3), np.uint8)
    arr[:, 4:] = 255
    Image.fromarray(arr).save(tmp_path / "emit.png")


def test_emission_texture_modulates(tmp_path):
    """An emissive panel textured half black, half white: one side dark,
    the other bright, and the JAX package's image."""
    _emit_png(tmp_path)
    s = _floor_scene([], 32)
    s["shapes"] = [{"type": "quad", "name": "panel", "param": {
        "width": 2.0, "height": 2.0, "emission": {"type": "area", "param": {
            "color": {"fn": "emit.png", "color_space": "srgb"},
            "scale": 1.0, "two_sided": True}}}}]
    s["materials"] = []
    s["integrator"]["param"]["max_depth"] = 1
    a, b = _render_both(s, str(tmp_path), 1, max_depth=1)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    left, right = b[8:24, 2:14].mean(), b[8:24, 18:30].mean()
    lo, hi = min(left, right), max(left, right)
    assert hi > 0.5 and lo < 0.1 * hi


def test_nee_sees_texture(tmp_path):
    """NEE towards a small textured panel averages its texture: about half
    of the white panel's light on the floor, as in the JAX package."""
    _emit_png(tmp_path)

    def scene(color):
        s = _floor_scene([], 32)
        s["shapes"].append({"type": "quad", "name": "panel", "param": {
            "width": 0.3, "height": 0.3,
            "transform": {"type": "matrix4x4", "param": {"matrix4x4": [
                [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 1, 0], [0, 1.0, 0, 1]]}},
            "emission": {"type": "area", "param": {"color": color,
                                                   "scale": 1.0}}}})
        return s

    a_tex, b_tex = _render_both(scene({"fn": "emit.png"}), str(tmp_path), 8)
    _, b_wht = _render_both(scene([1.0, 1.0, 1.0]), str(tmp_path), 8)
    np.testing.assert_allclose(b_tex, a_tex, rtol=1e-4, atol=1e-5)
    cols = np.r_[0:6, 26:32]
    ratio = b_tex[:, cols].mean() / b_wht[:, cols].mean()
    assert 0.3 < ratio < 0.7


def test_mix_combines_two_envs(tmp_path):
    """`mix` of a 4x8 and an 8x16 .hdr: one spherical light whose
    radiance is scale0 env0 + scale1 env1 at the larger resolution; the
    table and the atlas are the JAX package's."""
    import cv2
    cv2.imwrite(str(tmp_path / "a.hdr"), np.full((4, 8, 3), 2.0, np.float32))
    cv2.imwrite(str(tmp_path / "b.hdr"), np.full((8, 16, 3), 3.0, np.float32))

    def env(fn):
        return {"type": "spherical",
                "param": {"color": {"fn": fn, "color_space": "linear"}}}

    s = _floor_scene([{"type": "mix", "param": {
        "env0": env("a.hdr"), "scale0": 0.5,
        "env1": env("b.hdr"), "scale1": 2.0}}])
    js = JScene(s, scene_dir=str(tmp_path))
    ps = TScene(s, "cpu", scene_dir=str(tmp_path))
    table = ps.data.lights
    assert table.env_index >= 0 and (table.env_w, table.env_h) == (16, 8)
    np.testing.assert_array_equal(np_(ps.data.atlas.data),
                                  np.asarray(js.data.atlas.data))
    d = torch.tensor([[0.3, 0.8, 0.5]])
    d = d / torch.linalg.norm(d)
    Lr = np_(tlt.env_radiance(table, ps.data.atlas, d))
    np.testing.assert_allclose(Lr, 0.5 * 2.0 + 2.0 * 3.0, rtol=1e-5)
    La = np.asarray(jlt.env_radiance(js.data.lights, js.data.atlas,
                                     jnp.asarray(np_(d))))
    np.testing.assert_array_equal(Lr, La)


IES_SAMPLE = """IESNA:LM-63-1995
[TEST] sample
TILT=NONE
1 1000 1 5 2 1 2 0 0 0
1 1 0
0 45 90 135 180
0 90
1000 800 500 200 0
1000 800 500 200 0
"""

# a TILT=INCLUDE profile of the 1991 header (no IESNA line): the tilt
# table is skipped
IES_TILT = """[TEST] tilted
TILT=INCLUDE
1
3
0 45 90
1.0 0.9
0.8
1 1000 2 3 1 1 2 0 0 0
1 1 0
0 60 90
0
700 350 0
"""


@pytest.mark.parametrize("text", [IES_SAMPLE, IES_TILT,
                                  open(asset("spot.ies")).read()],
                         ids=["sample", "tilt_include", "asset"])
def test_ies_parse_table_and_eval(text):
    """The parser reads the JAX package's angles and candela; the table is
    bit for bit; eval_ies within float32 rounding; peak on the axis."""
    a, b = jies.IESProfile.parse(text), ties.IESProfile.parse(text)
    for k in ("v_angles", "h_angles", "candela"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    assert b.max_candela == a.max_candela
    for n in (32, 64):
        np.testing.assert_array_equal(b.to_table(n), np.asarray(a.to_table(n)))
    tbl = b.to_table(32)
    cos = np.linspace(-1.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(
        np_(ties.eval_ies(torch.as_tensor(tbl), torch.as_tensor(cos))),
        np.asarray(jies.eval_ies(jnp.asarray(tbl), jnp.asarray(cos))),
        rtol=1e-5, atol=1e-6)
    if text is IES_SAMPLE:
        assert b.candela.shape == (2, 5) and b.max_candela == 1000.0
        v0 = float(ties.eval_ies(torch.as_tensor(tbl), torch.tensor(1.0)))
        v180 = float(ties.eval_ies(torch.as_tensor(tbl), torch.tensor(-1.0)))
        assert v0 > 0.95 and v180 < 0.05


def test_ies_profile_masks_spot(tmp_path):
    """A narrow IES profile on a wide spot (tests/test_lights.py:233): on
    the axis most of the light stays, 35 degrees off it none; the sampled
    radiance is the JAX package's."""
    (tmp_path / "narrow.ies").write_text("""IESNA:LM-63-1995
TILT=NONE
1 1000 1 5 1 1 2 0 0 0
1 1 0
0 10 20 45 90
0
1000 800 0 0 0
""")

    def build(with_ies):
        s = copy.deepcopy(CBOX_JSON)
        s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
            16, 16]
        spot = {"type": "spot", "param": {
            "color": [50, 50, 50], "position": [0, 1.9, 0],
            "direction": [0, -1, 0], "angle": 80.0, "falloff": 5.0}}
        if with_ies:
            spot["param"]["ies"] = "narrow.ies"
        s["light_sampler"]["param"]["lights"] = [spot]
        s["shapes"] = [sh for sh in s["shapes"] if sh.get("name") != "light"]
        return (JScene(s, scene_dir=str(tmp_path)),
                TScene(s, "cpu", scene_dir=str(tmp_path)))

    # the first point is on the spot's axis: there the cosine is 1 to an
    # ulp, which the two packages' normalisations round differently, and
    # arccos turns 1 - 2^-24 into 3.5e-4 rad, a 4e-4 step of the profile
    ref = np.asarray([[0.0, 0.3, 0.0], [-0.95, 1.6, 0.0]], np.float32)
    ns = np.asarray([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    u = np.asarray([0.1, 0.1], np.float32)
    L = {}
    for with_ies in (True, False):
        js, ps = build(with_ies)
        assert ("ies" in ps.data.lights.feats) == with_ies
        lb = tlt.sample_wi(ps.data.lights, ps.data.atlas, ps.data.tri_pack,
                           tt(ref), tt(ns), tt(u), torch.zeros((2, 2)),
                           ps.data.world_radius)
        la = jlt.sample_wi(js.data.lights, js.data.atlas, js.data.tri_pack,
                           jnp.asarray(ref), jnp.asarray(ns), jnp.asarray(u),
                           jnp.zeros((2, 2)), js.data.world_radius)
        np.testing.assert_allclose(np_(lb.L), np.asarray(la.L), rtol=1e-3,
                                   atol=1e-7)
        L[with_ies] = np_(lb.L)
    assert L[True][0].mean() > 0.5 * L[False][0].mean()
    assert L[True][1].mean() < 0.2 * L[False][1].mean()
