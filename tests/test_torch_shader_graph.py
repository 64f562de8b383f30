"""The port's shader graph (`vision_tpu_torch/shading/shader_graph.py`) and
its shade-time nodes against the JAX package, the counterparts of
tests/test_shader_graph.py: image-valued node trees bake to the same
arrays and atlas (:51-92), a baked calc node renders its colour, the bump
slot perturbs `compute_interaction`'s shading normal lane for lane (:145),
and a fresnel-driven mix (:222) and a vector-mapped texture (:250) give the
JAX package's radiance per lane and through `gather_params`."""
import copy
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.fixtures import CBOX_JSON
from tests.torch_parity import (assert_radiance_close, np_, radiance_both,
                                tt)
from tests.torch_scenes import asset
from vision_tpu.integrator import pt as jpt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu.scene.texture import AtlasBuilder as JAtlas
from vision_tpu.shading import materials as jmat
from vision_tpu.shading import shader_graph as jsg
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.scene.scene import Scene as TScene
from vision_tpu_torch.scene.texture import AtlasBuilder as TAtlas
from vision_tpu_torch.shading import materials as tmat
from vision_tpu_torch.shading import shader_graph as tsg

torch.set_num_threads(2)


def _img(tmp_path, name, arr):
    Image.fromarray(arr.astype(np.uint8)).save(tmp_path / name)
    return name


def _same_value(a, b):
    assert a.is_const == b.is_const
    np.testing.assert_array_equal(b.const if b.is_const else b.image,
                                  a.const if a.is_const else a.image)


def test_image_times_number_bakes(tmp_path):
    arr = np.zeros((4, 4, 3), np.uint8)
    arr[:2] = 255
    fn = _img(tmp_path, "t.png", arr)
    raw = {"type": "multiply", "param": {
        "lhs": {"fn": fn, "color_space": "linear"},
        "rhs": {"type": "number", "param": {"value": [0.5, 1.0, 0.25]}}}}
    v = tsg.fold_slot(raw, scene_dir=str(tmp_path))
    assert not v.is_const
    np.testing.assert_allclose(v.image[0, 0], [0.5, 1.0, 0.25], atol=1e-6)
    np.testing.assert_allclose(v.image[3, 0], [0.0, 0.0, 0.0], atol=1e-6)
    _same_value(jsg.fold_slot(raw, scene_dir=str(tmp_path)), v)


def test_mixed_resolution_bake(tmp_path):
    """Leaves of 2x2 and 4x6 bake at 4x6 by nearest index, as in JAX, under
    multiply, lerp with an image t, scale, clamp and a swizzle."""
    g = np.random.default_rng(0)
    fa = _img(tmp_path, "a.png", g.integers(0, 256, (2, 2, 3)))
    fb = _img(tmp_path, "b.png", g.integers(0, 256, (4, 6, 3)))
    a = {"fn": fa, "color_space": "linear"}
    b = {"fn": fb}
    trees = [
        {"type": "multiply", "param": {"lhs": a, "rhs": b}},
        {"type": "lerp", "param": {"t": {"channels": "x", "node": a},
                                   "A": b, "B": [0.2, 0.4, 0.6]}},
        {"channels": "zy", "node": {"type": "clamp", "param": {
            "value": {"type": "scale", "param": {"value": b, "scale": 3.0}},
            "lower": 0.1, "upper": 0.9}}},
        {"type": "divide", "param": {"lhs": 1.0, "rhs": a}},
    ]
    for raw, shape in zip(trees, ((4, 6), (4, 6), (4, 6), (2, 2))):
        v = tsg.fold_slot(raw, scene_dir=str(tmp_path))
        assert v.image.shape[:2] == shape
        _same_value(jsg.fold_slot(raw, scene_dir=str(tmp_path)), v)


def test_resolve_rgb_bakes_to_atlas(tmp_path):
    """Colour and scalar slots bake into the atlas in the JAX package's
    order and bytes; a missing image takes the default with a warning."""
    g = np.random.default_rng(1)
    fn = _img(tmp_path, "w.png", g.integers(0, 256, (4, 4, 3)))
    slots = [({"type": "scale", "param": {"value": {"fn": fn}, "scale": 0.5}},
              "rgb"),
             ({"fn": fn, "color_space": "linear"}, "scalar"),
             ({"channels": "x", "node": {"fn": fn}}, "rgb"),
             ({"fn": "missing.png"}, "rgb"),
             ([0.1, 0.2], "rgb")]
    ja, ta = JAtlas(), TAtlas()
    for raw, kind in slots:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if kind == "rgb":
                a = jsg.resolve_rgb(raw, ja, str(tmp_path), (0.3, 0.3, 0.3))
                b = tsg.resolve_rgb(raw, ta, str(tmp_path), (0.3, 0.3, 0.3))
            else:
                a = jsg.resolve_scalar(raw, ja, str(tmp_path), 0.7)
                b = tsg.resolve_scalar(raw, ta, str(tmp_path), 0.7)
        assert a == b, raw
    with pytest.warns(UserWarning, match="using default"):
        tsg.resolve_rgb({"fn": "missing.png"}, ta, str(tmp_path))
    np.testing.assert_array_equal(ta.build("cpu").data.numpy(),
                                  np.asarray(ja.build().data))


def _floor_calc_scene(res=16):
    return {
        "shapes": [{"type": "quad", "name": "floor", "param": {
            "width": 2.0, "height": 2.0, "material": "M"}}],
        "materials": [{"type": "diffuse", "name": "M", "param": {"color": {
            "type": "multiply", "param": {
                "lhs": {"fn": "white.png", "color_space": "linear"},
                "rhs": {"type": "number",
                        "param": {"value": [0.5, 0.25, 0.125]}}}}}}],
        "camera": {"type": "thin_lens", "param": {
            "fov_y": 40, "transform": {"type": "look_at", "param": {
                "position": [0, 2, 0.01], "up": [0, 0, 1],
                "target_pos": [0, 0, 0]}},
            "radiance_collector": {"type": "normal",
                                   "param": {"resolution": [res, res]}},
            "filter": {"type": "box", "param": {"radius": [0.5, 0.5]}}}},
        "integrator": {"type": "pt", "param": {"max_depth": 2}},
        "spectrum": {"type": "srgb", "param": {"dimension": 3}},
        "light_sampler": {"type": "uniform", "param": {"lights": [
            {"type": "directional", "param": {
                "color": [np.pi, np.pi, np.pi], "direction": [0, -1, 0]}}]}},
        "output": {"spp": 1, "fn": "t.png"},
    }


def test_scene_with_calc_node_renders_nonwhite(tmp_path):
    """A multiplied texture renders as the product (under a directional
    light of E = pi the floor shows its albedo), in both packages."""
    _img(tmp_path, "white.png", np.full((4, 4, 3), 255))
    s = _floor_calc_scene()
    js = JScene(s, scene_dir=str(tmp_path))
    ps = TScene(s, "cpu", scene_dir=str(tmp_path))
    ia, _ = jax.jit(lambda d, c, f, i: jpt.render_sample(d, c, f, i,
                                                         max_depth=2))(
        js.data, js.camera, js.filter, jnp.uint32(0))
    ib, _ = tpt.render_sample(ps.data, ps.camera, ps.filter, 0, max_depth=2)
    c = np_(ib)[6:10, 6:10].mean(axis=(0, 1))
    np.testing.assert_allclose(c, [0.5, 0.25, 0.125], rtol=0.05)
    np.testing.assert_allclose(np_(ib), np.asarray(ia), rtol=1e-5, atol=1e-6)


def _bump_scene(d):
    """The cbox whose back wall is a diffuse material with a tangent-space
    normal map tilting across x (tests/test_shader_graph.py:145)."""
    H = W = 16
    ang = np.linspace(-0.9, 0.9, W)[None, :]
    nm = np.zeros((H, W, 3), np.float32)
    nm[..., 0] = np.broadcast_to(np.sin(ang), (H, W))
    nm[..., 2] = np.broadcast_to(np.cos(ang), (H, W))
    Image.fromarray(np.clip((nm * 0.5 + 0.5) * 255 + 0.5, 0, 255).astype(
        np.uint8)).save(os.path.join(d, "bump.png"))
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [24, 24]
    s["materials"] = list(s["materials"]) + [{
        "type": "diffuse", "name": "bumpy", "param": {
            "color": [0.7, 0.7, 0.7],
            "bump": {"fn": "bump.png", "color_space": "linear"},
            "bump_scale": 1.0}}]
    s["shapes"][2]["param"]["material"] = "bumpy"
    s["shapes"][6]["param"]["material"] = "bumpy"  # the tall box too
    return s


def test_bump_slot_perturbs_shading_normals(tmp_path):
    """`compute_interaction`'s shading normal per lane equals the JAX
    package's on the same hits (the bumpy back wall and tall box
    included); it varies across the wall, and the render differs from the
    unbumped scene's."""
    s = _bump_scene(str(tmp_path))
    js = JScene(s, scene_dir=str(tmp_path))
    ps = TScene(s, "cpu", scene_dir=str(tmp_path))
    assert "nmap" in ps.data.materials.feats
    R = 24 * 24
    pix = np.arange(R)
    g = np.random.default_rng(2)
    p = (np.stack([pix % 24, pix // 24], -1) + g.random((R, 2))).astype(
        np.float32)
    jray = js.camera.generate_ray(jnp.asarray(p))
    jhit = jpt.trace_closest(js.data, jray)
    out_j = jpt.compute_interaction(js.data, jray, jhit)
    from vision_tpu_torch.core.types import Hit
    thit = Hit(t=tt(jhit.t), prim_id=tt(jhit.prim_id), bary=tt(jhit.bary),
               inst=tt(jhit.prim_id) * 0 - 1)
    out_t = tpt.compute_interaction(ps.data, thit)
    for k, (a, b) in enumerate(zip(out_j, out_t)):
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-5,
                                   atol=2e-6, err_msg=str(k))
    ns, mat = np_(out_t[2]), np_(out_t[5])
    wall = mat == ps.data.materials.kd.shape[0] - 1
    assert wall.sum() > 20 and ns[wall].std(axis=0).max() > 0.05
    plain = copy.deepcopy(s)
    plain["materials"][-1]["param"].pop("bump")
    pp = TScene(plain, "cpu", scene_dir=str(tmp_path))
    assert "nmap" not in pp.data.materials.feats
    ia, _ = tpt.render_wave(pp.data, pp.camera, pp.filter, 0, 2, max_depth=3)
    ib, _ = tpt.render_wave(ps.data, ps.camera, ps.filter, 0, 2, max_depth=3)
    assert not np.allclose(np_(ia), np_(ib), atol=5e-3)


def test_bump_render_matches_jax(tmp_path):
    """Per-lane radiance of the bumped cbox at depth 3."""
    s = _bump_scene(str(tmp_path))
    js = JScene(s, scene_dir=str(tmp_path))
    ps = TScene(s, "cpu", scene_dir=str(tmp_path))
    assert_radiance_close(*radiance_both(js, ps, 24))


# a texture tiled 4x over a unit wall (8 texels a tile) turns the
# barycentrics' float32 rounding, which differs between the two packages'
# sweeps by ~1e-6, into ~3e-5 of texel weight in the first-bounce albedo
TEXTURED_ALBEDO_ATOL = 1e-4


def _fresnel_cbox():
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [24, 24]
    s["materials"][2] = {"type": "diffuse", "name": "White", "param": {
        "color": {"type": "mix", "param": {
            "t": {"type": "fresnel", "param": {"ior": 1.5}},
            "A": [0.8, 0.1, 0.1], "B": [0.1, 0.1, 0.8]}}}}
    return s


def test_fresnel_mix_differs_from_baked_average():
    """The fresnel-driven floor and walls: the JAX package's radiance per
    lane; it differs from the static mean colour and varies with the view
    (tests/test_shader_graph.py:222)."""
    s = _fresnel_cbox()
    js, ps = JScene(s), TScene(s, "cpu")
    assert "fresmix" in ps.data.materials.feats
    row = ps.data.materials
    assert float(row.fres_ior[2]) == 1.5
    np.testing.assert_allclose(np_(row.kd[2]), [0.45, 0.1, 0.45], rtol=1e-6)
    La, aa, Lb, ab = radiance_both(js, ps, 24, max_depth=2)
    assert_radiance_close(La, aa, Lb, ab)
    s2 = copy.deepcopy(s)
    s2["materials"][2]["param"]["color"] = [0.45, 0.1, 0.45]
    p2 = TScene(s2, "cpu")
    assert "fresmix" not in p2.data.materials.feats
    _, _, L2, _ = radiance_both(JScene(s2), p2, 24, max_depth=2)
    assert np.abs(Lb - L2).mean() > 1e-3
    rb = Lb[:, 0] - Lb[:, 2]
    assert rb[Lb.sum(-1) > 1e-4].std() > 1e-3


def test_vector_mapping_scales_texture_lookup(tmp_path):
    """A 2x2 checker through vector_mapping (scale 4, a rotation and an
    offset): the JAX package's radiance per lane; the tiling changes the
    image (tests/test_shader_graph.py:250)."""
    img = np.zeros((8, 8, 3), np.uint8)
    img[:4, :4] = img[4:, 4:] = 255
    Image.fromarray(img).save(tmp_path / "checker.png")
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [24, 24]
    base = {"fn": "checker.png", "color_space": "srgb"}
    s["materials"][2] = {"type": "diffuse", "name": "White", "param": {
        "color": {"type": "vector_mapping", "param": {
            "node": base, "scale": [4.0, 4.0, 1.0],
            "rotation": [0.0, 0.0, 20.0], "location": [0.1, 0.2, 0.0]}}}}
    js = JScene(s, scene_dir=str(tmp_path))
    ps = TScene(s, "cpu", scene_dir=str(tmp_path))
    assert "uvmap" in ps.data.materials.feats
    La, aa, Lb, ab = radiance_both(js, ps, 24, max_depth=2)
    assert_radiance_close(La, aa, Lb, ab, albedo_atol=TEXTURED_ALBEDO_ATOL)
    s2 = copy.deepcopy(s)
    s2["materials"][2]["param"]["color"] = base
    p2 = TScene(s2, "cpu", scene_dir=str(tmp_path))
    _, _, L2, _ = radiance_both(JScene(s2, scene_dir=str(tmp_path)), p2, 24,
                                max_depth=2)
    assert np.abs(Lb - L2).mean() > 1e-3


def test_gather_params_shade_time_nodes():
    """`gather_params` with the uv transform, textured kd / spec / rough
    slots and the fresnel mix on |cos wo|, lane for lane against the JAX
    package on the same table, atlas, ids, uvs and cosines."""
    checker = {"fn": asset("checker.png")}
    descs = [
        {"type": "diffuse", "name": "a", "param": {"color": {
            "type": "vector_mapping", "param": {
                "node": checker, "scale": [3.0, 2.0, 1.0],
                "rotation": [0, 0, 35.0], "location": [0.3, -0.2, 0]}}}},
        {"type": "diffuse", "name": "b", "param": {"color": {
            "type": "lerp", "param": {
                "t": {"type": "fresnel", "param": {"ior": 1.33}},
                "A": checker, "B": [0.9, 0.2, 0.1]}}}},
        {"type": "mirror", "name": "c", "param": {
            "color": {"type": "vector_mapping", "param": {
                "node": checker, "scale": [0.5, 0.5, 1]}},
            "roughness": {"fn": asset("bumps.png")}}},
        {"type": "diffuse", "name": "d", "param": {"color": checker}},
        {"type": "diffuse", "name": "e", "param": {"color": {
            "type": "fresnel", "param": {"ior": 2.0}}}},
    ]
    ja, ta = JAtlas(), TAtlas()
    jmc, tmc = jmat.MaterialCompiler(ja), tmat.MaterialCompiler(ta)
    for d in descs:
        assert jmc.compile(d) == tmc.compile(d)
    jt, pt_ = jmc.build(), tmc.build("cpu")
    for k in tmat.COLUMNS:
        np.testing.assert_array_equal(np_(getattr(pt_, k)),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    assert pt_.feats == jt.feats and {"fresmix", "uvmap"} <= set(pt_.feats)
    n = 4096
    g = np.random.default_rng(5)
    mid = g.integers(-1, len(descs), n).astype(np.int32)
    uv = (g.random((n, 2)) * 4 - 2).astype(np.float32)
    cos = g.random(n).astype(np.float32)
    pa, _ = jmat.gather_params(jt, ja.build(), jnp.asarray(mid),
                               jnp.asarray(uv), cos_wo=jnp.asarray(cos))
    pb, _ = tmat.gather_params(pt_, ta.build("cpu"), tt(mid), tt(uv),
                               cos_wo=tt(cos))
    for f in ("kd", "spec_tint", "ax", "ay", "diffuse_weight", "spec_weight"):
        np.testing.assert_allclose(np_(getattr(pb, f)),
                                   np.asarray(getattr(pa, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
