"""The port's lightmap bake (`vision_tpu_torch/pipelines/bake.py`) against
the JAX package's (`vision_tpu/pipelines/bake.py`) on the CPU: the host
stage (charts, texel maps, dilation) bit for bit; the device stage (the
texel radiance, before and after dilation) and the baked display per
texel and per pixel at the render parity tolerances (a lane whose path
meets a rounding-level decision may take another path: at most 1% of
them diverge, and the means agree within 0.5%); `sample_lightmap` at rtol
1e-6; the empty scene (ROADMAP C4); a bake through the BVH (K2's plain
walk); and, on the card, the bake against the CPU's."""
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import block_err, cbox, np_
from tests.torch_scenes import cbox_sphere
from vision_tpu.pipelines import bake as jb
from vision_tpu.render import render as jrender
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.pipelines import bake as tb

torch.set_num_threads(2)

LM, SPP, DEPTH = 64, 4, 2


def _geom(js):
    return tuple(np.asarray(getattr(js.data, k))
                 for k in ("tri_p0", "tri_e1", "tri_e2"))


def _assert_lanes(a, b, share=0.01):
    """Per-lane parity: at most `share` of the rows (texels, pixels)
    diverge beyond 1e-4 + 1e-3 |a|, and the means agree within 0.5%."""
    a = np.asarray(a).reshape(-1, 3)
    b = np_(b).reshape(-1, 3)
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(-1)
    assert bad.mean() <= share, bad.sum()
    assert a.mean() > 0.01
    assert abs(b.mean() / a.mean() - 1.0) < 0.005


def _capture_dilate(monkeypatch, mod, into):
    """Record the (lightmap, coverage) each package hands to `dilate`."""
    real = mod.dilate

    def spy(lm, covered, iterations=2):
        into.append((lm.copy(), covered.copy()))
        return real(lm, covered, iterations)

    monkeypatch.setattr(mod, "dilate", spy)


@pytest.fixture(scope="module")
def cbox_pair():
    s = cbox(24)
    return JScene(s), vt.load_scene(s, device="cpu")


@pytest.fixture(scope="module")
def bakes(cbox_pair):
    """The cbox baked by both packages at lightmap 64, 4 spp, depth 2:
    (JAX lightmap, charts, pre-dilation), the port's, and the port's
    stats."""
    js, ps = cbox_pair
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, mod, data in (("jax", jb, js.data), ("port", tb, ps.data)):
            seen = []
            _capture_dilate(mp, mod, seen)
            kw = {"stats": out.setdefault("stats", {})} if key == "port" else {}
            lm, charts = mod.bake_lightmap(data, LM, SPP, DEPTH, **kw)
            out[key] = (lm, charts, seen[0])
    return out


@pytest.mark.parametrize("res", [64, 128, 256])
def test_unwrap_charts_bit_for_bit(cbox_pair, res):
    """Charts of the cbox soup at three lightmap widths: uv0, uv1, uv2 and
    the atlas size equal to the last bit (test_subsystems.py:223)."""
    js, _ = cbox_pair
    a = jb.unwrap_charts(*_geom(js), res)
    b = tb.unwrap_charts(*_geom(js), res)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_unwrap_charts_mesh_bit_for_bit():
    """A 2,244-triangle sphere in the cbox: many charts, overlap
    evictions, and area ties resolved by the same unstable argsort."""
    g = vt.load_scene(cbox_sphere(16, sub_div=24), device="cpu").data.tri_geom
    g = np_(g)
    p0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    a = jb.unwrap_charts(p0, e1, e2, 128)
    b = tb.unwrap_charts(p0, e1, e2, 128)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    ta = jb.rasterize_texels(*a)
    tb_ = tb.rasterize_texels(*b)
    for x, y in zip(ta, tb_):
        np.testing.assert_array_equal(x, y)


def test_unwrap_triangles_bit_for_bit(cbox_pair):
    """The per-triangle packer (test_subsystems.py:53): equal charts,
    inside the atlas."""
    js, _ = cbox_pair
    a = jb.unwrap_triangles(*_geom(js), 128)
    b = tb.unwrap_triangles(*_geom(js), 128)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    uv0, _, _, (W, H) = b
    assert (uv0 >= 0).all() and (uv0[:, 0] <= W).all()


@pytest.mark.parametrize("unwrap", ["charts", "triangles"])
def test_rasterize_texels_bit_for_bit(cbox_pair, unwrap):
    """Texel -> (triangle, b1, b2) maps equal; the charts cover more of
    the atlas than the per-triangle packer (test_subsystems.py:223)."""
    js, _ = cbox_pair
    fn = {"charts": tb.unwrap_charts, "triangles": tb.unwrap_triangles}[unwrap]
    u = fn(*_geom(js), 128)
    a = jb.rasterize_texels(*u)
    b = tb.rasterize_texels(*u)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if unwrap == "charts":
        def used(uu):
            _, tx, ty, _, _ = tb.rasterize_texels(*uu)
            return len(set(zip(tx.tolist(), ty.tolist())))
        assert used(u) > used(tb.unwrap_triangles(*_geom(js), 128))


@pytest.mark.parametrize("edge", [False, True], ids=["inner", "edges"])
def test_dilate_bit_for_bit(edge):
    """Gutter dilation of a random lightmap; with `edges`, coverage on the
    atlas border, which `np.roll` wraps to the opposite side in both."""
    g = np.random.default_rng(3)
    lm = g.random((32, 48, 3)).astype(np.float32)
    cov = g.random((32, 48)) < 0.3
    if edge:
        cov[:, 0] = cov[0, :] = True
        cov[:, -1] = cov[-1, :] = False
    np.testing.assert_array_equal(tb.dilate(lm, cov), jb.dilate(lm, cov))


def test_bake_lightmap_matches_jax(bakes):
    """The cbox bake per texel, before dilation (the texel means and the
    coverage) and after; the charts equal; finite, lit, coverage > 0.2
    (test_subsystems.py:62)."""
    lm_a, ch_a, (pre_a, cov_a) = bakes["jax"]
    lm_b, ch_b, (pre_b, cov_b) = bakes["port"]
    for x, y in zip(ch_a, ch_b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(cov_a, cov_b)
    _assert_lanes(pre_a[cov_a], pre_b[cov_b])
    _assert_lanes(lm_a, lm_b)
    assert lm_b.dtype == np.float32 and np.isfinite(lm_b).all()
    assert lm_b.max() > 0.05
    assert (lm_b.sum(-1) > 0).mean() > 0.2


def test_bake_stats(bakes):
    """`stats`: one lane per covered texel, at least a ray per lane and
    pass, host and device seconds."""
    st = bakes["stats"]
    _, _, (_, cov) = bakes["port"]
    assert st["lanes"] >= cov.sum() > 0
    assert st["nrays"] >= st["lanes"] * SPP
    assert st["host_s"] > 0 and st["bake_s"] > 0


def test_render_baked_matches_jax(cbox_pair):
    """The display pass per pixel, each package reading its own bake; lit,
    and within (0.3, 3) of the path-traced mean (test_subsystems.py:137)."""
    js, ps = cbox_pair
    ja = np.asarray(jb.render_baked(js.data, js.camera,
                                    jb.bake_scene(js.data, LM, SPP, DEPTH)))
    baked = tb.bake_scene(ps.data, LM, SPP, DEPTH)
    assert baked.lm.device.type == "cpu"
    tbk = tb.render_baked(ps.data, ps.camera, baked)
    assert tbk.shape == (24, 24, 3) and torch.isfinite(tbk).all()
    _assert_lanes(ja, tbk)
    ratio = float(tbk.mean()) / float(np.asarray(jrender(js, spp=4)).mean())
    assert 0.3 < ratio < 3.0, ratio


def test_render_baked_same_lightmap(cbox_pair):
    """Both display passes on one lightmap (the JAX bake handed to the
    port): only the primary hit and the shading differ in rounding."""
    js, ps = cbox_pair
    lm, charts = jb.bake_lightmap(js.data, LM, SPP, DEPTH)
    a = np.asarray(jb.render_baked(js.data, js.camera,
                                   jb.BakedLightmap(lm, charts)))
    b = tb.render_baked(ps.data, ps.camera, tb.BakedLightmap(lm, charts, "cpu"))
    np.testing.assert_allclose(np_(b), a, rtol=1e-4, atol=1e-5)


def test_sample_lightmap_matches_jax():
    """Bilinear fetches at random surface points, taps at the atlas edges
    clamped, rtol 1e-6."""
    import jax.numpy as jnp
    g = np.random.default_rng(5)
    H, W, T, n = 16, 32, 8, 500
    lm = g.random((H, W, 3)).astype(np.float32)
    uv = (g.random((3, T, 2)) * [W, H]).astype(np.float32)
    tri = g.integers(0, T, n)
    b1 = g.random(n).astype(np.float32)
    b2 = ((1 - b1) * g.random(n)).astype(np.float32)
    a = jb.sample_lightmap(jnp.asarray(lm), *(jnp.asarray(u) for u in uv),
                           jnp.asarray(tri, jnp.int32), jnp.asarray(b1),
                           jnp.asarray(b2))
    b = tb.sample_lightmap(torch.as_tensor(lm),
                           *(torch.as_tensor(u) for u in uv),
                           torch.as_tensor(tri, dtype=torch.int32),
                           torch.as_tensor(b1), torch.as_tensor(b2))
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-6, atol=0)


def test_empty_scene_bakes_to_zero():
    """ROADMAP C4: for a scene without triangles the JAX bake raises
    ValueError (`unwrap_charts` returns two values where its caller takes
    four); the port's returns an all-zero lightmap and empty charts."""
    import types
    empty = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError):
        jb.bake_lightmap(types.SimpleNamespace(tri_p0=empty, tri_e1=empty,
                                               tri_e2=empty), 64, 1, 1)
    lm, charts = tb.bake_lightmap(
        types.SimpleNamespace(tri_geom=torch.zeros((0, 9))), 64, 1, 1)
    assert lm.shape == (4, 64, 3) and not lm.any()
    assert all(c.shape == (0, 2) for c in charts)


def test_bake_through_bvh_matches_jax():
    """A 2,244-triangle scene takes the BVH (the port's plain K2 walk; the
    JAX package's CPU walk): 404,241 lanes on the card, 1,818 here, not a
    multiple of any packet width; per texel at the parity tolerances."""
    s = cbox_sphere(16, sub_div=24)
    js, ps = JScene(s), vt.load_scene(s, device="cpu")
    assert ps.data.pbvh is not None
    st = {}
    lm_b, _ = tb.bake_lightmap(ps.data, LM, 2, DEPTH, stats=st)
    lm_a, _ = jb.bake_lightmap(js.data, LM, 2, DEPTH)
    assert st["lanes"] % 32 != 0
    _assert_lanes(lm_a, lm_b)


@pytest.mark.cuda
def test_bake_on_the_card_matches_cpu():
    """The cbox bake at lightmap 64, 4 spp, depth 2 through K1 on the card
    against the port's CPU bake, at the card-vs-CPU tolerance of
    chip_smoke.py's SDK check: 8x8 block error and bias <= 0.01."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    lm_c, _ = tb.bake_lightmap(vt.load_scene(cbox(24), device="cpu").data,
                               LM, SPP, DEPTH)
    lm_g, _ = tb.bake_lightmap(vt.load_scene(cbox(24), device="cuda").data,
                               LM, SPP, DEPTH)
    werr, bias = block_err(lm_g, lm_c)
    assert werr <= 0.01 and abs(bias) <= 0.01, (werr, bias)
