"""Parity of the port's material compiler and gather
(`vision_tpu_torch/shading/materials.py`), its optical constants
(`spectra/spd.py`) and the host-side Fresnel and microfacet helpers with
the JAX package: every material type compiles to the same rows, a table
holding every type gathers the same per-lane parameters (textured slots
included), and constant node trees fold to the same values."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_materials import (MATERIALS, NAMES, build_tables,
                                   gather_both, uniform)
from tests.torch_parity import np_, tt
from vision_tpu.shading import fresnel as jfr, microfacet as jmf
from vision_tpu.spectra import spd as jspd
from vision_tpu_torch.shading import fresnel as tfr, microfacet as tmf
from vision_tpu_torch.scene.texture import AtlasBuilder as TAtlas
from vision_tpu_torch.shading import materials as tmat
from vision_tpu_torch.shading import shader_graph as tsg
from vision_tpu_torch.spectra import spd as tspd

torch.set_num_threads(2)

# the tolerances of tests/test_torch_shading.py (rtol 1e-4, atol 1e-6);
# the tables and gathered rows are compared bit for bit: both packages
# build them with numpy on the host and gather without arithmetic
RTOL = 1e-4
ATOL = 1e-6
N = 4096

LOBE_FIELDS = ("kd", "sigma", "diffuse_kind", "diffuse_weight", "spec_tint",
               "ax", "ay", "fr_mode", "eta", "eta3", "k3", "spec_weight",
               "trans_weight", "cc_weight", "cc_alpha", "sheen_weight",
               "sheen_tint", "flatness", "metallic", "sheen_alpha")


def _same_table(jt, pt_):
    for k in tmat.COLUMNS + tmat.OPTIONAL:
        a, b = getattr(jt, k), getattr(pt_, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(np_(b), np.asarray(a), err_msg=k)
    assert pt_.feats == jt.feats


def _compile_both(descs):
    from vision_tpu.scene.texture import AtlasBuilder
    from vision_tpu.shading.materials import MaterialCompiler as JMC
    jmc, tmc = JMC(AtlasBuilder()), tmat.MaterialCompiler(TAtlas())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for d in descs:
            assert jmc.compile(d) == tmc.compile(d)
    return jmc.build(), tmc.build("cpu")


@pytest.mark.parametrize("name", NAMES)
def test_compile_rows(name):
    """One material type alone: the same rows, feats and LUTs."""
    _same_table(*_compile_both([m for m in MATERIALS if m["name"] == name]))


def test_table_of_every_type():
    jt, pt_, _ = build_tables()
    _same_table(jt, pt_)
    assert set(pt_.feats) == {"diff", "spec", "trans", "cc", "sheen", "oren",
                              "blend", "disney", "mix2", "ems"}
    assert pt_.fr_modes == (0, 1, 2, 3, 4)


def _same_params(pa, pb, exact=True):
    for f in LOBE_FIELDS:
        a, b = np.asarray(getattr(pa, f)), np_(getattr(pb, f))
        if exact:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f)
    assert pb.feats == pa.feats


def test_gather_params_row_for_row():
    """Every field of every lane, mixtures' second rows and weights too,
    bit for bit, on a table holding every type (and invalid lanes)."""
    jt, pt_, ids = build_tables()
    mid = np.random.default_rng(1).integers(-1, jt.kd.shape[0], N).astype(
        np.int32)
    pa, pb = gather_both(jt, pt_, mid, uniform(N, 2, 2))
    _same_params(pa, pb)
    _same_params(pa.mix_b, pb.mix_b)
    for f in ("mix_wa", "mix_wb"):
        np.testing.assert_array_equal(np_(getattr(pb, f)),
                                      np.asarray(getattr(pa, f)))
    assert (np.asarray(pa.mix_wb) > 0).any()


def test_gather_params_textured_slots():
    """kd, spec, rough and frac textures resolved against the atlas: a
    JAX table whose rows point at atlas textures, carried across as
    arrays."""
    from vision_tpu.scene.texture import AtlasBuilder as JA
    from vision_tpu_torch.scene.texture import AtlasBuilder as TA
    jt, _, ids = build_tables()
    g = np.random.default_rng(3)
    ja, ta = JA(), TA()
    for shape in ((5, 7, 3), (4, 3, 3), (6, 6, 3)):
        im = g.random(shape, dtype=np.float32)
        assert ja.add_array(im) == ta.add_array(im)
    M = jt.kd.shape[0]
    tex = {k: np.where(np.arange(M) % 3 == i, i, -1).astype(np.int32)
           for i, k in enumerate(("kd_tex", "spec_tex", "rough_tex"))}
    tex["frac_tex"] = np.where(np.arange(M) == ids["mix"], 2, -1).astype(
        np.int32)
    tex["rough_remap"] = (np.arange(M) % 2).astype(np.int32)
    jt = jt.replace(**{k: jnp.asarray(v) for k, v in tex.items()})
    pt_ = tmat.MaterialTable(
        feats=jt.feats,
        **{k: tt(getattr(jt, k)) for k in tmat.COLUMNS + tmat.OPTIONAL})
    assert pt_.tex_slots == ("kd", "spec", "rough", "frac")
    mid = g.integers(0, M, N).astype(np.int32)
    uv = (g.random((N, 2)) * 3.0 - 1.0).astype(np.float32)
    pa, pb = gather_both(jt, pt_, mid, uv, ja.build(), ta.build("cpu"))
    _same_params(pa, pb, exact=False)
    _same_params(pa.mix_b, pb.mix_b, exact=False)
    for f in ("mix_wa", "mix_wb"):
        np.testing.assert_allclose(np_(getattr(pb, f)),
                                   np.asarray(getattr(pa, f)),
                                   rtol=RTOL, atol=ATOL)


def test_mix_material_rows():
    """tests/test_mixtures.py TestMixtureCompile: the parent row carries
    mat0, mix_b points at mat1's row, weights (frac, 1 - frac)."""
    jt, pt_ = _compile_both([{"type": "mix", "name": "m", "param": {
        "frac": 0.3,
        "mat0": {"type": "diffuse", "param": {"color": [1, 0, 0]}},
        "mat1": {"type": "mirror", "param": {"roughness": 0.01}}}}])
    _same_table(jt, pt_)
    mid = 2
    b = int(pt_.mix_b[mid])
    assert "mix2" in pt_.feats and b >= 0 and b != mid
    assert abs(float(pt_.mix_wa[mid]) - 0.3) < 1e-6
    assert abs(float(pt_.mix_wb[mid]) - 0.7) < 1e-6
    assert float(pt_.kd[mid][0]) == 1.0 and float(pt_.spec_weight[b]) == 1.0


def test_nested_mixture_flattens_with_a_warning():
    desc = {"type": "mix", "param": {
        "mat0": {"type": "add", "param": {
            "mat0": {"type": "diffuse", "param": {}},
            "mat1": {"type": "mirror", "param": {}}}},
        "mat1": {"type": "diffuse", "param": {}}}}
    with pytest.warns(UserWarning, match="flatten"):
        tmat.MaterialCompiler(TAtlas()).compile(desc)
    _same_table(*_compile_both([desc]))


def test_missing_image_takes_the_default():
    """An image slot whose file is missing takes the slot's default in both
    packages (an existing one loads: test_torch_images)."""
    descs = [{"type": "diffuse", "param": {"color": {"fn": "none.png"}}},
             {"type": "mirror", "param": {"roughness": {"fn": "none.png"}}},
             {"type": "metallic",
              "param": {"color": {"type": "multiply", "param": {
                  "lhs": {"fn": "none.png"}, "rhs": 2.0}}}}]
    _same_table(*_compile_both(descs))


CONST_TREES = {
    "scalar": 0.5,
    "vector": [0.1, 0.2, 0.3],
    "swizzle": {"channels": "zyx", "node": [0.1, 0.2, 0.3]},
    "number_node": {"type": "number", "param": {"value": [0.4, 0.5]}},
    "binary": {"type": "divide", "param": {"lhs": [1.0, 2.0, 3.0],
                                           "rhs": [2.0, 0.0, 4.0]}},
    "lerp": {"type": "lerp", "param": {"t": [0.2, 0.5, 0.8],
                                       "A": 0.0, "B": [1.0, 2.0, 3.0]}},
    "scale_clamp": {"type": "clamp", "param": {
        "value": {"type": "scale", "param": {"value": [0.3, 0.6, 0.9],
                                             "scale": 1.5}},
        "lower": 0.1, "upper": 1.0}},
    "nested": {"channels": "x", "node": {"type": "subtract", "param": {
        "lhs": {"type": "mul", "param": {"lhs": 2.0, "rhs": [0.25, 0.5]}},
        "rhs": 0.125}}},
}


@pytest.mark.parametrize("name", sorted(CONST_TREES))
def test_fold_const(name):
    from vision_tpu.shading.shader_graph import fold_slot
    a = fold_slot(CONST_TREES[name]).const
    b = tsg.fold_slot(CONST_TREES[name], ".").const
    np.testing.assert_array_equal(b, a)
    assert b.dtype == a.dtype


def test_metal_ior_rgb():
    assert tspd.METAL_NAMES == jspd.METAL_NAMES
    for name in tspd.METAL_NAMES + ["unobtainium"]:
        for x, y in zip(jspd.metal_ior_rgb(name), tspd.metal_ior_rgb(name)):
            np.testing.assert_array_equal(y, x)
        for x, y in zip(jspd.metal_complex_ior(name),
                        tspd.metal_complex_ior(name)):
            np.testing.assert_array_equal(y, x)


def test_glass_ior_scalar():
    assert tspd.GLASS_NAMES == jspd.GLASS_NAMES
    assert tspd._SELLMEIER == jspd._SELLMEIER
    for name in tspd.GLASS_NAMES + ["unknown"]:
        assert tspd.glass_ior_scalar(name) == jspd.glass_ior_scalar(name)


def test_host_fresnel_and_alpha():
    g = np.random.default_rng(4)
    ior = (1.0 + g.random(64) * 2.0).astype(np.float32)
    f0 = g.random(64).astype(np.float32)
    F0 = g.random((64, 3)).astype(np.float32)
    tint = g.random((64, 3)).astype(np.float32)
    for fn, args in (("schlick_F0_from_ior", (ior,)),
                     ("schlick_ior_from_F0", (f0,)),
                     ("f82_b_from_edge_tint", (F0, tint))):
        np.testing.assert_allclose(getattr(tfr, fn)(*args),
                                   np.asarray(getattr(jfr, fn)(*args)),
                                   rtol=RTOL, atol=ATOL, err_msg=fn)
    alpha = (g.random(64) * 0.5).astype(np.float32)
    aniso = np.concatenate([(g.random(60) * 1.8 - 0.9), np.zeros(4)]).astype(
        np.float32)
    for x, y in zip(jmf.calculate_alpha(alpha, aniso),
                    tmf.calculate_alpha(alpha, aniso)):
        np.testing.assert_array_equal(y, np.asarray(x))


def test_btdf_div_ft():
    from tests.torch_materials import unit
    wo, wi = unit(N, 5, upper=True), -unit(N, 6, upper=True)
    eta = (1.1 + uniform(N, 1, 7)[:, 0]).astype(np.float32)
    ax, ay = 0.05 + uniform(N, 2, 8).T * 0.5
    wh = wo + wi * eta[:, None]
    wh = (wh / np.linalg.norm(wh, axis=-1, keepdims=True)
          * np.sign(wh[:, 2:3])).astype(np.float32)
    a = jmf.btdf_div_ft(*(jnp.asarray(x) for x in (wo, wh, wi, eta, ax, ay)))
    b = tmf.btdf_div_ft(*(tt(x) for x in (wo, wh, wi, eta, ax, ay)))
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(a).max())))
