"""Parity of the port's shading and light modules with the JAX package on
the same seeded inputs: fresnel, microfacet, material gather, the diffuse
BSDF (evaluate / sample / albedo), alias tables, the texture atlas and the
area-light sampling and evaluation of the cornell box."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import cbox, np_, tt
from vision_tpu.lights import alias as jal, lights as jlt
from vision_tpu.shading import bsdf as jb, fresnel as jfr, microfacet as jmf
from vision_tpu.shading.materials import gather_params as j_gather
from vision_tpu_torch.lights import alias as tal, lights as tlt
from vision_tpu_torch.shading import bsdf as tb, fresnel as tfr, microfacet as tmf
from vision_tpu_torch.shading.materials import gather_params as t_gather

torch.set_num_threads(2)

# float32 shading math in another op order on the two backends; 1e-4
# relative covers the divisions by cosines near grazing
RTOL = 1e-4
ATOL = 1e-6
N = 4096


def _unit(n, seed, upper=False):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _u(n, k, seed):
    return np.random.default_rng(seed).random((n, k), dtype=np.float32)


def close(b, a, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def scenes():
    import vision_tpu_torch as vt
    from vision_tpu.scene.scene import Scene
    s = cbox(16)
    return Scene(s), vt.load_scene(s, device="cpu")


FRESNEL = {
    "schlick_weight": lambda m, c, e, k: (m.schlick_weight(c),),
    "fresnel_schlick": lambda m, c, e, k: (m.fresnel_schlick(e, c),),
    "fresnel_dielectric": lambda m, c, e, k: (m.fresnel_dielectric(c[:, None], e),),
    "fresnel_complex": lambda m, c, e, k: (m.fresnel_complex(c[:, None], e, k),),
    "fresnel_f82": lambda m, c, e, k: (m.fresnel_f82(c, e * 0.3, k * 0.1),),
}


def _f64_schlick_weight(c):
    m = np.clip(1.0 - c, 0.0, 1.0)
    return m ** 5


def _f64_fresnel_dielectric(ci, eta):
    sin2_t = (1.0 - ci ** 2) / eta ** 2
    ct = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    r_parl = (eta * ci - ct) / (eta * ci + ct)
    r_perp = (ci - eta * ct) / (ci + eta * ct)
    return np.where(sin2_t >= 1.0, 1.0, 0.5 * (r_parl ** 2 + r_perp ** 2))


def _f64_fresnel_complex(ci, er, ei):
    """|r_parl|^2 and |r_perp|^2 of the complex IOR er - i ei, in complex128."""
    ci = np.clip(ci, 0.0, 1.0)
    eta = er + 1j * ei
    ct = np.sqrt(1.0 - (1.0 - ci ** 2) / eta ** 2)
    rp = (eta * ci - ct) / (eta * ci + ct)
    rs = (ci - eta * ct) / (ci + eta * ct)
    return 0.5 * (np.abs(rp) ** 2 + np.abs(rs) ** 2)


def _f64_fresnel_f82(c, F0, b):
    m = np.clip(1.0 - c, 0.0, 1.0)
    return F0 + (1.0 - F0) * (m ** 5)[:, None] - b * (c * m ** 6)[:, None]


# each formula in float64 numpy, on the float32 inputs of test_fresnel
FRESNEL_F64 = {
    "schlick_weight": lambda c, e, k: _f64_schlick_weight(c),
    "fresnel_schlick": lambda c, e, k: e + (1.0 - e) * _f64_schlick_weight(c)[:, None],
    "fresnel_dielectric": lambda c, e, k: _f64_fresnel_dielectric(c[:, None], e),
    "fresnel_complex": lambda c, e, k: _f64_fresnel_complex(c[:, None], e, k),
    "fresnel_f82": lambda c, e, k: _f64_fresnel_f82(c, e * 0.3, k * 0.1),
}


@pytest.mark.parametrize("fn", sorted(FRESNEL))
def test_fresnel(fn):
    """Each package against a float64 evaluation of the same formula, both
    within the float32 tolerance, so a failure names the side that left the
    formula."""
    c = _u(N, 1, 0)[:, 0]
    e = 1.0 + _u(N, 3, 1) * 2.0
    k = _u(N, 3, 2) * 4.0
    ref = FRESNEL_F64[fn](*(x.astype(np.float64) for x in (c, e, k)))
    a = FRESNEL[fn](jfr, jnp.asarray(c), jnp.asarray(e), jnp.asarray(k))
    b = FRESNEL[fn](tfr, tt(c), tt(e), tt(k))
    for side, out in (("jax", a[0]), ("torch", b[0])):
        np.testing.assert_allclose(np_(out), ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{side} vs the float64 formula")


MICROFACET = {
    "D_ggx": lambda m, wo, wi, u, ax, ay: m.D_ggx(wo, ax, ay),
    "lambda_ggx": lambda m, wo, wi, u, ax, ay: m.lambda_ggx(wo, ax, ay),
    "G1_ggx": lambda m, wo, wi, u, ax, ay: m.G1_ggx(wo, ax, ay),
    "G_ggx": lambda m, wo, wi, u, ax, ay: m.G_ggx(wo, wi, ax, ay),
    "sample_wh_ggx": lambda m, wo, wi, u, ax, ay: m.sample_wh_ggx(wo, u, ax, ay),
    "pdf_wh_ggx": lambda m, wo, wi, u, ax, ay: m.pdf_wh_ggx(
        wo, m.sample_wh_ggx(wo, u, ax, ay), ax, ay),
    "brdf_div_fr": lambda m, wo, wi, u, ax, ay: m.brdf_div_fr(
        wo, m.sample_wh_ggx(wo, u, ax, ay), wi, ax, ay),
    "pdf_wi_reflection": lambda m, wo, wi, u, ax, ay: m.pdf_wi_reflection(
        ax, wo, m.sample_wh_ggx(wo, u, ax, ay)),
    "pdf_wi_transmission": lambda m, wo, wi, u, ax, ay: m.pdf_wi_transmission(
        ax, wo, m.sample_wh_ggx(wo, u, ax, ay), -wi, ay + 1.0),
}


@pytest.mark.parametrize("fn", sorted(MICROFACET))
def test_microfacet(fn):
    wo, wi = _unit(N, 3, upper=True), _unit(N, 4, upper=True)
    u = _u(N, 2, 5)
    ax = 0.05 + _u(N, 1, 6)[:, 0] * 0.9
    ay = 0.05 + _u(N, 1, 7)[:, 0] * 0.9
    a = MICROFACET[fn](jmf, *(jnp.asarray(x) for x in (wo, wi, u, ax, ay)))
    b = MICROFACET[fn](tmf, *(tt(x) for x in (wo, wi, u, ax, ay)))
    # atol scaled to the value range: D and pdfs reach ~1e3 near normal
    # incidence at low roughness
    close(b, a, atol=1e-5 * max(1.0, float(np.abs(np.asarray(a)).max())))


def _params(scenes, seed):
    js, ps = scenes
    g = np.random.default_rng(seed)
    mid = g.integers(-1, len(ps.data.materials.kd), N).astype(np.int32)
    uv = _u(N, 2, seed + 1)
    pa, _ = j_gather(js.data.materials, js.data.atlas, jnp.asarray(mid),
                     jnp.asarray(uv), js.data.spectrum, None)
    pb, disp = t_gather(ps.data.materials, ps.data.atlas, tt(mid), tt(uv))
    assert not disp.any()
    return pa, pb


def test_gather_params(scenes):
    pa, pb = _params(scenes, 10)
    assert pa.feats == pb.feats == ("diff",)
    for f in ("kd", "sigma", "diffuse_kind", "diffuse_weight", "spec_tint",
              "ax", "ay", "fr_mode", "eta", "eta3", "k3", "spec_weight",
              "trans_weight", "cc_weight", "cc_alpha", "sheen_weight",
              "sheen_tint", "flatness", "metallic"):
        assert np.array_equal(np_(getattr(pb, f)), np.asarray(getattr(pa, f))), f


@pytest.mark.parametrize("wo_side", ["upper", "both"])
def test_bsdf_evaluate_and_albedo(scenes, wo_side):
    pa, pb = _params(scenes, 20)
    wo = _unit(N, 21, upper=wo_side == "upper")
    wi = _unit(N, 22)
    ea = jb.evaluate(pa, jnp.asarray(wo), jnp.asarray(wi))
    eb = tb.evaluate(pb, tt(wo), tt(wi))
    close(eb.f, ea.f)
    close(eb.pdf, ea.pdf)
    close(tb.albedo(pb, tt(wo)), jb.albedo(pa, jnp.asarray(wo)))


def test_bsdf_sample(scenes):
    """Same RNG state in -> same state, direction, value and pdf out."""
    pa, pb = _params(scenes, 30)
    wo = _unit(N, 31)
    st = np.random.default_rng(32).integers(0, 2 ** 32, N, dtype=np.uint64)
    sa, ba = jb.sample(pa, jnp.asarray(wo), jnp.asarray(st.astype(np.uint32)))
    sb, bb = tb.sample(pb, tt(wo), tt(st.astype(np.int64)))
    assert np.array_equal(np.asarray(sa).astype(np.int64), np_(sb))
    assert np.array_equal(np.asarray(ba.valid), np_(bb.valid))
    close(bb.wi, ba.wi, atol=1e-5)
    close(bb.ev.f, ba.ev.f)
    close(bb.ev.pdf, ba.ev.pdf, atol=1e-5)
    close(bb.eta_scale, ba.eta_scale)


@pytest.mark.parametrize("n_rows", [1, 7, 300])
def test_alias_sample(n_rows):
    w = np.random.default_rng(n_rows).random(n_rows) + 0.01
    pj, aj, mj = jal.build_alias(w)
    pt_, at_, mt_ = tal.build_alias(w)
    assert np.array_equal(pj, pt_) and np.array_equal(aj, at_)
    u = _u(N, 1, 40)[:, 0]
    ra = jal.sample_alias(jnp.asarray(pj), jnp.asarray(aj), jnp.asarray(mj),
                          jnp.asarray(u))
    rb = tal.sample_alias(tt(pt_), tt(at_), tt(mt_), tt(u))
    assert np.array_equal(np.asarray(ra[0]), np_(rb[0]))
    for x, y in zip(ra[1:], rb[1:]):
        close(y, x, atol=1e-6)


def test_texture_sample():
    from vision_tpu.scene.texture import AtlasBuilder as JA
    from vision_tpu_torch.scene.texture import AtlasBuilder as TA
    g = np.random.default_rng(50)
    imgs = [g.random((5, 7, 3), dtype=np.float32),
            g.random((4, 3, 3), dtype=np.float32)]
    ja, ta = JA(), TA()
    for im in imgs:
        assert ja.add_array(im) == ta.add_array(im)
    jat, tat = ja.build(), ta.build("cpu")
    tex = g.integers(0, 2, N).astype(np.int32)
    uv = (g.random((N, 2)) * 4.0 - 2.0).astype(np.float32)
    close(tat.sample(tt(tex), tt(uv)), jat.sample(jnp.asarray(tex),
                                                  jnp.asarray(uv)), atol=1e-6)


def _ref_points(n, seed):
    """Points inside the cornell box (x, z in [-1, 1], y in [0, 2])."""
    p = _u(n, 3, seed)
    return (p * np.array([2.0, 1.9, 2.0], np.float32)
            - np.array([1.0, 0.0, 1.0], np.float32))


def test_light_sample_wi(scenes):
    js, ps = scenes
    ref = _ref_points(N, 60)
    u_sel = _u(N, 1, 61)[:, 0]
    u2 = _u(N, 2, 62)
    la = jlt.sample_wi(js.data.lights, js.data.atlas, js.data.tri_pack,
                       jnp.asarray(ref), jnp.asarray(_unit(N, 63)),
                       jnp.asarray(u_sel), jnp.asarray(u2),
                       js.data.world_radius)
    lb = tlt.sample_wi(ps.data.lights, ps.data.atlas, ps.data.tri_pack,
                       tt(ref), tt(_unit(N, 63)), tt(u_sel), tt(u2),
                       ps.data.world_radius)
    for f in ("p_light", "wi", "L", "dist"):
        close(getattr(lb, f), getattr(la, f), atol=1e-5)
    # pdf ~ r^2 / cos: relative
    close(lb.pdf, la.pdf, atol=1e-5)


def test_eval_hit_area(scenes):
    js, ps = scenes
    light_tris = np.where(np.asarray(js.data.tri_pack)[:, 26] >= 0)[0]
    g = np.random.default_rng(70)
    tri = g.choice(light_tris, N)
    b = _u(N, 2, 71) * 0.5
    rows = np.asarray(js.data.tri_pack)[tri]
    hit_pos = rows[:, 0:3] + b[:, 0:1] * rows[:, 3:6] + b[:, 1:2] * rows[:, 6:9]
    ng = np.cross(rows[:, 3:6], rows[:, 6:9])
    ng = (ng / np.linalg.norm(ng, axis=-1, keepdims=True)).astype(np.float32)
    lid = np.where(g.random(N) < 0.8, rows[:, 26], -1).astype(np.int32)
    ref = _ref_points(N, 72)
    La, pa = jlt.eval_hit_area(js.data.lights, jnp.asarray(lid),
                               jnp.asarray(tri), None, jnp.asarray(ref),
                               jnp.asarray(hit_pos), jnp.asarray(ng), None,
                               js.data.atlas)
    Lb, pb = tlt.eval_hit_area(ps.data.lights, tt(lid), tt(ref), tt(hit_pos),
                               tt(ng))
    assert (np.asarray(La).max(-1) > 0).any()
    close(Lb, La)
    close(pb, pa, atol=1e-5)
    close(tlt.light_pmf(ps.data.lights, tt(lid)),
          jlt.light_pmf(js.data.lights, jnp.asarray(lid)))
