"""The port's inverse rendering (`vision_tpu_torch.diff.optimize`) in the
style of `tests/test_diff.py`: gradients against central differences
(the same RNG streams, no Russian roulette), finite gradients, the
checkpointed bounce against the taped one, the parameter surface's keys,
Adam steps against optax, and the albedo and texture recoveries."""
import inspect
import os
import tempfile

import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import cbox, np_, tt
from tests.torch_scenes import (cbox_glass, cbox_glass_hero, cbox_tex,
                                cbox_zoo, tex_wall_cbox, wall_texture)
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.diff import optimize as opt
from vision_tpu_torch.integrator import pt as tpt

torch.set_num_threads(2)

WHITE = 2   # the cbox's "White" row


def small_scene(res=24):
    return vt.load_scene(cbox(res), device="cpu")


def _mean(sc, params, depth=2, frame=3):
    img = opt.render_with_params(sc.data, sc.camera, params, frame,
                                 max_depth=depth, device="cpu")
    return img.mean()


def _fd(f, x, idx, eps):
    xp, xm = x.clone(), x.clone()
    xp[idx] += eps
    xm[idx] -= eps
    return (float(f(xp)) - float(f(xm))) / (2 * eps)


def _ad(f, x, idx):
    x = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(f(x), x)
    assert torch.isfinite(g).all()
    return float(g[idx])


def test_light_color_gradient_matches_fd():
    """The image is linear in the light's radiance: AD = FD almost
    exactly."""
    sc = small_scene(24)
    f = lambda lc: _mean(sc, {"lights": {"color": lc}})  # noqa: E731
    lc0 = sc.data.lights.color
    for ch in range(3):
        ad, fd = _ad(f, lc0, (0, ch)), _fd(f, lc0, (0, ch), 1e-1)
        assert abs(ad - fd) < max(1e-5, 2e-2 * abs(fd)), (ch, ad, fd)


def test_image_is_linear_in_light_colour():
    """srgb and one area light: the image is exactly linear in the light's
    colour (doubling it doubles every pixel bit for bit), so
    sum_c color_c d mean / d color_c = mean (chip_smoke.py's full-width
    identity, to 1e-5 here)."""
    sc = small_scene(16)
    lc = sc.data.lights.color.clone().requires_grad_(True)

    def img(c):
        return opt.render_with_params(sc.data, sc.camera,
                                      {"lights": {"color": c}}, 0,
                                      max_depth=4, spp=2, device="cpu")
    m = img(lc).mean()
    g, = torch.autograd.grad(m, lc)
    assert abs(float((lc * g).sum()) - float(m)) <= 1e-5 * float(m)
    with torch.no_grad():
        assert torch.equal(img(lc * 2.0), img(lc) * 2.0)


def test_albedo_gradient_matches_fd():
    sc = small_scene(24)
    f = lambda kd: _mean(sc, {"materials": {"kd": kd}})  # noqa: E731
    kd0 = sc.data.materials.kd
    ad, fd = _ad(f, kd0, (WHITE, 1)), _fd(f, kd0, (WHITE, 1), 1e-3)
    assert fd > 0.0 and ad > 0.0
    assert abs(ad - fd) / abs(fd) < 0.05, (ad, fd)


def test_light_position_gradient_matches_fd():
    """An area light samples its triangles: its `position` takes no part,
    and AD and FD agree on that (both 0 to within FD's noise)."""
    sc = small_scene(16)
    f = lambda pos: _mean(sc, {"lights": {"position": pos}})  # noqa: E731
    pos0 = sc.data.lights.position
    ad, fd = _ad(f, pos0, (0, 1)), _fd(f, pos0, (0, 1), 1e-2)
    assert abs(ad - fd) / max(abs(fd), 1e-5) < 0.2, (ad, fd)


@pytest.mark.parametrize("make", [cbox, cbox_glass, cbox_glass_hero],
                         ids=["cbox", "cbox_glass", "cbox_glass_hero"])
def test_gradients_finite_everywhere(make):
    """Every leaf of the four groups has a finite gradient, GGX lobes and
    the hero decode included (the roots' zero gradient at their edge), and
    the camera's is non-zero (K1's closest hit carries it)."""
    sc = vt.load_scene(make(12), device="cpu")
    params = opt._leaves(opt.param_surface(sc.data, sc.camera, opt.GROUPS))
    loss = opt.make_loss(sc.data, sc.camera, np.zeros((12, 12, 3), np.float32),
                         max_depth=3, device="cpu")
    loss(params, 0).backward()
    for g, leaves in params.items():
        for k, v in leaves.items():
            assert v.grad is None or torch.isfinite(v.grad).all(), (g, k)
    assert params["camera"]["c2w"].grad.abs().max() > 0.0


@pytest.mark.parametrize("make", [cbox, cbox_glass_hero],
                         ids=["cbox", "cbox_glass_hero"])
def test_remat_matches_taped_bounce(make):
    """`radiance(remat=True)` (each bounce checkpointed and replayed in the
    backward) gives the gradients of the taped bounce to 1e-6; the hero
    rows are built before the loop, so the replay saves what the forward
    did."""
    sc = vt.load_scene(make(12), device="cpu")
    R = 144
    pix = torch.arange(R)
    cot = tt(np.random.default_rng(2).standard_normal((R, 3)).astype(np.float32))
    out = []
    for remat in (True, False):
        params = opt._leaves(opt.param_surface(sc.data, sc.camera, opt.GROUPS))
        d, cam = opt.apply_params(sc.data, sc.camera, params)
        p = torch.stack([(pix % 12).float() + 0.5, (pix // 12).float() + 0.5], -1)
        L, _ = tpt.radiance(d, cam.generate_ray(p), trng.seed(pix, 7),
                            max_depth=3, min_depth=99, remat=remat)
        leaves = [v for g in params.values() for v in g.values()]
        gs = torch.autograd.grad(L, leaves, cot, allow_unused=True)
        out.append([torch.zeros_like(v) if g is None else g
                    for v, g in zip(leaves, gs)])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(
            b.abs().max()))


@pytest.mark.parametrize("make", [cbox, cbox_glass, cbox_tex, cbox_zoo],
                         ids=["cbox", "cbox_glass", "cbox_tex", "cbox_zoo"])
def test_float_leaves_has_the_jax_key_set(make):
    """`float_leaves(materials)` and `param_surface` give the JAX package's
    keys, shapes and dtypes (the LUT columns where its table holds them)."""
    from vision_tpu.diff import optimize as jopt
    from vision_tpu.scene.scene import Scene as JScene
    desc = make(8) if make is not cbox_zoo else make(8, sub_div=16)
    js = JScene(desc)
    ps = vt.load_scene(desc, device="cpu")
    ja = jopt.param_surface(js.data, js.camera, jopt.GROUPS)
    pa = opt.param_surface(ps.data, ps.camera, opt.GROUPS)
    assert set(ja) == set(pa) == set(opt.GROUPS)
    for g in ja:
        assert set(ja[g]) == set(pa[g]), g
        for k in ja[g]:
            assert tuple(ja[g][k].shape) == tuple(pa[g][k].shape), (g, k)
            assert pa[g][k].dtype == torch.float32


def test_apply_params_leaves_no_stale_table():
    """New leaves reach the packed rows and the hero rows (made anew), and
    the light-selection tables stay as loaded, as in the JAX package."""
    sc = vt.load_scene(cbox_glass_hero(8), device="cpu")
    old_hero = sc.data.materials.hero_rows(sc.data.spectrum)
    kd = sc.data.materials.kd * 0.5
    lc = sc.data.lights.color * 3.0
    d, _ = opt.apply_params(sc.data, sc.camera,
                            {"materials": {"kd": kd}, "lights": {"color": lc}})
    assert d.materials._hero is None
    new_hero = d.materials.hero_rows(d.spectrum)
    assert new_hero is not old_hero
    assert not torch.equal(new_hero.rows, old_hero.rows)
    assert torch.equal(d.materials.packed.fetch(torch.arange(7))("kd"), kd)
    assert torch.equal(d.lights.packed.fetch(torch.arange(1))("color"), lc)
    assert d.lights.sel_prob is sc.data.lights.sel_prob
    assert d.lights.sel_pmf is sc.data.lights.sel_pmf


def test_optimize_materials_follows_optax():
    """Four Adam steps on the White row's kd: the port's losses follow the
    JAX package's (optax.adam, the same defaults) to 1e-3. The JAX package
    runs op by op: compiled, XLA's rounding sends one of the 144 paths
    another way, which alone moves the loss by 1%."""
    import jax
    import jax.numpy as jnp
    from vision_tpu.diff import optimize as jopt
    from vision_tpu.scene.scene import Scene as JScene
    desc = cbox(12)
    js = JScene(desc)
    ps = vt.load_scene(desc, device="cpu")
    target = np.asarray(jopt.render_with_params(
        js.data, js.camera, {"kd": js.data.materials.kd}, 0, max_depth=2))
    bad = js.data.materials.kd.at[WHITE].set(jnp.asarray([0.3, 0.3, 0.9]))
    with jax.disable_jit():
        _, la = jopt.optimize_materials(
            js.data.replace(materials=js.data.materials.replace(kd=bad)),
            js.camera, target, steps=4, lr=5e-2, max_depth=2, fixed_frame=0)
    from dataclasses import replace
    pbad = tt(np.asarray(bad))
    _, lb = opt.optimize_materials(
        replace(ps.data, materials=replace(ps.data.materials, kd=pbad)),
        ps.camera, target, steps=4, lr=5e-2, max_depth=2, fixed_frame=0,
        device="cpu")
    assert lb[-1] < lb[0]
    np.testing.assert_allclose(lb, la, rtol=1e-3)


def test_recover_wall_albedo():
    """Perturb the white walls' albedo and optimize it back to the
    target's (BASELINE config 5's spirit)."""
    from dataclasses import replace
    sc = small_scene(24)
    true_kd = sc.data.materials.kd
    target = opt.render_with_params(sc.data, sc.camera, {"kd": true_kd}, 0,
                                    max_depth=3, spp=2, device="cpu")
    bad_kd = true_kd.clone()
    bad_kd[WHITE] = torch.tensor([0.3, 0.3, 0.9])
    sc_bad = replace(sc.data, materials=replace(sc.data.materials, kd=bad_kd))
    params, losses = opt.optimize_materials(
        sc_bad, sc.camera, target.detach(), param_keys=("kd",), steps=60,
        lr=5e-2, max_depth=3, spp=2, fixed_frame=0, device="cpu")
    assert losses[-1] < losses[0] * 0.05, losses[::8]
    rec, tru = np_(params["kd"][WHITE]), np_(true_kd[WHITE])
    assert np.abs(rec - tru).max() < 0.08, (rec, tru)


def textured_scene(res=24):
    """The cbox with an image-textured back wall, its 8x8 texture written
    with the port's `film.to_png`, as `tests/test_diff.py` builds it."""
    from vision_tpu_torch.sensor import film
    path = os.path.join(tempfile.mkdtemp(), "wall.png")
    film.to_png(wall_texture(), path)
    return vt.load_scene(tex_wall_cbox(res, path), device="cpu")


def test_texture_texel_gradients_and_recovery():
    from dataclasses import replace
    sc = textured_scene(24)
    assert sc.data.atlas.data.shape[0] > 1, "texture never loaded"
    true = opt.param_surface(sc.data, sc.camera, ("atlas",))
    target = opt.render_with_params(sc.data, sc.camera, true, 5, max_depth=2,
                                    device="cpu")
    gray = replace(sc.data, atlas=replace(
        sc.data.atlas, data=torch.full_like(sc.data.atlas.data, 0.5)))
    _, losses = opt.optimize_scene(gray, sc.camera, target.detach(),
                                   groups=("atlas",), steps=24, lr=0.1,
                                   max_depth=2, fixed_frame=5, device="cpu")
    assert losses[-1] < losses[0] * 0.35, losses[::6]


ENTRY_POINTS = ("render_with_params", "make_loss", "optimize_materials",
                "optimize_scene", "params_from_arrays")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_run_on_the_card_by_default(name):
    """Every new entry point takes `device`, "cuda" unless the caller asks
    for another; a scene elsewhere raises instead of being followed."""
    fn = getattr(opt, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if name == "params_from_arrays":
        return
    sc = small_scene(4)
    target = np.zeros((4, 4, 3), np.float32)
    args = {"render_with_params": (sc.data, sc.camera, {}, 0),
            "make_loss": (sc.data, sc.camera, target)}.get(
        name, (sc.data, sc.camera, target))
    with pytest.raises(ValueError, match="device=cuda"):
        fn(*args)
