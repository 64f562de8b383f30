"""Gradient parity of the port (torch autograd) with the JAX package
(`jax.vjp`) on the same scene arrays, parameters, rays, RNG states and a
seeded-random per-pixel cotangent, through per-lane `radiance` with no
Russian roulette and each bounce checkpointed (BASELINE's pixel-gradient
criterion: rtol 1e-3, atol 1e-3 max|g| per leaf).

Cases: all four parameter groups on the cbox (K1, whose closest hit
carries the camera's gradient); kd, eta and roughness on `cbox_glass`;
kd under the hero spectrum on `cbox_glass_hero` (a stale hero row would
shade with the old kd); the atlas texels on `cbox_tex`; kd and the light
colour on the mesh scene (K2, whose hits are constants in both packages,
the JAX package on its packet path in interpret mode).

Reference-side deviation (ROADMAP C13): the JAX package's gradient with
respect to roughness, eta and the camera is NaN in every row wherever a
GGX lobe runs, because `sin_theta` takes sqrt(1 - cos^2) of a half vector
on the normal (and, under the hero spectrum, the sigmoid table's arcsin
meets |x| = 1 at a black colour), where the unselected branch of a select
makes 0 * inf. The port's roots have a zero gradient there
(`core.math.sqrt0`, `asin0`). The glass cases hold the port against the
JAX package with those two roots given the same zero gradient in this
process (its files unchanged); `test_reference_root_gradient_is_nan`
shows the fault itself.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_grad_close, cbox, radiance_vjp_both
from tests.torch_scenes import (cbox_glass, cbox_glass_hero, cbox_sphere,
                                cbox_tex)
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.shading.materials import COLUMNS, INT_COLUMNS

torch.set_num_threads(2)

# every float column of the material table (`float_leaves`)
ALL = {"materials": [c for c in COLUMNS if c not in INT_COLUMNS],
       "lights": ["color", "position", "direction"],
       "atlas": ["data"], "camera": ["c2w"]}


@contextlib.contextmanager
def _reference_roots_with_zero_gradient():
    """The JAX package's sin_theta and arcsin with the port's gradient at
    the root's edge (0 instead of inf), for this process only."""
    import vision_tpu.core.math as jm
    asin = jnp.arcsin

    @jax.custom_jvp
    def sqrt0(x):
        return jnp.sqrt(x)

    @sqrt0.defjvp
    def _sqrt0(p, t):
        y = jnp.sqrt(p[0])
        return y, jnp.where(y > 0.0, t[0] / (2.0 * jnp.where(y > 0.0, y, 1.0)),
                            0.0)

    @jax.custom_jvp
    def asin0(x):
        return asin(x)

    @asin0.defjvp
    def _asin0(p, t):
        x = p[0]
        inside = jnp.abs(x) < 1.0
        return asin(x), jnp.where(
            inside, t[0] * jax.lax.rsqrt(jnp.where(inside, 1.0 - x * x, 1.0)),
            0.0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "sin_theta", lambda w: sqrt0(jm.sin2_theta(w)))
        mp.setattr(jnp, "arcsin", asin0)
        yield


def _case(desc, params, res=16, depth=3, patch=False, packet=False,
          jit=False):
    with contextlib.ExitStack() as stack:
        if patch:
            stack.enter_context(_reference_roots_with_zero_gradient())
        if packet:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setenv("VT_PACKET", "1")
        js = JScene(desc)
        return radiance_vjp_both(js, params, res, max_depth=depth,
                                 jit=jit) + (js,)


@pytest.fixture(scope="module")
def cbox_grads():
    return _case(cbox(16), ALL, jit=True)


@pytest.fixture(scope="module")
def glass_grads():
    return _case(cbox_glass(16), {"materials": ["kd", "eta", "ax", "ay"]},
                 patch=True)


@pytest.fixture(scope="module")
def hero_grads():
    return _case(cbox_glass_hero(16), {"materials": ["kd", "glass_coeffs"]},
                 depth=2, patch=True)


@pytest.fixture(scope="module")
def tex_grads():
    return _case(cbox_tex(16), {"atlas": ["data"], "materials": ["kd"]},
                 depth=2, jit=True)


@pytest.fixture(scope="module")
def mesh_grads():
    return _case(cbox_sphere(16, sub_div=40),
                 {"materials": ["kd"], "lights": ["color"]}, depth=2,
                 packet=True, jit=True)


@pytest.mark.parametrize("leaf", [f"{g}.{k}" for g, ks in ALL.items()
                                  for k in ks])
def test_cbox_all_groups(cbox_grads, leaf):
    """Every group on the cbox (K1): materials, the area light, the atlas
    and the camera pose. An area light's position and direction take no
    part (zero in both), nor does the one-texel atlas."""
    ga, gb, *_ = cbox_grads
    g, k = leaf.split(".")
    assert_grad_close(ga[g][k], gb[g][k])


def test_cbox_camera_gradient_is_nonzero(cbox_grads):
    """K1's closest hit carries the pose's gradient in both packages."""
    ga, gb, *_ = cbox_grads
    assert np.abs(ga["camera"]["c2w"]).max() > 1.0
    assert np.abs(gb["camera"]["c2w"]).max() > 1.0


@pytest.mark.parametrize("key", ["kd", "eta", "ax", "ay"])
def test_glass(glass_grads, key):
    """kd, eta and roughness on `cbox_glass` (K1; GGX reflection and
    transmission). The mirror row's roughness (alpha 1e-6) is left out:
    its half vector lies within 1e-6 rad of the normal, where
    sin^2 = 1 - cos^2 is below float32's resolution and the split between
    the ax and ay gradients follows the last bits of cos (it differs
    between the packages by up to 0.7 of 5.9); the glass row (alpha 1e-4)
    is held."""
    ga, gb, _, _, js = glass_grads
    rows = None
    if key in ("ax", "ay"):
        rows = np.flatnonzero(np.asarray(js.data.materials.ax) > 1e-5)
        assert len(rows) == ga["materials"][key].shape[0] - 1
    assert_grad_close(ga["materials"][key], gb["materials"][key], rows=rows)


@pytest.mark.parametrize("key", ["kd", "glass_coeffs"])
def test_glass_hero(hero_grads, key):
    """kd and the Sellmeier coefficients under the hero spectrum: the hero
    rows are rebuilt from the new kd (a stale `_hero` gives kd a zero
    gradient)."""
    ga, gb, *_ = hero_grads
    assert np.abs(gb["materials"]["kd"]).max() > 0.1
    assert_grad_close(ga["materials"][key], gb["materials"][key])


@pytest.mark.parametrize("leaf", ["atlas.data", "materials.kd"])
def test_tex(tex_grads, leaf):
    """The atlas texels on `cbox_tex` (a scatter-add from the bilinear
    fetch), and kd."""
    ga, gb, *_ = tex_grads
    g, k = leaf.split(".")
    assert np.abs(gb[g][k]).max() > 0.0
    assert_grad_close(ga[g][k], gb[g][k])


@pytest.mark.parametrize("leaf", ["materials.kd", "lights.color"])
def test_mesh_scene(mesh_grads, leaf):
    """kd and the light colour on the mesh scene (K2 in the port, the
    packet path in the JAX package: hits are constants in both)."""
    ga, gb, *_ = mesh_grads
    g, k = leaf.split(".")
    assert_grad_close(ga[g][k], gb[g][k])


def test_reference_root_gradient_is_nan():
    """ROADMAP C13: the JAX package's cos_phi at a direction on the pole
    has a NaN gradient (0 * inf through sqrt at 0); the port's is 0."""
    import vision_tpu.core.math as jm
    import vision_tpu_torch.core.math as tm
    w = np.array([0.0, 0.0, 1.0], np.float32)
    gj = jax.grad(lambda v: jm.cos_phi(v) + jm.sin_phi(v))(jnp.asarray(w))
    assert np.isnan(np.asarray(gj)).any()
    x = torch.tensor(w, requires_grad=True)
    (tm.cos_phi(x) + tm.sin_phi(x)).backward()
    assert torch.equal(x.grad, torch.zeros(3))
