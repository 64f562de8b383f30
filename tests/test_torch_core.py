"""Parity of the port's core, sensor and filter modules with the JAX package
(vision_tpu_torch.core / sensor vs vision_tpu.core / sensor) on the same
numpy inputs made from a seed."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import cbox, np_, tt
from vision_tpu.core import math as jm, rng as jr, transform as jxf, warp as jw
from vision_tpu_torch.core import math as tm, rng as tr, transform as txf, warp as tw

torch.set_num_threads(2)

# float32 ops run in another order / with other libm calls on the two
# backends: a few ULPs
RTOL = 1e-5
ATOL = 1e-6


def _u(n, k, seed=0):
    return np.random.default_rng(seed).random((n, k), dtype=np.float32)


class TestRng:
    """The PCG stream must match bit for bit."""

    def test_seed_bit_exact(self):
        g = np.random.default_rng(1)
        pix = g.integers(0, 2 ** 32, 4096, dtype=np.uint64)
        smp = g.integers(0, 2 ** 32, 4096, dtype=np.uint64)
        a = np.asarray(jr.seed(jnp.asarray(pix.astype(np.uint32)),
                               jnp.asarray(smp.astype(np.uint32))))
        b = tr.seed(tt(pix.astype(np.int64)), tt(smp.astype(np.int64)))
        assert np.array_equal(a.astype(np.int64), np_(b))

    @pytest.mark.parametrize("draw", ["next_1d", "next_2d", "next_3d"])
    def test_draws_bit_exact(self, draw):
        st = np.random.default_rng(2).integers(0, 2 ** 32, 4096,
                                               dtype=np.uint64)
        sa, ua = getattr(jr, draw)(jnp.asarray(st.astype(np.uint32)))
        sb, ub = getattr(tr, draw)(tt(st.astype(np.int64)))
        assert np.array_equal(np.asarray(sa).astype(np.int64), np_(sb))
        assert np.array_equal(np.asarray(ua), np_(ub))

    def test_stream_key_wraps(self):
        """The wavefront's stream key frame0 * 0x9E3779B9 + sample wraps at
        2^32 in both packages."""
        pix = np.arange(64, dtype=np.uint32)
        key = (7 * 0x9E3779B9 + 5) & 0xFFFFFFFF
        a = jr.seed(jnp.asarray(pix), jnp.uint32(7) * jnp.uint32(0x9E3779B9)
                    + jnp.uint32(5))
        b = tr.seed(tt(pix.astype(np.int64)), key)
        assert np.array_equal(np.asarray(a).astype(np.int64), np_(b))


WARPS_1 = ["square_to_disk", "square_to_disk_concentric",
           "square_to_cosine_hemisphere", "square_to_triangle",
           "square_to_sphere", "square_to_hemisphere"]


@pytest.mark.parametrize("fn", WARPS_1)
def test_warp(fn):
    u = _u(4096, 2)
    a = getattr(jw, fn)(jnp.asarray(u))
    b = getattr(tw, fn)(tt(u))
    # atol 1e-5: sqrt(1 - r^2) at the disk rim turns a 1-ULP sin/cos
    # difference into ~3e-6 absolute
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=RTOL, atol=1e-5)


def test_warp_cone_and_pdfs():
    u = _u(4096, 2, 3)
    c = np.float32(0.8)
    np.testing.assert_allclose(np_(tw.square_to_cone(tt(u), c)),
                               np.asarray(jw.square_to_cone(jnp.asarray(u), c)),
                               rtol=RTOL, atol=ATOL)
    f, g = _u(4096, 1, 4)[:, 0], _u(4096, 1, 5)[:, 0]
    for name in ("balance_heuristic", "power_heuristic", "mis_weight"):
        np.testing.assert_allclose(
            np_(getattr(tw, name)(tt(f), tt(g))),
            np.asarray(getattr(jw, name)(jnp.asarray(f), jnp.asarray(g))),
            rtol=RTOL, atol=ATOL)
    n = _u(4096, 3, 6) - 0.5
    w = _u(4096, 3, 7) - 0.5
    # keep |cos| away from 0, where 1/cos turns ULPs into large errors
    keep = np.abs((n * w).sum(-1)) > 0.05 * np.linalg.norm(
        n, axis=-1) * np.linalg.norm(w, axis=-1)
    f, n, w = f[keep], n[keep], w[keep]
    for name in ("pdf_wi_from_point", "pdf_point_from_wi"):
        np.testing.assert_allclose(
            np_(getattr(tw, name)(tt(f), tt(n), tt(w))),
            np.asarray(getattr(jw, name)(jnp.asarray(f), jnp.asarray(n),
                                         jnp.asarray(w))),
            rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(tw.sample_tent(tt(f), 1.5)),
                               np.asarray(jw.sample_tent(jnp.asarray(f), 1.5)),
                               rtol=RTOL, atol=ATOL)


VEC_FNS = ["normalize", "coordinate_system", "spherical_theta",
           "spherical_phi", "sin_theta", "tan2_theta", "cos_phi", "sin_phi",
           "luminance"]


@pytest.mark.parametrize("fn", VEC_FNS)
def test_math_unary(fn):
    v = _u(4096, 3, 8) * 2.0 - 1.0
    n = v / np.linalg.norm(v, axis=-1, keepdims=True)
    a = getattr(jm, fn)(jnp.asarray(n))
    b = getattr(tm, fn)(tt(n))
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        np.testing.assert_allclose(np_(y), np.asarray(x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["cross", "face_forward", "reflect", "dot"])
def test_math_binary(fn):
    a = _u(4096, 3, 9) * 2.0 - 1.0
    b = _u(4096, 3, 10) * 2.0 - 1.0
    np.testing.assert_allclose(
        np_(getattr(tm, fn)(tt(a), tt(b))),
        np.asarray(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b))),
        rtol=RTOL, atol=ATOL)


def test_math_refract_and_frames():
    v = _u(2048, 3, 11) * 2.0 - 1.0
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (2048, 1))
    eta = np.full(2048, 1.5, np.float32)
    va, wa = jm.refract(jnp.asarray(v), jnp.asarray(n), jnp.asarray(eta))
    vb, wb = tm.refract(tt(v), tt(n), tt(eta))
    assert np.array_equal(np.asarray(va), np_(vb))
    np.testing.assert_allclose(np_(wb), np.asarray(wa), rtol=RTOL, atol=ATOL)
    t, b = jm.coordinate_system(jnp.asarray(v))
    loc_a = jm.to_world(t, b, jnp.asarray(v), jm.to_local(t, b, jnp.asarray(v),
                                                          jnp.asarray(n)))
    tb, bb = tm.coordinate_system(tt(v))
    loc_b = tm.to_world(tb, bb, tt(v), tm.to_local(tb, bb, tt(v), tt(n)))
    np.testing.assert_allclose(np_(loc_b), np.asarray(loc_a), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("tdesc", [
    None,
    {"type": "matrix4x4", "param": {"matrix4x4": [[0, 2, 0, 0], [4, 0, 0, 0],
                                                  [0, 0, -2, 0], [-1, 1, 0, 1]]}},
    {"type": "look_at", "param": {"position": [0, 1, 6.8], "up": [0, 1, 0],
                                  "target_pos": [0, 1, 0]}},
    {"type": "Euler", "param": {"yaw": 30, "pitch": 10, "roll": 5}},
    {"type": "trs", "param": {"t": [1, 2, 3], "r": [0, 1, 0, 45], "s": 2}},
])
def test_transform_from_json(tdesc):
    assert np.array_equal(txf.from_json(tdesc), jxf.from_json(tdesc))


def test_camera_rays():
    """Camera rays of the cbox camera at 32^2 (thin lens, random film and
    lens samples)."""
    import vision_tpu_torch as vt
    from vision_tpu.scene.scene import Scene
    s = cbox(32)
    s["camera"]["param"]["lens_radius"] = 0.05
    js = Scene(s)
    ps = vt.load_scene(s, device="cpu")
    p_film = _u(1024, 2, 12) * 32.0
    u_lens = _u(1024, 2, 13)
    ra = js.camera.generate_ray(jnp.asarray(p_film), jnp.asarray(u_lens))
    rb = ps.camera.generate_ray(tt(p_film), tt(u_lens))
    np.testing.assert_allclose(np_(rb.origin), np.asarray(ra.origin),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(rb.direction), np.asarray(ra.direction),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ftype", ["box", "gaussian", "mitchell"])
def test_filter_sample(ftype):
    """FIS filter sampling: the box fast path and the alias path."""
    from vision_tpu.sensor.filters import FilterSampler as JF
    from vision_tpu_torch.sensor.filters import FilterSampler as TF
    params = {"radius": [1.5, 1.5]}
    u = _u(4096, 2, 14)
    oa, wa = JF.make(ftype, params).sample(jnp.asarray(u))
    ob, wb = TF.make(ftype, params, "cpu").sample(tt(u))
    np.testing.assert_allclose(np_(ob), np.asarray(oa), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(wb), np.asarray(wa), rtol=RTOL, atol=ATOL)


def test_film_postprocess():
    from vision_tpu.sensor import film as jf
    from vision_tpu_torch.sensor import film as tf
    x = _u(64, 3, 15) * 2.0
    for mode in ("linear", "aces", "reinhard"):
        a = jf.linear_to_srgb(jf.tonemap(jnp.asarray(x), mode, 1.3))
        b = tf.linear_to_srgb(tf.tonemap(tt(x), mode, 1.3))
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=RTOL, atol=ATOL)


# the real-time loop's modules (slice 6), which the walk must reach
REALTIME_MODULES = (
    "integrator.realtime", "integrator.restir", "integrator.restir_gi",
    "sensor.gbuffer", "caches.sharc", "caches.surfel", "post.svgf",
    "post.upsample", "post.denoise", "integrator.pt")


def test_import_without_jax():
    """The port imports no jax or flax: every module, the real-time loop's
    ten among them, imports with both blocked in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import vision_tpu_torch\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(vision_tpu_torch.__path__, "
        "'vision_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    seen.add(m.name)\n"
        f"assert {{'vision_tpu_torch.' + m for m in {REALTIME_MODULES!r}}} "
        "<= seen, seen\n"
        "assert not any(k in ('jax', 'flax', 'vision_tpu') or k.startswith("
        "('jax.', 'flax.', 'vision_tpu.')) for k, v in sys.modules.items() "
        "if v is not None)\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("user_value", [None, "COMPATIBLE"])
def test_import_pins_mkl_code_path(user_value):
    """Importing the port pins MKL to its reproducible AVX2 code path before
    any op runs (its AVX-512 sqrt can return one thread's chunk at rsqrt
    accuracy on a process's first call), and keeps a value the user set.
    The first threaded sqrt of the fresh process is then correctly rounded
    to within 1 ulp."""
    code = (
        "import os, numpy as np, torch\n"
        "import vision_tpu_torch\n"
        "torch.set_num_threads(8)\n"
        "x = np.random.default_rng(0).random(12288, dtype=np.float32) + 0.5\n"
        "y = torch.sqrt(torch.as_tensor(x)).numpy().astype(np.float64)\n"
        "rel = np.abs(y / np.sqrt(x.astype(np.float64)) - 1.0).max()\n"
        "print(os.environ['MKL_CBWR'], rel < 1.2e-7)\n")
    env = {k: v for k, v in os.environ.items() if k != "MKL_CBWR"}
    if user_value:
        env["MKL_CBWR"] = user_value
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [user_value or "AVX2", "True"]
