"""The port's real-time loop (`integrator/realtime.py`) against the JAX
package's, whole frames from the same initial state: four frames of the
cornell box at 32^2 with SHARC, with the surfel cache, with GI at half
resolution and with a camera that moves between frames; one frame of
`cbox_tex` (images, IES, a textured emitter sampled by the DI pass) and
one of `cbox_sphere` through the BVH (K2's plain walk). Both loops draw the
same samples, so the frames agree up to the last bits until frame 3. There
SVGF's history reaches 4 and its variance becomes the temporal m2 - m1^2,
which cancels on pixels whose light hardly changes between frames: the
last-bit differences of the float sums (the caches' scatter-adds, XLA's
and torch's rounding) grow into another luminance sigma there. Measured on
the CPU: frames 0-2 within 1e-6 block error with no parted pixel, frame 3
with 1-4.3% of pixels parted and block error <= 8e-5. So at most PARTED
of the pixels may part past the per-lane tolerance of the other parity
tests, the 8x8-block weighted error and |bias| stay within BLOCK and the
means within MEAN. Also the JAX package's behavioural checks of
tests/test_realtime.py, on the port alone."""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import block_err, cbox, np_, tt
from tests.torch_scenes import cbox_sphere, cbox_tex
from vision_tpu.integrator import realtime as jrt
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.caches.sharc import SharcCache
from vision_tpu_torch.caches.surfel import SurfelPool
from vision_tpu_torch.integrator import realtime as trt

torch.set_num_threads(2)

RES = 32
FRAMES = 4
PARTED = 0.08   # share of pixels that may part (per-lane tolerance below)
BLOCK = 0.002   # 8x8-block weighted error and |bias|
MEAN = 0.001    # relative difference of the means


def assert_frames_close(a, b):
    """Port frame b against JAX frame a."""
    a, b = np.asarray(a), np_(b)
    assert a.shape == b.shape and np.isfinite(b).all()
    parted = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(-1).mean()
    werr, bias = block_err(b, a)
    assert parted <= PARTED, parted
    assert werr <= BLOCK and abs(bias) <= BLOCK, (werr, bias)
    assert abs(b.mean() / a.mean() - 1.0) <= MEAN, (b.mean(), a.mean())
    assert a.mean() > 0.01


@pytest.fixture(scope="module")
def cb():
    return JScene(cbox(RES)), vt.load_scene(cbox(RES), device="cpu")


def run_both(js, ps, frames, cams=None, **kw):
    """`frames` frames of both loops from their initial states; `cams`
    gives each frame's camera-to-world matrix (prev_camera follows).
    Returns (JAX frames, port frames, port state)."""
    W, H = ps.camera.resolution
    init = {k: kw.pop(k) for k in ("cache", "gi_scale") if k in kw}
    if "gi_scale" in init:
        kw["gi_scale"] = init["gi_scale"]
    ja = jrt.RealTimeState.initial((W, H), **init)
    tb = trt.RealTimeState.initial((W, H), device="cpu", **init)
    out_a, out_b = [], []
    jprev = tprev = None
    for f in range(frames):
        jcam, tcam = js.camera, ps.camera
        if cams is not None:
            jcam = jcam.replace(c2w=jnp.asarray(cams[f]))
            tcam = dataclasses.replace(tcam, c2w=tt(cams[f]))
        img, ja = jrt.render_realtime(js.data, jcam, ja, prev_camera=jprev,
                                      **kw)
        out_a.append(np.asarray(img))
        img, tb = trt.render_realtime(ps.data, tcam, tb, prev_camera=tprev,
                                      **kw)
        out_b.append(img)
        if cams is not None:
            jprev, tprev = jcam, tcam
    return out_a, out_b, tb


@pytest.mark.parametrize("case", ["sharc", "surfel", "gi_half", "moving"])
def test_frames_match_jax(cb, case):
    """Four frames of each configuration, frame by frame; the state counts
    the frames and holds the cache that was asked for."""
    js, ps = cb
    kw, cams = {}, None
    if case == "surfel":
        kw["cache"] = "surfel"
    if case == "gi_half":
        kw["gi_scale"] = 0.5
    if case == "moving":
        c2w = np.asarray(js.camera.c2w)
        cams = []
        for f in range(FRAMES):
            m = c2w.copy()
            m[0, 3] += 0.04 * f
            cams.append(m)
    a, b, st = run_both(js, ps, FRAMES, cams, **kw)
    for x, y in zip(a, b):
        assert_frames_close(x, y)
    assert int(st.frame) == FRAMES and st.frame.dim() == 0
    assert isinstance(st.sharc, SurfelPool if case == "surfel" else SharcCache)
    assert (st.gbuffer_gi is not None) == (case == "gi_half")
    if case == "surfel":
        assert int(st.sharc.live.sum()) > 8 and float(st.sharc.count.sum()) > 8
    else:
        assert float((st.sharc.total_n > 0).float().mean()) > 0.001


@pytest.mark.parametrize("name", ["cbox_tex", "cbox_sphere"])
def test_one_frame_other_scenes(name):
    """One frame of `cbox_tex` (K1; its DI candidates sample the IES spot
    and the textured emitter) and of `cbox_sphere` at sub_div 40 (6,276
    triangles: the BVH, K2's plain walk in the port)."""
    desc = cbox_tex(RES) if name == "cbox_tex" else cbox_sphere(16, sub_div=40)
    js, ps = JScene(desc), vt.load_scene(desc, device="cpu")
    assert (ps.data.pbvh is not None) == (name == "cbox_sphere")
    a, b, _ = run_both(js, ps, 1)
    assert_frames_close(a[0], b[0])


def test_brightness_near_offline(cb):
    """The JAX package's band (tests/test_realtime.py): four frames stay
    within 0.3-3x of the offline render's mean (a feedback explosion
    through SVGF's history would leave it), and the state counts them."""
    _, ps = cb
    offline = float(vt.render(ps, spp=8).mean())
    st = trt.RealTimeState.initial((RES, RES), device="cpu")
    for i in range(4):
        img, st = trt.render_realtime(ps.data, ps.camera, st, m_light=4,
                                      spatial_taps=1, svgf_passes=2)
        assert torch.isfinite(img).all()
        assert 0.3 < float(img.mean()) / offline < 3.0, i
    assert int(st.frame) == 4


def test_profiled_stages_are_the_frame(cb):
    """tools/profile_torch_render.py's `staged_frame`, which splits a frame
    into its stages for the profile, computes `render_realtime`'s frame and
    state bit for bit (three frames: the first without history)."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "profile_torch_render", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "profile_torch_render.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    _, ps = cb
    st = trt.RealTimeState.initial((RES, RES), device="cpu")
    names = []
    for _ in range(3):
        a, sa = trt.render_realtime(ps.data, ps.camera, st)
        b, sb = prof.staged_frame(ps.data, ps.camera, st,
                                  lambda name, fn: names.append(name) or fn())
        assert torch.equal(a, b)
        for x, y in ((sa.sharc, sb.sharc), (sa.svgf, sb.svgf),
                     (sa.reservoir, sb.reservoir),
                     (sa.gi_reservoir, sb.gi_reservoir)):
            for f in dataclasses.fields(x):
                if isinstance(getattr(x, f.name), torch.Tensor):
                    assert torch.equal(getattr(x, f.name), getattr(y, f.name))
        assert int(sb.frame) == int(sa.frame)
        st = sa
    assert names[:4] == ["gbuffer", "restir_di", "restir_gi_with_cache",
                         "svgf"]


def test_state_on_the_card_by_default():
    """RealTimeState.initial puts the state on "cuda" unless asked, and
    the frame follows the device of the scene's tensors."""
    sig = inspect.signature(trt.RealTimeState.initial)
    assert sig.parameters["device"].default == "cuda"
    st = trt.RealTimeState.initial((8, 8), device="cpu")
    assert st.frame.device.type == "cpu" and st.svgf.illum.shape == (8, 8, 3)
    assert st.reservoir.W.shape == (64,) and st.gi_reservoir.W.shape == (64,)
    st = trt.RealTimeState.initial((8, 8), gi_scale=0.5, device="cpu")
    assert st.gi_reservoir.W.shape == (16,)
