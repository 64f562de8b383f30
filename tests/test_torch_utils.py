"""The port's utilities against the JAX package's on the CPU:
checkpoint/resume (`vision_tpu_torch/utils/checkpoint.py`: resumed bit for
bit, the extra state, checkpoints crossing between the packages), the
debug utilities (`utils/debug.py`) and the visualizers
(`sensor/visualizer.py`, `utils/visualizer.py`), mirroring
tests/test_aux.py."""
import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import cbox, np_
from tests.torch_scenes import cbox_sphere
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu.sensor import visualizer as jvz
from vision_tpu.utils import checkpoint as jck
from vision_tpu.utils import debug as jdbg
from vision_tpu.utils import visualizer as juvz
from vision_tpu_torch.sensor import visualizer as tvz
from vision_tpu_torch.utils import checkpoint as tck
from vision_tpu_torch.utils import debug as tdbg
from vision_tpu_torch.utils import visualizer as tuvz

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    s = cbox(24)
    return JScene(s), vt.load_scene(s, device="cpu")


def _assert_pixels(a, b, share=0.02):
    """One render against the other per pixel (test_torch_render.py's
    `test_render_sample_matches_jax`: at most 2% of the pixels part beyond
    1e-4 + 1e-3 |a|) and the means within 0.5%."""
    a, b = np.asarray(a), np_(b)
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(-1)
    assert bad.mean() <= share, bad.sum()
    assert abs(b.mean() / a.mean() - 1.0) < 0.005


# ---- checkpoint / resume ----

@pytest.fixture(scope="module")
def full_renders(scenes, tmp_path_factory):
    """6 spp of each package without interruption."""
    js, ps = scenes
    d = tmp_path_factory.mktemp("full")
    return (jck.render_resumable(js, 6, str(d / "j.npz"), checkpoint_every=100),
            tck.render_resumable(ps, 6, str(d / "t.npz"), checkpoint_every=100))


def test_resume_is_bitexact(scenes, full_renders, tmp_path):
    """3 spp, a checkpoint, then a resume to 6: the uninterrupted render
    bit for bit (test_aux.py:20)."""
    _, ps = scenes
    p = str(tmp_path / "b.npz")
    tck.render_resumable(ps, 3, p, checkpoint_every=3)
    resumed = tck.render_resumable(ps, 6, p, checkpoint_every=3)
    assert resumed.dtype == np.float32 and resumed.shape == (24, 24, 3)
    np.testing.assert_array_equal(resumed, full_renders[1])


def test_resumable_matches_jax(full_renders):
    _assert_pixels(*full_renders)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(scenes, full_renders, tmp_path, writer):
    """One package renders 3 spp and checkpoints; the other resumes to 6.
    The result stands against the writer's uninterrupted render at the
    render parity tolerance, and the checkpoint reads back the same in
    both packages."""
    js, ps = scenes
    p = str(tmp_path / "x.npz")
    first, second = ((jck, js), (tck, ps)) if writer == "jax" else \
        ((tck, ps), (jck, js))
    first[0].render_resumable(first[1], 3, p, checkpoint_every=3)
    ja, jf, _ = jck.load_checkpoint(p)
    ta, tf, _ = tck.load_checkpoint(p, device="cpu")
    assert jf == tf == 3
    np.testing.assert_array_equal(np_(ta), np.asarray(ja))
    resumed = second[0].render_resumable(second[1], 6, p, checkpoint_every=3)
    want = full_renders[0] if writer == "jax" else full_renders[1]
    _assert_pixels(want, resumed)


@dataclasses.dataclass
class _Record:
    m: torch.Tensor
    v: np.ndarray


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_extra_state_roundtrip(tmp_path, writer):
    """Nested extra state (a dict and a record) saved by either package
    loads in both with the same keys and values (test_aux.py:32)."""
    p = str(tmp_path / "c.npz")
    if writer == "port":
        tck.save_checkpoint(p, torch.ones((4, 4, 3)), 7, extra={
            "opt": {"mu": torch.arange(3.0),
                    "rec": _Record(torch.full((2,), 0.5), np.arange(2))}})
    else:
        jck.save_checkpoint(p, np.ones((4, 4, 3), np.float32), 7, extra={
            "opt": {"mu": np.arange(3.0, dtype=np.float32),
                    "rec": {"m": np.full((2,), 0.5, np.float32),
                            "v": np.arange(2)}}})
    with open(p + ".meta.json") as f:
        assert sorted(json.load(f)["keys"]) == [
            "extra/opt/mu", "extra/opt/rec/m", "extra/opt/rec/v"]
    acc, fi, extra = tck.load_checkpoint(p, device="cpu")
    jacc, jfi, jextra = jck.load_checkpoint(p)
    assert fi == jfi == 7 and isinstance(acc, torch.Tensor)
    np.testing.assert_array_equal(np_(acc), np.ones((4, 4, 3)))
    np.testing.assert_allclose(np_(extra["opt"]["mu"]), [0.0, 1.0, 2.0])
    for k in ("m", "v"):
        np.testing.assert_array_equal(np_(extra["opt"]["rec"][k]),
                                      np.asarray(jextra["opt"]["rec"][k]))


# ---- debug utilities ----

def test_memory_stats(scenes):
    """Every tensor of SceneData and its tables, the BVH records of a mesh
    scene included; the shared tables count the same bytes as the JAX
    package's (test_aux.py:70)."""
    js, ps = scenes
    st = tdbg.scene_memory_stats(ps.data)
    jst = jdbg.scene_memory_stats(js.data)
    assert st["TOTAL"] > 1000 and st["TOTAL"] == sum(
        v for k, v in st.items() if k != "TOTAL")
    assert st["tri_geom"] == ps.data.tri_geom.numel() * 4
    for k in ("tri_pack", "materials.kd", "lights.color", "atlas.data"):
        assert st[k] == jst[k], k
    sph = vt.load_scene(cbox_sphere(16, sub_div=24), device="cpu").data
    st = tdbg.scene_memory_stats(sph)
    assert any(k.startswith("pbvh.") for k in st)
    assert st["pbvh.nodes"] == sph.pbvh.nodes.numel() * 4


def test_validate_radiance():
    """ok on finite non-negative radiance; NaN, Inf and negative counted
    as the JAX package counts them, from a tensor or an array."""
    assert tdbg.validate_radiance(torch.ones((4, 4, 3))) == (
        True, {"nan": 0, "inf": 0, "negative": 0})
    bad = np.ones((4, 4, 3), np.float32)
    bad[0, 0, 0] = np.nan
    bad[1, 1, 1] = np.inf
    bad[2, 2, 2] = -1.0
    for x in (bad, torch.as_tensor(bad)):
        assert tdbg.validate_radiance(x) == jdbg.validate_radiance(bad)
    assert tdbg.validate_radiance(bad)[1]["nan"] == 1


def test_pixel_mask():
    """The lane mask of a pixel rectangle, the JAX package's, on the
    device asked for (test_aux.py:89)."""
    m = tdbg.pixel_debug_mask((8, 6), (2, 1), (5, 4), device="cpu")
    assert m.device.type == "cpu" and m.dtype == torch.bool
    assert int(m.sum()) == 9
    np.testing.assert_array_equal(
        np_(m), np.asarray(jdbg.pixel_debug_mask((8, 6), (2, 1), (5, 4))))


def test_debug_print_where(capsys):
    """Masked stats of a [N] and an [N, 3] value, and of an empty mask,
    printed line for line as the JAX package's `jax.debug.print` does
    (values exact in binary, so both reductions agree to the bit)."""
    g = np.random.default_rng(2)
    a = (g.integers(0, 64, 32) / 4.0).astype(np.float32)
    b = (g.integers(0, 64, (32, 3)) / 8.0).astype(np.float32)
    mask = np.arange(32) % 3 == 0
    lines = []
    for m in (mask, np.zeros(32, bool)):
        jdbg.debug_print_where(jnp.asarray(m), "px", jnp.asarray(a),
                               jnp.asarray(b))
        want = capsys.readouterr().out
        tdbg.debug_print_where(torch.as_tensor(m), "px", torch.as_tensor(a),
                               torch.as_tensor(b))
        got = capsys.readouterr().out
        assert got == want and got.count("\n") == 2
        lines.append(got)
    assert "[value 1] mean=" in lines[0] and "nan" in lines[1]


def test_scope_timer(capsys):
    """Host time of the block, printed as the JAX package's."""
    with tdbg.ScopeTimer("step") as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    assert capsys.readouterr().out.startswith("[timer] step: ")
    with tdbg.ScopeTimer("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""


# ---- visualizers ----

@pytest.fixture(scope="module")
def vis_scenes():
    s = cbox(48)
    return JScene(s), vt.load_scene(s, device="cpu")


def test_visualizer_overlays(vis_scenes):
    """test_aux.py:126 on the port: a point ahead of the camera lands mid
    frame, one behind it is culled; a segment draws a red line; normal
    whiskers and a path's segments mark pixels."""
    _, ps = vis_scenes
    r, front = tvz.world_to_raster(ps.camera, np.array([[0.0, 1.0, 0.0]]))
    assert front[0]
    assert abs(r[0, 0] - 24.0) < 1.0 and abs(r[0, 1] - 24.0) < 1.0
    _, back = tvz.world_to_raster(ps.camera, np.array([[0.0, 1.0, 99.0]]))
    assert not back[0]
    img = np.zeros((48, 48, 3), np.float32)
    tvz.draw_segments(img, [[-0.5, 1.0, 0.0]], [[0.5, 1.0, 0.0]], ps.camera)
    assert (img[..., 0] > 0.5).sum() >= 8
    img2 = tvz.overlay_normals(np.zeros((48, 48, 3), np.float32), ps.data,
                               ps.camera, stride=16)
    assert (img2[..., 1] > 0.5).any()
    img3 = tvz.overlay_rays(np.zeros((48, 48, 3), np.float32), ps.data,
                            ps.camera, [24 * 48 + 24], max_depth=2)
    assert (img3.sum(-1) > 0).any()


@pytest.mark.parametrize("what", ["project", "segments", "normals", "rays"])
def test_visualizer_matches_jax(vis_scenes, what):
    """Each overlay drawn by both packages on the same image: the
    projection within 1e-4 of a pixel; lines from given points pixel for
    pixel. The whiskers and paths start at traced hits, whose positions
    differ by float rounding; a whisker starts at a pixel centre, which
    projects to x.5, where `round` is a knife edge. So there every pixel
    one package draws lies within one pixel of one the other draws, and
    the counts agree within 10% (the path overlay: 16 pixels, three
    bounces)."""
    js, ps = vis_scenes
    g = np.random.default_rng(4)
    if what == "project":
        pts = g.uniform(-1, 2, (64, 3))
        a, fa = jvz.world_to_raster(js.camera, pts)
        b, fb = tvz.world_to_raster(ps.camera, pts)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_allclose(b[fb], a[fa], atol=1e-4)
        return
    base = g.random((48, 48, 3)).astype(np.float32) * 0.1
    a, b = base.copy(), base.copy()
    if what == "segments":
        p0, p1 = g.uniform(-1, 2, (2, 12, 3))
        jvz.draw_segments(a, p0, p1, js.camera)
        tvz.draw_segments(b, p0, p1, ps.camera)
    elif what == "normals":
        jvz.overlay_normals(a, js.data, js.camera, stride=8)
        tvz.overlay_normals(b, ps.data, ps.camera, stride=8)
    else:
        pix = g.choice(48 * 48, 16, replace=False)
        jvz.overlay_rays(a, js.data, js.camera, pix, rng_seed=3, max_depth=3)
        tvz.overlay_rays(b, ps.data, ps.camera, pix, rng_seed=3, max_depth=3)
    da, db = (a != base).any(-1), (b != base).any(-1)
    assert da.any()
    if what == "segments":
        np.testing.assert_array_equal(b, a)
        return
    assert abs(int(db.sum()) - int(da.sum())) <= 0.1 * da.sum()
    for x, y in ((da, db), (db, da)):
        near = np.zeros((50, 50), bool)
        for dy in range(3):
            for dx in range(3):
                near[dy:dy + 48, dx:dx + 48] |= y
        assert near[1:49, 1:49][x].all()


def test_utils_visualizer_matches_jax(vis_scenes):
    """`Visualizer` (segments, normals, frames) through
    `sensor/gbuffer.raster_coord`: the JAX package's overlay pixel for
    pixel; `clear` empties it."""
    js, ps = vis_scenes
    outs = []
    for mod, cam in ((juvz, js.camera), (tuvz, ps.camera)):
        v = mod.Visualizer(cam)
        v.add_line_segment([-0.5, 1.0, 0.0], [0.5, 1.2, 0.1])
        v.add_normal([0.0, 0.5, 0.0], [0.0, 1.0, 0.0], scale=0.3)
        v.add_frame([0.3, 1.0, -0.2], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                    scale=0.2)
        v.add_line_segment([0.0, 1.0, 0.0], [0.0, 1.0, 99.0])  # behind
        outs.append(v.overlay(np.zeros((48, 48, 3), np.float32)))
        v.clear()
        assert not v.overlay(np.zeros((2, 2, 3))).any()
    assert outs[1].any()
    np.testing.assert_array_equal(outs[1], outs[0])


def test_entry_points_default_to_the_card():
    """The new entry points that make tensors take the card unless the
    caller passes another device."""
    import inspect
    from vision_tpu_torch.parallel import launch
    for fn in (tdbg.pixel_debug_mask, tck.load_checkpoint,
               launch.init_distributed):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
