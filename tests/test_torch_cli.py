"""The port's entry points (`vision_tpu_torch/cli.py`, `pipelines/graph.py`,
`sdk.py`) against the JAX package's on the CPU: `cli.main(... -d cpu)`
against `vision_tpu.cli.main` on the same 16^2 cbox, PNG for PNG, for the
fixed, graph, realtime and bake pipelines and --denoise; the EXR
output; --distributed without a process group; --clear-cache; the render
graph's order and errors; and `VisionRenderer` against the JAX SDK."""
import inspect
import json
import os

import numpy as np
import pytest
import torch

import vision_tpu_torch as vt
from tests.torch_parity import cbox, np_
from vision_tpu import cli as jcli
from vision_tpu.pipelines import graph as jgraph
from vision_tpu.sdk import VisionRenderer as JRenderer
from vision_tpu_torch import cli as tcli
from vision_tpu_torch.accel import cuda_build
from vision_tpu_torch.pipelines import graph as tgraph
from vision_tpu_torch.scene.imageio import read_exr, read_png
from vision_tpu_torch.sdk import VisionRenderer

torch.set_num_threads(2)


def _scene_file(tmp_path, **changes):
    p = tmp_path / "cbox.json"
    p.write_text(json.dumps(cbox(16, **changes)))
    return str(p)


def _png(path):
    with open(path, "rb") as f:
        return read_png(f.read()).astype(np.int32)


@pytest.mark.parametrize("extra", [[], ["-p", "graph"],
                                   ["-p", "realtime", "--spp", "2"],
                                   ["--denoise"]],
                         ids=["fixed", "graph", "realtime", "denoise"])
def test_cli_matches_jax(tmp_path, extra):
    """The same scene through both command lines: the PNGs within one
    level (they agree exactly on the CPU today). realtime: two frames of
    the loop, averaged."""
    s = _scene_file(tmp_path)
    spp = [] if "--spp" in extra else ["--spp", "4"]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert tcli.main(["-s", s, "-o", a, "-d", "cpu", "-q"] + spp + extra) == 0
    assert jcli.main(["-s", s, "-o", b, "-d", "cpu", "-q"] + spp + extra) == 0
    pa, pb = _png(a), _png(b)
    assert pa.shape == pb.shape == (16, 16, 3) and pa.max() > 0
    assert np.abs(pa - pb).max() <= 1


def test_cli_scene_pipeline_picks_graph(tmp_path):
    """A scene whose pipeline is `customized` takes the render graph, as
    `-p graph` does."""
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tcli.main(["-s", _scene_file(tmp_path, pipeline={"type": "customized"}),
               "-o", a, "-d", "cpu", "-q"])
    tcli.main(["-s", _scene_file(tmp_path), "-o", b, "-d", "cpu", "-q",
               "-p", "graph"])
    np.testing.assert_array_equal(_png(a), _png(b))


def test_cli_exr_is_the_render(tmp_path):
    """-o .exr writes the linear render: it reads back bit for bit as
    `render` of the same scene and seeds."""
    s = _scene_file(tmp_path)
    out = str(tmp_path / "o.exr")
    tcli.main(["-s", s, "-o", out, "-d", "cpu", "-q", "--spp", "4"])
    with open(out, "rb") as f:
        got = read_exr(f.read())
    want = np_(vt.render(vt.load_scene(s, device="cpu"), spp=4))
    np.testing.assert_array_equal(got, want)


def _both_clis(tmp_path, scene, args):
    """Both command lines on `scene` with `args`: for each, the PNG it
    wrote (as int32) or the SystemExit it raised."""
    out = []
    for main, name in ((tcli.main, "t.png"), (jcli.main, "j.png")):
        path = str(tmp_path / name)
        try:
            assert main(["-s", scene, "-o", path, "-d", "cpu", "-q"]
                        + args) == 0
            out.append(_png(path))
        except SystemExit as e:
            out.append(e)
    return out


@pytest.mark.parametrize("args,where", [
    (["-p", "bake", "--spp", "2"], "slice 8b"), (["--distributed"], "slice 9")])
def test_cli_out_of_slice_raises(tmp_path, monkeypatch, args, where):
    """The options of ROADMAP slices 8b and 9 behave as in the JAX
    package's command line. `-p bake` (a 256-wide lightmap at 2 spp, then
    the display pass): the PNGs within one level. `--distributed` with
    none of RANK / WORLD_SIZE / MASTER_ADDR set: both exit non-zero
    (SystemExit with a message) instead of rendering alone."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    a, b = _both_clis(tmp_path, _scene_file(tmp_path), args)
    if where == "slice 9":
        for e in (a, b):
            assert isinstance(e, SystemExit) and e.code not in (0, None)
            assert str(e.code).startswith("--distributed:")
        return
    assert a.shape == b.shape == (16, 16, 3) and a.max() > 0
    assert np.abs(a - b).max() <= 1


def test_cli_bake_scene_raises(tmp_path):
    """A scene whose pipeline type is `bake` takes the bake, as in the JAX
    package: its PNG within one level of the JAX command line's, and bit
    for bit the port's `-p bake` of the same scene without the type."""
    s = _scene_file(tmp_path, pipeline={"type": "bake"})
    a, b = _both_clis(tmp_path, s, ["--spp", "2"])
    assert a.shape == (16, 16, 3) and np.abs(a - b).max() <= 1
    c = str(tmp_path / "p.png")
    tcli.main(["-s", _scene_file(tmp_path), "-o", c, "-d", "cpu", "-q",
               "-p", "bake", "--spp", "2"])
    np.testing.assert_array_equal(a, _png(c))


def test_cli_clear_cache_and_threads(tmp_path, monkeypatch):
    """--clear-cache removes the compiled-library directory (pointed at a
    temporary one here: the test workers share the real one); -t sets
    torch's CPU threads."""
    build = tmp_path / "_build"
    build.mkdir()
    (build / "libx_0.so").write_bytes(b"")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    n = torch.get_num_threads()
    try:
        tcli.main(["-s", _scene_file(tmp_path), "-o", str(tmp_path / "o.png"),
                   "-d", "cpu", "-q", "--spp", "1", "--clear-cache",
                   "-t", "3"])
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(n)
    assert not build.exists()


def test_entry_points_default_to_the_card():
    """The CLI's -d and the SDK's device default to "cuda" (read from the
    parser and the signature, no card needed)."""
    assert inspect.signature(VisionRenderer).parameters["device"].default \
        == "cuda"
    src = inspect.getsource(tcli.main)
    assert 'default="cuda", choices=["cuda", "cpu"]' in src


# ---- the render graph ----

def _passes(mod, spec):
    g = mod.RenderGraph()
    for name, ins, outs in spec:
        g.add_pass(name, lambda res, ctx, outs=outs: {o: len(res) for o in outs},
                   ins, outs)
    return g


GRAPHS = {
    "order": [("c", ("b",), ("out",)), ("a", (), ("a",)),
              ("b", ("a",), ("b",))],
    "cycle": [("a", ("y",), ("x",)), ("b", ("x",), ("y",))],
    "twice": [("a", (), ("x",)), ("b", (), ("x",))],
    "missing_input": [("a", ("nowhere",), ("x",))],
    "not_produced": [("a", (), ("x",))],
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_render_graph_matches_jax(name):
    """The same order, resources and errors (type and message) as the JAX
    package's RenderGraph."""
    results = []
    for mod in (tgraph, jgraph):
        g = _passes(mod, GRAPHS[name])
        if name == "not_produced":
            g.passes[0].fn = lambda res, ctx: {}
        try:
            res = g.execute({"seed": 0})
            results.append(("ok", [p.name for p in g._order], res))
        except (ValueError, KeyError) as e:
            results.append((type(e).__name__, str(e)))
    assert results[0] == results[1]
    want = {"order": "ok", "cycle": "ValueError", "twice": "ValueError",
            "missing_input": "KeyError", "not_produced": "KeyError"}[name]
    assert results[0][0] == want


def test_default_graph_matches_jax():
    """integrate -> accumulate (into accum_prev) -> tonemap -> gamma on the
    cbox, both packages."""
    import jax.numpy as jnp
    from vision_tpu.scene.scene import Scene as JScene
    s = cbox(16)
    ps, js = vt.load_scene(s, device="cpu"), JScene(s)
    prev = np.full((16, 16, 3), 0.25, np.float32)
    ctx = {"max_depth": 8, "tone_mapper": "linear", "exposure": 1.0}
    a = tgraph.default_graph(ps.data, ps.camera, ps.filter).execute(
        {"accum_prev": torch.as_tensor(prev)}, dict(ctx, frame_index=3))
    b = jgraph.default_graph(js.data, js.camera, js.filter).execute(
        {"accum_prev": jnp.asarray(prev)}, dict(ctx, frame_index=jnp.uint32(3)))
    for k in ("radiance", "accum", "output"):
        np.testing.assert_allclose(np_(a[k]), np.asarray(b[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---- the SDK ----

def _sdk(cls, **kw):
    """tests/test_aux.py's programmatic scene: a floor and a light above."""
    r = cls(resolution=(32, 32), **kw)
    white = r.add_material({"type": "diffuse",
                            "param": {"color": [0.7, 0.7, 0.7]}})
    quad = np.asarray([[-1, 0, -1], [1, 0, -1], [-1, 0, 1], [1, 0, 1]],
                      np.float32)
    tris = np.asarray([[0, 1, 2], [2, 1, 3]], np.int32)
    r.add_instance(quad, tris, material=white)
    r.add_instance(quad * 0.3 + np.asarray([0, 1.5, 0], np.float32), tris,
                   emission=[10, 10, 10])
    r.set_camera([0, 1.0, 2.5], [0, 0.5, 0], fov_y=40)
    r.build_accel()
    r.render(spp=4)
    return r.download_radiance(), np.asarray(r.download_image())


def test_sdk_matches_jax():
    """`VisionRenderer` on the CPU against the JAX SDK, 4 progressive
    passes: radiance and display image at the parity tolerance (rtol 1e-4,
    atol 1e-5)."""
    a, ai = _sdk(VisionRenderer, device="cpu")
    b, bi = _sdk(JRenderer)
    assert a.shape == (32, 32, 3) and a.max() > 0.1
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ai, bi, rtol=1e-4, atol=1e-5)


def test_sdk_needs_build_and_render():
    r = VisionRenderer(resolution=(8, 8), device="cpu")
    with pytest.raises(RuntimeError):
        r.render()
    with pytest.raises(RuntimeError):
        r.download_radiance()
