"""The port's bench ladder (`vision_tpu_torch/bench.py`) against the JAX
package's `bench.py` on the CPU at small sizes: the tile order element for
element, the traced-ray count of the wavefront rung exactly, the gradient
rung's loss and material gradients at BASELINE's tolerance (rtol 1e-3, atol
1e-3 max|g|), every path-taking rung on generated stand-ins, and `main()`'s
one line with bench.py's keys."""
import ast
import io
import json
import math
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_parity import cbox
from tests.torch_scenes import cbox_sphere
from vision_tpu.core import rng as jrng
from vision_tpu.integrator import pt as jpt
from vision_tpu.scene.scene import Scene as JScene
import vision_tpu_torch as vt
from vision_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("size", [(32, 32), (48, 40), (100, 7)])
def test_tile_order_matches_jax(size):
    W, H = size
    got = bench._tile_order(W, H)
    want = jpt._tile_order(W, H)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_wave_metric_counts_the_jax_rays():
    """The timed passes of `_wave_metric` (frames 100 and 102 after one
    warm-up) trace as many rays as the JAX package's render_wave on the
    same frames: cbox 16^2, 2 spp, depth 3."""
    spp, depth = 2, 3
    stats = {}
    mrays = bench._wave_metric(vt.load_scene(cbox(16), device="cpu"), spp=spp,
                               depth=depth, warmup=1, iters=2, stats=stats)
    js = JScene(cbox(16))
    f = jax.jit(lambda frame0: jpt.render_wave(
        js.data, js.camera, js.filter, frame0, spp=spp,
        max_depth=depth)[1]["nrays"])
    want = sum(int(float(f(jnp.uint32(100 + i * spp)))) for i in range(2))
    assert stats["nrays"] == want
    assert mrays > 0 and math.isfinite(mrays)


def test_grad_rung_matches_jax_value_and_grad():
    """bench_grad's step at 16^2, depth 2 (frame 1): the loss and the
    gradient of every floating material column against
    jax.value_and_grad of bench.py's loss, rtol 1e-3 and atol 1e-3 max|g|
    (BASELINE.md, as the gradient parity tests of slice 5); the forward's
    traced rays exactly."""
    depth, frame = 2, 1
    loss, grads, nrays = bench.grad_step(
        vt.load_scene(cbox(16), device="cpu"), depth)(frame)

    sc = JScene(cbox(16))
    W, H = sc.camera.resolution
    R = W * H
    pix = jnp.arange(R, dtype=jnp.uint32)
    p_film = jnp.stack([(pix % W).astype(jnp.float32) + 0.5,
                        (pix // W).astype(jnp.float32) + 0.5], -1)
    ray = sc.camera.generate_ray(p_film, jnp.zeros((R, 2)))
    mt = sc.data.materials
    mat_floats = {k: v for k, v in vars(mt).items()
                  if hasattr(v, "dtype")
                  and jnp.issubdtype(v.dtype, jnp.floating)}

    def loss_fn(mf, scene, fr):
        scene = scene.replace(materials=scene.materials.replace(**mf))
        L, aovs = jpt.radiance(scene, ray, jrng.seed(pix, fr),
                               max_depth=depth, remat=True)
        return jnp.mean(L ** 2), aovs["nrays"]

    (jl, jn), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        mat_floats, sc.data, jnp.uint32(frame))
    assert sorted(grads) == sorted(jg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert int(nrays) == int(float(jn))
    for k, g in jg.items():
        g = np.asarray(g)
        scale = float(np.abs(g).max()) if g.size else 0.0
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=k)


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """`cbox_sphere` with a sub_div-40 sphere (6,276 triangles: the plain
    K2 walk) as a scene file."""
    p = tmp_path_factory.mktemp("bench") / "sphere.json"
    p.write_text(json.dumps(cbox_sphere(8, sub_div=40)))
    return str(p)


PATH_RUNGS = ["bench_staircase", "bench_staircase_sol", "bench_prism",
              "bench_staircase_grad", "bench_kitchen", "bench_classroom_rt"]


@pytest.mark.parametrize("name", PATH_RUNGS)
def test_path_rungs_on_a_stand_in(monkeypatch, stand_in, name):
    """Each rung that reads a scene file returns a finite positive number
    on a generated BVH scene (8^2 here), and None when its file is
    absent."""
    for k in ("RES", "GRAD_RES", "PRISM_RES"):
        monkeypatch.setattr(bench, k, 8)
    fn = getattr(bench, name)
    v = fn(stand_in, device="cpu")
    assert isinstance(v, float) and math.isfinite(v) and v > 0
    assert fn(os.path.join(os.path.dirname(stand_in), "absent.json"),
              device="cpu") is None


def test_bvh_rungs_skip_a_scene_without_a_tree(tmp_path):
    """The BVH rungs return None on a scene that takes the dense sweep
    (pbvh is None), as bench.py's do."""
    p = tmp_path / "cbox.json"
    p.write_text(json.dumps(cbox(8)))
    for name in ("bench_staircase", "bench_staircase_sol",
                 "bench_staircase_grad", "bench_kitchen"):
        assert getattr(bench, name)(str(p), device="cpu") is None


def _bench_py_keys():
    """The `extra` keys of the JAX package's bench.py, read from its
    source (importing it would import nothing more, but its rungs are
    what main() lists)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))
    return [e.elts[0].value for e in loop.iter.elts]


def test_main_prints_one_line_of_bench_py_keys(monkeypatch):
    """main() at a tiny size prints one JSON line with bench.py's keys;
    the reference-scene rungs are left out (their files are absent here),
    and a rung that raises becomes "error: <Type>: <msg>" without sinking
    the headline."""
    monkeypatch.setattr(bench, "REF", os.path.join(ROOT, "no_such_dir"))
    for k in ("RES", "GRAD_RES", "PRISM_RES"):
        monkeypatch.setattr(bench, k, 8)
    monkeypatch.setattr(bench, "WARMUP", 1)
    monkeypatch.setattr(bench, "ITERS", 1)
    monkeypatch.setattr(bench, "BASELINE_MRAYS", 2.0)

    def boom(path=None, device="cuda"):
        raise RuntimeError("rung failed")

    monkeypatch.setattr(bench, "bench_classroom_rt", boom)
    headline, cbox = [], bench.bench_cbox

    def recorded(device="cuda"):
        headline.append(cbox(device=device))
        return headline[-1]

    monkeypatch.setattr(bench, "bench_cbox", recorded)
    buf = io.StringIO()
    with redirect_stdout(buf):
        bench.main(["--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert out["metric"] == "cbox_512_d8_pt_throughput"
    assert out["unit"] == "Mrays/s"
    assert out["value"] == round(headline[0], 3) > 0
    assert out["vs_baseline"] == round(headline[0] / 2.0, 3)
    assert [k for k, _ in bench.RUNGS] == _bench_py_keys()
    assert list(out["extra"]) == ["cbox_256_d4_grad_mrays", "classroom_rt_ms"]
    assert out["extra"]["cbox_256_d4_grad_mrays"] > 0
    assert out["extra"]["classroom_rt_ms"] == \
        "error: RuntimeError: rung failed"


def test_no_tpu_baseline_in_the_port():
    """bench.py's baseline is a TPU figure: the port carries its own."""
    pkg = os.path.join(ROOT, "vision_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                assert "1.933" not in open(os.path.join(dirpath, fn)).read(), fn
    assert bench.BASELINE_MRAYS != 1.933


def test_bench_imports_no_jax():
    tree = ast.parse(open(bench.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names} | {
        n.module.split(".")[0] for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not names & {"jax", "vision_tpu", "tests"}
