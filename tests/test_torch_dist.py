"""The port's distribution (`vision_tpu_torch/parallel/dist.py`,
`launch.py`) on torch.distributed with gloo on the CPU, mirroring
tests/test_scaling.py. Four ranks (one job, spawned once for the module:
`tests/torch_dist_worker.py`) render the cbox sharded over pixels (sp=1)
and over pixels and samples (sp=2) and take a training step; two ranks
measure weak scaling. Each is held against the port's single-process
render and step (rtol 1e-4, atol 1e-5) and against the JAX package's
`render_sharded` and `training_step` on 4 of conftest's 8 virtual devices
(the render parity and BASELINE gradient tolerances).

The ranks rendezvous through a file in the test's tmp directory (no
port), and every job has a deadline: a hung rank fails the test instead of
running the suite into its time limit. The JAX package's weak-scaling
bound (tests/test_scaling.py:35, a wall-time ratio) is not mirrored: the
other test workers share these cores, so only the keys, the pixel counts
and finite positive times are checked."""
import json
import multiprocessing as mp
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import vision_tpu_torch as vt
from tests import torch_dist_worker as worker
from tests.torch_parity import assert_grad_close, cbox, np_
from vision_tpu.parallel import dist as jdist
from vision_tpu.scene.scene import Scene as JScene
from vision_tpu_torch.core import rng as trng
from vision_tpu_torch.diff import optimize as opt
from vision_tpu_torch.integrator import pt as tpt
from vision_tpu_torch.parallel import launch

torch.set_num_threads(2)

RES, DEPTH, FRAME = worker.RES, worker.DEPTH, worker.FRAME
JOB_TIMEOUT = 120  # seconds for a whole job, spawn included


def _spawn(job, world, tmp):
    """Run `job` on `world` ranks; returns each rank's outputs. Fails if a
    rank errs or the job outlives JOB_TIMEOUT (its ranks are killed)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, str(tmp / "rendezvous"), job,
                               str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOB_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = sum(p.is_alive() for p in procs)
        assert not hung, f"{job}: {hung} rank(s) still running after " \
                         f"{JOB_TIMEOUT} s"
        assert [p.exitcode for p in procs] == [0] * world, job
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn("render_train", 4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn("weak", 2, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def scenes():
    s = cbox(RES)
    return JScene(s), vt.load_scene(s, device="cpu")


def _grads(out, sp):
    pre = f"grad_sp{sp}/"
    g = {}
    for k, v in out.items():
        if k.startswith(pre):
            grp, leaf = k[len(pre):].split("/")
            g.setdefault(grp, {})[leaf] = v
    return g


def _single_step(ps, sp):
    """The loss and gradient that the 4-rank step averages, in one
    process: per sample set sp_i the MSE over every pixel, averaged over
    the sets."""
    params = {g: {k: v.detach().clone().requires_grad_(True)
                  for k, v in leaves.items()}
              for g, leaves in opt.param_surface(ps.data, ps.camera,
                                                 worker.GROUPS).items()}
    sc, cam = opt.apply_params(ps.data, ps.camera, params)
    n = RES * RES
    pix = torch.arange(n)
    p_film = torch.stack([(pix % RES).float() + 0.5,
                          (pix // RES).float() + 0.5], -1)
    tgt = torch.as_tensor(worker.target_image()).reshape(n, 3)
    loss = 0.0
    for sp_i in range(sp):
        L = 0.0
        for s in range(sp):  # spp_local = sp in the job
            st = trng.seed(pix, (FRAME * sp + s) * sp + sp_i)
            L = L + tpt.radiance(sc, cam.generate_ray(p_film), st, DEPTH, 0,
                                 1.0, remat=True)[0]
        loss = loss + torch.mean((L / sp - tgt) ** 2)
    loss = loss / sp
    keys = [(g, k) for g in params for k in params[g]]
    gr = torch.autograd.grad(loss, [params[g][k] for g, k in keys],
                             allow_unused=True)
    out = {}
    for (g, k), x in zip(keys, gr):
        out.setdefault(g, {})[k] = (np.zeros(params[g][k].shape, np.float32)
                                    if x is None else np_(x))
    return float(loss.detach()), out


@pytest.mark.parametrize("sp", [1, 2])
def test_mesh_layout(world4, sp):
    """Rank r is dp index r // sp and sp index r % sp; every rank returns
    the same full image, loss and gradients."""
    for r, out in enumerate(world4):
        np.testing.assert_array_equal(out[f"mesh_sp{sp}"],
                                      [4 // sp, sp, r // sp, r % sp])
        for k, v in out.items():
            if not k.startswith("mesh_"):
                np.testing.assert_array_equal(v, world4[0][k], err_msg=k)


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_matches_single_process(world4, scenes, sp):
    """The 4-rank render against the port's single-process passes of the
    same sample indices (frame * sp + sp_i), averaged over the sets
    (tests/test_scaling.py:39)."""
    _, ps = scenes
    ref = sum(tpt.render_sample(ps.data, ps.camera, ps.filter, FRAME * sp + j,
                                max_depth=DEPTH)[0] for j in range(sp)) / sp
    img = world4[0][f"img_sp{sp}"]
    assert img.shape == (RES, RES, 3) and img.mean() > 0.01
    np.testing.assert_allclose(img, np_(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_matches_jax(world4, scenes, sp):
    """The 4-rank render against the JAX package's `render_sharded` on 4
    virtual devices: at most 2% of the pixels part beyond 1e-4 + 1e-3 |a|
    (test_torch_render.py's one-sample threshold), the means within
    0.5%."""
    js, _ = scenes
    mesh = jdist.make_mesh(jax.devices()[:4], sp=sp)
    a = np.asarray(jdist.render_sharded(js.data, js.camera, js.filter, FRAME,
                                        mesh, max_depth=DEPTH))
    b = world4[0][f"img_sp{sp}"]
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(-1)
    assert bad.mean() <= 0.02, bad.sum()
    assert abs(b.mean() / a.mean() - 1.0) < 0.005


@pytest.mark.parametrize("sp", [1, 2])
def test_training_step_matches_single_process(world4, scenes, sp):
    """Loss and every gradient of the 4-rank step (averaged over the
    ranks) against the same loss taken in one process."""
    _, ps = scenes
    loss, grads = _single_step(ps, sp)
    got = _grads(world4[0], sp)
    np.testing.assert_allclose(world4[0][f"loss_sp{sp}"], loss, rtol=1e-4,
                               atol=1e-5)
    assert got.keys() == grads.keys()
    for g in grads:
        assert got[g].keys() == grads[g].keys()
        for k in grads[g]:
            np.testing.assert_allclose(got[g][k], grads[g][k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{g}.{k}")


@pytest.mark.parametrize("sp", [1, 2])
def test_training_step_matches_jax(world4, scenes, sp):
    """Loss and gradients of the 4-rank step against the JAX package's
    `training_step` on 4 virtual devices, all four parameter groups, at
    BASELINE's tolerance (rtol 1e-3, atol 1e-3 max|g| per leaf)."""
    js, _ = scenes
    mesh = jdist.make_mesh(jax.devices()[:4], sp=sp)
    jloss, jgrads = jdist.training_step(
        js.data, js.camera, js.filter, FRAME, mesh, worker.target_image(),
        max_depth=DEPTH, groups=worker.GROUPS, spp_local=sp)
    got = _grads(world4[0], sp)
    np.testing.assert_allclose(world4[0][f"loss_sp{sp}"], float(jloss),
                               rtol=1e-3)
    assert set(got) == set(jgrads)
    for g in jgrads:
        for k, ga in jgrads[g].items():
            assert_grad_close(np.asarray(ga), got[g][k])


def test_weak_scaling(world2):
    """Two ranks, dp sizes 1, 2 and 4: the job holds 1 and 2; each grid is
    dp * 16^2 pixels with W a multiple of dp (W = H = 16, then 22); every
    rank gets the same finite positive times; the ranks outside a dp=1
    mesh render nothing."""
    times = [json.loads(str(o["times"])) for o in world2]
    assert times[0] == times[1] and set(times[0]) == {"1", "2"}
    assert all(np.isfinite(t) and t > 0 for t in times[0].values())
    for r, out in enumerate(world2):
        calls = out["calls"]
        # one warm-up + two timed passes per dp size the rank takes part in
        want = ([[1, 0, 16, 16, 16, 16]] * 3 if r == 0 else []) + \
            [[2, r, 22, 22, 22, 22]] * 3
        np.testing.assert_array_equal(calls, np.array(want).reshape(-1, 6))


def test_init_distributed_single_process_noop(monkeypatch):
    """No address and none of RANK / WORLD_SIZE / MASTER_ADDR: False, and
    no process group (tests/test_scaling.py:72)."""
    for k in launch.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert launch.init_distributed(device="cpu") is False
    assert not tdist.is_initialized()


@pytest.mark.parametrize("how", ["rank", "path", "environment"])
def test_init_distributed_failure_raises(tmp_path, monkeypatch, how):
    """ROADMAP C18: the JAX package's `init_distributed` turns a failed
    explicit start into `False` (a silent single-process run); the port's
    raises: rank 3 of a world of 1, a rendezvous file under a regular
    file, RANK without the rest of the environment."""
    for k in launch.ENV_KEYS + ("MASTER_PORT",):
        monkeypatch.delenv(k, raising=False)
    (tmp_path / "plain").write_text("")
    with pytest.raises((RuntimeError, ValueError)):
        if how == "rank":
            launch.init_distributed("file://" + str(tmp_path / "rdv"),
                                    world_size=1, rank=3, device="cpu")
        elif how == "path":
            launch.init_distributed("file://" + str(tmp_path / "plain" / "x"),
                                    world_size=1, rank=0, device="cpu")
        else:
            monkeypatch.setenv("RANK", "0")
            launch.init_distributed(device="cpu")
    assert not tdist.is_initialized()
