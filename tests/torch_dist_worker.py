"""Rank programs of `tests/test_torch_dist.py`: each runs in a process of
its own (torch.multiprocessing spawn), joins a gloo group through a
file:// rendezvous and writes what it computed to `<out>/rank<r>.npz`.
This module imports no jax: the ranks run the port alone."""
import json
import os

import numpy as np
import torch

RES = 16
DEPTH = 2
FRAME = 3
GROUPS = ("materials", "lights", "atlas", "camera")


def target_image(res=RES):
    return np.random.default_rng(7).random((res, res, 3)).astype(np.float32)


def _scene():
    import vision_tpu_torch as vt
    from tests.torch_parity import cbox
    return vt.load_scene(cbox(RES), device="cpu")


def _render_train(sc, out):
    from vision_tpu_torch.parallel import dist
    for sp in (1, 2):
        mesh = dist.make_mesh(sp=sp)
        out[f"img_sp{sp}"] = dist.render_sharded(
            sc.data, sc.camera, sc.filter, FRAME, mesh,
            max_depth=DEPTH).numpy()
        loss, grads = dist.training_step(
            sc.data, sc.camera, sc.filter, FRAME, mesh, target_image(),
            max_depth=DEPTH, groups=GROUPS, spp_local=sp)
        out[f"loss_sp{sp}"] = loss.numpy()
        for g, leaves in grads.items():
            for k, v in leaves.items():
                out[f"grad_sp{sp}/{g}/{k}"] = v.numpy()
        out[f"mesh_sp{sp}"] = np.array([mesh.n_dp, mesh.n_sp, mesh.dp_i,
                                        mesh.sp_i])


def _weak(sc, out):
    from vision_tpu_torch.parallel import dist, launch
    calls = []
    render = dist.render_sharded

    def logged(scene, camera, filt, frame_index, mesh, **kw):
        img = render(scene, camera, filt, frame_index, mesh, **kw)
        calls.append([mesh.n_dp, mesh.dp_i, *camera.resolution,
                      *img.shape[:2]])
        return img

    dist.render_sharded = logged
    try:
        times = launch.measure_weak_scaling(
            sc.data, sc.camera, sc.filter, dp_sizes=(1, 2, 4),
            pixels_per_chip=RES * RES, max_depth=DEPTH, iters=2)
    finally:
        dist.render_sharded = render
    out["times"] = np.array(json.dumps({str(k): v for k, v in times.items()}))
    out["calls"] = np.array(calls, np.int64).reshape(-1, 6)


JOBS = {"render_train": _render_train, "weak": _weak}


def run(rank, world, init_file, job, out_dir):
    """One rank: join the group, run `job`, write rank<r>.npz, leave."""
    import torch.distributed as tdist
    from vision_tpu_torch.parallel import launch
    torch.set_num_threads(1)
    assert launch.init_distributed("file://" + init_file, world_size=world,
                                   rank=rank, device="cpu")
    try:
        out = {}
        JOBS[job](_scene(), out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
