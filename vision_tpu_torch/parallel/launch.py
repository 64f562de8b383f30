"""Multi-process start-up and weak-scaling measurement.

Counterpart of `vision_tpu/parallel/launch.py` on torch.distributed. Each
process runs the same program; the process group's backend follows the
device asked for: NCCL for "cuda" (one card a process), gloo for "cpu".

Usage, one process per card (`torchrun --nproc_per_node=N script.py` sets
RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK):

    from vision_tpu_torch.parallel import dist, launch
    launch.init_distributed()                          # from the environment
    launch.init_distributed("tcp://10.0.0.1:8476", world_size=2, rank=i)
    mesh = dist.make_mesh(sp=1)
"""
from __future__ import annotations

import dataclasses
import os
import time

import torch
import torch.distributed as tdist

ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def init_distributed(address=None, world_size=None, rank=None,
                     device="cuda"):
    """Start the process group. Returns True if one is up (already, or
    started here); False, doing nothing, when there is neither an address
    nor any of RANK / WORLD_SIZE / MASTER_ADDR in the environment (a
    single-process run). An address ("tcp://host:port", "file://path", or
    "host:port") or that environment is a request to start one, and a
    failure raises. On "cuda" each process takes the card LOCAL_RANK
    (else its rank) modulo the cards it sees."""
    if tdist.is_initialized():
        return True
    if address is None and not any(k in os.environ for k in ENV_KEYS):
        return False
    if torch.device(device).type == "cuda":
        backend = "nccl"
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = rank if rank is not None else os.environ.get("RANK", 0)
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    else:
        backend = "gloo"
    if address is None:
        tdist.init_process_group(backend, init_method="env://")
    else:
        if "://" not in address:
            address = "tcp://" + address
        tdist.init_process_group(backend, init_method=address,
                                 world_size=world_size, rank=rank)
    return True


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_weak_scaling(scene, camera, filt, dp_sizes=(1, 8),
                         pixels_per_chip=64 * 64, max_depth=4, iters=3,
                         sp=1):
    """Weak scaling: fixed pixels per rank, growing dp. For each dp size
    that the job can hold, the first dp * sp ranks render a grid of
    dp * pixels_per_chip pixels (W a multiple of dp) once to warm up and
    then `iters` timed passes, while the other ranks wait at a barrier.
    Every rank calls it and gets the same {dp: seconds a pass}, the
    slowest rank's time. Efficiency against the smallest dp is
    t[dp_min] / t[dp]."""
    from . import dist
    dev = camera.c2w.device
    world = tdist.get_world_size()
    me = tdist.get_rank()
    times = {}
    for dp in dp_sizes:
        n_dev = dp * sp
        if n_dev > world:
            continue
        mesh = dist.make_mesh(sp, tdist.new_group(list(range(n_dev))))
        side = int((dp * pixels_per_chip) ** 0.5)
        W = (side // dp) * dp if side >= dp else dp
        H = max(side, 1)
        cam = dataclasses.replace(camera, resolution=(W, H))
        t = torch.zeros(1, dtype=torch.float64, device=dev)
        if me < n_dev:
            dist.render_sharded(scene, cam, filt, 0, mesh,
                                max_depth=max_depth)
            _sync(dev)
            t0 = time.perf_counter()
            for i in range(iters):
                dist.render_sharded(scene, cam, filt, i + 1, mesh,
                                    max_depth=max_depth)
            _sync(dev)
            t[0] = (time.perf_counter() - t0) / iters
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
        times[dp] = float(t[0])
    return times
