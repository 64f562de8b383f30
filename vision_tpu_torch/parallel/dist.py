"""Multi-process distribution: pixel / sample sharding on torch.distributed.

Counterpart of `vision_tpu/parallel/dist.py`. The ranks of a process group
form a (dp, sp) grid: rank r of the group is dp index r // sp and sp index
r % sp (the JAX package's `reshape(n // sp, sp)` of its devices). dp shards
the pixel grid, sp renders independent sample sets of the same pixels. Each
rank holds the whole scene (read-only during a frame). The sp sets are
averaged by an all-reduce over the sp subgroup, and the dp shards are
all-gathered, so every rank returns the full image. The collectives run on
the scene's device, through the backend the process group was started
with (`launch.init_distributed`: NCCL for the card, gloo for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core import rng
from ..diff.optimize import apply_params, param_surface
from ..integrator import pt


@dataclass
class Mesh:
    """This rank's place in a (dp, sp) grid of a process group. A rank
    outside the group has dp_i = sp_i = -1 and takes part in no render."""
    n_dp: int
    n_sp: int
    dp_i: int
    sp_i: int
    group: object      # the whole grid
    dp_group: object   # the ranks of this rank's sp index, in dp order
    sp_group: object   # the ranks of this rank's dp index, in sp order

    @property
    def size(self):
        return self.n_dp * self.n_sp


def make_mesh(sp=1, group=None):
    """The (dp, sp) grid over `group` (default: every rank). Every rank of
    the job calls it, members or not: it makes the dp and sp subgroups
    with `dist.new_group`, which every rank must enter in the same
    order."""
    ranks = (list(range(dist.get_world_size())) if group is None
             else dist.get_process_group_ranks(group))
    n = len(ranks)
    assert n % sp == 0, (n, sp)
    grid = np.asarray(ranks).reshape(n // sp, sp)
    sp_groups = [dist.new_group(grid[i].tolist()) for i in range(n // sp)]
    dp_groups = [dist.new_group(grid[:, j].tolist()) for j in range(sp)]
    me = dist.get_rank()
    if me not in ranks:
        return Mesh(n // sp, sp, -1, -1, group, None, None)
    dp_i, sp_i = divmod(ranks.index(me), sp)
    return Mesh(n // sp, sp, dp_i, sp_i, group, dp_groups[sp_i],
                sp_groups[dp_i])


def _local_pixels(camera, mesh):
    W, H = camera.resolution
    n = W * H
    assert n % mesh.n_dp == 0, (n, mesh.n_dp)
    n_local = n // mesh.n_dp
    pix = mesh.dp_i * n_local + torch.arange(n_local, dtype=torch.int64,
                                             device=camera.c2w.device)
    px = (pix % W).to(torch.float32)
    py = (pix // W).to(torch.float32)
    return pix, torch.stack([px + 0.5, py + 0.5], -1)


def _gather_dp(x, mesh):
    parts = [torch.empty_like(x) for _ in range(mesh.n_dp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.dp_group)
    return torch.cat(parts, 0)


def render_sharded(scene, camera, filt, frame_index, mesh, max_depth=8,
                   min_depth=0, rr_threshold=1.0):
    """One distributed sample pass: this rank renders its dp shard of the
    pixels with sample index frame_index * n_sp + sp_i; the sp sets are
    averaged (all-reduce sum / n_sp) and the dp shards gathered. Returns
    the full [H, W, 3] image on every rank of the mesh."""
    W, H = camera.resolution
    pix, p_center = _local_pixels(camera, mesh)
    # a distinct RNG stream per sample shard
    st = rng.seed(pix, (int(frame_index) * mesh.n_sp + mesh.sp_i)
                  & 0xFFFFFFFF)
    st, u_film = rng.next_2d(st)
    offset, fw = filt.sample(u_film)
    st, u_lens = rng.next_2d(st)
    ray = camera.generate_ray(p_center + offset, u_lens)
    L, _ = pt.radiance(scene, ray, st, max_depth, min_depth, rr_threshold)
    L = L * fw[..., None]
    dist.all_reduce(L, group=mesh.sp_group)
    L = L / mesh.n_sp
    return _gather_dp(L, mesh).reshape(H, W, 3)


def training_step(scene, camera, filt, frame_index, mesh, target,
                  max_depth=4, groups=("materials",), spp_local=1):
    """Differentiable render step sharded over the mesh: the L2 loss of
    this rank's pixels (`spp_local` samples through pixel centres, each
    bounce checkpointed) against `target` [H, W, 3], its gradient with
    respect to the parameter groups of `diff.optimize.param_surface`, and
    both averaged over every rank of the mesh. Returns (loss 0-dim tensor,
    grads {group: {key: tensor}}); a leaf the loss does not reach gets
    zeros."""
    n_sp = mesh.n_sp
    params = {g: {k: v.detach().clone().requires_grad_(True)
                  for k, v in leaves.items()}
              for g, leaves in param_surface(scene, camera, groups).items()}
    sc, cam = apply_params(scene, camera, params)
    pix, p_film = _local_pixels(cam, mesh)
    dev = p_film.device
    L = torch.zeros((pix.shape[0], 3), dtype=torch.float32, device=dev)
    for s in range(spp_local):
        st = rng.seed(pix, ((int(frame_index) * spp_local + s) * n_sp
                            + mesh.sp_i) & 0xFFFFFFFF)
        Ls, _ = pt.radiance(sc, cam.generate_ray(p_film), st, max_depth, 0,
                            1.0, remat=True)
        L = L + Ls
    L = L / spp_local
    tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)
    tgt = tgt.reshape(mesh.n_dp, -1, 3)[mesh.dp_i]
    diff = L - tgt
    loss = torch.mean(diff * diff)
    keys = [(g, k) for g in params for k in params[g]]
    leaves = [params[g][k] for g, k in keys]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr
             for x, gr in zip(leaves, grads)]
    # one all-reduce of [loss, every gradient] over the whole mesh
    flat = torch.cat([loss.detach().reshape(1)]
                     + [g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat = flat / mesh.size
    out, i = {}, 1
    for (g, k), x in zip(keys, leaves):
        out.setdefault(g, {})[k] = flat[i:i + x.numel()].reshape(x.shape)
        i += x.numel()
    return flat[0], out
