"""K1 on the card: the dense ray/triangle sweep as hand-written CUDA kernels.

`closest` and `anyhit` replace the Pallas kernels `_closest_kernel` and
`_anyhit_kernel` of `vision_tpu/accel/pallas_isect.py` (reached through
`intersect_pallas`). The kernels are in `csrc/dense_isect.cu` (persistent
blocks, the scene staged once per block in shared memory, two rays per
thread, dead rays answered at once and skipped); they are compiled with
nvcc for sm_90a at first use into `vision_tpu_torch/_build/`
(`accel/cuda_build.py`: a shared library with a plain C interface, loaded
with ctypes), from the sources in the checkout only.

`closest_plain` and `anyhit_plain` are their plain PyTorch versions (the
port of `intersect_brute` / `occluded_brute`, blocked over 128 triangles).
A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises. A build or launch failure is an
exception, never a switch to the plain version.

The closest hit carries a gradient, as the JAX package's CPU route
(`intersect_brute` + `recompute_bary`, plain jnp) does: when the rays
require grad, `closest` runs through `_Closest`, whose forward is the
kernel (or the plain sweep) without a graph and whose backward
differentiates the winner's Möller-Trumbore t and (u, v) with respect to
origin, direction and t_max (a miss passes t's gradient to t_max), in
torch ops over one gathered row per ray (`intersect.recompute_hit`). A
call without grad takes the kernel alone and adds no operation. The any
hit is a boolean and has no gradient, as `occluded_brute`'s.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import Ray
from . import cuda_build
from . import intersect as isect

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"closest": 0, "anyhit": 0}

_lib = None


def _split(tris):
    return tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]


def closest_plain(origin, direction, t_max, tris):
    """Plain closest hit: (t [R] f32, prim_id [R] int32, bary [R, 2] f32);
    a miss gives t = t_max, id -1, bary 0."""
    hit = isect.intersect_brute(Ray(origin, direction, t_max), *_split(tris))
    return hit.t, hit.prim_id, hit.bary


def anyhit_plain(origin, direction, t_max, tris):
    """Plain any hit: [R] bool, a hit with 0 < t < t_max."""
    return isect.occluded_brute(Ray(origin, direction, t_max), *_split(tris))


def build():
    """Compile the kernels unless this source's library exists.
    Returns (library path, seconds spent, compiler log)."""
    return cuda_build.build("dense_isect")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vt_dense_closest.argtypes = [ptr] * 4 + [i32, i32] + [ptr] * 4
        lib.vt_dense_closest.restype = i32
        lib.vt_dense_anyhit.argtypes = [ptr] * 4 + [i32, i32] + [ptr] * 2
        lib.vt_dense_anyhit.restype = i32
        lib.vt_error_string.argtypes = [i32]
        lib.vt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(origin, direction, t_max, tris):
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"dense_isect: tensors on {dev}, want cuda or cpu")
    R = origin.shape[0]
    for name, x, shape in (("origin", origin, (R, 3)),
                           ("direction", direction, (R, 3)),
                           ("t_max", t_max, (R,)),
                           ("tris", tris, (tris.shape[0], 9))):
        if x.device != dev:
            raise ValueError(f"dense_isect: {name} on {x.device}, want {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"dense_isect: {name} is {x.dtype}, want float32")
        if tuple(x.shape) != shape:
            raise ValueError(f"dense_isect: {name} has shape "
                             f"{tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"dense_isect: {name} is not contiguous")
    # the kernels index rays by chunks of 32 across the grid, in int32
    if R >= 2 ** 30 or tris.shape[0] >= 2 ** 31 // 9:
        raise ValueError("dense_isect: too many rays or triangles for int32")


def _raise_on(lib, code, name):
    if code != 0:
        raise RuntimeError(f"dense_isect {name} launch failed: "
                           f"{lib.vt_error_string(code).decode()}")


class _Closest(torch.autograd.Function):
    """The closest hit with the gradient of the winner's t and (u, v)."""

    @staticmethod
    def forward(ctx, origin, direction, t_max, tris):
        t, pid, bary = _closest(origin, direction, t_max, tris)
        ctx.save_for_backward(origin, direction, t_max, tris, pid)
        ctx.mark_non_differentiable(pid)
        return t, pid, bary

    @staticmethod
    def backward(ctx, g_t, _g_pid, g_bary):
        origin, direction, t_max, tris, pid = ctx.saved_tensors
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in (origin, direction,
                                                         t_max)]
            t, bary = isect.recompute_hit(Ray(*xs), pid, *_split(tris))
            # with no triangle, bary is a constant 0
            ys, gys = zip(*[(y, g) for y, g in ((t, g_t), (bary, g_bary))
                            if y.requires_grad])
            gs = torch.autograd.grad(ys, xs, gys, allow_unused=True)
        return (*(torch.zeros_like(x) if g is None else g
                  for x, g in zip(xs, gs)), None)


def closest(origin, direction, t_max, tris):
    """Closest hit of rays origin/direction [R, 3], t_max [R] against
    triangles tris [T, 9] (p0 e1 e2). Returns (t [R], prim_id [R] int32,
    bary [R, 2]); a miss gives t = t_max, id -1, bary 0, and so does a
    dead ray (t_max <= 0), which the kernel answers without a sweep.
    t and bary carry the gradient of the winner's hit when a ray input
    requires grad (`_Closest`)."""
    if torch.is_grad_enabled() and (origin.requires_grad
                                    or direction.requires_grad
                                    or t_max.requires_grad):
        return _Closest.apply(origin, direction, t_max, tris)
    return _closest(origin, direction, t_max, tris)


def _closest(origin, direction, t_max, tris):
    if origin.device.type == "cpu":
        return closest_plain(origin, direction, t_max, tris)
    _check(origin, direction, t_max, tris)
    R = origin.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=origin.device)
    pid = torch.empty(R, dtype=torch.int32, device=origin.device)
    bary = torch.empty((R, 2), dtype=torch.float32, device=origin.device)
    if R:
        lib = _library()
        with torch.cuda.device(origin.device):
            code = lib.vt_dense_closest(
                origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
                tris.data_ptr(), R, tris.shape[0], t.data_ptr(),
                pid.data_ptr(), bary.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, code, "closest")
        LAUNCHES["closest"] += 1
    return t, pid, bary


def anyhit(origin, direction, t_max, tris):
    """Whether any triangle is hit with 0 < t < t_max: [R] bool."""
    if origin.device.type == "cpu":
        return anyhit_plain(origin, direction, t_max, tris)
    _check(origin, direction, t_max, tris)
    R = origin.shape[0]
    occ = torch.empty(R, dtype=torch.bool, device=origin.device)
    if R:
        lib = _library()
        with torch.cuda.device(origin.device):
            code = lib.vt_dense_anyhit(
                origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
                tris.data_ptr(), R, tris.shape[0], occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, code, "anyhit")
        LAUNCHES["anyhit"] += 1
    return occ
