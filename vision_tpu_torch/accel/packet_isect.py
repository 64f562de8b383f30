"""K2 and K3 on the card: BVH traversal as hand-written CUDA kernels.

`closest` / `anyhit` (K2, a flat tree) replace the Pallas kernels
`_closest_kernel` / `_anyhit_kernel` (v2) and `_win_kernel3` (v3) of
`vision_tpu/accel/packet_bvh.py`, reached through `intersect_packet`;
`closest_inst` / `anyhit_inst` (K3, the TLAS over instances, then each
mesh's tree) replace `_inst_closest_kernel` / `_inst_anyhit_kernel`,
reached through `intersect_packet_inst`. The kernels are in
`csrc/packet_isect.cu`, built at first use by `accel/cuda_build.py`.

Their plain PyTorch versions are `packet_bvh.intersect_packet_plain` and
`intersect_packet_inst_plain`. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .packet_bvh import STACK, intersect_packet_inst_plain, intersect_packet_plain

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"closest": 0, "anyhit": 0, "closest_inst": 0, "anyhit_inst": 0}

_lib = None


def build():
    """Compile the kernels unless this source's library exists.
    Returns (library path, seconds spent, compiler log)."""
    return cuda_build.build("packet_isect")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vt_packet_stack.argtypes = []
        lib.vt_packet_stack.restype = i32
        if lib.vt_packet_stack() != STACK:
            raise RuntimeError(f"packet_isect.cu has a stack of "
                               f"{lib.vt_packet_stack()}, packet_bvh.py {STACK}")
        lib.vt_bvh_closest.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 4
        lib.vt_bvh_anyhit.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 2
        lib.vt_bvh_closest_inst.argtypes = ([ptr] * 5 + [i32] + [ptr] * 2
                                            + [i32] + [ptr] * 5)
        lib.vt_bvh_anyhit_inst.argtypes = ([ptr] * 5 + [i32] + [ptr] * 2
                                           + [i32] + [ptr] * 2)
        for fn in (lib.vt_bvh_closest, lib.vt_bvh_anyhit,
                   lib.vt_bvh_closest_inst, lib.vt_bvh_anyhit_inst):
            fn.restype = i32
        lib.vt_packet_error_string.argtypes = [i32]
        lib.vt_packet_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(origin, direction, t_max, tree, instanced):
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"packet_isect: tensors on {dev}, want cuda or cpu")
    R = origin.shape[0]
    n, s = tree.nodes.shape[0], tree.tris.shape[0]
    want = [("origin", origin, (R, 3), torch.float32),
            ("direction", direction, (R, 3), torch.float32),
            ("t_max", t_max, (R,), torch.float32),
            ("nodes", tree.nodes, (n, 8), torch.float32),
            ("tris", tree.tris, (s, 12), torch.float32)]
    if instanced:
        i = tree.inst_root.shape[0]
        want += [("inst_root", tree.inst_root, (i,), torch.int32),
                 ("inst_w2o", tree.inst_w2o, (i, 12), torch.float32)]
    for name, x, shape, dtype in want:
        if x.device != dev:
            raise ValueError(f"packet_isect: {name} on {x.device}, want {dev}")
        if x.dtype != dtype:
            raise ValueError(f"packet_isect: {name} is {x.dtype}, want {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"packet_isect: {name} has shape "
                             f"{tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"packet_isect: {name} is not contiguous")
    if tree.depth > STACK:
        raise ValueError(f"packet_isect: tree depth {tree.depth} > stack {STACK}")
    if R >= 2 ** 31 or 3 * s >= 2 ** 31 or 2 * n >= 2 ** 31:
        raise ValueError("packet_isect: too many rays, nodes or slots for int32")


def _launch(name, fn, *args):
    lib = _library()
    code = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"packet_isect {name} launch failed: "
                           f"{lib.vt_packet_error_string(code).decode()}")
    LAUNCHES[name] += 1


def _rays(origin, direction, t_max, tree):
    return (origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
            tree.nodes.data_ptr(), tree.tris.data_ptr(), tree.bsize)


def closest(origin, direction, t_max, pbvh):
    """K2 closest hit of rays origin/direction [R, 3], t_max [R] against a
    PacketBVH. Returns (t [R], prim_id [R] int32 original id, bary [R, 2]);
    a miss gives t = t_max, id -1, bary 0; a lane with t_max <= 0 misses."""
    if origin.device.type == "cpu":
        return intersect_packet_plain(origin, direction, t_max, pbvh)
    _check(origin, direction, t_max, pbvh, False)
    R = origin.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=origin.device)
    pid = torch.empty(R, dtype=torch.int32, device=origin.device)
    bary = torch.empty((R, 2), dtype=torch.float32, device=origin.device)
    if R:
        with torch.cuda.device(origin.device):
            _launch("closest", "vt_bvh_closest",
                    *_rays(origin, direction, t_max, pbvh), R, t.data_ptr(),
                    pid.data_ptr(), bary.data_ptr())
    return t, pid, bary


def anyhit(origin, direction, t_max, pbvh):
    """K2 any hit: [R] bool, some triangle with 0 < t < t_max."""
    if origin.device.type == "cpu":
        return intersect_packet_plain(origin, direction, t_max, pbvh,
                                      any_hit=True)
    _check(origin, direction, t_max, pbvh, False)
    R = origin.shape[0]
    occ = torch.empty(R, dtype=torch.bool, device=origin.device)
    if R:
        with torch.cuda.device(origin.device):
            _launch("anyhit", "vt_bvh_anyhit",
                    *_rays(origin, direction, t_max, pbvh), R, occ.data_ptr())
    return occ


def closest_inst(origin, direction, t_max, ipbvh):
    """K3 closest hit against an InstancedPBVH: (t, prim_id as a global
    object-space id, bary, inst [R] int32 TLAS instance, -1 on a miss)."""
    if origin.device.type == "cpu":
        return intersect_packet_inst_plain(origin, direction, t_max, ipbvh)
    _check(origin, direction, t_max, ipbvh, True)
    R = origin.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=origin.device)
    pid = torch.empty(R, dtype=torch.int32, device=origin.device)
    bary = torch.empty((R, 2), dtype=torch.float32, device=origin.device)
    inst = torch.empty(R, dtype=torch.int32, device=origin.device)
    if R:
        with torch.cuda.device(origin.device):
            _launch("closest_inst", "vt_bvh_closest_inst",
                    *_rays(origin, direction, t_max, ipbvh),
                    ipbvh.inst_root.data_ptr(), ipbvh.inst_w2o.data_ptr(), R,
                    t.data_ptr(), pid.data_ptr(), bary.data_ptr(),
                    inst.data_ptr())
    return t, pid, bary, inst


def anyhit_inst(origin, direction, t_max, ipbvh):
    """K3 any hit: [R] bool."""
    if origin.device.type == "cpu":
        return intersect_packet_inst_plain(origin, direction, t_max, ipbvh,
                                           any_hit=True)
    _check(origin, direction, t_max, ipbvh, True)
    R = origin.shape[0]
    occ = torch.empty(R, dtype=torch.bool, device=origin.device)
    if R:
        with torch.cuda.device(origin.device):
            _launch("anyhit_inst", "vt_bvh_anyhit_inst",
                    *_rays(origin, direction, t_max, ipbvh),
                    ipbvh.inst_root.data_ptr(), ipbvh.inst_w2o.data_ptr(), R,
                    occ.data_ptr())
    return occ
