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
Their hits are constants on both devices, as the JAX package's packet path
makes them (`stop_gradient` on every kernel input): the kernels write
into fresh tensors, and the plain walks run without a graph. All
four are instantiations of one walk, reached through one C entry
(`vt_bvh_walk`); `count_walk` launches its counting build, from which
chip_smoke.py computes each kernel's bound.
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
        lib.vt_bvh_walk.argtypes = ([ptr] * 6 + [i32, i32] + [ptr] * 6
                                    + [i32, i32] + [ptr] * 4)
        lib.vt_bvh_walk.restype = i32
        lib.vt_packet_error_string.argtypes = [i32]
        lib.vt_packet_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(origin, direction, t_max, tree, instanced):
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"packet_isect: tensors on {dev}, want cuda or cpu")
    R = origin.shape[0]
    m, s = tree.nodes.shape[0], tree.tris.shape[0]
    want = [("origin", origin, (R, 3), torch.float32),
            ("direction", direction, (R, 3), torch.float32),
            ("t_max", t_max, (R,), torch.float32),
            ("nodes", tree.nodes, (m, 16), torch.float32),
            ("tris", tree.tris, (s, 12), torch.float32)]
    if instanced:
        want.append(("insts", tree.insts, (tree.n_inst, 16), torch.float32))
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
    # ray indices run past R by at most one fetch per thread
    if R >= 2 ** 30 or 3 * s >= 2 ** 31 or 4 * m >= 2 ** 31:
        raise ValueError("packet_isect: too many rays, records or slots for int32")


def _launch(name, origin, direction, t_max, tree, any_hit, count=False):
    """Launch the walk over `tree` (K3 if it has instances) on the current
    stream: closest (t, id, bary[, inst]) or any hit (occ,), and with
    `count` also the counting build's (counts [R, 6] int32, rec_seen [M]
    uint8, slot_seen [slots] uint8). A launch of a kernel (not of the
    counting build) adds one to LAUNCHES[name]."""
    instanced = getattr(tree, "insts", None) is not None
    _check(origin, direction, t_max, tree, instanced)
    R, dev = origin.shape[0], origin.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    if any_hit:
        outs = (empty(R, torch.bool),)
        ptrs = [None] * 4 + [outs[0].data_ptr()]
    else:
        outs = (empty(R, torch.float32), empty(R, torch.int32),
                empty((R, 2), torch.float32))
        if instanced:
            outs += (empty(R, torch.int32),)
        ptrs = [x.data_ptr() for x in outs] + [None] * (5 - len(outs))
    seen = ()
    if count:
        seen = (torch.zeros((R, 6), dtype=torch.int32, device=dev),
                torch.zeros(tree.nodes.shape[0], dtype=torch.uint8, device=dev),
                torch.zeros(tree.tris.shape[0], dtype=torch.uint8, device=dev))
    if R:
        with torch.cuda.device(dev):
            lib = _library()
            nxt = torch.empty(1, dtype=torch.int32, device=dev)  # ray counter
            code = lib.vt_bvh_walk(
                origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
                tree.nodes.data_ptr(), tree.tris.data_ptr(),
                tree.insts.data_ptr() if instanced else None, tree.bsize, R,
                nxt.data_ptr(), *ptrs, int(any_hit), int(count),
                *([x.data_ptr() for x in seen] if count else [None] * 3),
                torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"packet_isect {name} launch failed: "
                                   f"{lib.vt_packet_error_string(code).decode()}")
        if not count:
            LAUNCHES[name] += 1
    return outs + seen


def count_walk(origin, direction, t_max, tree, any_hit=False):
    """The counting build of the kernel `tree` takes (K2 or K3), for
    measurement only: its outputs, which equal the kernel's, then per ray
    counts [R, 6] int32 (inner records, leaves, box tests, triangle tests,
    instance entries, deepest stack) and the records [M] and triangle slots
    [slots] it read, as uint8 flags. Not counted in LAUNCHES."""
    if origin.device.type != "cuda":
        raise ValueError("packet_isect.count_walk runs on the card only")
    return _launch("count", origin, direction, t_max, tree, any_hit, True)


def closest(origin, direction, t_max, pbvh):
    """K2 closest hit of rays origin/direction [R, 3], t_max [R] against a
    PacketBVH. Returns (t [R], prim_id [R] int32 original id, bary [R, 2]);
    a miss gives t = t_max, id -1, bary 0; a lane with t_max <= 0 misses."""
    if origin.device.type == "cpu":
        with torch.no_grad():
            return intersect_packet_plain(origin, direction, t_max, pbvh)
    return _launch("closest", origin, direction, t_max, pbvh, False)


def anyhit(origin, direction, t_max, pbvh):
    """K2 any hit: [R] bool, some triangle with 0 < t < t_max."""
    if origin.device.type == "cpu":
        with torch.no_grad():
            return intersect_packet_plain(origin, direction, t_max, pbvh,
                                          any_hit=True)
    return _launch("anyhit", origin, direction, t_max, pbvh, True)[0]


def closest_inst(origin, direction, t_max, ipbvh):
    """K3 closest hit against an InstancedPBVH: (t, prim_id as a global
    object-space id, bary, inst [R] int32 TLAS instance, -1 on a miss)."""
    if origin.device.type == "cpu":
        with torch.no_grad():
            return intersect_packet_inst_plain(origin, direction, t_max, ipbvh)
    return _launch("closest_inst", origin, direction, t_max, ipbvh, False)


def anyhit_inst(origin, direction, t_max, ipbvh):
    """K3 any hit: [R] bool."""
    if origin.device.type == "cpu":
        with torch.no_grad():
            return intersect_packet_inst_plain(origin, direction, t_max,
                                               ipbvh, any_hit=True)
    return _launch("anyhit_inst", origin, direction, t_max, ipbvh, True)[0]
