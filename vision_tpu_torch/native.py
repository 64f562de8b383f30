"""ctypes bindings of the native host builder (`native/bvh_builder.cpp`).

Counterpart of `vision_tpu/native.py` (`build_bvh_native`,
`build_bvh_boxes_native`) for the port, which may not import the JAX
package. At first use the sources `native/bvh_builder.cpp` and
`native/mesh_io.cpp` are compiled with g++ into
`vision_tpu_torch/_build/` (the tracked `native/libvision_native.so` is
neither loaded nor rebuilt). A missing compiler or a failed build raises:
the port has no fallback builder.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

from .accel.cuda_build import compile_library

_NATIVE = os.path.join(os.path.dirname(__file__), "..", "native")
SOURCES = [os.path.join(_NATIVE, f) for f in ("bvh_builder.cpp", "mesh_io.cpp")]
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None


def build():
    """Compile the builder unless this source's library exists.
    Returns (library path, seconds spent, compiler log)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX): the BVH builder "
                           "is compiled from native/ at first use")
    return compile_library("vision_native", cxx, CXX_FLAGS, SOURCES)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        F = ctypes.POINTER(ctypes.c_float)
        I = ctypes.POINTER(ctypes.c_int32)
        lib.vt_build_bvh.argtypes = [F, F, F, ctypes.c_int64, ctypes.c_int32,
                                     F, F, I, I, I, I, I]
        lib.vt_build_bvh.restype = ctypes.c_int64
        lib.vt_build_bvh_boxes.argtypes = [F, F, ctypes.c_int64, ctypes.c_int32,
                                           F, F, I, I, I, I, I]
        lib.vt_build_bvh_boxes.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _run(fn, inputs, n, max_leaf):
    """Call a builder entry point; returns the flat arrays of the tree."""
    F = ctypes.POINTER(ctypes.c_float)
    I = ctypes.POINTER(ctypes.c_int32)
    cap = max(2 * n, 2)
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    first, count, skip, axis = (np.empty(cap, np.int32) for _ in range(4))
    order = np.empty(max(n, 1), np.int32)
    nn = fn(*(a.ctypes.data_as(F) for a in inputs), n, max_leaf,
            lo.ctypes.data_as(F), hi.ctypes.data_as(F),
            first.ctypes.data_as(I), count.ctypes.data_as(I),
            skip.ctypes.data_as(I), order.ctypes.data_as(I),
            axis.ctypes.data_as(I))
    if nn <= 0:
        raise ValueError(f"the BVH builder returned {nn} nodes for {n} prims")
    return dict(lo=lo[:nn].copy(), hi=hi[:nn].copy(), first=first[:nn].copy(),
                count=count[:nn].copy(), skip=skip[:nn].copy(),
                axis=axis[:nn].copy(), order=order[:n].copy())


def build_bvh_native(p0, p1, p2, max_leaf=4):
    """Binned-SAH BVH over triangles. Returns a dict of flat arrays:
    lo/hi [N,3] f32, first/count/skip/axis [N] i32 (axis: split axis of an
    inner node, -1 for a leaf; the left child covers the lower side of it),
    order [T] i32 (leaf ranges are contiguous in it)."""
    a = [np.ascontiguousarray(x, np.float32) for x in (p0, p1, p2)]
    return _run(_library().vt_build_bvh, a, len(a[0]), max_leaf)


def build_bvh_boxes_native(lo, hi, max_leaf=1):
    """The same tree over boxes lo/hi [N,3] (the TLAS over instance
    bounds); `order` permutes box ids."""
    a = [np.ascontiguousarray(x, np.float32) for x in (lo, hi)]
    return _run(_library().vt_build_bvh_boxes, a, len(a[0]), max_leaf)
