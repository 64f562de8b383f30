"""Build the port's native sources at first use.

Each CUDA source `vision_tpu_torch/csrc/<name>.cu` is compiled by nvcc for
sm_90a into a shared library with a plain C interface, loaded with ctypes by
its wrapper. Every source is built with -fmad=false and without fast math, so
its kernels round as the plain PyTorch versions do. The host BVH builder
(`native/*.cpp`, see `vision_tpu_torch/native.py`) is compiled by g++ the
same way. Libraries go to `vision_tpu_torch/_build/`, named by a hash of
their sources and flags, so a changed source is rebuilt and an unchanged one
is not.
"""
from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(__file__), "..", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "_build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use")


def compile_library(stem, compiler, flags, sources, hashed=()):
    """Compile `sources` with `compiler` and `flags` into
    `_build/lib<stem>_<hash>.so` unless it exists; the hash covers the
    flags, the sources and the `hashed` headers. Returns (library path,
    seconds spent, compiler log); a failed build raises."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in list(sources) + list(hashed):
        with open(path, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, *sources],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"building lib{stem} failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, time.perf_counter() - t0, log


def build(name):
    """Compile `csrc/<name>.cu` unless this source's library exists.
    Returns (library path, seconds spent, compiler log)."""
    return compile_library(name, _nvcc(), NVCC_FLAGS,
                           [os.path.join(CSRC, f"{name}.cu")],
                           sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
