"""vision_tpu_torch: the vision_tpu path tracer ported to PyTorch + CUDA.

A second package beside the JAX reference `vision_tpu/`, for one NVIDIA
H100. It keeps the reference's layout and module names; plain functions on
tensors and dataclass records replace jnp functions and flax pytrees, and
ray traversal is hand-written CUDA: the dense ray/triangle sweep (kernel
K1, `accel/dense_isect.py`, `csrc/dense_isect.cu`) and the BVH walks, flat
(K2) and instanced (K3) (`accel/packet_isect.py`, `csrc/packet_isect.cu`).
The renderer is differentiable on torch autograd (`diff.optimize`).
Every entry point runs on the card ("cuda") unless the caller passes another
device, as the CPU tests do; nothing probes for a card and nothing falls
back. It imports torch and numpy, never jax.
"""
__version__ = "0.1.0"

import os as _os

# On the CPU, torch's float32 sqrt runs through MKL's vector math in chunks
# of 2048 elements, one chunk per thread. On the first such call of a
# process, MKL's AVX-512 code path sometimes (about 3% of fresh processes
# with 2-8 threads) returns one thread's whole chunk at rsqrt accuracy, up to
# 3.2e-4 relative, which the Fresnel and microfacet cancellations grow to 2%.
# Pinning MKL's reproducible AVX2 code path removes that (its SSE2 path,
# COMPATIBLE, rounds some functions differently from the default path). MKL
# reads this at its first use, so it is set before any op runs; a value set
# by the user is kept.
_os.environ.setdefault("MKL_CBWR", "AVX2")

import torch as _torch  # noqa: E402

# Renderer geometry must stay in full float32 (the JAX package pins
# jax_default_matmul_precision=highest for the same reason: reduced
# precision positions cost ~11% energy on the cornell box).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .scene.scene import Scene, load_scene  # noqa: E402,F401
from .render import render, render_to_file, postprocess  # noqa: E402,F401
from . import diff  # noqa: E402,F401
