"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel from the checkout's sources, all at once: K1 (the dense
ray/triangle sweep, `vision_tpu_torch/csrc/dense_isect.cu`), K2 and K3 (BVH
traversal, flat and instanced, `csrc/packet_isect.cu`) and the native SAH
builder (`native/*.cpp`), into `vision_tpu_torch/_build/`. Then, phase by
phase, one JSON line each:

  * K1 against its plain PyTorch version on the cornell box's primary
    wavefront, one bounce, a shadow wavefront with about half its lanes
    dead, the dense path's upper bound (2048 triangles) and every edge
    shape (1, 33 and 1,000 rays; 0, 1, 512, 513, 2048, 2049 and 261,156
    triangles),
    and the cornell box (`tests/fixtures.py` CBOX_JSON: 36 triangles,
    512x512, depth 8, 16 spp) rendered through `vision_tpu_torch.render`
    and held against its 1024-spp golden;
  * K2 against the plain walk and against K1 over the same 261,156
    triangles, on `cbox_sphere`'s 512^2 primary rays and one bounce;
  * K3 against the plain walk and against K2 on its flat twin, on
    `cbox_spheres_instanced`'s 512^2 primary rays and one bounce;
  * `cbox_sphere` rendered at 512^2, depth 8, 16 spp through K2 and held
    against `tests/goldens/cbox_sphere_hdr.npz`;
  * `cbox_spheres_instanced` rendered through K3 and its flat twin
    (VT_INSTANCING=0) through K2, held against each other;
  * the materials and lights of slice 1b: `cbox_glass` (glass and mirror
    boxes, ladder config 2; 36 triangles, K1) at 512^2, 64 spp, held
    against `tests/goldens/cbox_glass_hdr.npz`; `cbox_zoo` (every material
    family, point, spot and projector lights beside the area light;
    6,276 triangles, K2) at 512^2, 16 spp, held against
    `tests/goldens/cbox_zoo_hdr.npz`; `cbox_sky` (a substitute unit sky
    through the open front; K1) at 64^2, 16 spp on the card, held against
    the port's own render of the same seeds on the CPU;
  * the spectral and media transport of slice 4 (`phase_slice4`):
    `cbox_glass_hero` (`cbox_glass` under the hero spectrum of dimension
    4, dispersive BK7; ladder config 3, its 256 spp cut to 64) at 512^2
    through K1, held against `tests/goldens/cbox_glass_hero_hdr.npz`;
    `fog_cbox` (the cbox in a global homogeneous fog, srgb) at 512^2, 16
    spp through K1, held against `tests/goldens/fog_cbox_hdr.npz`;
    `cbox_sss` (a subsurface tall box under the hero spectrum) at 64^2,
    16 spp on the card, held against the port's CPU render of the same
    seeds; and `render_to_file` on the cbox (64^2, 4 spp), whose PNG,
    written without PIL, must decode to the tonemapped render;
  * images, node graphs, IES, adaptive sampling and the light field
    (slices 4c, 4d and 7a, `phase_images`; the images and the IES profile
    of `tests/assets_torch/`, read by the port's own decoders): `cbox_tex`
    (a baked image node, a uv-mapped texture, a normal map, a
    fresnel-driven colour, an IES spot, a textured emitter; K1) at 512^2,
    16 spp, held against `tests/goldens/cbox_tex_hdr.npz`; `env_sphere`
    (a checkered sphere under the `mix` of two .hdr skies and a projector
    image; 6,242 triangles, K2) at 512^2, and at 64^2 against the port's
    CPU render; the cbox through `render(adaptive=True)` at 64 spp,
    which must take fewer samples and pass the cbox golden; the cbox's
    light field (grid 3, a thin lens; 2.36M lanes) at 16 spp, whose views
    must differ and refocus at 0 to their mean, and whose tiles at a 64^2
    base must be within 0.01 of the CPU render; and `render_to_file`'s
    EXR, which must read back bit for bit as the render;
  * gradients (slice 5, `phase_grad`): a render without grad launching
    no more kernels per iteration than before; one loss-and-gradient step
    of `diff.optimize.make_loss` on the cbox at 512^2, depth 8, 16 spp
    (BASELINE's 1024 cut to 16), each bounce checkpointed, all four
    parameter groups (materials, lights, atlas, camera), its forward,
    backward and step walls, peak memory, K1's launches in the forward
    and in the backward's replay and kernel launches per bounce; the
    identity sum_c color_c d mean / d color_c = mean (the srgb image is
    linear in the light's colour) to 1e-4 at 512^2; the card's gradients
    against the port's CPU ones at 64^2 (the cbox, every group, the
    camera's through K1's hit; cbox_sphere's kd and light colour through
    K2) at rtol 1e-3, atol 1e-3 max|g|; K1's autograd Function against
    autograd through the plain sweep at 262,144 rays; the texture
    recovery of tests/test_diff.py at 128^2 (24 Adam steps, the last loss
    below 0.35 of the first); and peak memory at 128^2, 16 spp with and
    without the checkpoints.
  * the real-time loop (slice 6, `phase_realtime`): the cbox at 512^2 at
    its defaults (m_light 8, spatial_taps 2, svgf_passes 3, SHARC,
    gi_bounce_depth 2) through K1, timed as bench.py's bench_classroom_rt
    (one warm-up frame, two more, four timed), with kernel launches and
    device time a frame and the split by stage (G-buffer, ReSTIR DI,
    ReSTIR GI with the cache, SVGF); the cbox at 128^2, frames 0 and 7,
    against `tests/goldens/cbox_rt_hdr.npz` (the JAX loop's frames); four
    frames at 64^2 on the card against the port's CPU frames; and
    `cbox_sphere` at 512^2 with the surfel cache and GI at half
    resolution through K2.
  * mesh files, glTF, JPEG, the CLI and the SDK (slices 7, 7b and 8a,
    `phase_meshes`): `cbox_sphere`'s 261,120-triangle sphere written as
    OBJ, PLY, GLB and STL (tests/torch_scenes.py) and loaded as a `model`
    shape, tri_pack bit for bit against the procedural scene (the STL's
    positions); the OBJ twin at 512^2, 16 spp through K2 against the
    cbox_sphere golden and this call's procedural render; the OBJ placed
    16 times through K3 against the procedural instanced render;
    `gltf_cbox` (a GLB: pbrMetallicRoughness materials, a JPEG floor, a
    gold sphere, an emissive light, a KHR_lights_punctual point light, a
    camera node; 996 triangles, K1) at 512^2, 16 spp against
    `tests/goldens/gltf_cbox_hdr.npz`; every committed JPEG against its PIL
    decode, the 2048^2 one timed, with no PIL or OpenCV imported;
    `python -m vision_tpu_torch.cli` in process: the GLB to a PNG within
    one level of the tonemapped render, `-p graph`, `-p realtime` and
    `--denoise` at 128^2, an EXR read back bit for bit; and the SDK
    (`VisionRenderer`) on the OBJ's arrays at 512^2, 16 spp through K2,
    and at 64^2 on the card against the CPU.
  * the lightmap bake (slice 8b, `phase_bake`): the cbox baked through K1
    at the CLI's defaults (lightmap 256: 28,463 texel lanes, 16 spp, depth
    4) and `cbox_sphere(sub_div=40)` (6,276 triangles) through K2 at
    lightmap 1024 (404,241 lanes), each displayed by `render_baked` at
    512^2 within (0.3, 3) of the path-traced render's mean; host seconds
    of the unwrap and rasterization, device seconds of the bake, launches
    a pass, rays per second; the CLI's `-p bake` to a PNG within one level
    of the display; the card's lightmap-64 bake against the port's CPU
    bake (8x8 block error and bias <= 0.01).
  * distribution (slice 9, `phase_dist`): a world-size-1 NCCL group,
    `render_sharded` of the cbox at 512^2 bit for bit against the
    single-process pass, `training_step` against the same step taken in
    one process (rtol 1e-6 under torch's deterministic algorithms;
    BASELINE's tolerance in the default mode, whose atomic adds reorder),
    `measure_weak_scaling(dp_sizes=(1,))` timed. Several ranks are held
    on the CPU (tests/test_torch_dist.py): one card hosts one NCCL rank.
  * the utilities (slice 8b, `phase_utils`): `render_resumable` of the
    cbox at 512^2, 16 spp, stopped at 8 and resumed, bit for bit against
    the uninterrupted run; `scene_memory_stats` of cbox_sphere;
    `overlay_rays` of 16 pixels at 512^2.
  * the image files of slices 7c, 7d, 7e.1, 7e.6a, 7e.3b, 7e.4 and 7e.6b
    (`phase_image_files`):
    progressive, CMYK, YCCK, RGB, lossless and arithmetic-coded JPEG,
    Adam7, low-depth and 16-bit PNG, TGA, BMP, TIFF, GIF and WebP files of
    tests/assets_torch/, each decoded on the card's host, timed and held
    bit for bit against its committed PIL decode (image_decodes.npz,
    webp_decodes.npz); the OpenEXR files (every compression, tiled,
    multi-part) against their libOpenEXR decodes (exr_decodes.npz); the
    timing files `lzw_2048.tif`, `piz_2048.exr`, `grain_2048.webp` and
    `smooth_2048.webp`; the deep refusals. Slices 7e.2 and 7e.3a: the
    OpenEXR files OpenCV converts with its own code against OpenCV
    4.6.0's decodes (exr_cv_decodes.npz; `yc_2048.exr` and `deep_512.exr`
    timed), the PNM, PAM, PFM, Sun raster, BMP and YCCK JPEG files under
    .hdr / .exr names against the pip cv2's (cv_decodes.npz), an AVIF
    file under a .hdr name raising naming 7e. Slice 7e.6a: the files of
    the small formats PIL opens (PCX, SGI, MSP, PSD, XPM, DDS with BC1-BC7
    blocks, Sun raster, ICNS, CUR, QOI, PPM, ICO) against PIL's decodes
    (pil_decodes.npz, IM's rarer types among them), and a 2048^2 BC7 file
    built from a seed against its decode's sha256. Slice 7e.3b: TIFF and
    GIF files under .hdr / .exr names against the pip cv2's decodes
    (cvtiff_decodes.npz), and a 2048^2 float32 LZW TIFF built from a seed
    (`sky_2048.exr`) against its decode's sha256. Slice 7e.4: the rarer
    TIFF codecs and layouts on both routes against PIL's and the pip
    cv2's decodes (tiff_decodes.npz), and the committed 2048^2 Group 4
    page `g4_2048.tif` against its decode's sha256. Slice 7e.6b: the
    rarer formats PIL opens (BLP, FLI / FLC, FITS, FTEX, GBR, IMT, IPTC,
    McIdas, PIXAR, XV thumbnails) against PIL's decodes
    (pil_rare_decodes.npz), a 2048^2 BLP2 DXT5 file and a PhotoCD file
    built from seeds against their decodes' sha256. Slice 7e.4b: the
    old-style JPEG TIFF files (both layouts, every sampling, strips with
    restart intervals, tiles, planes, grey, tags left out) against PIL's
    decodes (ojpeg_decodes.npz), the ones PIL refuses refused, and a
    2048^2 tables-only file of 16-row strips built from a seed against
    its decode's sha256. Slice 7e.4b on OpenCV's route: the SGILog TIFF
    files under .hdr / .exr names (LogLuv32 and LogLuv24 as float XYZ
    through OpenCV's XYZ2BGR, LogL as libtiff's 8-bit grey; strips,
    tiles, odd widths, every uv code) against the pip cv2's decodes
    (sgilog_decodes.npz), the `sl_bad_*` files it refuses refused, and a
    2048^2 LogLuv32 file of 128 strips built from a seed (`luv_2048.exr`)
    against its decode's sha256, timed. Slice 7e.7a: the JPEG 2000 files
    (J2K and JP2; L, LA, I;16, RGB, RGBA, CMYK, sYCC, P and PA; 5/3 and
    9/7; every progression, tiles, layers, precincts, every code-block
    style, ROI, SOP / EPH, COC / QCC, POC, PPM / PPT, sub-sampled
    components; ICNS JPEG 2000 icons) against PIL's decodes
    (j2k_decodes.npz), the `j2k_bad_*` files PIL refuses refused, and the
    committed 2048^2 9/7 file `j2k_2048.jp2` against its decode's sha256,
    timed. Slice 7e.7b: every JPEG 2000 file of j2k_cv_decodes.npz under a
    .exr name (OpenJPEG's whole-image decode, JP2's palette, cmap and
    cdef boxes, OpenCV's colour-space rules, 9-16-bit samples, sYCC, POC
    stops) against the pip cv2's decode, the ones it refuses refused, and
    `j2k_2048.jp2` under a .exr name against its decode's sha256, timed.
    Slice 7e.7d: on both routes, with the files above, the files of Part
    2's CBD, MCT, MCC and MCO markers (in the main and tile-part headers)
    and of tiles with fewer resolutions than an earlier tile. Slice 7e.7c:
    on both routes, with the files above, the HTJ2K files (Part 15's HT
    code-blocks: cleanup, SigProp and MagRef, every code-block shape and
    style, layers, CAP / CPF; the `htj2k_bad_*` files refused) and the
    2048^2 HT file `htj2k_2048.jp2` against each library's decode's
    sha256, timed. Slice 7e.8a.1: the AVIF files of `avif_decodes.npz`
    (lossless AV1 on PIL's route; the `avif_bad_*` files refused, the
    `avif_later_*` ones raising naming their sub-item) and the 2048^2
    lossless file `avif_2048.avif` against PIL's decode's sha256, timed.
    Slice 7e.8a.2a: the lossy AVIF files of `avifq_decodes.npz` (every
    quantiser context, speeds 5-10, every subsampling, transform size and
    type aom picks, the deblocking filter; the `avif_later_*` ones of
    7e.8a.2b raising naming it) and the 2048^2 lossy file
    `avif_lossy_2048.avif` against PIL's decode's sha256, timed. Slice
    7e.8a.2c.1: the AVIF files of `avifibc_decodes.npz` (intra block copy:
    the displacement vectors, the var-tx tree, the inter transform sets
    with flipped ADST; qualities 0-99, speeds 0-7, lossless, every
    subsampling, odd sizes, tiles, 128x128 superblocks, alpha; and
    `avif_later_intrabc.avif` of `avif_decodes.npz`) and the 2048^2 file
    `avifibc_2048.avif` against PIL's decode's sha256, timed.
  * the twin scenes of slices 7d, 7e.1, 7e.2, 7e.3a, 7e.6a, 7e.3b, 7e.4
    7e.6b, 7e.5, 7e.4b, 7e.7a, 7e.7b, 7e.7d, 7e.7c, 7e.8a.1, 7e.8a.2a and
    7e.8a.2c.1 (`phase_image_twins`):
    `cbox_tex_files`,
    `cbox_tex_webp`, `cbox_sky_yc`, `cbox_tex_pil`, `cbox_tex_dds`,
    `cbox_sky_cvtiff`, `cbox_sky_bigtiff`, `cbox_tex_rare`,
    `cbox_tex_smooth`, `cbox_tex_ojpeg`, `cbox_sky_logluv`,
    `cbox_tex_j2k`, `cbox_sky_j2kcv`, `cbox_tex_j2kp2`,
    `cbox_tex_htj2k`, `cbox_tex_avif`, `cbox_tex_avifq` and
    `cbox_tex_avifibc` through K1,
    `env_sphere_files`, `env_sphere_webp`, `env_sphere_cv`,
    `env_sphere_pil`, `env_sphere_cvgif`, `env_sphere_zstd`,
    `env_sphere_rare`, `env_sphere_lossless`, `env_sphere_ojpeg`,
    `env_sphere_luv24`, `env_sphere_j2k`, `env_sphere_j2kcv`,
    `env_sphere_j2kp2cv`, `env_sphere_htj2kcv`, `env_sphere_avif`,
    `env_sphere_avifq` and `env_sphere_avifibc` through K2 at 512^2, their
    images read from TIFF
    (LZW, BigTIFF, ZSTD, old-style JPEG, SGILog LogLuv32 and LogLuv24), GIF,
    JPEG (cut progressive, lossless), OpenEXR (plain, luminance-chroma, deep),
    JPEG 2000 (lossy JP2, tiled J2K, a JP2 of Part 2's CBD and MCO, a
    reversible HTJ2K JP2; a 16-bit lossless JP2 named .exr, a 9/7 JP2
    named .hdr, tiles of different MCOs named .exr and a 9/7 HTJ2K
    codestream named .exr on OpenCV's route),
    lossless AVIF (4:2:0, an alpha item), lossy AVIF at PIL's defaults
    (a natural texture; a lossy alpha item), AVIF with intra block copy at
    PIL's defaults (the checker's colours; a screen-like projector),
    WebP, PFM, QOI, PPM, SGI, ICO, BC7 DDS, BLP, GBR, FLC and PIXAR files
    and OpenCV's TIFF and GIF readers, each bit for bit with its original's render in the same
    run (`cbox_tex_webp`'s, `cbox_tex_dds`'s, `cbox_tex_j2k`'s and
    `cbox_tex_j2kp2`'s originals read PIL's decode of their checker,
    `env_sphere_j2k`'s PIL's decode of its projector, `cbox_sky_yc`'s, `cbox_sky_cvtiff`'s,
    `cbox_sky_bigtiff`'s, `env_sphere_cvgif`'s, `cbox_sky_logluv`'s,
    `env_sphere_luv24`'s, `cbox_sky_j2kcv`'s, `env_sphere_j2kcv`'s,
    `env_sphere_j2kp2cv`'s and `env_sphere_htj2kcv`'s the OpenCV decode
    of their image, `cbox_tex_avif`'s, `env_sphere_avif`'s,
    `cbox_tex_avifq`'s, `env_sphere_avifq`'s, `cbox_tex_avifibc`'s and
    `env_sphere_avifibc`'s PIL's decode of theirs),
    with the same launch counts as the render it is held
    against.
  * the bench ladder (slice 10, `phase_bench`): `python -m
    vision_tpu_torch.bench` in a subprocess, as a user runs it; its one
    JSON line printed again and held to bench.py's schema (metric, unit, a
    finite positive value, the gradient rung, no rung in error); one
    `_wave_metric` pass of the cbox rung and the grad rung's
    `_grad_metric` (256^2, depth 4, two steps) under the launch counts
    (K1, the grad rung through K1's gradient); and the rungs that read reference scenes (absent here) on generated
    stand-ins at their own sizes, on lines of their own: the staircase
    rungs on `cbox_sphere` (K2), the kitchen on the 1.04M-triangle flat
    twin (K2), the prism on `cbox_glass_hero` (K1), classroom_rt on the
    cbox (K1).

Each render runs with every launch count set to 0 just before it and read
just after, and fails if a kernel of its path was not launched. On the K2
and K3 wavefronts the kernels' counting build (`packet_isect.count_walk`)
records the work each walk needed (box and triangle tests, records and
slots read), checked against the numpy model of the walk
(`tests/torch_walk_model.py`) on the first rays; from it, and for K1 from
the rays' t_max (dead rays need no tests) and, for the any hit, the
tests up to each ray's first occluder, comes each kernel's bound: the
larger of its operations at the card's fp32 peak and its bytes at its
memory rate. A kernel's `ms` is its device time with no host work in the
window (calls captured in a CUDA graph, replays timed with CUDA events;
K1's cross-checked once with torch.profiler); `call_ms` is the same calls
made back to back from Python, the wrapper's host side included. Last come
the kernel table, the card's name and power limit, and as the last line
`{"ok": true, "device": {...}}`. Any failed check raises, and the script
exits non-zero without that line; it never runs on the CPU.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import os
import statistics
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
RES = 512
SEED = 0
SPP = 16
SOURCES = {"dense_isect": "vision_tpu_torch/csrc/dense_isect.cu",
           "packet_isect": "vision_tpu_torch/csrc/packet_isect.cu"}
REPLACES = {
    "dense_isect.closest": "vision_tpu/accel/pallas_isect.py:82",
    "dense_isect.anyhit": "vision_tpu/accel/pallas_isect.py:117",
    "packet_isect.closest": "vision_tpu/accel/packet_bvh.py:390 (v2), :1343 (v3)",
    "packet_isect.anyhit": "vision_tpu/accel/packet_bvh.py:517 (v2), :1343 (v3)",
    "packet_isect.closest_inst": "vision_tpu/accel/packet_bvh.py:880",
    "packet_isect.anyhit_inst": "vision_tpu/accel/packet_bvh.py:1085",
}
# tolerances for kernel vs plain on the card (the kernels are built with
# -fmad=false in the plain versions' operation order, so they should agree
# bit for bit; these bound what rounding could still move)
T_RTOL = 1e-6        # t on lanes with equal ids
UV_ATOL = 1e-5       # barycentrics on lanes with equal ids
TIE_RTOL = 1e-6      # ids may differ only where the two best t tie this close
MAX_MISMATCH = 1e-4  # ... and on at most this share of lanes
# K3 against K2 on the flat twin: the instanced walk intersects in object
# space, so t rounds differently; hit masks and t within 1e-5 relative, but
# for edge and tie lanes on at most 1e-4 of the wavefront
FLAT_T_RTOL = 1e-5
# golden thresholds of tests/test_golden.py test_cbox_hdr_self_golden
GOLD_WERR = 0.06
GOLD_BIAS = 0.025
# instanced vs flat twin render (tests/test_instancing.py holds the JAX
# package's pair to the same streams)
TWIN_WERR = 0.01
# slice 1b: cbox_glass at ladder config 2's spp; cbox_sky on the card
# against the CPU, both the port, from the same seeds (the bound of the
# CPU tests' port-vs-JAX wavefronts)
GLASS_SPP = 64
SKY_RES = 64
SKY_WERR = 0.01
# slice 4: the hero glass at GLASS_SPP (ladder config 3's 256 spp cut to
# 64 for the run's time), the fog at SPP, the subsurface box like cbox_sky
SSS_RES = 64
PNG_RES = 64
PNG_SPP = 4
ADAPTIVE_SPP = 64  # the adaptive cbox: 8 chunks of 8
LF_CHECK_SPP = 4   # the light field's CPU check at a 64^2 base
# slice 5 (`phase_grad`): the full-width gradient step at BASELINE's
# resolution and depth, its 1024 spp cut to 16 for the run's time; the
# linearity identity at 4 spp; card against CPU at 64^2 (depth 3 on the
# cbox, 2 on cbox_sphere at sub_div 40, whose CPU walk stays quick); the
# texture recovery of tests/test_diff.py at 128^2; the memory of the
# checkpointed and the taped bounce at 128^2
GRAD_SPP = 16
GRAD_LINEAR_SPP = 4
GRAD_CPU_RES = 64
GRAD_CPU_SPP = 4
GRAD_RTOL = 1e-3      # BASELINE.md:22: rtol 1e-3, atol 1e-3 max|g| a leaf
LINEAR_RTOL = 1e-4
DIVERGE_SHARE = 0.01  # pixels whose card and CPU forwards part (rounding)
OPT_RES = 128
OPT_STEPS = 24
OPT_FRAME = 5
MEM_RES = 128
# the cbox's kernel launches at 512^2, 4 spp (31 wavefront iterations, 789
# each) before the gradient path existed: a render without grad must
# launch no more
CBOX_LAUNCHES_4SPP = 24466
CBOX_ITERS_4SPP = 31
# slice 6 (`phase_realtime`): the real-time loop at its defaults, timed as
# bench.py's bench_classroom_rt (one warm-up frame, two more, then
# RT_TIMED frames); the 128^2 golden's frames (tools/gen_torch_rt_golden.py)
# at GOLD_WERR / GOLD_BIAS; RT_TWIN_FRAMES frames at RT_TWIN_RES^2 on the
# card against the port's CPU frames within TWIN_WERR; cbox_sphere (K2)
# with the surfel cache and GI at half resolution for RT_SPHERE_FRAMES
RT_TIMED = 4
RT_GOLD_RES = 128
RT_GOLD_FRAMES = (0, 7)
RT_TWIN_RES = 64
RT_TWIN_FRAMES = 4
RT_SPHERE_FRAMES = 4
# slices 7, 7b and 8a (`phase_meshes`)
CLI_RES = 128       # the CLI's graph, realtime, denoise and EXR runs
SDK_RES = 64        # the SDK on the card against the SDK on the CPU ...
SDK_CPU_SPP = 4     # ... over a sub_div-40 OBJ sphere, at this many passes
# the bound of a kernel: the card's published peaks (NVIDIA H100 SXM data
# sheet, dense rates at 700 W), float32 outside the tensor cores and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MT_FLOP = 40     # one Möller-Trumbore test (csrc/dense_isect.cu's count)
SLAB_FLOP = 23   # one slab test: 6 subtracts, 6 multiplies, 11 min / max
XFORM_FLOP = 36  # a ray into an instance's object space: 18 mul, 15 add, 3 div
RAY_IN = 28      # bytes read per ray: origin, direction, t_max
LIBRARY = "none: no single PyTorch call computes this function"
MODEL_RAYS = 4096  # rays of a wavefront held against the numpy walk model
KERNEL_BATCH = 20  # kernel calls in one timing window (one CUDA graph)
# K1's edge shapes: one ray, a chunk of 32 and one, no multiple of a pass
# (512 rays); no triangle, one, the resident limit (512) and one past it
# (tiled), the dense path's limit (2048) and one past it, cbox_sphere's
# 261,156
EDGE_R = (1, 33, 1000)
EDGE_T = (0, 1, 512, 513, 2048, 2049, 261156)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, n=25, warmup=3, batch=KERNEL_BATCH):
    """Median milliseconds of one call of fn: n windows of `batch` calls
    back to back, each timed with CUDA events and divided by `batch`. The
    window holds the host's work too where a call's host side (checks,
    allocations, the ctypes launch) is slower than its kernel: a kernel
    row's `call_ms`, and the plain versions' times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def graph_ms(fn, n=25, batch=KERNEL_BATCH):
    """Median device milliseconds of one call of fn with no host work in
    the window: `batch` calls captured once in a CUDA graph, its replay
    timed with CUDA events n times, divided by `batch` (a kernel row's
    `ms`). The captured calls count their launches once, at capture; the
    renders set the counts to 0 before they run."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(batch):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    del g
    return statistics.median(times)


def profiled_ms(fn, key, calls=KERNEL_BATCH):
    """Mean device milliseconds per launch of the kernels whose name holds
    `key` over `calls` calls of fn, from torch.profiler: the cross-check
    of graph_ms. None if the profiler saw no such kernel."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and key in e.key:
            us += float(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)))
            count += e.count
    return us / count / 1e3 if count else None


def bound_ms(ops, nbytes):
    """The least time the card could take for `ops` operations that move
    `nbytes` bytes: the larger of the two at the card's peaks. Returns
    (ms, "operations" or "bytes")."""
    t_ops = ops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_work(n_rays, n_tris, any_hit, live=None, tests=None):
    """(operations, bytes) of K1 on these inputs: `live` rays (t_max > 0;
    all by default) each against every triangle, or `tests` tests in all
    (an any-hit sweep that stops at its first hit); a dead ray needs its
    t_max read and its result written, a live one its origin and direction
    too; the [T, 9] float32 triangles read once; each result written once
    (t, id, u, v; or the any-hit flag)."""
    live = n_rays if live is None else live
    tests = live * n_tris if tests is None else tests
    return (tests * MT_FLOP,
            n_rays * (4 + (1 if any_hit else 16)) + live * (RAY_IN - 4)
            + n_tris * 36)


def anyhit_tests(o, d, tmax, tris, block=128):
    """Tests an any-hit sweep in id order needs on these rays: for a live
    ray the index of its first occluding triangle plus one, else every
    triangle; none for a dead ray (the plain Möller-Trumbore, in blocks)."""
    from vision_tpu_torch.accel import intersect as isect
    T = tris.shape[0]
    first = torch.full((o.shape[0],), T, dtype=torch.int64, device=DEV)
    for base in range(0, T, block):
        sl = tris[base:base + block]
        t, _, _, ok = isect._mt_batch(o, d, sl[None, :, 0:3], sl[None, :, 3:6],
                                      sl[None, :, 6:9])
        occ = ok & (t < tmax[:, None])
        j = torch.where(occ.any(1), occ.int().argmax(1) + base, T)
        first = torch.minimum(first, j)
    need = torch.where(first < T, first + 1, T)
    return int(torch.where(tmax > 0, need, 0).sum())


def walk_work(pi, o, d, tmax, tree, any_hit, out):
    """The counting build of the K2/K3 walk on these rays. Its outputs
    must equal the kernel's `out`. Returns (record, per-ray counts): the
    work the walk needed (box, triangle and instance steps; records and
    slots read once each, rays in and results out) and its bound, the steps
    per live ray, the one-ray-per-thread lane share and the deepest stack.
    That share is lane steps / (32 x the longest walk of each warp of
    32 consecutive rays): the SIMD share a launch of one thread per ray
    would get on these rays, a measure of their coherence. The kernel's
    persistent warps fetch rays as lanes free up, so it is not the kernel's
    own lane utilisation."""
    instanced = getattr(tree, "insts", None) is not None
    res = pi.count_walk(o, d, tmax, tree, any_hit)
    counts, rec_seen, slot_seen = res[-3:]
    want = (out,) if any_hit else out
    check(all(torch.equal(a, b) for a, b in zip(res[:-3], want)),
          "the counting build's outputs differ from the kernel's")
    c = counts.long()
    R = c.shape[0]
    steps = c[:, 0] + c[:, 1] + c[:, 4]
    warps = torch.nn.functional.pad(steps, (0, (-R) % 32)).view(-1, 32)
    box, tri, ent = (int(c[:, k].sum()) for k in (2, 3, 4))
    ops = box * SLAB_FLOP + tri * MT_FLOP + ent * XFORM_FLOP
    n_rec, n_slot = int(rec_seen.sum()), int(slot_seen.sum())
    nbytes = (R * (RAY_IN + (1 if any_hit else 16 + 4 * instanced))
              + n_rec * 64 + n_slot * 48
              + (tree.n_inst * 64 if instanced else 0))
    ms, by = bound_ms(ops, nbytes)
    live = max(int((tmax > 0).sum()), 1)
    return dict(bound_ms=ms, bound_by=by, ops=ops, bytes=nbytes,
                records_read=n_rec, slots_read=n_slot,
                steps_per_ray=float(steps.sum()) / live,
                max_steps=int(steps.max()),
                inner_steps_per_ray=float(c[:, 0].sum()) / live,
                box_tests_per_ray=box / live, tri_tests_per_ray=tri / live,
                instance_entries_per_ray=ent / live,
                one_ray_per_thread_lane_share=float(steps.sum())
                / max(32.0 * float(warps.max(1).values.sum()), 1.0),
                deepest_stack=int(c[:, 5].max())), c


def model_check(wm, case, o, d, tmax, tree, any_hit, out, counts):
    """The numpy model of the walk (tests/torch_walk_model.py) on the first
    MODEL_RAYS rays: the same outputs and the same per-ray counts as the
    kernel and its counting build."""
    n = MODEL_RAYS
    args = [x[:n].cpu().numpy() for x in (o, d, tmax)]
    args += [tree.nodes.cpu().numpy(), tree.tris.cpu().numpy(), tree.bsize]
    if getattr(tree, "insts", None) is not None:
        args.append(tree.insts.cpu().numpy())
    got, mc = wm.walk(*args, any_hit=any_hit)
    want = (out,) if any_hit else out
    got = (got,) if any_hit else got
    same = all(np.array_equal(a, b[:n].cpu().numpy())
               for a, b in zip(got, want))
    check(same and np.array_equal(mc, counts[:n].cpu().numpy()),
          f"{case}: the walk model differs from the kernel's walk")


def _load_by_path(name, rel):
    # by path: a site-packages `tests` package may shadow the repo's
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cbox_scene(vt, res):
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    s = copy.deepcopy(fixtures.CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [res, res]
    return vt.load_scene(s, device=DEV)


def cbox_rays(scene):
    """Primary rays through the pixel centres, from the port's camera."""
    W, H = scene.camera.resolution
    pix = torch.arange(W * H, device=DEV)
    p = torch.stack([(pix % W).float() + 0.5, (pix // W).float() + 0.5], -1)
    ray = scene.camera.generate_ray(p, torch.zeros_like(p))
    return ray.origin.contiguous(), ray.direction.contiguous()


def soup_case(n_tris=2048, n_rays=262144):
    """A seeded random triangle soup in the unit cube and random rays."""
    g = np.random.default_rng(SEED)
    p0 = g.uniform(0.0, 1.0, (n_tris, 3))
    e1 = g.uniform(-0.1, 0.1, (n_tris, 3))
    e2 = g.uniform(-0.1, 0.1, (n_tris, 3))
    o = g.uniform(0.0, 1.0, (n_rays, 3))
    d = g.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def cu(a):
        return torch.as_tensor(a.astype(np.float32), device=DEV).contiguous()

    return cu(o), cu(d), cu(np.concatenate([p0, e1, e2], 1))


def compare_closest(case, k, p, inst_k=None, inst_p=None):
    """Closest-hit outputs k = (t, id, uv) of a kernel against p of its
    plain version: ids (and instances) equal but on exact-t ties within
    the budget; t and uv within the tolerances on the other lanes."""
    (t_k, id_k, uv_k), (t_p, id_p, uv_p) = k, p
    same = id_k == id_p
    if inst_k is not None:
        same &= inst_k == inst_p
    tie = torch.abs(t_k - t_p) <= TIE_RTOL * torch.abs(t_p)
    n_diff = int((~same).sum())
    R = t_k.shape[0]
    check(bool((tie | same).all()),
          f"{case}: closest ids differ on {int((~same & ~tie).sum())} lanes "
          "that are not ties")
    check(n_diff <= MAX_MISMATCH * R, f"{case}: {n_diff} id ties > budget")
    dt = torch.abs(t_k - t_p)[same]
    t_err = float(dt.max()) if dt.numel() else 0.0
    t_rel = float((dt / torch.clamp_min(torch.abs(t_p[same]), 1e-30)).max()) \
        if dt.numel() else 0.0
    uv_err = float(torch.abs(uv_k - uv_p)[same].max()) if dt.numel() else 0.0
    check(t_rel <= T_RTOL, f"{case}: closest t rel err {t_rel}")
    check(uv_err <= UV_ATOL, f"{case}: closest uv err {uv_err}")
    return dict(closest_id_ties=n_diff, closest_t_abs_err=t_err,
                closest_t_rel_err=t_rel, closest_uv_abs_err=uv_err,
                hit_share=float((id_p >= 0).float().mean()))


def compare_anyhit(case, occ_k, occ_p, t_near, tmax):
    """Any-hit flags: equal but where the nearest hit sits at t_max."""
    edge = torch.abs(t_near - tmax) < 1e-6 * tmax
    bad = (occ_k != occ_p) & ~edge
    n_diff = int((occ_k != occ_p).sum())
    check(not bool(bad.any()), f"{case}: any-hit differs on "
          f"{int(bad.sum())} non-edge lanes")
    check(n_diff <= MAX_MISMATCH * occ_k.shape[0],
          f"{case}: any-hit {n_diff} > budget")
    return dict(anyhit_edge_diffs=n_diff,
                anyhit_max_abs_err=float(bad.float().max()),
                occluded_share=float(occ_p.float().mean()))


def shadow_tmax(t_p, id_p, miss_tmax):
    """t_max scattered around the nearest hit, so about half the lanes are
    occluded; dead lanes (t_max 0 on entry) stay dead."""
    g = torch.Generator(device=DEV).manual_seed(SEED)
    u = torch.empty(t_p.shape[0], device=DEV).uniform_(0.5, 1.5, generator=g)
    return (torch.where(id_p >= 0, t_p, miss_tmax) * u).contiguous()


def compare_k1(di, case, o, d, tris, tmax, shadow):
    """K1 against its plain version on one wavefront: the closest hit with
    t_max `tmax`, the any hit with `shadow`. Returns the phase record:
    differences, each kernel's host-free time (`*_ms`), its back-to-back
    call time (`*_call_ms`), its plain version's time, and its bound on
    these inputs (dead rays need no tests; the any hit stops at its first
    occluder in id order)."""
    R, T = o.shape[0], tris.shape[0]
    k = di.closest(o, d, tmax, tris)
    p = di.closest_plain(o, d, tmax, tris)
    torch.cuda.synchronize()
    rec = compare_closest(case, k, p)
    near = di.closest_plain(o, d, torch.full_like(tmax, 1e30), tris)[0]
    occ_k = di.anyhit(o, d, shadow, tris)
    occ_p = di.anyhit_plain(o, d, shadow, tris)
    torch.cuda.synchronize()
    rec.update(compare_anyhit(case, occ_k, occ_p, near, shadow))
    live_c, live_a = int((tmax > 0).sum()), int((shadow > 0).sum())
    tests = anyhit_tests(o, d, shadow, tris)
    for op, tm, live, n in (("closest", tmax, live_c, None),
                            ("anyhit", shadow, live_a, tests)):
        kern, plain = getattr(di, op), getattr(di, f"{op}_plain")
        b_ms, b_by = bound_ms(*k1_work(R, T, op == "anyhit", live, n))
        rec.update({f"{op}_ms": graph_ms(lambda: kern(o, d, tm, tris)),
                    f"{op}_call_ms": cuda_ms(lambda: kern(o, d, tm, tris)),
                    f"{op}_plain_ms": cuda_ms(lambda: plain(o, d, tm, tris),
                                              n=5, warmup=1, batch=1),
                    f"{op}_live_rays": live, f"{op}_bound_ms": b_ms,
                    f"{op}_bound_by": b_by})
    rec["anyhit_tests_per_live_ray"] = tests / max(live_a, 1)
    return dict(phase="k1_vs_plain", case=case, rays=R, tris=T, **rec)


def half_dead(tmax, seed):
    """t_max with about half the lanes, chosen from `seed`, dead (0)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    u = torch.rand(tmax.shape[0], device=DEV, generator=g)
    return torch.where(u < 0.5, 0.0, tmax).contiguous()


def phase_k1(di, vt_pt, scene):
    """K1 against its plain versions on the cornell box's primary
    wavefront, one bounce, a shadow wavefront with about half its lanes
    dead, and the 2048-triangle soup (the dense path's upper bound), then
    at every edge shape. Returns the four wavefronts' records."""
    from vision_tpu_torch.core.types import Hit
    tris = scene.data.tri_geom
    o, d = cbox_rays(scene)
    inf = torch.full((o.shape[0],), 1e30, device=DEV)
    p = di.closest_plain(o, d, inf, tris)
    recs = [compare_k1(di, "cbox_primary", o, d, tris, inf,
                       shadow_tmax(p[0], p[1], 10.0))]
    o2, d2, tm2 = bounce_wave(vt_pt, scene.data, o, d, Hit(*p))
    p2 = di.closest_plain(o2, d2, tm2, tris)
    shadow2 = torch.where(tm2 > 0, shadow_tmax(p2[0], p2[1], 10.0), 0.0)
    recs.append(compare_k1(di, "cbox_bounce", o2, d2, tris, tm2,
                           shadow2.contiguous()))
    recs.append(compare_k1(di, "cbox_shadow_half_dead", o2, d2, tris,
                           half_dead(tm2, SEED + 2),
                           half_dead(shadow2, SEED + 2)))
    so, sd, stris = soup_case()
    sinf = torch.full((so.shape[0],), 1e30, device=DEV)
    sp = di.closest_plain(so, sd, sinf, stris)
    recs.append(compare_k1(di, "soup_2048tris", so, sd, stris, sinf,
                           shadow_tmax(sp[0], sp[1], 1.0)))
    recs[0]["closest_profiler_ms"] = profiled_ms(
        lambda: di.closest(o, d, inf, tris), "dense_sweep_kernel")
    for r in recs:
        emit(r)
    edges = []
    for T in EDGE_T:
        for R in EDGE_R:
            eo, ed, etris = soup_case(T, R)
            tm = torch.full((R,), 1e30, device=DEV)
            tm[::3] = 0.0
            case = f"edge_{R}rays_{T}tris"
            k = di.closest(eo, ed, tm, etris)
            p = di.closest_plain(eo, ed, tm, etris)
            torch.cuda.synchronize()
            rec = compare_closest(case, k, p)
            sh = torch.where(tm > 0, shadow_tmax(p[0], p[1], 1.0), 0.0)
            near = di.closest_plain(eo, ed, torch.full_like(tm, 1e30), etris)[0]
            rec.update(compare_anyhit(case, di.anyhit(eo, ed, sh, etris),
                                      di.anyhit_plain(eo, ed, sh, etris),
                                      near, sh))
            check(bool(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])),
                  f"{case}: closest not bit for bit")
            edges.append(dict(case=case, **rec))
        if T == 512:
            # |e1|_1 |d|_1 |e2|_1 past 2^122, so the kernels keep the
            # division's exact path: directions scaled by 1e38 (hits kept,
            # t subnormal), geometry by 1e20 (det and t overflow)
            for what, scale in (("dir", 1e38), ("geom", 1e20)):
                eo, ed, etris = soup_case(512, 1000)
                if what == "dir":
                    ed = (ed * scale).contiguous()
                else:
                    eo = (eo * scale).contiguous()
                    etris = (etris * scale).contiguous()
                tm = torch.full((1000,), 3e38, device=DEV)
                k = di.closest(eo, ed, tm, etris)
                p = di.closest_plain(eo, ed, tm, etris)
                occ = (di.anyhit(eo, ed, p[0], etris),
                       di.anyhit_plain(eo, ed, p[0], etris))
                torch.cuda.synchronize()
                case = f"edge_{what}_scale_{scale:g}"
                check(all(torch.equal(a, b) for a, b in zip(k, p))
                      and torch.equal(*occ), f"{case}: not bit for bit")
                edges.append(dict(case=case, hit_share=float(
                    (p[1] >= 0).float().mean())))
    emit(dict(phase="k1_edges", cases=edges))
    return recs


def bounce_wave(vt_pt, data, o, d, hit):
    """One bounce from a primary wavefront: cosine directions about the
    geometric normal facing the ray (seeded), origins spawned off the
    surface; lanes that missed trace with t_max = 0."""
    from vision_tpu_torch.core import warp
    from vision_tpu_torch.core.math import coordinate_system, dot, to_world
    pos, ng, _, _, _, _, _ = vt_pt.compute_interaction(data, hit)
    n = torch.where((dot(ng, d) > 0)[..., None], -ng, ng)
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    u = torch.rand((o.shape[0], 2), device=DEV, generator=g)
    t, b = coordinate_system(n)
    w = to_world(t, b, n, warp.square_to_cosine_hemisphere(u)).contiguous()
    o2 = vt_pt.spawn_origin(pos, ng, w, data.ray_offset).contiguous()
    tmax = torch.where(hit.prim_id >= 0, 1e30, 0.0).contiguous()
    return o2, w, tmax


def phase_k2(pi, pbvh_mod, di, vt_pt, wm, scene):
    """K2 against the plain walk and K1 on the primary wavefront and one
    bounce of `scene` (cbox_sphere), with the work each walk needed."""
    from vision_tpu_torch.core.types import Hit
    data = scene.data
    tree = data.pbvh
    o, d = cbox_rays(scene)
    R = o.shape[0]
    tmax = torch.full((R,), 1e30, device=DEV)
    recs = []
    for wave in ("primary", "bounce"):
        case = f"cbox_sphere_{wave}"
        k = pi.closest(o, d, tmax, tree)
        p = pbvh_mod.intersect_packet_plain(o, d, tmax, tree)
        torch.cuda.synchronize()
        rec = compare_closest(case, k, p)
        # K1 over the same triangles: an independent algorithm
        k1 = di.closest(o, d, tmax, data.tri_geom)
        torch.cuda.synchronize()
        k1_rec = compare_closest(case + "_vs_k1", k, k1)
        rec.update({f"vs_k1_{a}": b for a, b in k1_rec.items()},
                   vs_k1_bit_exact=bool(torch.equal(k[0], k1[0])
                                        and torch.equal(k[1], k1[1])
                                        and torch.equal(k[2], k1[2])))
        st = shadow_tmax(p[0], p[1], 10.0)
        st = torch.where(tmax > 0, st, 0.0).contiguous()
        occ = pi.anyhit(o, d, st, tree)
        rec.update(compare_anyhit(case, occ, pbvh_mod.intersect_packet_plain(
            o, d, st, tree, any_hit=True), p[0], st))
        rec["closest_work"], counts = walk_work(pi, o, d, tmax, tree, False, k)
        if wave == "primary":
            model_check(wm, case, o, d, tmax, tree, False, k, counts)
        rec["anyhit_work"], counts = walk_work(pi, o, d, st, tree, True, occ)
        if wave == "primary":
            model_check(wm, case, o, d, st, tree, True, occ, counts)
        rec.update(
            closest_ms=graph_ms(lambda: pi.closest(o, d, tmax, tree)),
            closest_call_ms=cuda_ms(lambda: pi.closest(o, d, tmax, tree)),
            closest_plain_ms=cuda_ms(lambda: pbvh_mod.intersect_packet_plain(
                o, d, tmax, tree), n=3, warmup=1, batch=1),
            anyhit_ms=graph_ms(lambda: pi.anyhit(o, d, st, tree)),
            anyhit_call_ms=cuda_ms(lambda: pi.anyhit(o, d, st, tree)),
            anyhit_plain_ms=cuda_ms(lambda: pbvh_mod.intersect_packet_plain(
                o, d, st, tree, any_hit=True), n=3, warmup=1, batch=1),
            k1_closest_ms=cuda_ms(lambda: di.closest(o, d, tmax, data.tri_geom),
                                  n=5, warmup=1, batch=1))
        recs.append(dict(phase="k2_vs_plain", case=case, rays=R,
                         live_rays=int((tmax > 0).sum()),
                         tris=data.tri_geom.shape[0], nodes=tree.n_nodes,
                         leaf=tree.bsize, depth=tree.depth, **rec))
        emit(recs[-1])
        if wave == "primary":
            o, d, tmax = bounce_wave(vt_pt, data, o, d, Hit(*p))
    return recs


def phase_k3(pi, pbvh_mod, vt_pt, wm, scene, flat):
    """K3 against the plain walk, and against K2 on the flat twin, on the
    primary wavefront and one bounce of `scene` (cbox_spheres_instanced),
    with the work each walk needed."""
    from vision_tpu_torch.core.types import Hit
    data = scene.data
    ip = data.ipbvh
    o, d = cbox_rays(scene)
    R = o.shape[0]
    tmax = torch.full((R,), 1e30, device=DEV)
    recs = []
    for wave in ("primary", "bounce"):
        case = f"cbox_spheres_instanced_{wave}"
        t_k, id_k, uv_k, in_k = pi.closest_inst(o, d, tmax, ip)
        t_p, id_p, uv_p, in_p = pbvh_mod.intersect_packet_inst_plain(o, d, tmax, ip)
        torch.cuda.synchronize()
        rec = compare_closest(case, (t_k, id_k, uv_k), (t_p, id_p, uv_p),
                              in_k, in_p)
        # K2 over the flat twin (world-space triangles, other ids)
        t_f, id_f, _ = pi.closest(o, d, tmax, flat.data.pbvh)
        torch.cuda.synchronize()
        mask_diff = (id_k >= 0) != (id_f >= 0)
        t_off = ((id_k >= 0) & (id_f >= 0)
                 & (torch.abs(t_k - t_f) > FLAT_T_RTOL * torch.abs(t_f)))
        n_flat = int((mask_diff | t_off).sum())
        check(n_flat <= MAX_MISMATCH * R,
              f"{case}: K3 vs K2 on the flat twin differ on {n_flat} lanes")
        both = (id_k >= 0) & (id_f >= 0) & ~t_off
        rec.update(vs_flat_diff_lanes=n_flat,
                   vs_flat_t_rel_err=float((torch.abs(t_k - t_f)
                                            / torch.abs(t_f))[both].max()))
        st = shadow_tmax(t_p, id_p, 10.0)
        st = torch.where(tmax > 0, st, 0.0).contiguous()
        occ = pi.anyhit_inst(o, d, st, ip)
        rec.update(compare_anyhit(case, occ, pbvh_mod.intersect_packet_inst_plain(
            o, d, st, ip, any_hit=True), t_p, st))
        k = (t_k, id_k, uv_k, in_k)
        rec["closest_work"], counts = walk_work(pi, o, d, tmax, ip, False, k)
        if wave == "primary":
            model_check(wm, case, o, d, tmax, ip, False, k, counts)
        rec["anyhit_work"], counts = walk_work(pi, o, d, st, ip, True, occ)
        if wave == "primary":
            model_check(wm, case, o, d, st, ip, True, occ, counts)
        rec.update(
            closest_ms=graph_ms(lambda: pi.closest_inst(o, d, tmax, ip)),
            closest_call_ms=cuda_ms(lambda: pi.closest_inst(o, d, tmax, ip)),
            closest_plain_ms=cuda_ms(lambda: pbvh_mod.intersect_packet_inst_plain(
                o, d, tmax, ip), n=3, warmup=1, batch=1),
            anyhit_ms=graph_ms(lambda: pi.anyhit_inst(o, d, st, ip)),
            anyhit_call_ms=cuda_ms(lambda: pi.anyhit_inst(o, d, st, ip)),
            anyhit_plain_ms=cuda_ms(lambda: pbvh_mod.intersect_packet_inst_plain(
                o, d, st, ip, any_hit=True), n=3, warmup=1, batch=1),
            flat_k2_closest_ms=graph_ms(lambda: pi.closest(o, d, tmax,
                                                           flat.data.pbvh)))
        recs.append(dict(phase="k3_vs_plain", case=case, rays=R,
                         live_rays=int((tmax > 0).sum()),
                         instances=ip.n_inst, nodes=ip.n_nodes,
                         flat_tris=flat.data.tri_geom.shape[0],
                         depth=ip.depth, **rec))
        emit(recs[-1])
        if wave == "primary":
            o, d, tmax = bounce_wave(vt_pt, data, o, d,
                                     Hit(t_p, id_p, uv_p, in_p))
    return recs


def render(vt, modules, scene, name, spp=SPP, res=RES, adaptive=False):
    """The main path on one scene: warm up at 1 spp, set every launch count
    to 0, render res^2 at `spp` (adaptive: `render(adaptive=True)`; the
    light-field frame buffer: the mosaic of its grid of views), read the
    counts. Returns (image, record)."""
    check(scene.max_depth == 8 and scene.resolution == (res, res),
          f"{name} config")
    grid = scene.lf_grid if scene.framebuffer_type == "light_field" else 1
    vt.render(scene, spp=1, adaptive=adaptive)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0
    stats = {}
    t0 = time.perf_counter()
    hdr = vt.render(scene, spp=spp, adaptive=adaptive, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f"{m.__name__.rsplit('.', 1)[-1]}.{k}": v
                for m in modules for k, v in m.LAUNCHES.items()}
    img = hdr.cpu().numpy()
    check(img.shape == (grid * res, grid * res, 3),
          f"{name}: image shape {img.shape}")
    check(bool(np.isfinite(img).all()), f"{name}: image has non-finite values")
    check(float(img.max()) > 0.0, f"{name}: image is all zero")
    extra = {k: stats[k] for k in ("mean_spp", "active_frac") if k in stats}
    if grid > 1:
        extra.update(lf_grid=grid, lanes=grid * grid * res * res)
    return img, dict(phase="render", scene=name, res=res, spp=spp, **extra,
                     material_feats=list(scene.data.materials.feats),
                     light_feats=list(scene.data.lights.feats),
                     max_depth=scene.max_depth, wall_s=wall,
                     nrays=stats["nrays"], iters=stats["iters"],
                     mrays_per_s=stats["nrays"] / wall / 1e6,
                     peak_mem_bytes=torch.cuda.max_memory_allocated(),
                     # the render's own: the peak above what the earlier
                     # phases' scenes hold
                     peak_mem_over_start_bytes=(
                         torch.cuda.max_memory_allocated() - mem0),
                     launches=launches, mean=float(img.mean()))


def phase_slice1b(vt, modules, scenes):
    """cbox_glass (K1) and cbox_zoo (K2) against their JAX goldens, cbox_sky
    on the card against the port's CPU render. Returns each render's
    launch counts."""
    per_render = {}
    runs = (("cbox_glass", scenes.cbox_glass(RES), GLASS_SPP, "dense_isect"),
            ("cbox_zoo", scenes.cbox_zoo(RES, sub_div=40), SPP,
             "packet_isect"))
    for name, desc, spp, kernel in runs:
        t0 = time.perf_counter()
        scene = vt.load_scene(desc, device=DEV)
        emit(dict(phase="load", scene=name, seconds=time.perf_counter() - t0,
                  tris=scene.data.tri_geom.shape[0]))
        check((scene.data.pbvh is not None) == (kernel == "packet_isect")
              and scene.data.ipbvh is None, f"{name} takes {kernel}")
        img, rec = render(vt, modules, scene, name, spp=spp)
        rec["golden_werr"], rec["golden_bias"] = vs_golden(
            img, f"tests/goldens/{name}_hdr.npz")
        emit(rec)
        other = "packet_isect" if kernel == "dense_isect" else "dense_isect"
        check(all(rec["launches"][f"{kernel}.{k}"] > 0
                  for k in ("closest", "anyhit")), f"{name} {rec['launches']}")
        check(all(v == 0 for k, v in rec["launches"].items()
                  if k.startswith(other)), f"{name} {rec['launches']}")
        check(rec["golden_werr"] < GOLD_WERR,
              f"{name} vs golden {rec['golden_werr']}")
        check(abs(rec["golden_bias"]) < GOLD_BIAS,
              f"{name} bias {rec['golden_bias']}")
        per_render[name] = rec["launches"]

    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the sky's HDRI file is missing
        sky = vt.load_scene(scenes.cbox_sky(SKY_RES), device=DEV)
        sky_cpu = vt.load_scene(scenes.cbox_sky(SKY_RES), device="cpu")
    check(sky.data.lights.env_index == 0 and sky.data.pbvh is None,
          "cbox_sky: one environment light, the dense sweep")
    img, rec = render(vt, modules, sky, "cbox_sky", spp=SPP, res=SKY_RES)
    t0 = time.perf_counter()
    ref = vt.render(sky_cpu, spp=SPP).numpy()
    rec["cpu_render_s"] = time.perf_counter() - t0
    rec["vs_cpu_werr"], rec["vs_cpu_bias"] = block_err(img, ref)
    emit(rec)
    check(rec["launches"]["dense_isect.closest"] > 0, f"cbox_sky {rec}")
    check(rec["vs_cpu_werr"] <= SKY_WERR and abs(rec["vs_cpu_bias"]) <= SKY_WERR,
          f"cbox_sky vs its CPU render {rec['vs_cpu_werr']}")
    per_render["cbox_sky"] = rec["launches"]
    return per_render


def phase_slice4(vt, modules, scenes):
    """cbox_glass_hero and fog_cbox (K1) against their JAX goldens,
    cbox_sss on the card against the port's CPU render, and
    render_to_file's PNG. Returns each render's launch counts."""
    per_render = {}
    runs = (("cbox_glass_hero", scenes.cbox_glass_hero(RES), GLASS_SPP,
             True, False),
            ("fog_cbox", scenes.fog_cbox(RES), SPP, False, True))
    for name, desc, spp, hero, media in runs:
        t0 = time.perf_counter()
        scene = vt.load_scene(desc, device=DEV)
        emit(dict(phase="load", scene=name, seconds=time.perf_counter() - t0,
                  tris=scene.data.tri_geom.shape[0]))
        check(scene.data.spectrum.hero == hero
              and scene.data.has_media == media and scene.data.pbvh is None
              and scene.data.ipbvh is None,
              f"{name}: spectrum, media and the dense sweep")
        img, rec = render(vt, modules, scene, name, spp=spp)
        rec["golden_werr"], rec["golden_bias"] = vs_golden(
            img, f"tests/goldens/{name}_hdr.npz")
        emit(rec)
        check(all(rec["launches"][f"dense_isect.{k}"] > 0
                  for k in ("closest", "anyhit")), f"{name} {rec['launches']}")
        check(all(v == 0 for k, v in rec["launches"].items()
                  if k.startswith("packet_isect")), f"{name} {rec['launches']}")
        check(rec["golden_werr"] < GOLD_WERR,
              f"{name} vs golden {rec['golden_werr']}")
        check(abs(rec["golden_bias"]) < GOLD_BIAS,
              f"{name} bias {rec['golden_bias']}")
        per_render[name] = rec["launches"]

    sss = vt.load_scene(scenes.cbox_sss(SSS_RES), device=DEV)
    sss_cpu = vt.load_scene(scenes.cbox_sss(SSS_RES), device="cpu")
    check(sss.data.spectrum.hero and sss.data.has_media
          and sss.data.pbvh is None, "cbox_sss: hero, media, dense sweep")
    img, rec = render(vt, modules, sss, "cbox_sss", spp=SPP, res=SSS_RES)
    t0 = time.perf_counter()
    ref = vt.render(sss_cpu, spp=SPP).numpy()
    rec["cpu_render_s"] = time.perf_counter() - t0
    rec["vs_cpu_werr"], rec["vs_cpu_bias"] = block_err(img, ref)
    emit(rec)
    check(rec["launches"]["dense_isect.closest"] > 0, f"cbox_sss {rec}")
    check(rec["vs_cpu_werr"] <= SKY_WERR and abs(rec["vs_cpu_bias"]) <= SKY_WERR,
          f"cbox_sss vs its CPU render {rec['vs_cpu_werr']}")
    per_render["cbox_sss"] = rec["launches"]

    # render_to_file: the JAX package's argument order, a PNG without PIL
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    desc = copy.deepcopy(fixtures.CBOX_JSON)
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        PNG_RES, PNG_RES]
    out = os.path.join(ROOT, "vision_tpu_torch", "_build", "smoke_cbox.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    check(vt.render_to_file(desc, out, PNG_SPP, False, device=DEV) == out,
          "render_to_file's path")
    seconds = time.perf_counter() - t0
    png = read_png(out)
    scene = vt.load_scene(desc, device=DEV)
    want = vt.postprocess(scene, vt.render(scene, spp=PNG_SPP)).cpu().numpy()
    want = np.clip(want * 255.0 + 0.5, 0, 255).astype(np.uint8)
    diff = np.abs(png.astype(np.int32) - want.astype(np.int32))
    rec = dict(phase="render_to_file", path=os.path.relpath(out, ROOT),
               bytes=os.path.getsize(out), seconds=seconds,
               shape=list(png.shape), max_level_diff=int(diff.max()),
               pil_loaded="PIL" in sys.modules,
               pil_installed=importlib.util.find_spec("PIL") is not None)
    emit(rec)
    check(png.shape == (PNG_RES, PNG_RES, 3) and diff.max() <= 1,
          f"render_to_file's PNG against the tonemapped render {rec}")
    return per_render


def phase_images(vt, modules, scenes, images):
    """Slices 4c, 4d and 7a: `cbox_tex` (K1) against its JAX golden,
    `env_sphere` (K2) on the card at 64^2 against the port's CPU render,
    the adaptive cbox against the cbox golden, the light-field cbox (its
    tiles at 64^2 against the CPU render, parallax, refocus), and
    `render_to_file`'s EXR. Returns each render's launch counts; the
    cbox_tex and env_sphere images go into `images`."""
    per_render = {}
    # which image libraries the card's machine has (the port needs none)
    emit(dict(phase="image_libraries",
              pil_installed=importlib.util.find_spec("PIL") is not None,
              cv2_installed=importlib.util.find_spec("cv2") is not None))

    t0 = time.perf_counter()
    tex = vt.load_scene(scenes.cbox_tex(RES), device=DEV)
    emit(dict(phase="load", scene="cbox_tex", seconds=time.perf_counter() - t0,
              tris=tex.data.tri_geom.shape[0],
              atlas_texels=tex.data.atlas.data.shape[0]))
    check(tex.data.pbvh is None
          and {"nmap", "fresmix", "uvmap"} <= set(tex.data.materials.feats)
          and {"ies", "tex"} <= set(tex.data.lights.feats),
          "cbox_tex: the dense sweep, every new material and light feature")
    img, rec = render(vt, modules, tex, "cbox_tex")
    images["cbox_tex"] = img
    rec["golden_werr"], rec["golden_bias"] = vs_golden(
        img, "tests/goldens/cbox_tex_hdr.npz")
    emit(rec)
    check(all(rec["launches"][f"dense_isect.{k}"] > 0
              for k in ("closest", "anyhit")), f"cbox_tex {rec['launches']}")
    check(rec["golden_werr"] < GOLD_WERR,
          f"cbox_tex vs golden {rec['golden_werr']}")
    check(abs(rec["golden_bias"]) < GOLD_BIAS,
          f"cbox_tex bias {rec['golden_bias']}")
    per_render["cbox_tex"] = rec["launches"]

    t0 = time.perf_counter()
    env = vt.load_scene(scenes.env_sphere(RES), device=DEV)
    emit(dict(phase="load", scene="env_sphere",
              seconds=time.perf_counter() - t0,
              tris=env.data.tri_geom.shape[0]))
    check(env.data.pbvh is not None and env.data.lights.env_index >= 0
          and {"proj", "tex"} <= set(env.data.lights.feats),
          "env_sphere: the BVH, the mix environment, the projector image")
    img, rec = render(vt, modules, env, "env_sphere")
    images["env_sphere"] = img
    check(all(rec["launches"][f"packet_isect.{k}"] > 0
              for k in ("closest", "anyhit")), f"env_sphere {rec['launches']}")
    small = vt.load_scene(scenes.env_sphere(SKY_RES), device=DEV)
    small_cpu = vt.load_scene(scenes.env_sphere(SKY_RES), device="cpu")
    card = vt.render(small, spp=SPP).cpu().numpy()
    t0 = time.perf_counter()
    ref = vt.render(small_cpu, spp=SPP).numpy()
    rec["cpu_render_s"] = time.perf_counter() - t0
    rec["vs_cpu_werr"], rec["vs_cpu_bias"] = block_err(card, ref)
    emit(rec)
    check(rec["vs_cpu_werr"] <= SKY_WERR and abs(rec["vs_cpu_bias"]) <= SKY_WERR,
          f"env_sphere vs its CPU render {rec['vs_cpu_werr']}")
    per_render["env_sphere"] = rec["launches"]

    # adaptive sampling on the cbox: chunks of 8, converged pixels stop
    cb = cbox_scene(vt, RES)
    img, rec = render(vt, modules, cb, "cbox_adaptive", spp=ADAPTIVE_SPP,
                      adaptive=True)
    rec["golden_werr"], rec["golden_bias"] = vs_golden(
        img, "tests/goldens/cbox_hdr.npz")
    emit(rec)
    check(rec["launches"]["dense_isect.closest"] > 0, f"cbox_adaptive {rec}")
    check(rec["mean_spp"] < ADAPTIVE_SPP,
          f"cbox_adaptive took every sample {rec['mean_spp']}")
    check(rec["golden_werr"] < GOLD_WERR and abs(rec["golden_bias"]) < GOLD_BIAS,
          f"cbox_adaptive vs golden {rec['golden_werr']} {rec['golden_bias']}")
    per_render["cbox_adaptive"] = rec["launches"]

    # the light-field frame buffer: grid 3 through a thin lens
    lf = vt.load_scene(scenes.lf_cbox(RES), device=DEV)
    img, rec = render(vt, modules, lf, "lf_cbox")
    g = lf.lf_grid
    from vision_tpu_torch.sensor import light_field as vt_lf
    tiles = torch.as_tensor(img).reshape(g, RES, g, RES, 3).permute(0, 2, 1,
                                                                   3, 4)
    rec["corner_views_mean_abs_diff"] = float(
        (tiles[0, 0] - tiles[-1, -1]).abs().mean())
    rec["refocus0_vs_mean_max_abs"] = float(
        (vt_lf.refocus(tiles, 0.0) - tiles.mean(dim=(0, 1))).abs().max())
    vtr = importlib.import_module("vision_tpu_torch.render")
    small = vt.load_scene(scenes.lf_cbox(SKY_RES), device=DEV)
    small_cpu = vt.load_scene(scenes.lf_cbox(SKY_RES), device="cpu")
    card = vtr.render_light_field(small, spp=LF_CHECK_SPP).cpu().numpy()
    t0 = time.perf_counter()
    ref = vtr.render_light_field(small_cpu, spp=LF_CHECK_SPP).numpy()
    rec["cpu_render_s"] = time.perf_counter() - t0
    rec["vs_cpu_werr_by_tile"] = [block_err(card[j, i], ref[j, i])[0]
                                  for j in range(g) for i in range(g)]
    emit(rec)
    check(rec["launches"]["dense_isect.closest"] > 0, f"lf_cbox {rec}")
    check(rec["corner_views_mean_abs_diff"] > 1e-4, f"lf_cbox parallax {rec}")
    check(rec["refocus0_vs_mean_max_abs"] <= 1e-6, f"lf_cbox refocus {rec}")
    check(max(rec["vs_cpu_werr_by_tile"]) <= SKY_WERR,
          f"lf_cbox tiles vs the CPU render {rec['vs_cpu_werr_by_tile']}")
    per_render["lf_cbox"] = rec["launches"]

    # render_to_file's OpenEXR, read back by the port's own reader
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    desc = copy.deepcopy(fixtures.CBOX_JSON)
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        PNG_RES, PNG_RES]
    out = os.path.join(ROOT, "vision_tpu_torch", "_build", "smoke_cbox.exr")
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    check(vt.render_to_file(desc, out, PNG_SPP, False, device=DEV) == out,
          "render_to_file's EXR path")
    seconds = time.perf_counter() - t0
    from vision_tpu_torch.scene.imageio import read_image
    got, kind = read_image(out)
    scene = vt.load_scene(desc, device=DEV)
    want = vt.render(scene, spp=PNG_SPP).cpu().numpy()
    rec = dict(phase="render_to_file_exr", path=os.path.relpath(out, ROOT),
               bytes=os.path.getsize(out), seconds=seconds,
               shape=list(got.shape), kind=kind,
               max_abs_diff=float(np.abs(got - want).max()),
               bit_equal=bool(np.array_equal(got, want)))
    emit(rec)
    check(rec["bit_equal"], f"render_to_file's EXR against the render {rec}")
    return per_render


def device_kernels(fn):
    """(kernel launches on the card, device milliseconds) while fn runs,
    from torch.profiler's device-side events; and fn's result."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for e in prof.key_averages():
        t = float(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)))
        if e.device_type == DeviceType.CUDA and t > 0:
            n += e.count
            us += t
    return n, us / 1e3, out


def grad_leaves(opt, data, camera, keys):
    """Fresh leaves that require grad, for `keys` {group: [key, ...]} (a
    group's every key for None) of the parameter surface."""
    surf = opt.param_surface(data, camera, tuple(keys))
    return {g: {k: v.detach().clone().requires_grad_(True)
                for k, v in surf[g].items() if keys[g] is None or k in keys[g]}
            for g in keys}


def flat_leaves(params):
    return [(f"{g}.{k}", v) for g, d in params.items() for k, v in d.items()]


def zero_counts(modules):
    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def read_counts(modules):
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{k}": v
            for m in modules for k, v in m.LAUNCHES.items()}


def card_vs_cpu(vt, opt, desc, keys, depth, spp, name, card):
    """The port's gradients of `keys` on the card against its CPU ones on
    the same scene, seeds and a seeded-random per-pixel cotangent, at
    BASELINE's tolerance; pixels whose forwards part past the per-lane
    tolerance of the CPU tests get a zero cotangent (at most 1%)."""
    res = desc["camera"]["param"]["radiance_collector"]["param"]["resolution"][0]
    runs = []   # (params, image, seconds) on the card, then on the CPU
    for dev in (DEV, "cpu"):
        sc = vt.load_scene(desc, device=dev)
        params = grad_leaves(opt, sc.data, sc.camera, keys)
        t0 = time.perf_counter()
        img = opt.render_with_params(sc.data, sc.camera, params, 0,
                                     max_depth=depth, spp=spp, device=dev)
        runs.append((params, img, time.perf_counter() - t0))
    a, b = (r[1].detach().cpu().numpy() for r in runs)
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(b)).any(-1)
    w = np.random.default_rng(SEED + 5).standard_normal(a.shape).astype(
        np.float32) * ~bad[..., None]
    grads = []
    for params, img, _ in runs:
        leaves = flat_leaves(params)
        gs = torch.autograd.grad(
            (img * torch.as_tensor(w, device=img.device)).sum(),
            [v for _, v in leaves], allow_unused=True)
        grads.append({k: (torch.zeros_like(v) if g is None else g).cpu().numpy()
                      for (k, v), g in zip(leaves, gs)})
    rec = dict(phase="grad_card_vs_cpu", scene=name, res=res, spp=spp,
               max_depth=depth, diverged_pixels=int(bad.sum()),
               card_s=runs[0][2], cpu_s=runs[1][2], leaves={})
    for k, gc in grads[1].items():
        gk = grads[0][k]
        m = float(np.abs(gc).max())
        rec["leaves"][k] = dict(
            max_abs_grad=m, max_abs_err=float(np.abs(gk - gc).max()),
            ok=bool(np.isfinite(gk).all() and np.allclose(
                gk, gc, rtol=GRAD_RTOL, atol=GRAD_RTOL * m)))
    emit(dict(rec, card=card))
    check(bad.mean() <= DIVERGE_SHARE, f"{name}: {bad.sum()} pixels part")
    check(all(v["ok"] for v in rec["leaves"].values()),
          f"{name}: card gradients against the CPU's {rec['leaves']}")
    return rec


def phase_grad(vt, modules, scenes, card):
    """Slice 5: one loss-and-gradient step on the cbox at 512^2, 16 spp,
    depth 8, every bounce checkpointed, all four parameter groups (walls,
    memory, K1 launches in the forward and the backward's replay, kernel
    launches per bounce); the linearity of the image in the light's
    colour; the card's gradients against the CPU's on the cbox (K1, the
    camera included) and cbox_sphere (K2); K1's autograd Function against
    autograd through the plain sweep at 262,144 rays; the texture recovery
    of tests/test_diff.py at 128^2; peak memory with and without the
    checkpoints at 128^2. Each record carries `card`, the card's name and
    power limit as nvidia-smi gives them."""
    from vision_tpu_torch.accel import dense_isect as di
    from vision_tpu_torch.diff import optimize as opt
    from vision_tpu_torch.integrator import pt as vt_pt
    from vision_tpu_torch.sensor import film
    from vision_tpu_torch.core import rng
    every = {g: None for g in opt.GROUPS}

    # ---- a render without grad launches what it did ----
    cb = cbox_scene(vt, RES)
    stats = {}
    n, dev_ms, _ = device_kernels(
        lambda: vt.render(cb, spp=4, stats=stats))
    rec = dict(phase="grad_nograd_render", scene="cbox", spp=4,
               kernel_launches=n, iters=stats["iters"],
               launches_per_iter=n / stats["iters"], device_ms=dev_ms)
    emit(dict(rec, card=card))
    check(rec["iters"] == CBOX_ITERS_4SPP
          and rec["kernel_launches"] <= CBOX_LAUNCHES_4SPP,
          f"a render without grad launches more: {rec}")

    # ---- the full-width step ----
    gold = np.load(os.path.join(ROOT, "tests/goldens/cbox_hdr.npz"))["img"]
    k = RES // gold.shape[0]
    target = np.repeat(np.repeat(gold, k, 0), k, 1)
    params = grad_leaves(opt, cb.data, cb.camera, every)
    warm = opt.make_loss(cb.data, cb.camera, target, max_depth=cb.max_depth,
                         spp=1, device=DEV)
    warm(params, 0).backward()
    loss_fn = opt.make_loss(cb.data, cb.camera, target,
                            max_depth=cb.max_depth, spp=GRAD_SPP, device=DEV)
    params = grad_leaves(opt, cb.data, cb.camera, every)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    zero_counts(modules)
    t0 = time.perf_counter()
    loss = loss_fn(params, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = read_counts(modules)
    zero_counts(modules)
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bwd = read_counts(modules)
    grads = {k: v.grad for k, v in flat_leaves(params)}
    rec = dict(phase="grad_step", scene="cbox", res=RES, spp=GRAD_SPP,
               max_depth=cb.max_depth, remat=True, groups=list(opt.GROUPS),
               loss=loss.item(), forward_s=t1 - t0, backward_s=t2 - t1,
               step_s=t2 - t0, bounce_calls=GRAD_SPP * cb.max_depth,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               peak_mem_over_start_bytes=(torch.cuda.max_memory_allocated()
                                          - mem0),
               launches_forward=fwd, launches_backward=bwd,
               max_abs_grad={k: (None if g is None else float(g.abs().max()))
                             for k, g in grads.items()})
    del loss
    # kernel launches per bounce, at 1 spp: the forward's 8 bounces, then
    # the backward's replays and their backward operations
    params = grad_leaves(opt, cb.data, cb.camera, every)
    n_f, ms_f, loss = device_kernels(lambda: warm(params, 0))
    n_b, ms_b, _ = device_kernels(lambda: loss.backward())
    rec.update(profile_spp=1, kernel_launches_per_bounce_forward=n_f / cb.max_depth,
               kernel_launches_per_bounce_backward=n_b / cb.max_depth,
               device_ms_forward_1spp=ms_f, device_ms_backward_1spp=ms_b)
    emit(dict(rec, card=card))
    check(all(g is None or bool(torch.isfinite(g).all())
              for g in grads.values()), "a non-finite gradient in the step")
    check(all(grads[k] is not None for k in ("materials.kd", "lights.color",
                                             "camera.c2w")),
          "a gradient of the step is missing")
    check(rec["max_abs_grad"]["camera.c2w"] > 0.0,
          "the camera's gradient vanished: K1's hit carries none")
    check(fwd["dense_isect.closest"] == rec["bounce_calls"],
          f"K1 closest in the forward {fwd}")
    check(bwd["dense_isect.closest"] > 0,
          f"the backward's replay did not run K1 {bwd}")
    del grads, params, loss

    # ---- the image is linear in the light's colour ----
    lc = cb.data.lights.color.detach().clone().requires_grad_(True)
    img = opt.render_with_params(cb.data, cb.camera, {"lights": {"color": lc}},
                                 0, max_depth=cb.max_depth,
                                 spp=GRAD_LINEAR_SPP, device=DEV)
    m = img.mean()
    g, = torch.autograd.grad(m, lc)
    lhs = float((lc.detach() * g).sum())
    rec = dict(phase="grad_linearity", scene="cbox", res=RES,
               spp=GRAD_LINEAR_SPP, mean=m.item(), sum_c_dmean_dc=lhs,
               rel_err=abs(lhs - m.item()) / m.item())
    emit(dict(rec, card=card))
    check(rec["rel_err"] < LINEAR_RTOL, f"linearity {rec}")
    del img, m

    # ---- the card's gradients against the CPU's ----
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    desc = copy.deepcopy(fixtures.CBOX_JSON)
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        GRAD_CPU_RES, GRAD_CPU_RES]
    rec = card_vs_cpu(vt, opt, desc, every, 3, GRAD_CPU_SPP, "cbox", card)
    cam = rec["leaves"]["camera.c2w"]
    check(cam["max_abs_grad"] > 1.0 and cam["ok"],
          f"the camera's gradient on the card {cam}")
    card_vs_cpu(vt, opt, scenes.cbox_sphere(GRAD_CPU_RES, sub_div=40),
                {"materials": ["kd"], "lights": ["color"]}, 2, GRAD_CPU_SPP,
                "cbox_sphere", card)

    # ---- K1's Function against autograd through the plain sweep ----
    o, d = cbox_rays(cb)
    inf = torch.full((o.shape[0],), 1e30, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    g_t = torch.randn(o.shape[0], device=DEV, generator=gen)
    g_b = torch.randn((o.shape[0], 2), device=DEV, generator=gen)
    res = []
    for fn in (di.closest, di.closest_plain):
        x = [o.clone().requires_grad_(True), d.clone().requires_grad_(True)]
        t, _, bary = fn(x[0], x[1], inf, cb.data.tri_geom)
        res.append(torch.autograd.grad((t, bary), x, (g_t, g_b)))
    errs = [float((a - b).abs().max()) for a, b in zip(*res)]
    scale = [float(b.abs().max()) for b in res[1]]
    rec = dict(phase="grad_k1_function", rays=o.shape[0],
               max_abs_err_origin=errs[0], max_abs_err_direction=errs[1],
               max_abs_grad_origin=scale[0], max_abs_grad_direction=scale[1])
    emit(dict(rec, card=card))
    check(all(e <= 1e-5 * s for e, s in zip(errs, scale)),
          f"K1's Function against plain autograd {rec}")

    # ---- the texture recovery (tests/test_diff.py) at 128^2 ----
    path = os.path.join(ROOT, "vision_tpu_torch", "_build", "grad_wall.png")
    film.to_png(scenes.wall_texture(), path)
    tex = vt.load_scene(scenes.tex_wall_cbox(OPT_RES, path), device=DEV)
    check(tex.data.atlas.data.shape[0] > 1, "the wall texture never loaded")
    target = opt.render_with_params(
        tex.data, tex.camera, opt.param_surface(tex.data, tex.camera,
                                                ("atlas",)),
        OPT_FRAME, max_depth=2, device=DEV).detach()
    from dataclasses import replace
    gray = replace(tex.data, atlas=replace(
        tex.data.atlas, data=torch.full_like(tex.data.atlas.data, 0.5)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = opt.optimize_scene(gray, tex.camera, target, groups=("atlas",),
                                   steps=OPT_STEPS, lr=0.1, max_depth=2,
                                   fixed_frame=OPT_FRAME, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(phase="grad_texture_recovery", res=OPT_RES, steps=OPT_STEPS,
               lr=0.1, max_depth=2, wall_s=wall, step_wall_s=wall / OPT_STEPS,
               losses=losses, last_over_first=losses[-1] / losses[0])
    emit(dict(rec, card=card))
    check(rec["last_over_first"] < 0.35, f"texture recovery {rec}")

    # ---- peak memory with and without the checkpoints, 128^2 ----
    small = cbox_scene(vt, MEM_RES)
    W = MEM_RES
    pix = torch.arange(W * W, device=DEV)
    p_film = torch.stack([(pix % W).float() + 0.5,
                          (pix // W).float() + 0.5], -1)
    peaks = {}
    for remat in (True, False):
        params = grad_leaves(opt, small.data, small.camera, every)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sc, cam = opt.apply_params(small.data, small.camera, params)
        img = torch.zeros((W * W, 3), device=DEV)
        for s in range(GRAD_SPP):
            L, _ = vt_pt.radiance(sc, cam.generate_ray(p_film),
                                  rng.seed(pix, s), max_depth=small.max_depth,
                                  min_depth=99, remat=remat)
            img = img + L
        (img / GRAD_SPP).square().mean().backward()
        torch.cuda.synchronize()
        peaks[remat] = dict(
            peak_over_start_bytes=torch.cuda.max_memory_allocated() - mem0,
            step_s=time.perf_counter() - t0)
        del params, sc, cam, img, L
    rec = dict(phase="grad_memory", res=MEM_RES, spp=GRAD_SPP,
               max_depth=small.max_depth, remat=peaks[True],
               taped=peaks[False],
               taped_over_remat=(peaks[False]["peak_over_start_bytes"]
                                 / peaks[True]["peak_over_start_bytes"]))
    emit(dict(rec, card=card))
    check(rec["taped_over_remat"] > 1.0, f"checkpointing saved nothing {rec}")


def rt_frames(rt, data, camera, state, n, **kw):
    """n frames of `render_realtime` from `state`: (images, state)."""
    imgs = []
    for _ in range(n):
        img, state = rt.render_realtime(data, camera, state, **kw)
        imgs.append(img)
    return imgs, state


def parted_share(a, b):
    """Share of pixels of a whose value parts from b's past the per-lane
    tolerance of the CPU tests."""
    return float((np.abs(a - b) > 1e-4 + 1e-3 * np.abs(b)).any(-1).mean())


def phase_realtime(vt, modules, scenes, sphere, card):
    """Slice 6: the real-time loop (`integrator/realtime.py`). The cbox at
    512^2 at the defaults through K1: steady-state frame time (host clock
    ending in a synchronize), launches and K1 launches a frame, device
    busy share, the per-stage split (`tools/profile_torch_render.py`
    `staged_frame`, each stage in its own profiler window), peak memory.
    The cbox at 128^2 against the JAX golden's frames 0 and 7; at 64^2,
    four card frames against the port's CPU frames of the same seeds.
    cbox_sphere at 512^2 with the surfel cache and GI at half resolution
    through K2. Returns the launch counts of one frame of each 512^2 run."""
    from vision_tpu_torch.integrator import realtime as rt
    prof = _load_by_path("vt_profile_render", "tools/profile_torch_render.py")
    per_frame = {}

    # ---- the cbox at 512^2, defaults, K1 ----
    cb = cbox_scene(vt, RES)
    t0 = time.perf_counter()
    state = rt.RealTimeState.initial((RES, RES), device=DEV)
    _, state = rt_frames(rt, cb.data, cb.camera, state, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _, state = rt_frames(rt, cb.data, cb.camera, state, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    zero_counts(modules)
    t0 = time.perf_counter()
    imgs, state = rt_frames(rt, cb.data, cb.camera, state, RT_TIMED)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / RT_TIMED
    launches = read_counts(modules)
    peak = torch.cuda.max_memory_allocated()
    img = imgs[-1].cpu().numpy()
    n, dev_ms, (_, state) = device_kernels(
        lambda: rt.render_realtime(cb.data, cb.camera, state))
    stages = {}

    def run(name, fn):
        k, ms, out = device_kernels(fn)
        stages[name] = dict(kernel_launches=k, device_ms=ms)
        return out
    prof.staged_frame(cb.data, cb.camera, state, run)
    per_frame["cbox_rt_frame"] = {k: v // RT_TIMED for k, v in launches.items()}
    rec = dict(phase="realtime", scene="cbox", res=RES, settings="defaults",
               first_frame_s=first_s, frame_s=wall, timed_frames=RT_TIMED,
               fps=1.0 / wall, kernel_launches_per_frame=n,
               device_ms_per_frame=dev_ms,
               device_busy_share=dev_ms / 1e3 / wall,
               launches_per_frame=per_frame["cbox_rt_frame"], stages=stages,
               peak_mem_bytes=peak, peak_mem_over_start_bytes=peak - mem0,
               mean=float(img.mean()))
    emit(dict(rec, card=card))
    check(img.shape == (RES, RES, 3) and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.0, f"cbox real-time frame {rec}")
    check(all(launches[f"dense_isect.{k}"] > 0 for k in ("closest", "anyhit"))
          and not any(v for k, v in launches.items()
                      if k.startswith("packet_isect")),
          f"cbox real-time frames' launches {launches}")
    del state, imgs

    # ---- the cbox at 128^2 against the JAX golden ----
    gold = np.load(os.path.join(ROOT, "tests/goldens/cbox_rt_hdr.npz"))
    sc = cbox_scene(vt, RT_GOLD_RES)
    imgs, _ = rt_frames(rt, sc.data, sc.camera, rt.RealTimeState.initial(
        (RT_GOLD_RES, RT_GOLD_RES), device=DEV), max(RT_GOLD_FRAMES) + 1)
    rec = dict(phase="realtime_golden", scene="cbox", res=RT_GOLD_RES,
               frames={})
    for f in RT_GOLD_FRAMES:
        a, b = imgs[f].cpu().numpy(), gold[f"frame{f}"]
        werr, bias = block_err(a, b)
        rec["frames"][f] = dict(werr=werr, bias=bias,
                                parted_share=parted_share(a, b))
    emit(rec)
    check(all(v["werr"] < GOLD_WERR and abs(v["bias"]) < GOLD_BIAS
              for v in rec["frames"].values()),
          f"real-time frames against the JAX golden {rec}")

    # ---- the cbox at 64^2: card frames against the port's CPU frames ----
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    desc = copy.deepcopy(fixtures.CBOX_JSON)
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        RT_TWIN_RES, RT_TWIN_RES]
    runs = {}
    for dev in (DEV, "cpu"):
        sc = vt.load_scene(desc, device=dev)
        t0 = time.perf_counter()
        imgs, _ = rt_frames(rt, sc.data, sc.camera, rt.RealTimeState.initial(
            (RT_TWIN_RES, RT_TWIN_RES), device=dev), RT_TWIN_FRAMES)
        runs[dev] = ([i.cpu().numpy() for i in imgs],
                     time.perf_counter() - t0)
    rec = dict(phase="realtime_vs_cpu", scene="cbox", res=RT_TWIN_RES,
               cpu_s=runs["cpu"][1], frames=[])
    for a, b in zip(runs[DEV][0], runs["cpu"][0]):
        werr, bias = block_err(a, b)
        rec["frames"].append(dict(werr=werr, bias=bias,
                                  parted_share=parted_share(a, b)))
    emit(rec)
    check(all(v["werr"] <= TWIN_WERR and abs(v["bias"]) <= TWIN_WERR
              for v in rec["frames"]),
          f"real-time frames on the card against the CPU's {rec}")

    # ---- cbox_sphere at 512^2, the surfel cache, GI at half res, K2 ----
    state = rt.RealTimeState.initial((RES, RES), cache="surfel",
                                     gi_scale=0.5, device=DEV)
    _, state = rt_frames(rt, sphere.data, sphere.camera, state,
                         RT_SPHERE_FRAMES - 1, gi_scale=0.5)
    torch.cuda.synchronize()
    zero_counts(modules)
    t0 = time.perf_counter()
    imgs, state = rt_frames(rt, sphere.data, sphere.camera, state, 1,
                            gi_scale=0.5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(modules)
    img = imgs[0].cpu().numpy()
    per_frame["cbox_sphere_rt_frame"] = launches
    rec = dict(phase="realtime", scene="cbox_sphere", res=RES,
               settings="surfel cache, gi_scale 0.5", frames=RT_SPHERE_FRAMES,
               frame_s=wall, launches_per_frame=launches,
               live_surfels=int(state.sharc.live.sum()),
               mean=float(img.mean()))
    emit(dict(rec, card=card))
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"cbox_sphere real-time frame {rec}")
    check(all(launches[f"packet_isect.{k}"] > 0 for k in ("closest", "anyhit"))
          and not any(v for k, v in launches.items()
                      if k.startswith("dense_isect")),
          f"cbox_sphere real-time launches {launches}")
    check(rec["live_surfels"] > 0, "no surfel spawned")
    return per_frame


def sdk_cbox_sphere(res, device, obj_path):
    """`VisionRenderer` fed the cbox's walls, boxes and emitter (procedural
    arrays with the cbox's matrices) and the sphere's arrays as the OBJ
    at `obj_path` loads them, placed where cbox_sphere puts its sphere."""
    from vision_tpu_torch.scene import shapes as shp
    from vision_tpu_torch.sdk import VisionRenderer
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    scenes = _load_by_path("vt_torch_scenes", "tests/torch_scenes.py")
    r = VisionRenderer(resolution=(res, res), device=device)
    for m in fixtures.CBOX_JSON["materials"]:
        r.add_material(copy.deepcopy(m))
    for sh in fixtures.CBOX_JSON["shapes"]:
        mesh = (shp.make_cube() if sh["type"] == "cube" else shp.make_quad())
        p = sh["param"]
        rows = np.asarray(p["transform"]["param"]["matrix4x4"], np.float64)
        r.add_instance(mesh.positions, mesh.triangles, mesh.normals, mesh.uvs,
                       material=p["material"], o2w=rows.T,
                       emission=[17, 12, 4] if "emission" in p else None)
    m = shp.load_model(obj_path)
    rows = np.eye(4)
    rows[3] = scenes.SPHERE_ROW
    r.add_instance(m.positions, m.triangles, m.normals, m.uvs,
                   material="White", o2w=rows.T)
    r.set_camera([0, 1, 6.8], [0, 1, 0], fov_y=19.5)
    return r.build_accel()


def phase_meshes(vt, modules, scenes, sphere_img, inst, inst_img, card):
    """Slices 7, 7b and 8a: mesh files, glTF import, JPEG, the CLI and the
    SDK. The 261,120-triangle sphere of cbox_sphere written as OBJ, PLY,
    GLB and STL (load seconds, the file alone and the whole scene; tri_pack
    bit for bit against the procedural scene, the STL's positions); the
    OBJ twin at 512^2, 16 spp through K2 against the cbox_sphere golden and
    the procedural render of this call; the OBJ placed 16 times through K3
    against the procedural instanced render; gltf_cbox (a GLB with a JPEG
    texture, 996 triangles) at 512^2, 16 spp through K1 against its JAX
    golden; every committed JPEG against its PIL decode, with no PIL or
    OpenCV imported; the CLI (the GLB to a PNG, the graph, realtime and
    denoise pipelines, an EXR); the SDK on the OBJ's arrays through K2.
    Returns each render's launch counts."""
    import hashlib
    import tempfile
    from vision_tpu_torch import cli
    from vision_tpu_torch.scene import imageio
    from vision_tpu_torch.scene import shapes as shp
    per_render = {}
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name

    # ---- 1. the four files of the sphere against the procedural scene ----
    t0 = time.perf_counter()
    files = scenes.cbox_sphere_files(d, RES)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = vt.load_scene(scenes.cbox_sphere(RES), device=DEV)
    proc_s = time.perf_counter() - t0
    want = proc.data.tri_pack
    obj_scene = None
    for fmt in scenes.MESH_FORMATS:
        path = files[fmt]["shapes"][-1]["param"]["fn"]
        t0 = time.perf_counter()
        mesh = shp.load_model(path)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sc = vt.load_scene(files[fmt], device=DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = sc.data.tri_pack
        rec = dict(phase="load", scene=f"cbox_sphere_{fmt}", card=card,
                   file_bytes=os.path.getsize(path), parse_seconds=parse_s,
                   seconds=load_s, procedural_seconds=proc_s,
                   write_all_four_seconds=write_s,
                   mesh_tris=int(mesh.num_triangles),
                   tris=int(sc.data.tri_geom.shape[0]),
                   takes_bvh=sc.data.pbvh is not None)
        if fmt == "stl":
            rec["positions_equal"] = bool(torch.equal(got[:, :9], want[:, :9]))
            rec["ids_equal"] = bool(torch.equal(got[:, 24:], want[:, 24:]))
            ok = rec["positions_equal"] and rec["ids_equal"]
        else:
            rec["tri_pack_bit_equal"] = bool(torch.equal(got, want))
            ok = rec["tri_pack_bit_equal"]
        emit(rec)
        check(ok and rec["tris"] == 261156 and rec["takes_bvh"],
              f"cbox_sphere {fmt} twin {rec}")
        if fmt == "obj":
            obj_scene = sc
    del proc

    # ---- 2. the OBJ twin through K2 ----
    img, rec = render(vt, modules, obj_scene, "cbox_sphere_obj")
    rec["golden_werr"], rec["golden_bias"] = vs_golden(
        img, "tests/goldens/cbox_sphere_hdr.npz")
    rec["vs_procedural_werr"], _ = block_err(img, sphere_img)
    rec["vs_procedural_max_abs"] = float(np.abs(img - sphere_img).max())
    emit(rec)
    check(all(rec["launches"][f"packet_isect.{k}"] > 0
              for k in ("closest", "anyhit"))
          and not any(v for k, v in rec["launches"].items()
                      if k.startswith("dense_isect")),
          f"cbox_sphere_obj launches {rec['launches']}")
    check(rec["golden_werr"] < GOLD_WERR and abs(rec["golden_bias"]) < GOLD_BIAS,
          f"cbox_sphere_obj vs golden {rec}")
    check(rec["vs_procedural_werr"] <= TWIN_WERR,
          f"cbox_sphere_obj vs the procedural render {rec}")
    per_render["cbox_sphere_obj"] = rec["launches"]
    del obj_scene

    # ---- 3. one OBJ placed 16 times: K3 ----
    t0 = time.perf_counter()
    sc = vt.load_scene(scenes.cbox_spheres_instanced_obj(d, RES), device=DEV)
    load_s = time.perf_counter() - t0
    check(sc.data.ipbvh is not None
          and sc.data.ipbvh.n_inst == inst.data.ipbvh.n_inst
          and torch.equal(sc.data.tri_pack, inst.data.tri_pack),
          "the instanced OBJ scene takes K3 as the procedural one")
    img, rec = render(vt, modules, sc, "cbox_spheres_instanced_obj")
    rec["load_seconds"] = load_s
    rec["instances"] = sc.data.ipbvh.n_inst
    rec["vs_procedural_werr"], _ = block_err(img, inst_img)
    emit(rec)
    check(all(rec["launches"][f"packet_isect.{k}_inst"] > 0
              for k in ("closest", "anyhit")),
          f"cbox_spheres_instanced_obj launches {rec['launches']}")
    check(rec["vs_procedural_werr"] <= TWIN_WERR,
          f"instanced OBJ vs the procedural render {rec}")
    per_render["cbox_spheres_instanced_obj"] = rec["launches"]
    del sc

    # ---- 4. gltf_cbox through K1 against its JAX golden ----
    t0 = time.perf_counter()
    desc, gdir = scenes.gltf_cbox_scene(d, RES)
    sc = vt.Scene(desc, DEV, scene_dir=gdir)
    load_s = time.perf_counter() - t0
    glb = os.path.join(gdir, "gltf_cbox.glb")
    check(sc.data.pbvh is None and sc.data.tri_geom.shape[0] == 996
          and sc.data.atlas.n_real == 1 and sc.data.lights.n_lights == 2,
          "gltf_cbox: 996 triangles on the dense sweep, a JPEG, two lights")
    img, rec = render(vt, modules, sc, "gltf_cbox")
    rec["load_seconds"] = load_s
    rec["glb_bytes"] = os.path.getsize(glb)
    rec["golden_werr"], rec["golden_bias"] = vs_golden(
        img, "tests/goldens/gltf_cbox_hdr.npz")
    emit(rec)
    check(all(rec["launches"][f"dense_isect.{k}"] > 0
              for k in ("closest", "anyhit"))
          and not any(v for k, v in rec["launches"].items()
                      if k.startswith("packet_isect")),
          f"gltf_cbox launches {rec['launches']}")
    check(rec["golden_werr"] < GOLD_WERR and abs(rec["golden_bias"]) < GOLD_BIAS,
          f"gltf_cbox vs golden {rec}")
    per_render["gltf_cbox"] = rec["launches"]
    del sc

    # ---- 5. the committed JPEGs against their PIL decodes ----
    assets = os.path.join(ROOT, "tests", "assets_torch")
    dec = np.load(os.path.join(assets, "jpeg_decodes.npz"))
    for k in sorted(n for n in dec.files if "." not in n):
        t0 = time.perf_counter()
        got, _ = imageio.read_image(os.path.join(assets, k + ".jpg"))
        seconds = time.perf_counter() - t0
        ref = dec[k]
        part = got[:ref.shape[0], :ref.shape[1]].astype(np.int32)
        rec = dict(phase="jpeg", file=k + ".jpg", card=card,
                   shape=list(got.shape), seconds=seconds,
                   max_abs_diff=int(np.abs(part - ref).max()))
        ok = rec["max_abs_diff"] == 0
        if k + ".sha256" in dec:
            rec["sha256_equal"] = (hashlib.sha256(got.tobytes()).digest()
                                   == dec[k + ".sha256"].tobytes())
            ok = ok and rec["sha256_equal"] and list(got.shape) == list(
                dec[k + ".shape"])
        emit(rec)
        check(ok, f"JPEG {k} against its PIL decode {rec}")
    check("PIL" not in sys.modules and "cv2" not in sys.modules,
          "an image library was imported")

    # ---- 6. the command line ----
    def run_cli(name, args):
        zero_counts(modules)
        t0 = time.perf_counter()
        check(cli.main(args + ["-d", DEV, "-q"]) == 0, f"cli {name}")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, read_counts(modules)

    out = os.path.join(d, "glb.png")
    wall, launches = run_cli("gltf_cbox", ["-s", glb, "-o", out, "--spp",
                                           str(SPP)])
    sc = vt.load_scene(glb, device=DEV)
    want = postprocess_u8(vt, sc, vt.render(sc, spp=SPP))
    png = read_png(out).astype(np.int32)
    rec = dict(phase="cli", run="gltf_cbox.glb -> png", wall_s=wall,
               res=list(png.shape[:2]), spp=SPP, max_depth=sc.max_depth,
               launches=launches,
               max_level_diff=int(np.abs(png - want).max()))
    emit(rec)
    check(png.shape == (RES, RES, 3) and rec["max_level_diff"] <= 1
          and launches["dense_isect.closest"] > 0,
          f"the CLI's PNG of gltf_cbox {rec}")
    per_render["cli_gltf_cbox"] = launches
    del sc
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    small = copy.deepcopy(fixtures.CBOX_JSON)
    small["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        CLI_RES, CLI_RES]
    js = os.path.join(d, "cbox.json")
    with open(js, "w") as f:
        json.dump(small, f)
    for name, extra in (("graph", ["-p", "graph"]),
                        ("realtime", ["-p", "realtime", "--spp", "2"]),
                        ("denoise", ["--denoise", "--spp", "4"])):
        out = os.path.join(d, f"{name}.png")
        wall, launches = run_cli(name, ["-s", js, "-o", out] + extra)
        png = read_png(out)
        rec = dict(phase="cli", run=name, res=CLI_RES, wall_s=wall,
                   launches=launches, mean=float(png.mean()))
        emit(rec)
        check(png.shape == (CLI_RES, CLI_RES, 3) and png.max() > 0
              and launches["dense_isect.closest"] > 0, f"cli {name} {rec}")
    out = os.path.join(d, "cbox.exr")
    wall, _ = run_cli("exr", ["-s", js, "-o", out, "--spp", "4"])
    with open(out, "rb") as f:
        got = imageio.read_exr(f.read())
    want = vt.render(vt.load_scene(js, device=DEV), spp=4).cpu().numpy()
    rec = dict(phase="cli", run="exr", res=CLI_RES, wall_s=wall,
               bit_equal=bool(np.array_equal(got, want)))
    emit(rec)
    check(rec["bit_equal"], f"the CLI's EXR against the render {rec}")

    # ---- 7. the SDK on the OBJ's arrays ----
    obj = files["obj"]["shapes"][-1]["param"]["fn"]
    t0 = time.perf_counter()
    r = sdk_cbox_sphere(RES, DEV, obj)
    build_s = time.perf_counter() - t0
    check(r._scene.data.pbvh is not None, "the SDK scene takes the BVH")
    r.render(spp=1)  # warm-up
    r._accum, r._frame = None, 0
    torch.cuda.synchronize()
    zero_counts(modules)
    t0 = time.perf_counter()
    r.render(spp=SPP)
    img = r.download_radiance()
    wall = time.perf_counter() - t0
    launches = read_counts(modules)
    rec = dict(phase="sdk", scene="cbox + the OBJ sphere", res=RES, spp=SPP,
               build_seconds=build_s, wall_s=wall, launches=launches,
               mean=float(img.mean()))
    rec["golden_werr"], rec["golden_bias"] = vs_golden(
        img, "tests/goldens/cbox_sphere_hdr.npz")
    # on the card and on the CPU at SDK_RES over a sub_div-40 OBJ sphere
    small_obj = os.path.join(d, "sphere40.obj")
    scenes.write_obj(small_obj, shp.make_sphere(0.3, 40))
    imgs = []
    for dev in (DEV, "cpu"):
        s = sdk_cbox_sphere(SDK_RES, dev, small_obj)
        imgs.append(s.render(spp=SDK_CPU_SPP).download_radiance())
    rec["vs_cpu_werr"], rec["vs_cpu_bias"] = block_err(imgs[0], imgs[1])
    emit(rec)
    check(launches["packet_isect.closest"] > 0
          and launches["packet_isect.anyhit"] > 0
          and launches["dense_isect.closest"] == 0, f"SDK launches {rec}")
    check(rec["golden_werr"] < GOLD_WERR and abs(rec["golden_bias"]) < GOLD_BIAS,
          f"the SDK's cbox_sphere vs the golden {rec}")
    check(rec["vs_cpu_werr"] <= SKY_WERR and abs(rec["vs_cpu_bias"]) <= SKY_WERR,
          f"the SDK on the card vs the CPU {rec}")
    per_render["sdk_cbox_sphere_obj"] = launches
    tmp.cleanup()
    return per_render


BAKE_SPP = 16        # the CLI's default bake (vision_tpu/cli.py:92)
BAKE_DEPTH = 4       # bake_lightmap's default depth
BAKE_LM = 256        # the CLI's lightmap width
BAKE_K2_LM = 1024    # cbox_sphere(sub_div=40): 404,241 lanes through K2
BAKE_K2_SUBDIV = 40  # 6,276 triangles (> 2048: K2); the chart unwrap is
                     # quadratic in chart size, out of reach at 261,120
BAKE_CPU = (64, 4, 2)  # lightmap, spp, depth of the card-vs-CPU bake
DIST_FRAME = 3
DIST_DEPTH = 4       # training_step's default depth
GRAD_GROUPS = ("materials", "lights", "atlas", "camera")
RESUME_AT = 8        # render_resumable: stopped here, resumed to SPP
OVERLAY_PIXELS = 16


def bake_run(vt, modules, scene, name, lm_res, card, spp=BAKE_SPP,
             depth=BAKE_DEPTH):
    """One bake through `bake.bake_scene` with every launch count set to 0
    just before it and read just after, and its display pass at the
    scene's resolution the same way. Returns (baked, display image,
    record)."""
    from vision_tpu_torch.pipelines import bake
    torch.cuda.synchronize()
    zero_counts(modules)
    st = {}
    t0 = time.perf_counter()
    baked = bake.bake_scene(scene.data, lm_res, spp, depth, stats=st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(modules)
    lm = baked.lm.cpu().numpy()
    zero_counts(modules)
    t0 = time.perf_counter()
    img = bake.render_baked(scene.data, scene.camera, baked).cpu().numpy()
    disp_s = time.perf_counter() - t0
    disp_launches = read_counts(modules)
    rec = dict(phase="bake", scene=name, card=card, lightmap=list(lm.shape[:2]),
               spp=spp, max_depth=depth,
               tris=int(scene.data.tri_geom.shape[0]),
               host_unwrap_rasterize_s=st["host_s"], device_bake_s=st["bake_s"],
               wall_s=wall, lanes=st["lanes"], nrays=st["nrays"],
               rays_per_s=st["nrays"] / st["bake_s"],
               launches=launches,
               launches_per_pass={k: v / spp for k, v in launches.items()},
               coverage=float((lm.sum(-1) > 0).mean()),
               lm_finite=bool(np.isfinite(lm).all()), lm_mean=float(lm.mean()),
               display_res=list(img.shape[:2]), display_s=disp_s,
               display_launches=disp_launches,
               display_mean=float(img.mean()))
    check(rec["lm_finite"] and bool(np.isfinite(img).all()),
          f"bake {name}: non-finite values")
    check(rec["coverage"] > 0.2, f"bake {name}: coverage {rec['coverage']}")
    return baked, img, rec


def phase_bake(vt, modules, scenes, cbox, cbox_img, card):
    """Slice 8b: the lightmap bake (`pipelines/bake.py`). The cbox baked
    through K1 at the CLI's defaults (lightmap 256, 16 spp, depth 4) and
    cbox_sphere(sub_div=40) (6,276 triangles) through K2 at lightmap 1024
    (404,241 lanes), each displayed by `render_baked` at 512^2, whose mean
    must be within (0.3, 3) of the path-traced render's; the CLI's
    `-p bake` on the cbox to a PNG within one level of that display; the
    cbox bake at lightmap 64, 4 spp, depth 2 on the card against the
    port's CPU bake (8x8 block error and bias <= 0.01). Returns the launch
    counts of each bake and display pass."""
    import tempfile
    from vision_tpu_torch import cli
    from vision_tpu_torch.pipelines import bake
    per_run = {}

    # ---- the cbox through K1 ----
    _, img, rec = bake_run(vt, modules, cbox, "cbox", BAKE_LM, card)
    rec["display_vs_render_mean"] = rec["display_mean"] / float(cbox_img.mean())
    emit(rec)
    L = rec["launches"]
    check(L["dense_isect.closest"] > 0 and L["dense_isect.anyhit"] > 0
          and L["packet_isect.closest"] == 0, f"cbox bake launches {L}")
    check(rec["display_launches"]["dense_isect.closest"] == 1,
          f"render_baked launches {rec['display_launches']}")
    check(0.3 < rec["display_vs_render_mean"] < 3.0,
          f"cbox baked display against the render {rec}")
    per_run["bake_cbox"] = L
    per_run["render_baked_cbox"] = rec["display_launches"]
    cbox_u8 = postprocess_u8(vt, cbox, torch.as_tensor(img, device=DEV))

    # ---- cbox_sphere(sub_div=40) through K2 ----
    sph = vt.load_scene(scenes.cbox_sphere(RES, sub_div=BAKE_K2_SUBDIV),
                        device=DEV)
    check(sph.data.pbvh is not None, "the sub_div-40 sphere takes the BVH")
    sph_img, rrec = render(vt, modules, sph, "cbox_sphere_sub40")
    _, img, rec = bake_run(vt, modules, sph, "cbox_sphere_sub40", BAKE_K2_LM,
                           card)
    rec["display_vs_render_mean"] = rec["display_mean"] / float(sph_img.mean())
    rec["render_wall_s"] = rrec["wall_s"]
    emit(rec)
    L = rec["launches"]
    check(L["packet_isect.closest"] > 0 and L["packet_isect.anyhit"] > 0
          and L["dense_isect.closest"] == 0, f"cbox_sphere bake launches {L}")
    check(rec["lanes"] > 262144, f"lanes {rec['lanes']}")
    check(0.3 < rec["display_vs_render_mean"] < 3.0,
          f"cbox_sphere baked display against the render {rec}")
    per_run["bake_cbox_sphere_sub40"] = L
    per_run["render_baked_cbox_sphere_sub40"] = rec["display_launches"]
    del sph

    # ---- the CLI's -p bake on the cbox ----
    fixtures = _load_by_path("cbox_fixtures", "tests/fixtures.py")
    desc = copy.deepcopy(fixtures.CBOX_JSON)
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [
        RES, RES]
    with tempfile.TemporaryDirectory() as d:
        js = os.path.join(d, "cbox.json")
        with open(js, "w") as f:
            json.dump(desc, f)
        out = os.path.join(d, "bake.png")
        zero_counts(modules)
        t0 = time.perf_counter()
        check(cli.main(["-s", js, "-o", out, "-p", "bake", "-d", DEV,
                        "-q"]) == 0,
              "cli -p bake")
        wall = time.perf_counter() - t0
        launches = read_counts(modules)
        png = read_png(out).astype(np.int32)
    rec = dict(phase="cli", run="-p bake", res=list(png.shape[:2]),
               wall_s=wall, launches=launches,
               max_level_diff=int(np.abs(png - cbox_u8).max()))
    emit(rec)
    check(png.shape == (RES, RES, 3) and rec["max_level_diff"] <= 1
          and launches["dense_isect.closest"] > 0, f"cli -p bake {rec}")
    per_run["cli_bake_cbox"] = launches

    # ---- the card's bake against the CPU's ----
    lm_res, spp, depth = BAKE_CPU
    lms = [bake.bake_lightmap(vt.load_scene(desc, device=dev).data, lm_res,
                              spp, depth)[0] for dev in (DEV, "cpu")]
    werr, bias = block_err(lms[0], lms[1])
    off = (np.abs(lms[0] - lms[1]) > 1e-4 + 1e-3 * np.abs(lms[1])).any(-1)
    rec = dict(phase="bake", scene="cbox card vs cpu", lightmap=lm_res,
               spp=spp, max_depth=depth, vs_cpu_werr=werr, vs_cpu_bias=bias,
               parted_texel_share=float(off.mean()))
    emit(rec)
    check(werr <= SKY_WERR and abs(bias) <= SKY_WERR,
          f"the bake on the card vs the CPU {rec}")
    return per_run


def single_step(vt_pt, opt, data, camera, target, depth):
    """The world-1 training step's loss and gradients in one process, the
    way the gradient path takes them: `param_surface` leaves through
    `apply_params`, pixel centres, seeds (pixel, frame), `pt.radiance` with
    each bounce checkpointed, torch autograd."""
    from vision_tpu_torch.core import rng
    params = grad_leaves(opt, data, camera, {g: None for g in GRAD_GROUPS})
    sc, cam = opt.apply_params(data, camera, params)
    W, H = cam.resolution
    pix = torch.arange(W * H, device=DEV)
    p = torch.stack([(pix % W).float() + 0.5, (pix // W).float() + 0.5], -1)
    L, _ = vt_pt.radiance(sc, cam.generate_ray(p), rng.seed(pix, DIST_FRAME),
                          depth, 0, 1.0, remat=True)
    diff = L - target.reshape(-1, 3)
    loss = torch.mean(diff * diff)
    leaves = flat_leaves(params)
    grads = torch.autograd.grad(loss, [v for _, v in leaves],
                                allow_unused=True)
    return float(loss.detach()), {k: (torch.zeros_like(v) if g is None else g)
                         for (k, v), g in zip(leaves, grads)}


def phase_dist(vt, modules, vt_pt, cbox, card):
    """Slice 9 on one card: a world-size-1 NCCL process group (file://
    rendezvous), `render_sharded` of the cbox at 512^2 bit for bit against
    the single-process pass of the same seeds, `training_step` (all four
    groups, depth 4) against the same loss and gradients taken in one
    process (under torch's deterministic algorithms within rtol 1e-6; in
    the default mode, whose atomic adds reorder between runs, at
    BASELINE's rtol 1e-3, atol 1e-3 max|g|, with the spread of two
    single-process steps beside it), `measure_weak_scaling(dp_sizes=(1,))`
    timed. Several
    ranks are held on the CPU with gloo (tests/test_torch_dist.py): one
    H100 cannot host two NCCL ranks. Returns the launch counts of the
    sharded render and step."""
    import tempfile
    import torch.distributed as tdist
    from vision_tpu_torch.diff import optimize as opt
    from vision_tpu_torch.parallel import dist, launch
    per_run = {}
    d = tempfile.mkdtemp()
    check(launch.init_distributed("file://" + os.path.join(d, "rendezvous"),
                                  world_size=1, rank=0, device=DEV),
          "init_distributed")
    try:
        backend = tdist.get_backend()
        mesh = dist.make_mesh(sp=1)
        data, cam, filt = cbox.data, cbox.camera, cbox.filter
        ref, _ = vt_pt.render_sample(data, cam, filt, DIST_FRAME, max_depth=8)
        dist.render_sharded(data, cam, filt, DIST_FRAME, mesh, max_depth=8)
        torch.cuda.synchronize()
        zero_counts(modules)
        t0 = time.perf_counter()
        img = dist.render_sharded(data, cam, filt, DIST_FRAME, mesh,
                                  max_depth=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(modules)
        rec = dict(phase="dist", run="render_sharded", backend=backend,
                   world=tdist.get_world_size(), card=card, res=RES,
                   max_depth=8, wall_s=wall, launches=launches,
                   bit_equal=bool(torch.equal(img, ref)),
                   max_abs_diff=float((img - ref).abs().max()))
        emit(rec)
        check(backend == "nccl" and rec["bit_equal"]
              and launches["dense_isect.closest"] > 0,
              f"render_sharded against the single-process pass {rec}")
        per_run["render_sharded_cbox"] = launches

        target = torch.as_tensor(np.random.default_rng(SEED).random(
            (RES, RES, 3)).astype(np.float32), device=DEV)

        def step():
            return dist.training_step(data, cam, filt, DIST_FRAME, mesh,
                                      target, max_depth=DIST_DEPTH,
                                      groups=GRAD_GROUPS)

        def single():
            return single_step(vt_pt, opt, data, cam, target, DIST_DEPTH)

        step()  # warm-up: the first all-reduce over the whole group
        torch.cuda.synchronize()
        zero_counts(modules)
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(modules)
        ref_loss, ref_grads = single()
        _, ref2_grads = single()
        # the backward's index_add_ adds with atomics on the card, in the
        # order they land: the same step twice differs in the last bits.
        # Under torch's deterministic algorithms both take the sorted
        # adds, and the step must equal the single-process one within
        # rtol 1e-6; in the default mode the run-to-run spread is
        # reported and the step held at BASELINE's gradient tolerance.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        try:
            det_loss, det_grads = step()
            det_ref_loss, det_ref_grads = single()
        finally:
            torch.use_deterministic_algorithms(False)

        def worst(got, want, rtol, arel):
            """(largest |a - b| / (rtol |b| + arel max|b|) over the leaves
            {name: tensor}, the leaves past 1)."""
            top, parted = 0.0, []
            for k, b in want.items():
                tol = rtol * b.abs() + arel * float(b.abs().max())
                r = float(((got[k] - b).abs() / tol.clamp_min(1e-38)).max())
                top = max(top, r)
                if r > 1.0:
                    parted.append(k)
            return top, parted

        def by_name(nested):
            return {f"{g}.{k}": v for g, d in nested.items()
                    for k, v in d.items()}

        spread, _ = worst(ref2_grads, ref_grads, 1e-6, 1e-6)
        default_r, default_parted = worst(by_name(grads), ref_grads, 1e-3,
                                          1e-3)
        default_r6, _ = worst(by_name(grads), ref_grads, 1e-6, 1e-6)
        det_r, det_parted = worst(by_name(det_grads), det_ref_grads, 1e-6,
                                  0.0)
        rec = dict(phase="dist", run="training_step", backend=backend,
                   res=RES, max_depth=DIST_DEPTH, groups=list(GRAD_GROUPS),
                   wall_s=wall, launches=launches, loss=float(loss),
                   single_process_loss=ref_loss,
                   loss_rel_diff=abs(float(loss) - ref_loss) / ref_loss,
                   default_vs_single_over_rtol1e3=default_r,
                   default_vs_single_over_rtol1e6=default_r6,
                   single_vs_single_over_rtol1e6=spread,
                   deterministic_loss_rel_diff=abs(
                       float(det_loss) - det_ref_loss) / det_ref_loss,
                   deterministic_vs_single_over_rtol1e6=det_r,
                   deterministic_leaves_parted=det_parted)
        emit(rec)
        check(rec["loss_rel_diff"] <= 1e-6 and not default_parted,
              f"training_step against the single-process step {rec}")
        check(rec["deterministic_loss_rel_diff"] <= 1e-6 and not det_parted,
              f"deterministic training_step against the single-process "
              f"step {rec}")
        per_run["training_step_cbox"] = launches

        t0 = time.perf_counter()
        times = launch.measure_weak_scaling(data, cam, filt, dp_sizes=(1,),
                                            pixels_per_chip=RES * RES,
                                            max_depth=8, iters=3)
        rec = dict(phase="dist", run="measure_weak_scaling", backend=backend,
                   pixels_per_rank=RES * RES, max_depth=8, iters=3,
                   seconds_per_pass=times,
                   wall_s=time.perf_counter() - t0)
        emit(rec)
        check(set(times) == {1} and times[1] > 0, f"weak scaling {rec}")
    finally:
        tdist.destroy_process_group()
    return per_run


def phase_utils(vt, modules, cbox, sphere, cbox_img, card):
    """The utilities of slice 8b on the card: `render_resumable` of the cbox
    at 512^2, 16 spp, stopped at 8 and resumed, bit for bit against the
    uninterrupted run; `scene_memory_stats` of cbox_sphere (261,156
    triangles) beside the card's own count; `validate_radiance` of the cbox
    render; `overlay_rays` of 16 pixels at 512^2. Returns the launch counts
    of the resumed half and the overlay."""
    import tempfile
    from vision_tpu_torch.sensor import visualizer as vz
    from vision_tpu_torch.utils import checkpoint as ck
    from vision_tpu_torch.utils import debug as dbg
    per_run = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        full = ck.render_resumable(cbox, SPP, os.path.join(d, "a.npz"),
                                   checkpoint_every=SPP)
        full_s = time.perf_counter() - t0
        part = os.path.join(d, "b.npz")
        ck.render_resumable(cbox, RESUME_AT, part, checkpoint_every=RESUME_AT)
        zero_counts(modules)
        t0 = time.perf_counter()
        resumed = ck.render_resumable(cbox, SPP, part,
                                      checkpoint_every=RESUME_AT)
        resume_s = time.perf_counter() - t0
        launches = read_counts(modules)
        ckpt_bytes = os.path.getsize(part)
    ok, counts = dbg.validate_radiance(full)
    rec = dict(phase="utils", run="render_resumable", res=RES, spp=SPP,
               stopped_at=RESUME_AT, full_s=full_s, resumed_half_s=resume_s,
               checkpoint_bytes=ckpt_bytes, launches=launches,
               bit_equal=bool(np.array_equal(full, resumed)),
               validate_radiance=counts,
               vs_render_werr=block_err(full, cbox_img)[0])
    emit(rec)
    check(rec["bit_equal"] and ok and launches["dense_isect.closest"] > 0,
          f"render_resumable {rec}")
    per_run["render_resumable_cbox_second_half"] = launches

    st = dbg.scene_memory_stats(sphere.data)
    top = sorted((v, k) for k, v in st.items() if k != "TOTAL")[-5:]
    rec = dict(phase="utils", run="scene_memory_stats", scene="cbox_sphere",
               tris=int(sphere.data.tri_geom.shape[0]), total_bytes=st["TOTAL"],
               largest={k: v for v, k in reversed(top)},
               entries=len(st) - 1)
    emit(rec)
    check(st["TOTAL"] > st["tri_pack"] > 0 and any(
        k.startswith("pbvh.") for k in st), f"memory stats {rec}")

    W, H = cbox.camera.resolution
    pix = np.random.default_rng(SEED).choice(W * H, OVERLAY_PIXELS,
                                             replace=False)
    base = np.zeros((H, W, 3), np.float32)
    zero_counts(modules)
    t0 = time.perf_counter()
    over = vz.overlay_rays(base.copy(), cbox.data, cbox.camera, pix,
                           max_depth=3)
    wall = time.perf_counter() - t0
    launches = read_counts(modules)
    rec = dict(phase="utils", run="overlay_rays", res=RES,
               pixels=OVERLAY_PIXELS, max_depth=3, wall_s=wall,
               drawn_pixels=int((over != base).any(-1).sum()),
               launches=launches)
    emit(rec)
    check(rec["drawn_pixels"] > 0 and launches["dense_isect.closest"] > 0,
          f"overlay_rays {rec}")
    per_run["overlay_rays_cbox"] = launches
    return per_run


def _image_file_rec(fn, got, want, seconds, card, kind):
    """One `image_file` line: the decode against its committed reference,
    bit for bit (float data compared as its bits, NaN payloads included)."""
    same = got.shape == want.shape
    if same and got.dtype == np.float32:
        bit_equal = bool(np.array_equal(got.view(np.uint32),
                                        want.view(np.uint32)))
        with np.errstate(invalid="ignore"):
            d = np.abs(got.astype(np.float64) - want)
        diff = float(np.nanmax(d)) if not np.isnan(d).all() else 0.0
    elif same:
        bit_equal = bool(np.array_equal(got, want))
        diff = int(np.abs(got.astype(np.int32) - want).max())
    else:
        bit_equal, diff = False, None
    return dict(phase="image_file", file=fn, kind=kind, card=card,
                shape=list(got.shape), seconds=seconds, max_abs_diff=diff,
                bit_equal=bit_equal)


def phase_image_files(card):
    """Slices 7c, 7d, 7e.1, 7e.2, 7e.3a, 7e.6a, 7e.3b, 7e.4, 7e.6b, 7e.5,
    7e.4b (both routes), 7e.7a, 7e.7b, 7e.7d, 7e.7c, 7e.8a.1 and 7e.8a.2a
    on the card's host: every
    file of
    tests/assets_torch/image_decodes.npz (progressive, CMYK, YCCK, RGB,
    lossless and arithmetic-coded JPEG, Adam7 and low- and 16-bit PNG, TGA,
    BMP; TIFF and GIF, `tiny.tif` among them) and of webp_decodes.npz
    (lossless, lossy, alpha, VP8X, animated WebP; hand-built ALPH, VP8 and
    VP8L variants) held bit for bit against its committed PIL decode, and
    every file of exr_decodes.npz (every OpenEXR compression, tiled and
    multi-part files) against its committed libOpenEXR decode, each with
    its seconds; the timing files `lzw_2048.tif`, `piz_2048.exr`,
    `grain_2048.webp` and `smooth_2048.webp` against their decodes' sha256;
    the deep files refused (ValueError); slices 7e.2 and 7e.3a: every file
    of exr_cv_decodes.npz (luminance-chroma, UINT, channel sets, deep
    composites, perceptually linear B44 / DWA, DWA version 1) against its
    committed OpenCV 4.6.0 decode and of cv_decodes.npz (PNM, PAM, PFM, Sun
    raster, BMP, YCCK JPEG under .hdr / .exr names) against the pip cv2's,
    the timing files `yc_2048.exr` and `deep_512.exr` (and B44's log table)
    against their sha256; an AVIF file under a .hdr name raising naming
    ROADMAP 7e; slice 7e.6a: every file of pil_decodes.npz (PCX, SGI, MSP,
    PSD, XPM, DDS of every pixel format, BC6H and BC7 blocks of every
    mode, Sun raster, ICNS, CUR, the twins' QOI, PPM, SGI, ICO and BC7
    files; the IM files of PIL's bit decoder, RGB3 / RYB3 and YCC types)
    against its committed PIL decode, and `bc7_2048.dds` (2048^2 random
    BC7 blocks built here from its seed, `tools/gen_torch_pil.py`
    `bc7_timing`) against its decode's sha256; slice 7e.3b: every file of
    cvtiff_decodes.npz (TIFF on both of OpenCV's routes, GIF, under .hdr /
    .exr names) against the pip cv2's decode, and `sky_2048.exr` (a 2048^2
    float32 TIFF, LZW with the floating-point predictor, built here from
    its seed, `tools/gen_torch_cvtiff.py` `float_timing`) against its
    decode's sha256; slice 7e.4: every file of tiff_decodes.npz (CCITT,
    LZMA, ZSTD, ThunderScan, BigTIFF, CIELab, YCbCr, 10- to 14-bit, CMYK
    and planar JPEG TIFF, under .tif names against PIL's decode and under
    .hdr / .exr names against the pip cv2's) and the committed 2048^2
    Group 4 page `g4_2048.tif` against its decode's sha256; slice 7e.6b:
    every file of pil_rare_decodes.npz (BLP, FLI / FLC, FITS, FTEX, GBR,
    IMT, IPTC, McIdas, PIXAR, XV thumbnails; the twins' BLP, GBR, FLC
    and PIXAR files) against its committed PIL decode, and `blp_2048.blp`
    (2048^2 random BLP2 DXT5 blocks through PIL's Python decoders) and
    `photocd.pcd` (a PhotoCD base image), both built here from their
    seeds (`tools/gen_torch_pil.py` `blp_dxt_timing`, `pcd_file`),
    against their decodes' sha256; slice 7e.5: every file of
    jpeg_7e5_decodes.npz (progressive files cut between or inside their
    scans, through libjpeg's block smoothing, Huffman- and
    arithmetic-coded; subsampled lossless files; the twins' JPEGs)
    against its committed PIL decode, the committed 2048^2 progressive
    `smooth_2048.jpg` whole and cut here after its DC scan and after its
    first AC scan (`tools/gen_torch_assets.py` `smooth_cuts`), each cut's
    smoothing pass timed on its own, and a 2048^2 4:2:0 lossless file
    built here from its seed (`lossless_timing`), against their decodes'
    sha256; the SOF11 file `ll_arith.jpg` refused (ValueError); slice
    7e.4b: every file of ojpeg_decodes.npz (old-style JPEG TIFF in both
    layouts, every sampling, strips with restart intervals, tiles,
    planes, grey, tags left out; the twins' files) against its committed
    PIL decode, the `oj_bad_*` files PIL refuses refused (ValueError),
    and a 2048^2 tables-only 4:2:0 file of 16-row strips, a restart
    interval each, built here from its seed (`tools/gen_torch_ojpeg.py`
    `ojpeg_timing`) against its decode's sha256; slice 7e.4b on OpenCV's
    route: every file of sgilog_decodes.npz (LogLuv32 and LogLuv24 TIFF
    as float XYZ through OpenCV's XYZ2BGR, LogL as libtiff's 8-bit grey:
    several strips, tiles, odd widths, runs and literals across 127 / 128
    bytes, every uv code, orientation; the twins' files) against the pip
    cv2's decode, the `sl_bad_*` files it refuses refused (ValueError),
    and a 2048^2 LogLuv32 file of 128 strips built here from its seed
    (`tools/gen_torch_sgilog.py` `logluv_timing`) against its decode's
    sha256; slice 7e.7a: every file of j2k_decodes.npz (JPEG 2000 on
    PIL's route: J2K and JP2, every mode, 5/3 and 9/7, progressions,
    tiles, layers, precincts, every Part-1 code-block style, ROI, SOP /
    EPH, COC / QCC, POC, PPM / PPT, sub-sampled components, palettes,
    ICNS icons; the twins' files) against its committed PIL decode, the
    `j2k_bad_*` files PIL refuses refused (ValueError), and the committed
    2048^2 file `j2k_2048.jp2` (9/7, six resolutions, 64 x 64
    code-blocks, about 0.5 bits a pixel; the card's machine has no
    encoder) against its decode's sha256, timed; slice 7e.7b: every file
    of j2k_cv_decodes.npz (slice 7e.7a's JPEG 2000 files and the `j2kcv_*`
    ones: 9-16-bit samples, palettes with cmap and cdef boxes, sYCC, grey
    colr boxes over 2-4 components, tiles at the origin, POC stops; the
    twins' files) copied under a .exr name against the pip cv2's decode,
    the ones it refuses refused (ValueError), and `j2k_2048.jp2` under a
    .exr name against its decode's sha256, timed; slice 7e.7d: Part 2's
    files (CBD, MCT / MCC / MCO in the main and tile-part headers, tiles
    of fewer resolutions; the twins' files) among both .npz files' and
    the `j2k_bad_*` ones; slice 7e.7c: the HTJ2K files (`htj2k_*`, the
    twins' files) among both .npz files', the `htj2k_bad_*` ones PIL
    refuses refused (ValueError), and the committed 2048^2 HT file
    `htj2k_2048.jp2` (9/7, ICT, six resolutions, 64 x 64 code-blocks of
    cleanup, SigProp and MagRef) on both routes against each library's
    decode's sha256, timed; slice 7e.8a.1: every file of avif_decodes.npz
    (lossless AV1 in AVIF on PIL's route: every subsampling, tiles,
    palettes, every intra tool, alpha, other matrices and ranges; the
    twins' files) against its committed PIL decode, the ones PIL refuses
    refused (ValueError), the later sub-items' raising NotImplementedError
    naming them, and the committed 2048^2 lossless file `avif_2048.avif`
    (autotiled) against its decode's sha256, timed; slice 7e.8a.2a: every
    file of avifq_decodes.npz (lossy AV1 on PIL's route: qualities 0-99,
    speeds 5-10, every subsampling, odd sizes, tiles, 128x128
    superblocks, reduced_tx_set, sharpness, a lossy alpha item, limited
    range, each intra tool off, the 4:1 and 64-point transforms; the
    twins' files) against its committed PIL decode, the 7e.8a.2b files
    raising NotImplementedError naming it, and the committed 2048^2 lossy
    file `avif_lossy_2048.avif` (autotiled, PIL's defaults) against its
    decode's sha256, timed; slice 7e.8a.2c.1: every file of
    avifibc_decodes.npz (intra block copy at PIL's defaults for flat and
    screen-like images: qualities 0-99, speeds 0-7, lossless, every
    subsampling, odd sizes, tiles, 128x128 superblocks, reduced_tx_set, an
    alpha item, limited range, each intra tool off; the twins' files)
    against its committed PIL decode, and the committed 2048^2 file
    `avifibc_2048.avif` (autotiled, PIL's defaults) against its decode's
    sha256, timed; no image library imported."""
    import hashlib
    import tempfile
    from vision_tpu_torch.scene import imageio
    assets = os.path.join(ROOT, "tests", "assets_torch")
    built_dir = tempfile.mkdtemp()
    gen_pil = _load_by_path("vt_gen_torch_pil", "tools/gen_torch_pil.py")
    gen_cv = _load_by_path("vt_gen_torch_cvtiff", "tools/gen_torch_cvtiff.py")
    gen_assets = _load_by_path("vt_gen_torch_assets",
                               "tools/gen_torch_assets.py")
    gen_ojpeg = _load_by_path("vt_gen_torch_ojpeg", "tools/gen_torch_ojpeg.py")
    gen_sgilog = _load_by_path("vt_gen_torch_sgilog",
                               "tools/gen_torch_sgilog.py")
    with open(os.path.join(assets, "smooth_2048.jpg"), "rb") as f:
        cuts = gen_assets.smooth_cuts(f.read())
    t0 = time.perf_counter()
    for fn, make in (("bc7_2048.dds", gen_pil.bc7_timing),
                     ("sky_2048.exr", gen_cv.float_timing),
                     ("blp_2048.blp", gen_pil.blp_dxt_timing),
                     ("photocd.pcd", gen_pil.pcd_file),
                     ("lossless_2048.jpg", gen_assets.lossless_timing),
                     ("ojpeg_2048.tif", gen_ojpeg.ojpeg_timing),
                     ("luv_2048.exr", gen_sgilog.logluv_timing),
                     *((fn, lambda d=d: d) for fn, d in cuts.items())):
        with open(os.path.join(built_dir, fn), "wb") as f:
            f.write(make())
    emit(dict(phase="image_files_built", seconds=time.perf_counter() - t0,
              card=card))
    # timing files built from a seed (and the cuts of a committed one)
    built = {fn: built_dir for fn in ("bc7_2048.dds", "sky_2048.exr",
                                      "blp_2048.blp", "photocd.pcd",
                                      "lossless_2048.jpg", "ojpeg_2048.tif",
                                      "luv_2048.exr", *cuts)}
    for npz, kind in (("image_decodes.npz", "ldr"), ("exr_decodes.npz", "hdr"),
                      ("webp_decodes.npz", "ldr"),
                      ("exr_cv_decodes.npz", "hdr"), ("cv_decodes.npz", "hdr"),
                      ("pil_decodes.npz", "ldr"),
                      ("pil_rare_decodes.npz", "ldr"),
                      ("cvtiff_decodes.npz", "hdr"),
                      ("tiff_decodes.npz", None),
                      ("jpeg_7e5_decodes.npz", "ldr"),
                      ("ojpeg_decodes.npz", "ldr"),
                      ("sgilog_decodes.npz", "hdr"),
                      ("j2k_decodes.npz", "ldr")):
        dec = np.load(os.path.join(assets, npz))
        files = [k for k in dec.files if ":" not in k]
        must = {"image_decodes.npz": ("tiny.tif",),
                "webp_decodes.npz": ("projector.webp",),
                "exr_cv_decodes.npz": ("deep_composite.exr",),
                "cv_decodes.npz": ("cv_ycck.exr",),
                "pil_decodes.npz": ("checker_bc7.dds", "im_ycc.im",
                                    "psd_lab_raw.psd"),
                "pil_rare_decodes.npz": ("checker.blp", "bumps.gbr",
                                         "checker.flc", "projector.pxr",
                                         "blp1_jpeg_cmyk.blp",
                                         "fits_gz16.fits",
                                         "iptc_jpeg_rgb.iim"),
                "cvtiff_decodes.npz": ("sky_a_f32.exr",
                                       "projector_gif.hdr"),
                "tiff_decodes.npz": ("sky_a_big.exr", "projector_zstd.tif",
                                     "tf_g4.tif", "tf_zstd_pred2.tif",
                                     "tf_cv_lab.hdr"),
                "jpeg_7e5_decodes.npz": ("checker_smooth.jpg",
                                         "projector_lossless.jpg",
                                         "cut_arith_mid.jpg", "cut_440_dc.jpg",
                                         "ll_planes.jpg", "ll_cmyk.jpg"),
                "ojpeg_decodes.npz": ("checker_ojpeg.tif",
                                      "projector_ojpeg.tif",
                                      "oj_tb_strips.tif", "oj_tb_tiles.tif",
                                      "oj_planar_strips.tif", "oj_grey.tif",
                                      "oj_411.tif", "oj_tb_440.tif"),
                "sgilog_decodes.npz": ("sky_a_logluv.exr",
                                       "projector_luv24.hdr",
                                       "sl_luv32_strips.exr",
                                       "sl_luv32_runs.exr",
                                       "sl_luv32_tiles.exr",
                                       "sl_luv24_uv.exr",
                                       "sl_logl_strips.exr",
                                       "sl_logl_cut.exr"),
                "j2k_decodes.npz": ("checker_j2k.jp2", "projector_j2k.j2k",
                                    "j2k_sty_bypass.j2k",
                                    "j2k_sty_reset.j2k",
                                    "j2k_sty_termall.j2k",
                                    "j2k_sty_vsc.j2k", "j2k_sty_pterm.j2k",
                                    "j2k_sty_segsym.j2k", "j2k_icns.icns",
                                    "j2k_sycc.jp2", "j2k_p3.jp2",
                                    "checker_j2kp2.jp2",
                                    "j2k_p2_cbd12.j2k",
                                    "j2k_p2_mco_f64.jp2",
                                    "j2k_p2_tiles_mco.j2k",
                                    "j2k_p2_res_poc.j2k",
                                    "checker_htj2k.jp2", "htj2k_grey.j2k",
                                    "htj2k_irr_ict.jp2", "htj2k_prec16.jp2",
                                    "htj2k_layers2.j2k", "htj2k_vsc.j2k",
                                    "htj2k_cblk16x256.j2k",
                                    "htj2k_mel_unchecked.j2k")
                }.get(npz, ())
        check(set(must) <= set(files), f"{npz}'s files")
        for fn in files:
            t0 = time.perf_counter()
            got, got_kind = imageio.read_image(os.path.join(assets, fn))
            rec = _image_file_rec(fn, got, dec[fn], time.perf_counter() - t0,
                                  card, got_kind)
            emit(rec)
            want_kind = kind or ("hdr" if fn.endswith((".hdr", ".exr"))
                                 else "ldr")
            check(got_kind == want_kind and rec["bit_equal"]
                  and rec["max_abs_diff"] == 0, f"{fn} against its decode {rec}")
        # the timing files: a decode's sha256 and corner
        for fn in sorted(k[:-len(":corner")] for k in dec.files
                         if k.endswith(":corner")):
            t0 = time.perf_counter()
            got, got_kind = imageio.read_image(os.path.join(
                built.get(fn, assets), fn))
            seconds = time.perf_counter() - t0
            rec = _image_file_rec(fn, got[:128, :128], dec[fn + ":corner"],
                                  seconds, card, got_kind)
            rec.update(shape=list(got.shape), timing_file=True,
                       sha256_equal=hashlib.sha256(got.tobytes()).digest()
                       == dec[fn + ":sha256"].tobytes())
            emit(rec)
            check(rec["bit_equal"] and rec["sha256_equal"]
                  and rec["max_abs_diff"] == 0, f"{fn} {rec}")
    # slice 7e.5: block smoothing's share of a cut 2k file's decode
    for fn, data in cuts.items():
        scans = imageio._jpeg_scans(data)
        t0 = time.perf_counter()
        imageio._block_smoothing(*scans[:4], scans[-1])
        emit(dict(phase="jpeg_smoothing", file=fn, card=card,
                  smoothing_s=time.perf_counter() - t0,
                  coef_bits=scans[-1][0].tolist(),
                  last_good_imcu_row=scans[-1][2]))
        check(scans[-1] is not None, f"{fn} leaves no coefficient to smooth")
    got = imageio.read_image(os.path.join(assets, "yc.exr"))[0]
    check(np.array_equal(got.view(np.uint32), np.load(os.path.join(
        assets, "exr_cv_decodes.npz"))["yc.exr"].view(np.uint32)),
        "yc.exr against OpenCV 4.6.0's decode")
    with tempfile.TemporaryDirectory() as tmp:
        avif = os.path.join(tmp, "avif.hdr")
        with open(avif, "wb") as f:   # the ISO-BMFF box that names AVIF
            f.write(struct.pack(">I", 28) + b"ftypavif" + bytes(4)
                    + b"avifmif1miaf")
        refused = [(os.path.join(assets, fn), ValueError, "")
                   for fn in sorted(os.listdir(assets))
                   if fn.startswith("oj_bad_")]
        check(len(refused) >= 12, "the old-style JPEG files PIL refuses")
        sl_bad = [(os.path.join(assets, fn), ValueError, "")
                  for fn in sorted(os.listdir(assets))
                  if fn.startswith("sl_bad_")]
        check(len(sl_bad) >= 5, "the SGILog files the pip cv2 refuses")
        refused += sl_bad
        j2k_bad = [(os.path.join(assets, fn), ValueError, "")
                   for fn in sorted(os.listdir(assets))
                   if fn.startswith("j2k_bad_")]
        check(len(j2k_bad) >= 18, "the JPEG 2000 files PIL refuses")
        ht_bad = [(os.path.join(assets, fn), ValueError, "")
                  for fn in sorted(os.listdir(assets))
                  if fn.startswith("htj2k_bad_")]
        check(len(ht_bad) >= 13, "the HTJ2K files PIL refuses")
        refused += j2k_bad + ht_bad
        for path, err, what in (*refused,
                                (avif, NotImplementedError, "7e"),
                                (os.path.join(assets, "ll_arith.jpg"),
                                 ValueError, "arithmetic-coded lossless"),
                                (os.path.join(assets, "deep_scanline.exr"),
                                 ValueError, "deep"),
                                (os.path.join(assets, "deep_tiled.exr"),
                                 ValueError, "deep")):
            try:
                imageio.read_image(path)
                raised = None
            except err as e:
                raised = str(e)
            check(raised is not None and what in raised,
                  f"{os.path.basename(path)}: {raised!r}")
    # slice 7e.7b: JPEG 2000 under a .exr name, OpenCV's route
    dec = np.load(os.path.join(assets, "j2k_cv_decodes.npz"))
    refused_cv = set(dec[":refused"].tolist())
    files = sorted([k for k in dec.files if ":" not in k] + list(refused_cv))
    check({"sky_a_j2kcv.exr", "projector_j2kcv.hdr", "j2kcv_pal_cdef.jp2",
           "j2kcv_sycca16.jp2", "j2kcv_grey16.j2k", "j2kcv_poc_stop_c1.j2k",
           "j2k_poc_reduced.j2k", "j2k_p3.jp2", "projector_j2kp2cv.exr",
           "j2k_p2_cbd12.j2k", "j2k_p2_tiles_mco.j2k",
           "j2k_p2_res_4123.j2k", "projector_htj2kcv.exr",
           "checker_htj2k.jp2", "htj2k_layers3.j2k", "htj2k_sp_only.j2k",
           "htj2k_irr.j2k"} <= set(files)
          and {"j2k_signed_l.j2k", "j2kcv_bad_tnsot1.j2k", "j2k_p2_cbd7.j2k",
               "j2k_bad_p2_mct_size.j2k", "htj2k_bad_mel.j2k",
               "htj2k_bad_uq.j2k"} <= refused_cv,
          "j2k_cv_decodes.npz's files")
    exr = os.path.join(built_dir, "j2k.exr")
    timing = ("j2k_2048.jp2", "htj2k_2048.jp2")
    for fn in [*files, *timing]:
        with open(os.path.join(assets, fn), "rb") as f:
            data = f.read()
        with open(exr, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        try:
            got, got_kind = imageio.read_image(exr)
        except ValueError as e:
            got, got_kind = None, str(e)
        seconds = time.perf_counter() - t0
        if fn in refused_cv:
            emit(dict(phase="image_file", file=fn, name="j2k.exr",
                      card=card, seconds=seconds, refused=got is None))
            check(got is None, f"{fn} under a .exr name: {got_kind!r}")
            continue
        check(got is not None and got_kind == "hdr", f"{fn}: {got_kind!r}")
        if fn in timing:
            rec = _image_file_rec(fn, got[:128, :128], dec[fn + ":corner"],
                                  seconds, card, got_kind)
            rec.update(shape=list(got.shape), timing_file=True,
                       sha256_equal=hashlib.sha256(got.tobytes()).digest()
                       == dec[fn + ":sha256"].tobytes())
        else:
            rec = _image_file_rec(fn, got, dec[fn], seconds, card, got_kind)
        rec.update(name="j2k.exr")
        emit(rec)
        check(rec["bit_equal"] and rec["max_abs_diff"] == 0
              and rec.get("sha256_equal", True), f"{fn} {rec}")
    os.remove(exr)
    for fn in built:
        os.remove(os.path.join(built_dir, fn))
    os.rmdir(built_dir)
    # slice 7e.8a.1: lossless AVIF on PIL's route
    files, refused_avif = _avif_files(assets, "avif_decodes.npz",
                                      "avif_2048.avif", card)
    check({"avif_noise_420.avif", "avif_pal8_420_s0.avif",
           "avif_tiles_11.avif", "avif_alpha_444.avif",
           "avif_nclx_mc9_cp9_444.avif", "avif_nclx_identity_444.avif",
           "checker_avif.avif", "projector_avif.avif"} <= set(files)
          and {"avif_bad_noispe.avif", "avif_bad_cut_item.avif",
               "avif_bad_matrix10.avif"} <= refused_avif
          and {"avif_later_intrabc.avif", "avif_later_lossy.avif"}
          <= set(files), "avif_decodes.npz's files")
    # slice 7e.8a.2a: lossy AVIF on PIL's route
    files, _ = _avif_files(assets, "avifq_decodes.npz",
                           "avif_lossy_2048.avif", card)
    check({"avifq_q0.avif", "avifq_q99.avif", "avifq_s10.avif",
           "avifq_sb128.avif", "avifq_alpha.avif", "avifq_bars_420_s0.avif",
           "texture_avifq.avif", "projector_avifq.avif",
           "avif_later_cdef.avif"} <= set(files), "avifq_decodes.npz's files")
    # slice 7e.8a.2c.1: intra block copy on PIL's route
    files, _ = _avif_files(assets, "avifibc_decodes.npz",
                           "avifibc_2048.avif", card)
    check({"avifibc_page.avif", "avifibc_q0.avif", "avifibc_s0.avif",
           "avifibc_lossless_444.avif", "avifibc_400.avif",
           "avifibc_sb128.avif", "avifibc_rgba.avif", "avifibc_tiles_11.avif",
           "avifibc_vartx_s0.avif", "checker_avifibc.avif",
           "projector_avifibc.avif"} <= set(files),
          "avifibc_decodes.npz's files")
    check(not {"PIL", "cv2", "OpenEXR", "Imath"} & set(sys.modules),
          "an image library was imported")


def _avif_files(assets, npz, timing, card):
    """Every AVIF file of `npz` (PIL's decodes, the names it refuses under
    ":refused") and its 2048^2 timing file, read on the card's host and
    held to PIL's outcome, timed: bit for bit, refused (ValueError), or
    NotImplementedError naming the sub-item of `AVIF_LATER`; the timing
    file by its decode's sha256. Returns (the files, the refused)."""
    import hashlib
    from vision_tpu_torch.scene import imageio
    dec = np.load(os.path.join(assets, npz))
    refused = set(dec[":refused"].tolist()) if ":refused" in dec else set()
    files = sorted([k for k in dec.files if ":" not in k] + list(refused))
    for fn in [*files, timing]:
        t0 = time.perf_counter()
        try:
            got, got_kind = imageio.read_image(os.path.join(assets, fn))
        except (ValueError, NotImplementedError) as e:
            got, got_kind = None, f"{type(e).__name__}: {e}"
        seconds = time.perf_counter() - t0
        if fn in refused or fn in AVIF_LATER:
            want = "ValueError" if fn in refused else \
                "NotImplementedError: AVIF"
            emit(dict(phase="image_file", file=fn, card=card,
                      seconds=seconds, raised=got_kind))
            check(got is None and got_kind.startswith(want) and
                  AVIF_LATER.get(fn, "") in got_kind, f"{fn}: {got_kind!r}")
            continue
        check(got is not None and got_kind == "ldr", f"{fn}: {got_kind!r}")
        if fn == timing:
            rec = _image_file_rec(fn, got[:128, :128], dec[fn + ":corner"],
                                  seconds, card, got_kind)
            rec.update(shape=list(got.shape), timing_file=True,
                       sha256_equal=hashlib.sha256(got.tobytes()).digest()
                       == dec[fn + ":sha256"].tobytes())
        else:
            rec = _image_file_rec(fn, got, dec[fn], seconds, card, got_kind)
        emit(rec)
        check(rec["bit_equal"] and rec["max_abs_diff"] == 0
              and rec.get("sha256_equal", True), f"{fn} {rec}")
    return files, refused


# the AVIF files PIL decodes and the port sends to a later sub-item
AVIF_LATER = {"avif_later_10bit.avif": "7e.8a.3",
              "avif_later_prem.avif": "7e.8a.3",
              "avif_later_scaled.avif": "7e.8a.3",
              "avif_later_cdef.avif": "7e.8a.2b",
              "avif_later_qm.avif": "7e.8a.2b",
              "avif_later_lr.avif": "7e.8a.2b"}


# the twin scenes: (name, maker, kernel, the render it must equal)
IMAGE_TWINS = (
    ("cbox_tex_files", "cbox_tex_files", "dense_isect", "cbox_tex"),
    ("env_sphere_files", "env_sphere_files", "packet_isect", "env_sphere"),
    ("cbox_tex_webp_ref", "cbox_tex_webp_ref", "dense_isect", None),
    ("cbox_tex_webp", "cbox_tex_webp", "dense_isect", "cbox_tex_webp_ref"),
    ("env_sphere_webp", "env_sphere_webp", "packet_isect", "env_sphere"),
    ("cbox_sky_yc_ref", "cbox_sky_yc_ref", "dense_isect", None),
    ("cbox_sky_yc", "cbox_sky_yc", "dense_isect", "cbox_sky_yc_ref"),
    ("env_sphere_cv", "env_sphere_cv", "packet_isect", "env_sphere"),
    ("cbox_tex_pil", "cbox_tex_pil", "dense_isect", "cbox_tex"),
    ("env_sphere_pil", "env_sphere_pil", "packet_isect", "env_sphere"),
    ("cbox_tex_dds_ref", "cbox_tex_dds_ref", "dense_isect", None),
    ("cbox_tex_dds", "cbox_tex_dds", "dense_isect", "cbox_tex_dds_ref"),
    ("cbox_sky_cvtiff_ref", "cbox_sky_cvtiff_ref", "dense_isect", None),
    ("cbox_sky_cvtiff", "cbox_sky_cvtiff", "dense_isect",
     "cbox_sky_cvtiff_ref"),
    ("env_sphere_cvgif_ref", "env_sphere_cvgif_ref", "packet_isect", None),
    ("env_sphere_cvgif", "env_sphere_cvgif", "packet_isect",
     "env_sphere_cvgif_ref"),
    ("cbox_sky_bigtiff", "cbox_sky_bigtiff", "dense_isect",
     "cbox_sky_cvtiff_ref"),
    ("env_sphere_zstd", "env_sphere_zstd", "packet_isect", "env_sphere"),
    ("cbox_tex_rare", "cbox_tex_rare", "dense_isect", "cbox_tex"),
    ("env_sphere_rare", "env_sphere_rare", "packet_isect", "env_sphere"),
    ("cbox_tex_smooth_ref", "cbox_tex_smooth_ref", "dense_isect", None),
    ("cbox_tex_smooth", "cbox_tex_smooth", "dense_isect",
     "cbox_tex_smooth_ref"),
    ("env_sphere_lossless_ref", "env_sphere_lossless_ref", "packet_isect",
     None),
    ("env_sphere_lossless", "env_sphere_lossless", "packet_isect",
     "env_sphere_lossless_ref"),
    ("cbox_tex_ojpeg_ref", "cbox_tex_ojpeg_ref", "dense_isect", None),
    ("cbox_tex_ojpeg", "cbox_tex_ojpeg", "dense_isect", "cbox_tex_ojpeg_ref"),
    ("env_sphere_ojpeg_ref", "env_sphere_ojpeg_ref", "packet_isect", None),
    ("env_sphere_ojpeg", "env_sphere_ojpeg", "packet_isect",
     "env_sphere_ojpeg_ref"),
    ("cbox_sky_logluv_ref", "cbox_sky_logluv_ref", "dense_isect", None),
    ("cbox_sky_logluv", "cbox_sky_logluv", "dense_isect",
     "cbox_sky_logluv_ref"),
    ("env_sphere_luv24_ref", "env_sphere_luv24_ref", "packet_isect", None),
    ("env_sphere_luv24", "env_sphere_luv24", "packet_isect",
     "env_sphere_luv24_ref"),
    ("cbox_tex_j2k_ref", "cbox_tex_j2k_ref", "dense_isect", None),
    ("cbox_tex_j2k", "cbox_tex_j2k", "dense_isect", "cbox_tex_j2k_ref"),
    ("env_sphere_j2k_ref", "env_sphere_j2k_ref", "packet_isect", None),
    ("env_sphere_j2k", "env_sphere_j2k", "packet_isect",
     "env_sphere_j2k_ref"),
    ("cbox_sky_j2kcv_ref", "cbox_sky_j2kcv_ref", "dense_isect", None),
    ("cbox_sky_j2kcv", "cbox_sky_j2kcv", "dense_isect", "cbox_sky_j2kcv_ref"),
    ("env_sphere_j2kcv_ref", "env_sphere_j2kcv_ref", "packet_isect", None),
    ("env_sphere_j2kcv", "env_sphere_j2kcv", "packet_isect",
     "env_sphere_j2kcv_ref"),
    ("cbox_tex_j2kp2_ref", "cbox_tex_j2kp2_ref", "dense_isect", None),
    ("cbox_tex_j2kp2", "cbox_tex_j2kp2", "dense_isect", "cbox_tex_j2kp2_ref"),
    ("env_sphere_j2kp2cv_ref", "env_sphere_j2kp2cv_ref", "packet_isect",
     None),
    ("env_sphere_j2kp2cv", "env_sphere_j2kp2cv", "packet_isect",
     "env_sphere_j2kp2cv_ref"),
    ("cbox_tex_htj2k", "cbox_tex_htj2k", "dense_isect", "cbox_tex"),
    ("env_sphere_htj2kcv_ref", "env_sphere_htj2kcv_ref", "packet_isect",
     None),
    ("env_sphere_htj2kcv", "env_sphere_htj2kcv", "packet_isect",
     "env_sphere_htj2kcv_ref"),
    ("cbox_tex_avif_ref", "cbox_tex_avif_ref", "dense_isect", None),
    ("cbox_tex_avif", "cbox_tex_avif", "dense_isect", "cbox_tex_avif_ref"),
    ("env_sphere_avif_ref", "env_sphere_avif_ref", "packet_isect", None),
    ("env_sphere_avif", "env_sphere_avif", "packet_isect",
     "env_sphere_avif_ref"),
    ("cbox_tex_avifq_ref", "cbox_tex_avifq_ref", "dense_isect", None),
    ("cbox_tex_avifq", "cbox_tex_avifq", "dense_isect", "cbox_tex_avifq_ref"),
    ("env_sphere_avifq_ref", "env_sphere_avifq_ref", "packet_isect", None),
    ("env_sphere_avifq", "env_sphere_avifq", "packet_isect",
     "env_sphere_avifq_ref"),
    ("cbox_tex_avifibc_ref", "cbox_tex_avifibc_ref", "dense_isect", None),
    ("cbox_tex_avifibc", "cbox_tex_avifibc", "dense_isect",
     "cbox_tex_avifibc_ref"),
    ("env_sphere_avifibc_ref", "env_sphere_avifibc_ref", "packet_isect",
     None),
    ("env_sphere_avifibc", "env_sphere_avifibc", "packet_isect",
     "env_sphere_avifibc_ref"))


def phase_image_twins(vt, modules, scenes, originals, card, launches):
    """Slices 7d, 7e.1, 7e.2, 7e.3a, 7e.6a, 7e.3b, 7e.4, 7e.6b, 7e.5,
    7e.4b (both routes), 7e.7a, 7e.7b, 7e.7d, 7e.7c, 7e.8a.1 and 7e.8a.2a
    through the kernels, at
    512^2 and the seeds of
    `phase_images`: `env_sphere_files` (its skies from OpenEXR files, PIZ
    and tiled RLE; its checker from an LZW TIFF; its projector image from a
    GIF) and `env_sphere_webp` (checker and projector from lossless WebP
    files) through K2, bit for bit with `env_sphere`'s render of this run;
    `cbox_tex_files` (TIFF and GIF) through K1, bit for bit with
    `cbox_tex`; `cbox_tex_webp` (a lossy WebP checker, a lossless WebP
    normal map) through K1, bit for bit with `cbox_tex_webp_ref` (the
    checker read from PIL's decode of the lossy file, a PNG); slices 7e.2
    and 7e.3a: `cbox_sky_yc` (a luminance-chroma OpenEXR sky) through K1,
    bit for bit with `cbox_sky_yc_ref` (OpenCV 4.6.0's decode of that sky
    in a plain FLOAT file), and `env_sphere_cv` (its skies from a PFM named
    .hdr and a deep OpenEXR file with Z and A) through K2, bit for bit with
    `env_sphere`; slice 7e.6a: `cbox_tex_pil` (a QOI checker, a PPM normal
    map) through K1, bit for bit with `cbox_tex`, `env_sphere_pil` (a
    run-length SGI checker, an icon projector holding a 32-bit BMP)
    through K2, bit for bit with `env_sphere`, and `cbox_tex_dds` (a BC7
    checker) through K1, bit for bit with `cbox_tex_dds_ref` (PIL's decode
    of that checker in a PNG); slice 7e.3b: `cbox_sky_cvtiff` (sky_a as a
    float32 LZW TIFF named .exr) through K1, bit for bit with
    `cbox_sky_cvtiff_ref` (the pip cv2's decode in a FLOAT OpenEXR file),
    and `env_sphere_cvgif` (its projector image a GIF named .hdr) through
    K2, bit for bit with `env_sphere_cvgif_ref` (the pip cv2's decode in a
    PFM named .hdr); slice 7e.4: `cbox_sky_bigtiff` (sky_a as a float32
    BigTIFF, Deflate with the floating-point predictor, named .exr)
    through K1, bit for bit with `cbox_sky_cvtiff_ref`, and
    `env_sphere_zstd` (its projector image an RGB ZSTD TIFF) through K2,
    bit for bit with `env_sphere`; slice 7e.6b: `cbox_tex_rare` (a BLP2
    palette checker, a GIMP brush normal map) through K1, bit for bit
    with `cbox_tex`, and `env_sphere_rare` (an FLC checker, a PIXAR
    projector image) through K2, bit for bit with `env_sphere`; slice
    7e.5: `cbox_tex_smooth` (its checker a progressive JPEG cut inside a
    scan, through libjpeg's block smoothing) through K1, bit for bit with
    `cbox_tex_smooth_ref` (PIL's decode of that JPEG in a PNG), and
    `env_sphere_lossless` (its projector image a 4:2:0 lossless JPEG)
    through K2, bit for bit with `env_sphere_lossless_ref` (PIL's decode
    in a PNG); slice 7e.4b: `cbox_tex_ojpeg` (its checker an interchange
    old-style JPEG TIFF) through K1, bit for bit with `cbox_tex_ojpeg_ref`
    (PIL's decode of that file in a PNG), and `env_sphere_ojpeg` (its
    projector image a tables-only old-style JPEG TIFF of four strips, a
    restart interval each) through K2, bit for bit with
    `env_sphere_ojpeg_ref`; slice 7e.4b on OpenCV's route:
    `cbox_sky_logluv` (sky_a as a LogLuv32 TIFF named .exr) through K1,
    bit for bit with `cbox_sky_logluv_ref` (the pip cv2's decode in a
    FLOAT OpenEXR file), and `env_sphere_luv24` (its projector image a
    LogLuv24 TIFF named .hdr) through K2, bit for bit with
    `env_sphere_luv24_ref` (the pip cv2's decode in a PFM); slice 7e.7a:
    `cbox_tex_j2k` (its checker a lossy JP2 file: 9/7, ICT, two quality
    layers) through K1, bit for bit with `cbox_tex_j2k_ref` (PIL's decode
    of that file in a PNG), and `env_sphere_j2k` (its projector image a
    reversible J2K codestream: 5/3, RCT, four tiles with a tile offset,
    PCRL, precincts) through K2, bit for bit with `env_sphere_j2k_ref`;
    slice 7e.7b: `cbox_sky_j2kcv` (sky_a times 1600 as a lossless 5/3
    16-bit JP2 named .exr) through K1, bit for bit with
    `cbox_sky_j2kcv_ref` (the pip cv2's decode in a FLOAT OpenEXR file),
    and `env_sphere_j2kcv` (its projector image an 8-bit 9/7 JP2 named
    .hdr) through K2, bit for bit with `env_sphere_j2kcv_ref` (the pip
    cv2's decode in a PFM); slice 7e.7d: `cbox_tex_j2kp2` (its checker a
    JP2 whose CBD gives 9-bit samples and whose main header's MCO sets
    offsets) through K1, bit for bit with `cbox_tex_j2kp2_ref` (PIL's
    decode in a PNG), and `env_sphere_j2kp2cv` (its projector image four
    tiles with different MCOs in their tile-part headers, named .exr)
    through K2, bit for bit with `env_sphere_j2kp2cv_ref` (the pip cv2's
    decode in a PFM); slice 7e.7c: `cbox_tex_htj2k` (its checker a
    reversible HTJ2K JP2 on PIL's route, lossless) through K1, bit for bit
    with `cbox_tex`, and `env_sphere_htj2kcv` (its projector image a 9/7
    HTJ2K codestream named .exr, SigProp and MagRef in a second layer)
    through K2, bit for bit with `env_sphere_htj2kcv_ref` (the pip cv2's
    decode in a PFM); slice 7e.8a.1: `cbox_tex_avif` (its checker a
    lossless 4:2:0 AVIF file) through K1, bit for bit with
    `cbox_tex_avif_ref` (PIL's decode in a PNG), and `env_sphere_avif`
    (its projector image a lossless AVIF file with an alpha item) through
    K2, bit for bit with `env_sphere_avif_ref`; slice 7e.8a.2a:
    `cbox_tex_avifq` (a natural texture in a lossy AVIF file at PIL's
    defaults) through K1, bit for bit with `cbox_tex_avifq_ref` (PIL's
    decode in a PNG), and `env_sphere_avifq` (its projector image a lossy
    AVIF file with a lossy alpha item) through K2, bit for bit with
    `env_sphere_avifq_ref`; slice 7e.8a.2c.1: `cbox_tex_avifibc` (the
    checker's colours at 256^2 in an AVIF file at PIL's defaults whose
    frame copies blocks of itself) through K1, bit for bit with
    `cbox_tex_avifibc_ref` (PIL's decode in a PNG), and
    `env_sphere_avifibc` (its projector image a screen-like AVIF file with
    intra block copy and an alpha item) through K2, bit for bit with
    `env_sphere_avifibc_ref`. A twin has its reference's
    launch counts too, the
    reference rendered here or in an earlier phase (`launches`). Returns
    each render's launch counts."""
    per_render = {}
    renders = dict(originals)
    for name, maker, kernel, ref in IMAGE_TWINS:
        t0 = time.perf_counter()
        sc = vt.load_scene(getattr(scenes, maker)(RES), device=DEV)
        load_s = time.perf_counter() - t0
        img, rec = render(vt, modules, sc, name)
        renders[name] = img
        rec.update(load_s=load_s, card=card)
        if ref is not None:
            rec.update(equal_to=ref,
                       bit_equal_to_original=bool(np.array_equal(
                           img, renders[ref])),
                       max_abs_diff_to_original=float(
                           np.abs(img - renders[ref]).max()))
        if ref in per_render or ref in launches:
            rec.update(launches_equal_to_original=rec["launches"]
                       == per_render.get(ref, launches.get(ref)))
        emit(rec)
        check(ref is None or rec["bit_equal_to_original"],
              f"{name} against {ref}")
        check(rec.get("launches_equal_to_original", True),
              f"{name}'s launches against {ref}'s")
        check(all(rec["launches"][f"{kernel}.{k}"] > 0
                  for k in ("closest", "anyhit")), f"{name} {rec['launches']}")
        per_render[name] = rec["launches"]
    return per_render


BENCH_TIMEOUT = 900  # seconds for `python -m vision_tpu_torch.bench`
BENCH_METRIC = ("cbox_512_d8_pt_throughput", "Mrays/s")  # bench.py's
# the rungs that read a reference scene, each on a generated stand-in:
# (rung, stand-in, the scene's maker and arguments, the kernel it must launch)
BENCH_STANDINS = (
    ("bench_staircase", "cbox_sphere", "cbox_sphere", "packet_isect.closest"),
    ("bench_staircase_sol", "cbox_sphere", "cbox_sphere",
     "packet_isect.closest"),
    ("bench_staircase_grad", "cbox_sphere", "cbox_sphere",
     "packet_isect.closest"),
    ("bench_kitchen", "cbox_spheres_instanced flat twin (1,040,420 tris)",
     "cbox_spheres_instanced", "packet_isect.closest"),
    ("bench_prism", "cbox_glass_hero", "cbox_glass_hero",
     "dense_isect.closest"),
    ("bench_classroom_rt", "cbox", None, "dense_isect.closest"))


def phase_bench(vt, modules, scenes, cbox, card):
    """Slice 10: `python -m vision_tpu_torch.bench` as a user runs it, in a
    subprocess; its one line printed again here and held to bench.py's
    schema (no rung may report an error). Then, in this process and under
    the launch counts, one `_wave_metric` pass of the cbox rung (K1), the
    grad rung's `_grad_metric` (one untimed and one timed step, K1 with its
    gradient), and
    each rung that reads a reference scene on a generated stand-in at the
    rung's own sizes. Returns the launch counts of each."""
    import math
    import tempfile
    from vision_tpu_torch import bench
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vision_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for ln in lines:
        print(ln, flush=True)
    check(proc.returncode == 0,
          f"bench exited {proc.returncode}: {proc.stderr[-4000:]}")
    check(len(lines) == 1, f"bench printed {len(lines)} lines")
    out = json.loads(lines[0])
    emit(dict(phase="bench", seconds=wall, card=card,
              stderr_tail=proc.stderr[-600:]))
    check((out.get("metric"), out.get("unit")) == BENCH_METRIC,
          f"bench metric {out.get('metric')} {out.get('unit')}")
    check(isinstance(out.get("value"), float) and math.isfinite(out["value"])
          and out["value"] > 0, f"bench value {out.get('value')}")
    extra = out.get("extra", {})
    check(isinstance(extra.get("cbox_256_d4_grad_mrays"), float),
          f"bench grad rung {extra}")
    check(not any(isinstance(v, str) and v.startswith("error:")
                  for v in extra.values()), f"bench rung errors {extra}")

    per_run = {}
    zero_counts(modules)
    stats = {}
    mrays = bench._wave_metric(cbox, spp=16, depth=bench.DEPTH, warmup=0,
                               iters=1, stats=stats)
    launches = read_counts(modules)
    rec = dict(phase="bench_pass", rung="bench_cbox", res=RES, spp=16,
               depth=bench.DEPTH, mrays=mrays, **stats, launches=launches)
    emit(rec)
    check(launches["dense_isect.closest"] > 0
          and launches["dense_isect.anyhit"] > 0, f"bench cbox pass {rec}")
    per_run["bench_cbox_pass"] = launches

    zero_counts(modules)
    t0 = time.perf_counter()
    mrays = bench._grad_metric(bench._cbox(bench.GRAD_RES, DEV), depth=4,
                               iters=1)
    wall = time.perf_counter() - t0
    launches = read_counts(modules)
    rec = dict(phase="bench_pass", rung="bench_grad", res=bench.GRAD_RES,
               depth=4, steps=2, mrays=mrays, wall_s=wall, launches=launches)
    emit(rec)
    check(math.isfinite(mrays) and mrays > 0
          and launches["dense_isect.closest"] > 0
          and launches["dense_isect.anyhit"] > 0, f"bench grad pass {rec}")
    per_run["bench_grad_pass"] = launches

    with tempfile.TemporaryDirectory() as d:
        for rung, stand_in, maker, kernel in BENCH_STANDINS:
            desc = getattr(scenes, maker)(RES) if maker else cbox.raw
            path = os.path.join(d, f"{maker or 'cbox'}.json")
            with open(path, "w") as f:
                json.dump(desc, f)
            if maker == "cbox_spheres_instanced":
                os.environ["VT_INSTANCING"] = "0"
            zero_counts(modules)
            t0 = time.perf_counter()
            try:
                v = getattr(bench, rung)(path, device=DEV)
            finally:
                os.environ.pop("VT_INSTANCING", None)
            wall = time.perf_counter() - t0
            launches = read_counts(modules)
            rec = dict(phase="bench_standin", rung=rung, stand_in=stand_in,
                       value=v, unit="ms" if rung.endswith("_rt") else
                       "Mrays/s", wall_s=wall, launches=launches)
            emit(rec)
            check(isinstance(v, float) and math.isfinite(v) and v > 0
                  and launches[kernel] > 0, f"bench stand-in {rec}")
            per_run[f"{rung}_standin"] = launches
    return per_run


def postprocess_u8(vt, scene, hdr):
    """The 8-bit image `film.to_png` writes of a render."""
    img = vt.postprocess(scene, hdr).cpu().numpy()
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8).astype(np.int32)


def read_png(path):
    """The pixels [H, W, 3] of an 8-bit RGB PNG as `film.to_png` writes it
    (one IDAT, filter byte 0 on every row), each chunk's CRC checked."""
    import struct
    import zlib
    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(crc == zlib.crc32(kind + body) & 0xFFFFFFFF, f"PNG CRC {kind}")
        chunks[kind] = body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    check((depth, ctype) == (8, 2) and b"IEND" in chunks, "PNG header")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), "PNG row filters")
    return raw[:, 1:].reshape(h, w, 3)


def block_err(a, b, B=8):
    H, W, _ = a.shape
    ab = a.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    bb = b.reshape(H // B, B, W // B, B, 3).mean((1, 3))
    return float(np.abs(ab - bb).sum() / bb.sum()), \
        float((ab - bb).mean() / bb.mean())


def vs_golden(img, rel):
    """Box-downsample a render to the golden's 128^2 and hold it against
    the golden's 8x8 blocks."""
    gold = np.load(os.path.join(ROOT, rel))["img"]
    k = RES // 128
    return block_err(img.reshape(128, k, 128, k, 3).mean((1, 3)), gold)


def build_all(di, pi, native):
    """One nvcc per CUDA source and the g++ build of the SAH builder, all
    started together."""
    jobs = {"dense_isect": di.build, "packet_isect": pi.build,
            "native": native.build}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(v) for k, v in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
    rec = dict(phase="build", seconds={k: v[1] for k, v in out.items()},
               library={k: os.path.relpath(v[0], ROOT) for k, v in out.items()})
    for k in out:
        if k != "native":
            rec[f"ptxas_{k}"] = [ln.strip() for ln in out[k][2].splitlines()
                                 if "registers" in ln or "Compiling entry" in ln
                                 or "stack frame" in ln]
    return rec


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this script runs only on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import vision_tpu_torch as vt
    from vision_tpu_torch import native
    from vision_tpu_torch.accel import dense_isect as di
    from vision_tpu_torch.accel import packet_bvh as pbvh_mod
    from vision_tpu_torch.accel import packet_isect as pi
    from vision_tpu_torch.integrator import pt as vt_pt
    scenes = _load_by_path("vt_torch_scenes", "tests/torch_scenes.py")
    wm = _load_by_path("vt_torch_walk_model", "tests/torch_walk_model.py")

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit(dict(phase="device", name=name, nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              capability=list(torch.cuda.get_device_capability(0))))
    emit(build_all(di, pi, native))

    # ---- K1 vs its plain version: the cornell box's wavefronts, the
    # dense path's upper bound, the edge shapes ----
    scene = cbox_scene(vt, RES)
    k1 = phase_k1(di, vt_pt, scene)

    # ---- the cornell box, 512^2, depth 8, 16 spp, through K1 ----
    img, rec = render(vt, [di, pi], scene, "cbox")
    cbox_img = img
    rec["golden_werr"], rec["golden_bias"] = vs_golden(
        img, "tests/goldens/cbox_hdr.npz")
    emit(rec)
    check(all(rec["launches"][f"dense_isect.{k}"] > 0
              for k in ("closest", "anyhit")), f"K1 launches {rec['launches']}")
    check(rec["golden_werr"] < GOLD_WERR, f"cbox vs golden {rec['golden_werr']}")
    check(abs(rec["golden_bias"]) < GOLD_BIAS, f"cbox bias {rec['golden_bias']}")
    per_render = {"cbox": rec["launches"]}

    # ---- K2: cbox_sphere, 261,156 triangles ----
    t0 = time.perf_counter()
    sphere = vt.load_scene(scenes.cbox_sphere(RES), device=DEV)
    emit(dict(phase="load", scene="cbox_sphere",
              seconds=time.perf_counter() - t0,
              tris=sphere.data.tri_geom.shape[0]))
    check(sphere.data.pbvh is not None and sphere.data.tri_geom.shape[0] == 261156,
          "cbox_sphere takes the BVH")
    k2 = phase_k2(pi, pbvh_mod, di, vt_pt, wm, sphere)
    img, rec = render(vt, [di, pi], sphere, "cbox_sphere")
    sphere_img = img
    rec["golden_werr"], rec["golden_bias"] = vs_golden(
        img, "tests/goldens/cbox_sphere_hdr.npz")
    emit(rec)
    check(rec["launches"]["packet_isect.closest"] > 0
          and rec["launches"]["packet_isect.anyhit"] > 0,
          f"K2 launches {rec['launches']}")
    check(rec["launches"]["dense_isect.closest"] == 0
          and rec["launches"]["dense_isect.anyhit"] == 0,
          f"K1 launched on the BVH path {rec['launches']}")
    check(rec["golden_werr"] < GOLD_WERR,
          f"cbox_sphere vs golden {rec['golden_werr']}")
    check(abs(rec["golden_bias"]) < GOLD_BIAS,
          f"cbox_sphere bias {rec['golden_bias']}")
    per_render["cbox_sphere"] = rec["launches"]

    # ---- K3: cbox_spheres_instanced and its flat twin ----
    t0 = time.perf_counter()
    inst = vt.load_scene(scenes.cbox_spheres_instanced(RES), device=DEV)
    t1 = time.perf_counter()
    os.environ["VT_INSTANCING"] = "0"
    try:
        flat = vt.load_scene(scenes.cbox_spheres_instanced(RES), device=DEV)
    finally:
        os.environ.pop("VT_INSTANCING")
    emit(dict(phase="load", scene="cbox_spheres_instanced",
              seconds=t1 - t0, flat_twin_seconds=time.perf_counter() - t1,
              instances=inst.data.ipbvh.n_inst,
              flat_twin_tris=flat.data.tri_geom.shape[0]))
    check(inst.data.ipbvh is not None and flat.data.pbvh is not None,
          "the instanced scene takes K3, its flat twin K2")
    k3 = phase_k3(pi, pbvh_mod, vt_pt, wm, inst, flat)
    img_i, rec = render(vt, [di, pi], inst, "cbox_spheres_instanced")
    check(rec["launches"]["packet_isect.closest_inst"] > 0
          and rec["launches"]["packet_isect.anyhit_inst"] > 0,
          f"K3 launches {rec['launches']}")
    per_render["cbox_spheres_instanced"] = rec["launches"]
    img_f, rec_f = render(vt, [di, pi], flat, "cbox_spheres_instanced_flat_twin")
    check(rec_f["launches"]["packet_isect.closest"] > 0,
          f"flat twin launches {rec_f['launches']}")
    rec["twin_werr"], rec["twin_bias"] = block_err(img_i, img_f)
    emit(rec)
    emit(rec_f)
    check(rec["twin_werr"] <= TWIN_WERR,
          f"instanced vs flat twin {rec['twin_werr']}")
    per_render["cbox_spheres_instanced_flat_twin"] = rec_f["launches"]

    # ---- slice 1b: every material and light type ----
    per_render.update(phase_slice1b(vt, [di, pi], scenes))

    # ---- slice 4: hero spectrum and dispersion, media and subsurface ----
    per_render.update(phase_slice4(vt, [di, pi], scenes))

    # ---- slices 4c, 4d, 7a: images, node graphs, IES, adaptive, light
    # field, EXR ----
    originals = {}
    per_render.update(phase_images(vt, [di, pi], scenes, originals))

    # ---- slice 5: gradients ----
    phase_grad(vt, [di, pi], scenes, smi)

    # ---- slice 6: the real-time loop ----
    per_render.update(phase_realtime(vt, [di, pi], scenes, sphere, smi))

    # ---- slices 7, 7b, 8a: mesh files, glTF, JPEG, the CLI and the SDK ----
    per_render.update(phase_meshes(vt, [di, pi], scenes, sphere_img, inst,
                                   img_i, smi))

    # ---- slices 8b and 9: the bake, distribution, the utilities ----
    per_render.update(phase_bake(vt, [di, pi], scenes, scene, cbox_img, smi))
    per_render.update(phase_dist(vt, [di, pi], vt_pt, scene, smi))
    per_render.update(phase_utils(vt, [di, pi], scene, sphere, cbox_img, smi))

    # ---- slices 7c, 7d and 7e: the image files PIL
    # and OpenCV (libOpenEXR, libwebp and its own readers) decode for the
    # JAX package, and the scenes that read them ----
    phase_image_files(smi)
    per_render.update(phase_image_twins(vt, [di, pi], scenes, originals, smi,
                                        dict(per_render)))

    # ---- slice 10: the bench ladder ----
    per_render.update(phase_bench(vt, [di, pi], scenes, scene, smi))

    # ---- the kernel table ----
    def worst(recs, keys):
        return max(float(r[k]) for r in recs for k in keys)

    closest_keys = ("closest_t_abs_err", "closest_uv_abs_err")
    errs = {"dense_isect.closest": worst(k1, closest_keys),
            "dense_isect.anyhit": worst(k1, ("anyhit_max_abs_err",)),
            "packet_isect.closest": worst(k2, closest_keys),
            "packet_isect.anyhit": worst(k2, ("anyhit_max_abs_err",)),
            "packet_isect.closest_inst": worst(k3, closest_keys),
            "packet_isect.anyhit_inst": worst(k3, ("anyhit_max_abs_err",))}
    # every row at its main path's primary wavefront; K1 also at the others
    times, work = {}, {}
    for op in ("closest", "anyhit"):
        times[f"dense_isect.{op}"] = tuple(
            k1[0][f"{op}_{x}"] for x in ("ms", "call_ms", "plain_ms"))
        work[f"dense_isect.{op}"] = dict(
            bound_ms=k1[0][f"{op}_bound_ms"], bound_by=k1[0][f"{op}_bound_by"],
            ms_by_wavefront={r["case"]: r[f"{op}_ms"] for r in k1},
            bound_ms_by_wavefront={r["case"]: r[f"{op}_bound_ms"]
                                   for r in k1})
    for recs, suffix in ((k2, ""), (k3, "_inst")):
        for op in ("closest", "anyhit"):
            times[f"packet_isect.{op}{suffix}"] = tuple(
                recs[0][f"{op}_{x}"] for x in ("ms", "call_ms", "plain_ms"))
            w = recs[0][f"{op}_work"]
            work[f"packet_isect.{op}{suffix}"] = dict(
                bound_ms=w["bound_ms"], bound_by=w["bound_by"],
                steps_per_ray=w["steps_per_ray"],
                tri_tests_per_ray=w["tri_tests_per_ray"],
                one_ray_per_thread_lane_share=w[
                    "one_ray_per_thread_lane_share"],
                deepest_stack=max(r[f"{op}_work"]["deepest_stack"]
                                  for r in recs))
    main_path = {"dense_isect": "cbox", "packet_isect": "cbox_sphere"}
    rows = []
    for k in REPLACES:
        run = ("cbox_spheres_instanced" if k.endswith("_inst")
               else main_path[k.split(".")[0]])
        rows.append(dict(
            name=k, route="cuda", source=SOURCES[k.split(".")[0]],
            replaces=REPLACES[k], launches=per_render[run][k],
            max_abs_err=errs[k], ms=times[k][0], call_ms=times[k][1],
            plain_ms=times[k][2],
            **work[k], share_of_bound=work[k]["bound_ms"] / times[k][0],
            launches_per_render={r: n[k] for r, n in per_render.items()
                                 if n[k] > 0},
            library_ms=None, library=LIBRARY))
    check(all(r["launches"] > 0 for r in rows),
          f"launches {[(r['name'], r['launches']) for r in rows]}")
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
