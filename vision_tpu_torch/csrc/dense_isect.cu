// Dense ray/triangle sweep (kernel family K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vision_tpu/accel/pallas_isect.py:
//   dense_closest_kernel  <- _closest_kernel  (closest hit: t, id, u, v)
//   dense_anyhit_kernel   <- _anyhit_kernel   (shadow rays: any 0 < t < t_max)
// Both test every ray against every triangle of a scene of at most 2048
// triangles (the dense path; larger scenes take a BVH). The plain PyTorch
// versions are vision_tpu_torch/accel/intersect.py intersect_brute /
// occluded_brute, which the Python wrapper (accel/dense_isect.py) uses for
// CPU tensors and which chip_smoke.py compares these kernels with.
//
// What bounds it on an H100: one ray-triangle Möller-Trumbore test is about
// 40 FLOP (27 multiplies, 15 adds, one divide) and reads 36 bytes of
// triangle. At 2048 triangles a ray does ~80 kFLOP against 44 bytes of ray
// I/O, so the sweep is compute-bound on the fp32 pipes; at the cornell
// box's 36 triangles it is ~1.4 kFLOP per ray and the 28 bytes in / 16 out
// per ray (plus launch latency) bound it.
// What the design does about that:
//   * one thread per ray, rays read from [R,3] origin / direction and [R]
//     t_max with no padding; no TPU layout is carried over (no [8, R] ray
//     plane, no 8-row triangle chunks, no one-hot u/v pick);
//   * the block stages triangles through shared memory in tiles of 256
//     (9 KB); every thread of a warp reads the same word, a broadcast, so
//     the inner loop is register arithmetic only;
//   * any-hit: a thread stops at its first hit and the block leaves the
//     tile loop once every thread is done (__syncthreads_or).
//
// Numerics: compiled with -fmad=false and without fast math, each multiply,
// add and divide rounds as PyTorch's eager ops do, in the same order, so on
// the card the kernels agree with their plain versions almost bit for bit
// (an FMA would move t by ULPs and turn exact ties into id flips).
// Closest hit: best_t starts at t_max and is replaced only by a strictly
// smaller t, scanning ids upward, so an exact tie keeps the lower id as
// intersect_brute does. Edges are tested with the 1e-6 barycentric slack of
// intersect.py and packet_bvh.py (mt.cuh); the Pallas K1 tests them
// strictly, which can crack shared edges (ROADMAP fault C1), and that is not
// copied.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;          // triangles staged per shared-memory tile

// Möller-Trumbore against one staged triangle (p0 e1 e2, 9 floats).
__device__ __forceinline__ bool mt_test(const float* s, float ox, float oy,
                                        float oz, float dx, float dy, float dz,
                                        float& t, float& u, float& v) {
  return vt::mt_test(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                     ox, oy, oz, dx, dy, dz, t, u, v);
}

__device__ __forceinline__ void stage_tile(float* s, const float* tris,
                                           int base, int n) {
  const float* src = tris + 9 * base;
  for (int k = threadIdx.x; k < 9 * n; k += blockDim.x) s[k] = src[k];
}

__global__ void __launch_bounds__(kThreads)
dense_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmax,
                     const float* __restrict__ tris, int n_rays, int n_tris,
                     float* __restrict__ t_out, int* __restrict__ id_out,
                     float* __restrict__ bary_out) {
  __shared__ float s[9 * kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float best_t = 0.f, best_u = 0.f, best_v = 0.f;
  int best_id = -1;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    best_t = tmax[i];
  }
  for (int base = 0; base < n_tris; base += kTile) {
    const int n = min(kTile, n_tris - base);
    stage_tile(s, tris, base, n);
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float t, u, v;
        if (mt_test(s + 9 * j, ox, oy, oz, dx, dy, dz, t, u, v) &&
            t < best_t) {
          best_t = t;
          best_id = base + j;
          best_u = u;
          best_v = v;
        }
      }
    }
    __syncthreads();  // the tile is consumed before the next one lands
  }
  if (live) {
    t_out[i] = best_t;
    id_out[i] = best_id;
    bary_out[2 * i] = best_u;
    bary_out[2 * i + 1] = best_v;
  }
}

__global__ void __launch_bounds__(kThreads)
dense_anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmax,
                    const float* __restrict__ tris, int n_rays, int n_tris,
                    bool* __restrict__ occ_out) {
  __shared__ float s[9 * kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tm = 0.f;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tm = tmax[i];
  }
  bool hit = false;
  for (int base = 0; base < n_tris; base += kTile) {
    const int n = min(kTile, n_tris - base);
    stage_tile(s, tris, base, n);
    __syncthreads();
    if (live && !hit) {
      for (int j = 0; j < n; ++j) {
        float t, u, v;
        if (mt_test(s + 9 * j, ox, oy, oz, dx, dy, dz, t, u, v) && t < tm) {
          hit = true;
          break;
        }
      }
    }
    // also the barrier that frees the tile for the next load
    if (!__syncthreads_or(live && !hit)) break;
  }
  if (live) occ_out[i] = hit;
}

inline int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous float32 tensors (int32 / bool outputs); `stream` is a
// cudaStream_t. Each returns cudaGetLastError() right after the launch.
extern "C" int vt_dense_closest(const float* o, const float* d,
                                const float* tmax, const float* tris,
                                int n_rays, int n_tris, float* t_out,
                                int* id_out, float* bary_out, void* stream) {
  dense_closest_kernel<<<blocks_for(n_rays), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      o, d, tmax, tris, n_rays, n_tris, t_out, id_out, bary_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vt_dense_anyhit(const float* o, const float* d,
                               const float* tmax, const float* tris,
                               int n_rays, int n_tris, bool* occ_out,
                               void* stream) {
  dense_anyhit_kernel<<<blocks_for(n_rays), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, tmax, tris, n_rays, n_tris, occ_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
