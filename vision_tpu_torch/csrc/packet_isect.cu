// BVH traversal (kernel families K2 and K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vision_tpu/accel/packet_bvh.py:
//   bvh_closest_kernel       <- _closest_kernel (:390, K2v2) and the
//                               closest-hit _win_kernel3 (:1343, K2v3)
//   bvh_anyhit_kernel        <- _anyhit_kernel (:517, K2v2) and the any-hit
//                               _win_kernel3 (:1343, K2v3)
//   bvh_closest_inst_kernel  <- _inst_closest_kernel (:880, K3)
//   bvh_anyhit_inst_kernel   <- _inst_anyhit_kernel (:1085, K3)
// They compute what those compute: the closest hit (t, original triangle id,
// u, v; K3 also the instance) or whether any hit has 0 < t < t_max, over the
// binned-SAH tree of native/bvh_builder.cpp. The plain PyTorch versions are
// vision_tpu_torch/accel/packet_bvh.py intersect_packet_plain /
// intersect_packet_inst_plain, which the wrapper (accel/packet_isect.py)
// uses for CPU tensors and which chip_smoke.py compares these kernels with.
//
// Not carried over from the TPU: the 1024-ray block that shares one walk,
// the scalar-prefetch node arrays, the double-buffered brick copies and the
// per-octant windows of v3. Here one thread walks one ray:
//   * ordered stack walk: at an inner node both children's boxes are
//     tested; the near child by the ray's own direction sign along the
//     split axis (the left child covers the lower side) is entered, the far
//     one is pushed with its tnear and skipped at pop time if best_t has
//     dropped below it;
//   * a box is visited when tfar >= tnear and tnear <= best_t (not <), so an
//     equal-t triangle with a smaller id is not culled; the closest hit keeps
//     the strictly smaller t, on equal t the smaller original id (then the
//     smaller instance), so the result does not depend on the walk's order
//     and agrees with the plain walk and with K1's dense sweep;
//   * K3: at a TLAS leaf the ray moves to the instance's object space by
//     its 3x4 world-to-object rows, the mesh tree is walked on top of the
//     same stack, and the world ray comes back once the stack is down to
//     where the mesh walk began. The direction stays unnormalized, so t
//     compares across instances;
//   * any hit returns at its first hit; a lane with t_max <= 0 at once.
//   * the stack is bounded by construction: it never holds more entries
//     than the tree's depth (for K3 the TLAS depth plus the deepest mesh
//     tree), which the host checks against kStack before every launch. The
//     walk is never cut short (the TPU K3's step cap, ROADMAP fault C2, is
//     not copied).
//
// What bounds it on an H100: divergence and node-fetch latency. Lanes of a
// warp walk different paths, so a warp runs as long as its slowest lane,
// and each step is a dependent 32-byte node load (two float4: (lo.xyz,
// right child) and (hi.xyz, brick)) followed by 48-byte triangle loads
// (three float4 per slot) at leaves. The cbox_sphere tree at leaf 4 is
// 153,989 nodes (4.9 MB) and 307,980 triangle slots (14.8 MB), both inside
// the 50 MB L2, so the loads are L2 hits after warm-up; the design keeps
// every load a 16-byte vector load and keeps per-thread state in registers
// (the stack in local memory, cached in L1).
//
// Numerics: built with -fmad=false and without fast math; the slab test,
// the reciprocal clamp (+-1e-12), the instance transform and Möller-Trumbore
// (mt.cuh) follow the plain version's operation order.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 96;  // packet_bvh.py STACK

struct RayState {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float rcp_clamped(float v) {
  const float a = fabsf(v) > 1e-12f ? v : (v >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / a;
}

__device__ __forceinline__ void set_ray(RayState& r, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz) {
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = rcp_clamped(dx); r.iy = rcp_clamped(dy); r.iz = rcp_clamped(dz);
}

// Slab test of node n: hit if tfar >= tnear and tnear <= lim.
__device__ __forceinline__ bool slab(const float4* __restrict__ nodes, int n,
                                     const RayState& r, float lim,
                                     float& tnear) {
  const float4 a = nodes[2 * n];
  const float4 b = nodes[2 * n + 1];
  const float ax = (a.x - r.ox) * r.ix, bx = (b.x - r.ox) * r.ix;
  const float ay = (a.y - r.oy) * r.iy, by = (b.y - r.oy) * r.iy;
  const float az = (a.z - r.oz) * r.iz, bz = (b.z - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                         fmaxf(fminf(az, bz), 0.0f));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  tnear = tn;
  return tf >= tn && tn <= lim;
}

struct Result {
  float t, u, v;
  int id, inst;
  bool occ;
};

template <bool kInst, bool kAnyHit>
__device__ __forceinline__ Result walk(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax_in, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, int bsize,
    const int* __restrict__ inst_root, const float* __restrict__ w2o, int i) {
  const float wox = o[3 * i], woy = o[3 * i + 1], woz = o[3 * i + 2];
  const float wdx = d[3 * i], wdy = d[3 * i + 1], wdz = d[3 * i + 2];
  const float tmax = tmax_in[i];
  Result res{tmax, 0.0f, 0.0f, -1, -1, false};
  if (!(tmax > 0.0f)) return res;

  RayState ray;
  set_ray(ray, wox, woy, woz, wdx, wdy, wdz);
  int stk[kStack];
  float stk_t[kStack];
  int sp = 0;
  int base_sp = 0;  // entries below belong to the TLAS (K3)
  int cur = -1;     // current instance, -1 = world (K3)
  int node = 0;
  float tn;
  bool go = slab(nodes, 0, ray, res.t, tn);
  while (true) {
    if (go) {
      const float4 a = nodes[2 * node];
      const int code = __float_as_int(nodes[2 * node + 1].w);
      if (code >= 0) {
        // leaf: sweep its slots up to the first padding slot
        for (int k = 0; k < bsize; ++k) {
          const int s = code * bsize + k;
          const float4 q0 = tris[3 * s];
          const int pid = __float_as_int(q0.w);
          if (pid < 0) break;
          const float4 q1 = tris[3 * s + 1];
          const float4 q2 = tris[3 * s + 2];
          float t, u, v;
          if (!vt::mt_test(q0.x, q0.y, q0.z, q1.x, q1.y, q1.z, q2.x, q2.y,
                           q2.z, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                           ray.dz, t, u, v))
            continue;
          if (kAnyHit) {
            if (t < tmax) {
              res.occ = true;
              return res;
            }
          } else if (t < res.t ||
                     (t == res.t && res.id >= 0 &&
                      (pid < res.id ||
                       (kInst && pid == res.id && cur < res.inst)))) {
            res.t = t;
            res.u = u;
            res.v = v;
            res.id = pid;
            res.inst = cur;
          }
        }
        go = false;
      } else if (kInst && code <= -4) {
        // TLAS leaf: enter the instance's mesh tree in object space
        cur = -4 - code;
        const float* m = w2o + 12 * cur;
        set_ray(ray,
                m[0] * wox + m[1] * woy + m[2] * woz + m[3],
                m[4] * wox + m[5] * woy + m[6] * woz + m[7],
                m[8] * wox + m[9] * woy + m[10] * woz + m[11],
                m[0] * wdx + m[1] * wdy + m[2] * wdz,
                m[4] * wdx + m[5] * wdy + m[6] * wdz,
                m[8] * wdx + m[9] * wdy + m[10] * wdz);
        base_sp = sp;
        node = inst_root[cur];
        go = slab(nodes, node, ray, res.t, tn);
        continue;
      } else {
        // inner: enter the near child, push the far one
        const int l = node + 1;
        const int r = __float_as_int(a.w);
        float tl, tr;
        const bool hl = slab(nodes, l, ray, res.t, tl);
        const bool hr = slab(nodes, r, ray, res.t, tr);
        if (hl && hr) {
          const int axis = -1 - code;
          const float da = axis == 0 ? ray.dx : (axis == 1 ? ray.dy : ray.dz);
          const bool left_first = da >= 0.0f;
          stk[sp] = left_first ? r : l;
          stk_t[sp] = left_first ? tr : tl;
          ++sp;
          node = left_first ? l : r;
          continue;
        }
        if (hl || hr) {
          node = hl ? l : r;
          continue;
        }
        go = false;
      }
    }
    // pop; leaving a mesh tree restores the world ray
    if (kInst && cur >= 0 && sp == base_sp) {
      set_ray(ray, wox, woy, woz, wdx, wdy, wdz);
      cur = -1;
    }
    if (sp == 0) break;
    --sp;
    node = stk[sp];
    go = stk_t[sp] <= res.t;
  }
  return res;
}

__global__ void __launch_bounds__(kThreads)
bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmax,
                   const float4* __restrict__ nodes,
                   const float4* __restrict__ tris, int bsize, int n_rays,
                   float* __restrict__ t_out, int* __restrict__ id_out,
                   float* __restrict__ bary_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const Result r = walk<false, false>(o, d, tmax, nodes, tris, bsize, nullptr,
                                      nullptr, i);
  t_out[i] = r.t;
  id_out[i] = r.id;
  bary_out[2 * i] = r.u;
  bary_out[2 * i + 1] = r.v;
}

__global__ void __launch_bounds__(kThreads)
bvh_anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ tmax,
                  const float4* __restrict__ nodes,
                  const float4* __restrict__ tris, int bsize, int n_rays,
                  bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  occ_out[i] = walk<false, true>(o, d, tmax, nodes, tris, bsize, nullptr,
                                 nullptr, i).occ;
}

__global__ void __launch_bounds__(kThreads)
bvh_closest_inst_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tmax,
                        const float4* __restrict__ nodes,
                        const float4* __restrict__ tris, int bsize,
                        const int* __restrict__ inst_root,
                        const float* __restrict__ w2o, int n_rays,
                        float* __restrict__ t_out, int* __restrict__ id_out,
                        float* __restrict__ bary_out,
                        int* __restrict__ inst_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const Result r = walk<true, false>(o, d, tmax, nodes, tris, bsize,
                                     inst_root, w2o, i);
  t_out[i] = r.t;
  id_out[i] = r.id;
  bary_out[2 * i] = r.u;
  bary_out[2 * i + 1] = r.v;
  inst_out[i] = r.inst;
}

__global__ void __launch_bounds__(kThreads)
bvh_anyhit_inst_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tmax,
                       const float4* __restrict__ nodes,
                       const float4* __restrict__ tris, int bsize,
                       const int* __restrict__ inst_root,
                       const float* __restrict__ w2o, int n_rays,
                       bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  occ_out[i] = walk<true, true>(o, d, tmax, nodes, tris, bsize, inst_root,
                                w2o, i).occ;
}

inline int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: rays o/d [R,3] and t_max [R] f32, nodes [N,8] f32,
// tris [slots,12] f32, inst_root [I] i32, w2o [I,12] f32; outputs t [R] f32,
// id [R] i32, bary [R,2] f32, inst [R] i32, occ [R] bool. `stream` is a
// cudaStream_t. Each returns cudaGetLastError() right after the launch.
extern "C" int vt_packet_stack() { return kStack; }

extern "C" int vt_bvh_closest(const float* o, const float* d,
                              const float* tmax, const float* nodes,
                              const float* tris, int bsize, int n_rays,
                              float* t_out, int* id_out, float* bary_out,
                              void* stream) {
  bvh_closest_kernel<<<blocks_for(n_rays), kThreads, 0, as_stream(stream)>>>(
      o, d, tmax, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), bsize, n_rays, t_out, id_out,
      bary_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vt_bvh_anyhit(const float* o, const float* d,
                             const float* tmax, const float* nodes,
                             const float* tris, int bsize, int n_rays,
                             bool* occ_out, void* stream) {
  bvh_anyhit_kernel<<<blocks_for(n_rays), kThreads, 0, as_stream(stream)>>>(
      o, d, tmax, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), bsize, n_rays, occ_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vt_bvh_closest_inst(const float* o, const float* d,
                                   const float* tmax, const float* nodes,
                                   const float* tris, int bsize,
                                   const int* inst_root, const float* w2o,
                                   int n_rays, float* t_out, int* id_out,
                                   float* bary_out, int* inst_out,
                                   void* stream) {
  bvh_closest_inst_kernel<<<blocks_for(n_rays), kThreads, 0,
                            as_stream(stream)>>>(
      o, d, tmax, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), bsize, inst_root, w2o, n_rays,
      t_out, id_out, bary_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vt_bvh_anyhit_inst(const float* o, const float* d,
                                  const float* tmax, const float* nodes,
                                  const float* tris, int bsize,
                                  const int* inst_root, const float* w2o,
                                  int n_rays, bool* occ_out, void* stream) {
  bvh_anyhit_inst_kernel<<<blocks_for(n_rays), kThreads, 0,
                           as_stream(stream)>>>(
      o, d, tmax, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), bsize, inst_root, w2o, n_rays,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vt_packet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
