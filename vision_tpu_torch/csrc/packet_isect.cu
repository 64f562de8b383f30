// BVH traversal (kernel families K2 and K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vision_tpu/accel/packet_bvh.py:
//   bvh_walk_kernel<false, false>  <- _closest_kernel (:390, K2v2) and the
//                                     closest-hit _win_kernel3 (:1343, K2v3)
//   bvh_walk_kernel<false, true>   <- _anyhit_kernel (:517, K2v2) and the
//                                     any-hit _win_kernel3 (:1343, K2v3)
//   bvh_walk_kernel<true, false>   <- _inst_closest_kernel (:880, K3)
//   bvh_walk_kernel<true, true>    <- _inst_anyhit_kernel (:1085, K3)
// They compute what those compute: the closest hit (t, original triangle id,
// u, v; K3 also the instance) or whether any hit has 0 < t < t_max, over the
// binned-SAH tree of native/bvh_builder.cpp. The plain PyTorch versions are
// vision_tpu_torch/accel/packet_bvh.py intersect_packet_plain /
// intersect_packet_inst_plain, which the wrapper (accel/packet_isect.py)
// uses for CPU tensors and which chip_smoke.py compares these kernels with.
// A third instantiation per kernel (kCount) also records, per ray, the work
// the walk did and which records and triangle slots it read; only
// chip_smoke.py launches it, to compute each kernel's bound.
//
// What bounds it on an H100: memory traffic through the L2, not arithmetic.
// A ray's walk is a chain of dependent loads at scattered addresses down a
// tree ~22 levels deep; each 16-byte load costs a 32-byte sector, so a
// closest-hit ray moves ~1 KB (9 records of 64 bytes, 6-7 triangle slots of
// 48 bytes on cbox_sphere's primary rays), ~16x the bytes its bound counts
// (each record and slot once). The trees (cbox_sphere: 4.9 MB of records,
// 14.8 MB of slots) stay in the 50 MB L2. The design cuts the dependent
// rounds and keeps the card full (after Aila & Laine, "Understanding the
// efficiency of ray traversal on GPUs", 2009):
//   * child-pair records (packet_bvh.py _kernel_layout): an inner node's 64
//     bytes hold both children's boxes and references, so one step is one
//     round of four independent 16-byte loads and no box is read twice. A
//     reference is index << 2 | kind (inner record, leaf brick, TLAS
//     instance; -1 none). Each tree has a header record holding its root's
//     box, tested once before the walk;
//   * ordered stack walk: both children's boxes are tested; if both are hit
//     the near one by the ray's direction sign along the split axis (the
//     left child covers the lower side) is entered and the far one pushed
//     with its tnear, skipped at pop time if best_t has dropped below it;
//   * persistent warps with dynamic ray fetch: as many blocks as stay
//     resident; a lane whose ray is done (or dead, t_max <= 0) takes the
//     next ray index from a global counter, which the warp bumps once for
//     all its waiting lanes (__ballot_sync / __popc at the loop's top, where
//     the warp has reconverged) when kFetchBatch lanes wait or none walks.
//     One loop iteration walks each lane down to its next leaf and sweeps
//     it, so a finished lane waits at most one leaf for a new ray;
//   * the stack holds kStack (reference, tnear) entries in local memory.
// It never holds more entries than the tree's depth (for K3 the TLAS depth
// plus the deepest mesh tree), which the host checks against kStack before
// every launch. The walk is never cut short (the TPU K3's step cap, ROADMAP
// fault C2, is not copied).
//
// Results do not depend on the walk's order or on which lane walks a ray: a
// box is visited when tfar >= tnear and tnear <= best_t (not <), the closest
// hit keeps the strictly smaller t, on equal t the smaller original id (then
// the smaller instance), so the kernels agree with the plain walk and with
// K1's dense sweep bit for bit. K3: at a TLAS leaf the ray moves to the
// instance's object space by its 3x4 world-to-object rows (three float4),
// its mesh tree is walked on top of the same stack, and the world ray comes
// back once the stack is down to where the mesh walk began. The direction
// stays unnormalized, so t compares across instances. Any hit returns at
// its first hit.
//
// Numerics: built with -fmad=false and without fast math; the slab test,
// the reciprocal clamp (+-1e-12), the instance transform and Möller-Trumbore
// (mt.cuh) follow the plain version's operation order.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 96;  // packet_bvh.py STACK
constexpr int kFetchBatch = 8;  // waiting lanes that make a warp fetch rays
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInner = 0, kLeaf = 1, kInstance = 2, kNone = -1;
constexpr int kCounts = 6;  // per-ray counts of the counting build

struct Params {
  const float* o;
  const float* d;
  const float* tmax;
  const float4* nodes;
  const float4* tris;
  const float4* insts;
  int bsize;
  int n_rays;
  int* next;
  float* t_out;
  int* id_out;
  float2* bary_out;
  int* inst_out;
  bool* occ_out;
  int* counts;
  unsigned char* rec_seen;
  unsigned char* slot_seen;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float rcp_clamped(float v) {
  const float a = fabsf(v) > 1e-12f ? v : (v >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / a;
}

__device__ __forceinline__ void set_ray(Ray& r, float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = rcp_clamped(dx); r.iy = rcp_clamped(dy); r.iz = rcp_clamped(dz);
}

// Slab test of the box lo.xyz / hi.xyz: hit if tfar >= tnear and tnear <= lim.
__device__ __forceinline__ bool slab(const float4& lo, const float4& hi,
                                     const Ray& r, float lim, float& tnear) {
  const float ax = (lo.x - r.ox) * r.ix, bx = (hi.x - r.ox) * r.ix;
  const float ay = (lo.y - r.oy) * r.iy, by = (hi.y - r.oy) * r.iy;
  const float az = (lo.z - r.oz) * r.iz, bz = (hi.z - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                         fmaxf(fminf(az, bz), 0.0f));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  tnear = tn;
  return tf >= tn && tn <= lim;
}

// The stack, in local memory. Kept out of Lane: an array indexed at run
// time would pull the whole struct, the ray and the best hit with it, into
// local memory.
struct Stack {
  int ref[kStack];
  float t[kStack];
};

// One lane's walk of one ray.
template <bool kInst, bool kAnyHit, bool kCount>
struct Lane {
  Ray ray;
  float wox, woy, woz, wdx, wdy, wdz, tmax;
  float best_t, best_u, best_v;
  int best_id, best_inst;
  bool occ;
  int cur;      // reference to visit next, kNone once the walk is over
  int sp;       // stack entries
  int base_sp;  // entries below belong to the TLAS (K3)
  int inst;     // current instance, -1 = world (K3)
  // counting build: inner records, leaves, box tests, triangle tests,
  // instance entries, deepest stack
  int n_inner, n_leaf, n_box, n_tri, n_enter, n_deep;

  __device__ __forceinline__ void push(Stack& s, int ref, float tn) {
    s.ref[sp] = ref;
    s.t[sp] = tn;
    ++sp;
    if (kCount) n_deep = max(n_deep, sp);
  }

  // The next stacked reference whose box may still hold a closer hit, or
  // kNone; leaving a mesh tree restores the world ray.
  __device__ __forceinline__ int pop(Stack& s) {
    while (true) {
      if (kInst && inst >= 0 && sp == base_sp) {
        set_ray(ray, wox, woy, woz, wdx, wdy, wdz);
        inst = -1;
      }
      if (sp == 0) return kNone;
      --sp;
      if (s.t[sp] <= best_t) return s.ref[sp];
    }
  }

  // Test a tree's root box from its header record: the root's reference,
  // or the next stacked one if the box is missed.
  __device__ __forceinline__ int enter_tree(const Params& p, Stack& s,
                                            int head) {
    const float4 a = p.nodes[4 * head];
    const float4 b = p.nodes[4 * head + 1];
    if (kCount) {
      n_box += 1;
      p.rec_seen[head] = 1;
    }
    float tn;
    return slab(a, b, ray, best_t, tn) ? __float_as_int(a.w) : pop(s);
  }

  __device__ __forceinline__ void start(const Params& p, Stack& s, int i) {
    wox = p.o[3 * i]; woy = p.o[3 * i + 1]; woz = p.o[3 * i + 2];
    wdx = p.d[3 * i]; wdy = p.d[3 * i + 1]; wdz = p.d[3 * i + 2];
    tmax = p.tmax[i];
    best_t = tmax;
    best_u = best_v = 0.0f;
    best_id = best_inst = -1;
    occ = false;
    sp = base_sp = 0;
    inst = -1;
    cur = kNone;
    n_inner = n_leaf = n_box = n_tri = n_enter = n_deep = 0;
    if (!(tmax > 0.0f)) return;
    set_ray(ray, wox, woy, woz, wdx, wdy, wdz);
    cur = enter_tree(p, s, 0);
  }

  __device__ __forceinline__ void sweep(const Params& p, int brick) {
    const int first = brick * p.bsize;
    for (int k = 0; k < p.bsize; ++k) {
      const int s = first + k;
      const float4 q0 = p.tris[3 * s];
      const int pid = __float_as_int(q0.w);
      if (pid < 0) break;  // padding trails the brick's triangles
      const float4 q1 = p.tris[3 * s + 1];
      const float4 q2 = p.tris[3 * s + 2];
      if (kCount) {
        n_tri += 1;
        p.slot_seen[s] = 1;
      }
      float t, u, v;
      if (!vt::mt_test(q0.x, q0.y, q0.z, q1.x, q1.y, q1.z, q2.x, q2.y, q2.z,
                       ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, t, u,
                       v))
        continue;
      if (kAnyHit) {
        if (t < tmax) {
          occ = true;
          return;
        }
      } else if (t < best_t ||
                 (t == best_t && best_id >= 0 &&
                  (pid < best_id ||
                   (kInst && pid == best_id && inst < best_inst)))) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_id = pid;
        best_inst = inst;
      }
    }
  }

  // Walk down to the next leaf and sweep it, or enter the next instance.
  // Returns true once the ray's walk is over.
  __device__ __forceinline__ bool advance(const Params& p, Stack& s) {
    while ((cur & 3) == kInner) {
      const int r = cur >> 2;
      const float4 a = p.nodes[4 * r];
      const float4 b = p.nodes[4 * r + 1];
      const float4 c = p.nodes[4 * r + 2];
      const float4 d = p.nodes[4 * r + 3];
      if (kCount) {
        n_inner += 1;
        n_box += 2;
        p.rec_seen[r] = 1;
      }
      float tl, tr;
      const bool hl = slab(a, b, ray, best_t, tl);
      const bool hr = slab(c, d, ray, best_t, tr);
      const int ref_l = __float_as_int(a.w), ref_r = __float_as_int(b.w);
      if (hl && hr) {
        const int axis = __float_as_int(c.w);
        const float da = axis == 0 ? ray.dx : (axis == 1 ? ray.dy : ray.dz);
        const bool left_first = da >= 0.0f;
        push(s, left_first ? ref_r : ref_l, left_first ? tr : tl);
        cur = left_first ? ref_l : ref_r;
      } else if (hl || hr) {
        cur = hl ? ref_l : ref_r;
      } else {
        cur = pop(s);
      }
    }
    if ((cur & 3) == kLeaf) {
      if (kCount) n_leaf += 1;
      sweep(p, cur >> 2);
      if (kAnyHit && occ) return true;
      cur = pop(s);
    } else if (kInst && (cur & 3) == kInstance) {
      // TLAS leaf: enter the instance's mesh tree in object space
      inst = cur >> 2;
      const float4* ir = p.insts + 4 * inst;
      const float4 m0 = ir[0], m1 = ir[1], m2 = ir[2];
      const int head = __float_as_int(ir[3].x);
      if (kCount) n_enter += 1;
      set_ray(ray,
              m0.x * wox + m0.y * woy + m0.z * woz + m0.w,
              m1.x * wox + m1.y * woy + m1.z * woz + m1.w,
              m2.x * wox + m2.y * woy + m2.z * woz + m2.w,
              m0.x * wdx + m0.y * wdy + m0.z * wdz,
              m1.x * wdx + m1.y * wdy + m1.z * wdz,
              m2.x * wdx + m2.y * wdy + m2.z * wdz);
      base_sp = sp;
      cur = enter_tree(p, s, head);
    }
    return cur == kNone;
  }

  __device__ __forceinline__ void finish(const Params& p, int i) {
    if (kAnyHit) {
      p.occ_out[i] = occ;
    } else {
      p.t_out[i] = best_t;
      p.id_out[i] = best_id;
      p.bary_out[i] = make_float2(best_u, best_v);
      if (kInst) p.inst_out[i] = best_inst;
    }
    if (kCount) {
      int* c = p.counts + kCounts * i;
      c[0] = n_inner; c[1] = n_leaf; c[2] = n_box;
      c[3] = n_tri; c[4] = n_enter; c[5] = n_deep;
    }
  }
};

template <bool kInst, bool kAnyHit, bool kCount>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Lane<kInst, kAnyHit, kCount> w;
  Stack stack;
  int ray = -1;  // -1: waits for a ray; n_rays: none left
  while (true) {
    // every lane of the warp is here: the loop body reconverges
    const unsigned want = __ballot_sync(kFull, ray < 0);
    const unsigned busy = __ballot_sync(kFull, ray >= 0 && ray < p.n_rays);
    if (want != 0 && (busy == 0 || __popc(want) >= kFetchBatch)) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(p.next, __popc(want));
      base = __shfl_sync(kFull, base, leader);
      if (ray < 0) {
        ray = min(base + __popc(want & below), p.n_rays);
        if (ray < p.n_rays) w.start(p, stack, ray);
      }
    } else if (busy == 0) {
      break;
    }
    if (ray >= 0 && ray < p.n_rays && w.advance(p, stack)) {
      w.finish(p, ray);
      ray = -1;
    }
  }
}

// Blocks that stay resident on the card, capped by the blocks the rays fill.
template <bool kInst, bool kAnyHit, bool kCount>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bvh_walk_kernel<kInst, kAnyHit, kCount>, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident = sms * per_sm;
  }
  const int fill = (p.n_rays + kThreads - 1) / kThreads;
  const int blocks = resident < fill ? resident : fill;
  const cudaError_t e = cudaMemsetAsync(p.next, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  bvh_walk_kernel<kInst, kAnyHit, kCount><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool kInst>
cudaError_t dispatch(const Params& p, bool any_hit, bool count,
                     cudaStream_t s) {
  if (count)
    return any_hit ? launch<kInst, true, true>(p, s)
                   : launch<kInst, false, true>(p, s);
  return any_hit ? launch<kInst, true, false>(p, s)
                 : launch<kInst, false, false>(p, s);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: rays o/d [R,3] and t_max [R] f32, nodes [M,16] f32
// child-pair records, tris [slots,12] f32, insts [I,16] f32 (null for a flat
// tree: K2, else K3), next [1] i32 (the ray counter, zeroed here on the
// stream before the launch); outputs t [R]
// f32, id [R] i32, bary [R,2] f32, inst [R] i32 (K3), occ [R] bool (any
// hit). `count` != 0 launches the counting build, which also writes counts
// [R,6] i32 and sets rec_seen [M] / slot_seen [slots] u8 to 1 where it read.
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int vt_packet_stack() { return kStack; }

extern "C" int vt_bvh_walk(const float* o, const float* d, const float* tmax,
                           const float* nodes, const float* tris,
                           const float* insts, int bsize, int n_rays,
                           int* next, float* t_out, int* id_out,
                           float* bary_out, int* inst_out, bool* occ_out,
                           int any_hit, int count, int* counts,
                           unsigned char* rec_seen, unsigned char* slot_seen,
                           void* stream) {
  const Params p{o, d, tmax, reinterpret_cast<const float4*>(nodes),
                 reinterpret_cast<const float4*>(tris),
                 reinterpret_cast<const float4*>(insts), bsize, n_rays, next,
                 t_out, id_out, reinterpret_cast<float2*>(bary_out), inst_out,
                 occ_out, counts, rec_seen, slot_seen};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(insts ? dispatch<true>(p, any_hit, count, s)
                                : dispatch<false>(p, any_hit, count, s));
}

extern "C" const char* vt_packet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
