// Dense ray/triangle sweep (kernel family K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vision_tpu/accel/pallas_isect.py:
//   dense_sweep_kernel<false>  <- _closest_kernel  (closest hit: t, id, u, v)
//   dense_sweep_kernel<true>   <- _anyhit_kernel   (shadow rays: any 0 < t < t_max)
// Both test every ray against every triangle of a scene of at most 2048
// triangles (the dense path; larger scenes take a BVH, but any count works).
// The plain PyTorch versions are vision_tpu_torch/accel/intersect.py
// intersect_brute / occluded_brute, which the Python wrapper
// (accel/dense_isect.py) uses for CPU tensors and which chip_smoke.py
// compares these kernels with. tests/torch_sweep_model.py is a numpy model
// of this file's loop order (its constants are read from here).
//
// What bounds it on an H100: issue. One Möller-Trumbore test is 40 FLOP
// without FMA (-fmad=false keeps the plain version's rounding), about 60
// SASS instructions with the reciprocal, the compares and the predicated
// update; the fp32 pipes and the issue slots run at the same rate, so no
// bit-exact sweep passes ~50% of the 67 TFLOP/s (FMA-counted) bound. At the
// cornell box's 36 triangles the 44 bytes of ray I/O per ray are far below
// the arithmetic. What the design does about it:
//   * persistent blocks: as many as stay resident, each taking chunks of 32
//     rays interleaved across the grid (chunk b, b + grid, ...), so the
//     blocks' loads differ by at most one chunk and no partial wave trails;
//   * the scene in shared memory once per block when it has <= kTileTris
//     triangles, as padded 48-byte records (p0, e1, e2 as three float4: one
//     broadcast LDS.128 each); larger scenes stream through in tiles of
//     kTileTris, re-staged per pass. 512 (24 KB) and not the dense path's
//     2048 (96 KB): at 96 KB two blocks fit an SM, and the 2048-triangle
//     sweep ran 7-9% slower than with 512 or 1024 (PERF.md §6);
//   * dead rays (t_max <= 0, or NaN: no hit can have 0 < t < t_max) are
//     answered at once (closest: t = t_max, id -1, uv 0; any hit: false),
//     and the live ones of a pass are packed, in order, into the thread
//     slots, so lanes sweep only rays whose result is read;
//   * kRays rays per thread: each staged triangle's loads serve all of
//     them and their independent chains hide the reciprocal's latency; a
//     warp sweeps only the slots that hold a live ray for some lane;
//   * any hit: no per-lane break; a warp sweeps kChunk triangles unrolled,
//     then leaves once no lane has an open ray (__any_sync);
//   * the reciprocal without a branch: staging a tile also finds its largest
//     |e1|_1 |e2|_1, and a warp whose rays' |d|_1 times that stays under
//     2^122 (always, at any realistic scale) sweeps the tile with mt.cuh's
//     rcp_fast, the division's fast path alone, and no select around it;
//     other warps keep the division's branch to its exact slow path (1/det
//     subnormal);
//   * at most 64 registers (kBlocksPerSM), the closest sweep unrolled four
//     triangles deep: four blocks an SM. Without the bound the any hit took
//     72 registers, three blocks, and ran 4-10% slower (PERF.md §6).
//
// Numerics: compiled with -fmad=false and without fast math, each multiply,
// add and divide rounds as PyTorch's eager ops do, in the same order
// (mt.cuh), so the kernels agree with their plain versions bit for bit.
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
constexpr int kWarps = kThreads / 32;
constexpr int kRays = 2;                   // ray slots per thread
constexpr int kChunksPerPass = kWarps * kRays;
constexpr int kPass = 32 * kChunksPerPass;  // rays a block takes per pass
constexpr int kTileTris = 512;             // triangles in shared memory (24 KB)
constexpr int kChunk = 8;                  // any hit: triangles between votes
constexpr int kBlocksPerSM = 4;            // blocks an SM: <= 64 registers
constexpr unsigned kFull = 0xffffffffu;
// |det| <= |e1|_1 |d|_1 |e2|_1 (times 1 + a few ulps); below this bound on
// the right side every det of the pair is far under 2^126 and the
// reciprocal needs no branch (mt.cuh rcp_fast)
constexpr float kSmallDetBound = 0x1p122f;

struct Params {
  const float* o;
  const float* d;
  const float* tmax;
  const float* tris;
  int n_rays;
  int n_tris;
  float* t_out;
  int* id_out;
  float2* bary_out;
  bool* occ_out;
};

// A thread's ray slots. Indexed only inside fully unrolled loops, so they
// stay in registers.
struct Slots {
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tm[kRays];  // t_max; 0 in an empty slot, which then cannot hit
  float dn[kRays];  // |d|_1, for the bound on det (0 in an empty slot)
  float best_t[kRays], best_u[kRays], best_v[kRays];
  int best_id[kRays];
  bool occ[kRays];  // any hit; an empty slot counts as done
};

// Triangles [first, first + n) of the [T, 9] array into padded records;
// *bound (zeroed before) becomes the float bits of the largest
// |e1|_1 |e2|_1 (NaN, the largest as unsigned bits, if any is NaN).
__device__ __forceinline__ void stage(float4* s, unsigned* bound,
                                     const float* tris, int first, int n) {
  float b = 0.0f;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float* q = tris + 9 * static_cast<size_t>(first + k);
    s[3 * k] = make_float4(q[0], q[1], q[2], 0.0f);
    s[3 * k + 1] = make_float4(q[3], q[4], q[5], 0.0f);
    s[3 * k + 2] = make_float4(q[6], q[7], q[8], 0.0f);
    const float bk = (fabsf(q[3]) + fabsf(q[4]) + fabsf(q[5])) *
                     (fabsf(q[6]) + fabsf(q[7]) + fabsf(q[8]));
    b = bk > b || bk != bk ? bk : b;
  }
  atomicMax(bound, __float_as_uint(fabsf(b)));
}

template <int M, bool kSmall>
__device__ __forceinline__ void sweep_closest(const float4* s, int first,
                                              int n, Slots& r) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 a = s[3 * j], b = s[3 * j + 1], c = s[3 * j + 2];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float t, u, v;
      if (vt::mt_test<kSmall>(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z,
                              r.ox[k], r.oy[k], r.oz[k], r.dx[k], r.dy[k],
                              r.dz[k], t, u, v) &&
          t < r.best_t[k]) {
        r.best_t[k] = t;
        r.best_u[k] = u;
        r.best_v[k] = v;
        r.best_id[k] = first + j;
      }
    }
  }
}

template <int M, bool kSmall>
__device__ __forceinline__ void test_any(const float4* s, int j, Slots& r) {
  const float4 a = s[3 * j], b = s[3 * j + 1], c = s[3 * j + 2];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    float t, u, v;
    const bool h = vt::mt_test<kSmall>(a.x, a.y, a.z, b.x, b.y, b.z, c.x,
                                       c.y, c.z, r.ox[k], r.oy[k], r.oz[k],
                                       r.dx[k], r.dy[k], r.dz[k], t, u, v) &&
                   t < r.tm[k];
    r.occ[k] |= h;
  }
}

template <int M>
__device__ __forceinline__ bool any_open(const Slots& r) {
  bool open = false;
#pragma unroll
  for (int k = 0; k < M; ++k) open |= !r.occ[k];
  return open;
}

// Returns true once no lane of the warp has an open ray.
template <int M, bool kSmall>
__device__ __forceinline__ bool sweep_anyhit(const float4* s, int n,
                                             Slots& r) {
  int j = 0;
  for (; j + kChunk <= n; j += kChunk) {
#pragma unroll
    for (int q = 0; q < kChunk; ++q) test_any<M, kSmall>(s, j + q, r);
    if (!__any_sync(kFull, any_open<M>(r))) return true;
  }
  for (; j < n; ++j) test_any<M, kSmall>(s, j, r);
  return !__any_sync(kFull, any_open<M>(r));
}

// Sweep the first m (warp-uniform, 1..kRays) slots over a staged tile;
// kSmall: every det of the warp's rays and the tile is < 2^126.
template <bool kAnyHit, bool kSmall, int M>
__device__ __forceinline__ bool sweep(const float4* s, int first, int n,
                                      int m, Slots& r) {
  if constexpr (M > 1) {
    if (m < M) return sweep<kAnyHit, kSmall, M - 1>(s, first, n, m, r);
  }
  if constexpr (kAnyHit) {
    return sweep_anyhit<M, kSmall>(s, n, r);
  } else {
    sweep_closest<M, kSmall>(s, first, n, r);
    return false;
  }
}

template <bool kAnyHit>
__device__ __forceinline__ void write_miss(const Params& p, int i, float tm) {
  if (kAnyHit) {
    p.occ_out[i] = false;
  } else {
    p.t_out[i] = tm;
    p.id_out[i] = -1;
    p.bary_out[i] = make_float2(0.0f, 0.0f);
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dense_sweep_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 s_tri[];  // 3 per triangle: p0, e1, e2
  __shared__ int s_live[kPass];      // this pass's live rays, packed
  __shared__ int s_count[kChunksPerPass];  // live rays per (slot, warp)
  __shared__ unsigned s_bound;  // float bits: the tile's max |e1|_1 |e2|_1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grid = gridDim.x, block = blockIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const int n_chunks = (p.n_rays + 31) / 32;
  const bool resident = p.n_tris <= kTileTris;
  if (resident) {
    if (threadIdx.x == 0) s_bound = 0u;
    __syncthreads();
    stage(s_tri, &s_bound, p.tris, 0, p.n_tris);
  }
  // pass `pass` takes chunks (pass * kChunksPerPass + q) * grid + block,
  // q = k * kWarps + warp for slot k
  for (int pass = 0; pass * kChunksPerPass * grid + block < n_chunks;
       ++pass) {
    __syncthreads();  // the last pass is done with s_live / s_count
    unsigned live[kRays];
    int first_ray[kRays];  // this lane's ray of slot k's chunk
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int chunk = (pass * kChunksPerPass + k * kWarps + warp) * grid +
                        block;
      const int i = first_ray[k] = chunk * 32 + lane;
      bool is_live = false;
      if (i < p.n_rays) {
        const float tm = p.tmax[i];
        is_live = tm > 0.0f;
        if (!is_live) write_miss<kAnyHit>(p, i, tm);
      }
      live[k] = __ballot_sync(kFull, is_live);
      if (lane == 0) s_count[k * kWarps + warp] = __popc(live[k]);
    }
    __syncthreads();
    int n_live = 0, off[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) off[k] = n_live;
        n_live += s_count[k * kWarps + w];
      }
    }
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if ((live[k] >> lane) & 1u)
        s_live[off[k] + __popc(live[k] & below)] = first_ray[k];
    }
    __syncthreads();
    // slot k of this thread holds packed entry k * kThreads + threadIdx.x;
    // the warp sweeps the m slots in which some lane holds a ray
    int m = 0;
    Slots r;
    int ray[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int e = k * kThreads + threadIdx.x;
      m += (k * kThreads + warp * 32 < n_live) ? 1 : 0;
      ray[k] = e < n_live ? s_live[e] : -1;
      float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
      float tm = 0.0f;
      if (ray[k] >= 0) {
        const int i = ray[k];
        ox = p.o[3 * i]; oy = p.o[3 * i + 1]; oz = p.o[3 * i + 2];
        dx = p.d[3 * i]; dy = p.d[3 * i + 1]; dz = p.d[3 * i + 2];
        tm = p.tmax[i];
      }
      r.ox[k] = ox; r.oy[k] = oy; r.oz[k] = oz;
      r.dx[k] = dx; r.dy[k] = dy; r.dz[k] = dz;
      r.tm[k] = tm;
      r.dn[k] = fabsf(dx) + fabsf(dy) + fabsf(dz);
      r.best_t[k] = tm;
      r.best_u[k] = 0.0f;
      r.best_v[k] = 0.0f;
      r.best_id[k] = -1;
      r.occ[k] = ray[k] < 0;
    }
    bool done = m == 0;
    for (int first = 0; first < p.n_tris; first += kTileTris) {
      const int n = min(kTileTris, p.n_tris - first);
      if (!resident) {
        __syncthreads();  // every warp is done with the last tile
        if (threadIdx.x == 0) s_bound = 0u;
        __syncthreads();
        stage(s_tri, &s_bound, p.tris, first, n);
        __syncthreads();
      }
      if (done) continue;
      float dmax = 0.0f;
#pragma unroll
      for (int k = 0; k < kRays; ++k) dmax = fmaxf(dmax, r.dn[k]);
      if (__all_sync(kFull,
                     dmax * __uint_as_float(s_bound) < kSmallDetBound))
        done = sweep<kAnyHit, true, kRays>(s_tri, first, n, m, r);
      else
        done = sweep<kAnyHit, false, kRays>(s_tri, first, n, m, r);
    }
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = ray[k];
      if (i < 0) continue;
      if (kAnyHit) {
        p.occ_out[i] = r.occ[k];
      } else {
        p.t_out[i] = r.best_t[k];
        p.id_out[i] = r.best_id[k];
        p.bary_out[i] = make_float2(r.best_u[k], r.best_v[k]);
      }
    }
  }
}

// Dynamic shared memory stays under the 48 KB a launch gets without opting in.
static_assert(sizeof(float4) * 3 * kTileTris +
                      sizeof(int) * (kPass + kChunksPerPass) <= 48 * 1024,
              "a larger tile needs cudaFuncAttributeMaxDynamicSharedMemorySize");

// Blocks that stay resident with this scene's shared memory, capped by the
// chunks of 32 rays (each block takes at least one).
template <bool kAnyHit>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static size_t cached_smem = ~size_t(0);
  static int resident = 0;
  auto kernel = dense_sweep_kernel<kAnyHit>;
  const int tile = p.n_tris < kTileTris ? p.n_tris : kTileTris;
  const size_t smem = sizeof(float4) * 3 * static_cast<size_t>(tile);
  if (smem != cached_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return e;
    resident = sms * per_sm;
    cached_smem = smem;
  }
  const int n_chunks = (p.n_rays + 31) / 32;
  const int blocks = resident < n_chunks ? resident : n_chunks;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers of
// contiguous tensors: o / d [R,3], t_max [R], tris [T,9] float32; outputs
// t [R] f32, id [R] i32, bary [R,2] f32, or occ [R] bool. `stream` is a
// cudaStream_t. Each returns cudaGetLastError() right after the launch.
extern "C" int vt_dense_closest(const float* o, const float* d,
                                const float* tmax, const float* tris,
                                int n_rays, int n_tris, float* t_out,
                                int* id_out, float* bary_out, void* stream) {
  const Params p{o, d, tmax, tris, n_rays, n_tris, t_out, id_out,
                 reinterpret_cast<float2*>(bary_out), nullptr};
  return static_cast<int>(
      launch<false>(p, static_cast<cudaStream_t>(stream)));
}

extern "C" int vt_dense_anyhit(const float* o, const float* d,
                               const float* tmax, const float* tris,
                               int n_rays, int n_tris, bool* occ_out,
                               void* stream) {
  const Params p{o,       d,       tmax,    tris,   n_rays,
                 n_tris,  nullptr, nullptr, nullptr, occ_out};
  return static_cast<int>(
      launch<true>(p, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
