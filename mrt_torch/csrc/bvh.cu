// Kernels B5 (sphere-BVH closest hit), B6 (triangle-BVH closest hit)
// and B7 (two-level TLAS closest hit).
//
// B5 replaces mrt/ops/pallas_bvh.py::_kernel (wrapper
// intersect_bvh_spheres).  B6 replaces pallas_bvh.py::_tri_kernel (wrapper
// traverse_bvh_tris): the single-level mesh walk of the world-flattened
// TLAS routes and of a scene's own mesh BVH; over a TLAS's flat parts it
// walks one forest (a top tree over the parts' roots, the parts' trees as
// its subtrees) in one launch, where the reference folds one traversal a
// part.  B7 replaces pallas_bvh.py::_tlas_kernel and
// ::_tlas_kernel_ordered (wrapper intersect_tlas), and also
// mrt/ops/pallas_stream.py::_build_kernel: that kernel pages tables past
// the TPU's 448 KB of SMEM in from HBM; here B7 copies its whole table
// set into each block's shared memory where it fits the card's opt-in
// limit and is not too small to pay for the copy (the "shared" regime;
// ops/bvh.py::tlas_regime) and reads global memory otherwise
// ("global").  The TPU kernels walk one traversal cursor per 1024-ray
// packet; here each thread walks its own ray, so no ray visits a node
// that its own slab test culled.
//
// Walks.  B5, B6 and B7 go stacklessly front to back: a walk follows the
// threading of one
// direction octant (bit a set <=> d[a] < 0) of the tree
// (geometry/bvh.py::thread_octants, the reference's), which enters the
// nearer child first, so the best t shrinks early and culls far
// subtrees: a hit continues at order[oct][node].x, anything else at .y
// (a leaf's two are equal), until the tree's sentinel.  A small tree's
// table holds the escape order in every octant (card_order).  B5 and B6
// take each ray's octant.  B7 walks its TLAS in the octant of the ray's warp (on
// each axis the sign of most of its 32 rays, so the warp's lanes meet
// the same instances in the same order) and a BLAS in the octant of the
// ray in instance space; one node visit (visit()) serves B6 and B7's
// BLAS steps.
//
// The arithmetic mirrors the plain PyTorch versions in
// mrt_torch/ops/bvh.py operation for operation (the library is built
// with --fmad=false, so nothing is contracted into an FMA) and results
// are bit-equal to them:
//   - the slab test propagates NaN like torch.minimum/maximum (fminf and
//     fmaxf would drop it): a ray on a slab plane with a zero direction
//     component gets 0 * inf = NaN and culls the box; its far limit is
//     min(best, t_max) and a box passes on near <= far;
//   - B5 leaf test in the reference traversal's own form
//     (mrt/geometry/bvh.py:459-479): oc = o - c, half_b = oc.d,
//     c = oc.oc - r^2, disc = half_b^2 - a c, roots (-half_b -+ sq) / a
//     as a multiply by 1/a; near root first; equal t -> lower index;
//     a leaf is tested whole at the limit min(best, t_max) of its entry
//     (the plain version's sphere_leaf), which keeps the reference
//     sequential leaf's winner;
//   - B6 and B7 share the leaf test (tri_test): Möller–Trumbore with
//     DET_EPS = 1e-6 and inv_det = 1 / (det_ok ? det : 1), t accepted in
//     [t_min, t_max].  B6: equal t -> the lower triangle index (over a
//     forest the lower global row: the reference's fold, in which equal
//     t keeps the earlier part).  B7 first warps the ray into the
//     instance as ((r0 ox + r1 oy) + r2 oz) + t0 (the Pallas order,
//     pallas_bvh.py:577-586); equal t -> the lexicographically lower
//     (instance, triangle).  So the winner does not depend on the visit
//     order, up to the slab test's rounding (ROADMAP C15).
//
// Tables (row-major, one row per node / primitive):
//   B5: sph    float4 per sphere: (center xyz, radius)
//   B5, B6, B7 (ops/bvh.py card_nodes, card_tris):
//       knodes float4 x2 per node: (bmin xyz, a), (bmax xyz, b), ints
//              bit-cast: a BVH's (first, count), a TLAS's (instance or
//              -1, 0): a visit issues two independent 16-byte loads and
//              the order load beside them, not a chain;
//       order  int2 per octant and node: (next on a hit, next on a miss)
//       rows   float4 x3 per triangle: (va, 0), (e_ab, 0), (e_ac, 0)
//       inst   float4 x3 per instance: the inverse transform's rows
//              R00..R22 then t0 t1 t2;  imeta int2: (blas_root, blas_end)
//
// Bound: FP32 issue rate.  A node visit costs ~26 operations (slab test
// and advance), a sphere test ~32, a triangle test ~58; rays and results
// move ~40-52 bytes a ray.  B5's and B6's tables stay in L2 (sphere_grid
// 209 KB, lucy's forest ~4.3 MB).  Threads of a warp diverge in their
// walks, which keeps all three far from the bound: B5, B6, and B7 in
// shared memory, fetch their rays a warp at a time from a global counter
// in persistent blocks, so a warp that finishes early takes new rays
// instead of idling while its block's slowest warp walks on, and B7's
// table copy serves every ray its block takes.  B5's lanes at different
// leaves would run their leaf loops one after another; where that costs
// more than testing each lane's leaf with the whole warp (up to 32
// spheres a leaf, one a lane), the warp does the latter, and a lane at a
// hit leaf waits for others to reach theirs, so that one leaf step
// serves about half the warp.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <mutex>

namespace {

constexpr int kThreads = 128;
constexpr int kSharedThreads = 256;  // B7 with its tables in shared memory
constexpr float kDetEps = 1e-6f;

// NaN-propagating min / max (torch.minimum / torch.maximum).
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int oct;  // direction octant: bit a set <=> d[a] < 0
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = 1.0f / dx;
  r.iy = 1.0f / dy;
  r.iz = 1.0f / dz;
  r.oct = (dx < 0.0f ? 1 : 0) | (dy < 0.0f ? 2 : 0) | (dz < 0.0f ? 4 : 0);
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        int ray) {
  return make_ray(o[3 * ray], o[3 * ray + 1], o[3 * ray + 2], d[3 * ray],
                  d[3 * ray + 1], d[3 * ray + 2]);
}

// The running winner: t, (u, v), (instance, triangle).
struct Best {
  float t, u, v;
  int inst, tri;
};

// Table loads: through the read-only cache from global memory, plain
// loads from shared memory (the compiler emits ld.shared for them).
template <bool kShared>
__device__ __forceinline__ float4 ld(const float4* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}
template <bool kShared>
__device__ __forceinline__ int2 ld(const int2* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The slab test of a packed node's two rows.
__device__ __forceinline__ bool slab_rows(const float4 lo, const float4 hi,
                                          const Ray& r, float t_min,
                                          float t_max) {
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  const float near = maxp(
      maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z)), t_min);
  const float far = minp(
      minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z)), t_max);
  return near <= far;
}

// Möller–Trumbore against a packed triangle row (va, e_ab, e_ac): true
// if the ray hits it at t in [lo, hi]; t, u, v out.
template <bool kShared>
__device__ __forceinline__ bool tri_test(const float4* tr, const Ray& r,
                                         float lo, float hi, float& t,
                                         float& u, float& v) {
  const float4 va = ld<kShared>(tr), ab = ld<kShared>(tr + 1),
               ac = ld<kShared>(tr + 2);
  const float px = r.dy * ac.z - r.dz * ac.y;
  const float py = r.dz * ac.x - r.dx * ac.z;
  const float pz = r.dx * ac.y - r.dy * ac.x;
  const float det = (ab.x * px + ab.y * py) + ab.z * pz;
  const bool det_ok = fabsf(det) >= kDetEps;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float tvx = r.ox - va.x, tvy = r.oy - va.y, tvz = r.oz - va.z;
  u = ((tvx * px + tvy * py) + tvz * pz) * inv_det;
  const float qx = tvy * ab.z - tvz * ab.y;
  const float qy = tvz * ab.x - tvx * ab.z;
  const float qz = tvx * ab.y - tvy * ab.x;
  v = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv_det;
  t = ((ac.x * qx + ac.y * qy) + ac.z * qz) * inv_det;
  return det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= lo && t <= hi;
}

// One node visit of B6's walk, also of B7's inside an instance: the
// slab test, a hit leaf's triangles, and the next node in the walk's
// order (`ord`: the threading's rows of the walk's octant).  Winners
// compare as (t, inst, triangle); B6 passes inst 0.
template <bool kShared>
__device__ __forceinline__ int visit(const float4* nodes, const int2* ord,
                                     const float4* tris, int n_tris,
                                     int node, const Ray& r, float lo,
                                     float hi, int inst, Best& b) {
  const float4 bl = ld<kShared>(nodes + 2 * node);
  const float4 bh = ld<kShared>(nodes + 2 * node + 1);
  const int2 next = ld<kShared>(ord + node);
  const bool hit = slab_rows(bl, bh, r, lo, minp(b.t, hi));
  const int count = __float_as_int(bh.w);
  if (hit && count > 0) {
    const int first = __float_as_int(bl.w);
    for (int k = 0; k < count; ++k) {
      const int ti = min(first + k, n_tris - 1);
      float t, u, v;
      if (tri_test<kShared>(tris + 3 * ti, r, lo, hi, t, u, v) &&
          (t < b.t || (t == b.t && (inst < b.inst ||
                                    (inst == b.inst && ti < b.tri))))) {
        b.t = t;
        b.u = u;
        b.v = v;
        b.inst = inst;
        b.tri = ti;
      }
    }
  }
  return hit ? next.x : next.y;
}

// The octant of a warp's rays: on each axis the sign of the most of its
// valid rays (a tie: positive).  All 32 lanes call it together.
__device__ __forceinline__ int warp_octant(bool valid, float dx, float dy,
                                           float dz) {
  const int n = __popc(__ballot_sync(0xffffffffu, valid));
  const auto most = [n](bool neg) {
    return 2 * __popc(__ballot_sync(0xffffffffu, neg)) > n;
  };
  return (most(valid && dx < 0.0f) ? 1 : 0) |
         (most(valid && dy < 0.0f) ? 2 : 0) |
         (most(valid && dz < 0.0f) ? 4 : 0);
}

// Calls trace(ray, oct) for each ray, oct the octant whose threading the
// walk follows: the ray's own, or with kWarpOctant its warp's.  Rays
// group into warps as 32 consecutive indices in both schedules.
// kPersistent: each warp takes the next 32 rays from `counter` (zeroed
// before the launch) until none are left; else one thread a ray.
template <bool kPersistent, bool kWarpOctant, typename F>
__device__ __forceinline__ void for_each_ray(int n, int* counter,
                                             const float* __restrict__ d,
                                             F&& trace) {
  const auto run = [&](int ray) {
    const bool valid = ray < n;
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
    if (valid) {
      dx = d[3 * ray];
      dy = d[3 * ray + 1];
      dz = d[3 * ray + 2];
    }
    const int oct =
        kWarpOctant ? warp_octant(valid, dx, dy, dz)
                    : (dx < 0.0f ? 1 : 0) | (dy < 0.0f ? 2 : 0) |
                          (dz < 0.0f ? 4 : 0);
    if (valid) trace(ray, oct);
  };
  if constexpr (kPersistent) {
    const int lane = threadIdx.x & 31;
    for (;;) {
      int base = 0;
      if (lane == 0) base = atomicAdd(counter, 32);
      base = __shfl_sync(0xffffffffu, base, 0);
      if (base >= n) return;
      run(base + lane);
    }
  } else {
    run(blockIdx.x * blockDim.x + threadIdx.x);
  }
}

// A warp test of one lane's leaf costs about this many lane loops' steps
// (the broadcast of the ray and the reduction beside the sphere test).
constexpr int kWarpLeafCost = 2;

// One sphere against a ray: the root in [lo, lim] (near root first), or
// +inf.  The reference traversal's form (mrt/geometry/bvh.py:459-479).
__device__ __forceinline__ float sphere_root(const float4 c, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float a,
                                             float inv_a, float lo,
                                             float lim) {
  const float ocx = ox - c.x, ocy = oy - c.y, ocz = oz - c.z;
  const float half_b = (ocx * dx + ocy * dy) + ocz * dz;
  const float cterm = ((ocx * ocx + ocy * ocy) + ocz * ocz) - c.w * c.w;
  const float disc = half_b * half_b - a * cterm;
  const bool ok = disc >= 0.0f;
  const float sq = sqrtf(ok ? fmaxf(disc, 0.0f) : 1.0f);
  const float r0 = (-half_b - sq) * inv_a;
  const float r1 = (-half_b + sq) * inv_a;
  if (ok && r0 >= lo && r0 <= lim) return r0;
  if (ok && r1 >= lo && r1 <= lim) return r1;
  return CUDART_INF_F;
}

// B5: persistent warps, each ray in its own octant's order from the
// packed nodes.  The warp steps on together: each iteration every lane
// that is not waiting at a leaf does one node visit.  A lane at a hit
// leaf waits, its walk paused, until the waiting lanes are at least half
// of those still walking, so that one leaf step serves more lanes.  Then
// the waiting lanes test their leaves, whichever way costs less for them
// (kWarpLeafCost): each its own leaf in a loop, or the whole warp one
// lane's leaf at a time: lane j
// tests sphere first + j against the owner's ray and limit
// min(best, t_max) at leaf entry, a shuffle reduction keeps the lowest
// (root, index), and the owner merges it.  The reference's sequential
// leaf shrinks its limit as it goes; a root that passes the entry limit
// but not a shrunk one is larger than the best found meanwhile and
// cannot win, so both give its winner.  A lane's own visits and tests
// keep their order whatever the warp does, so the winner is the plain
// walk's in the same octant order.
__global__ void __launch_bounds__(kThreads)
sphere_bvh_kernel(const float4* __restrict__ nodes,
                  const int2* __restrict__ order, int m,
                  const float4* __restrict__ sph, int s,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_min, float t_min_s,
                  const float* __restrict__ t_max, float t_max_s, int n,
                  float* __restrict__ t_out, int* __restrict__ i_out,
                  int* counter) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(kAll, base, 0);
    if (base >= n) return;
    const int ray = base + lane;
    const bool live = ray < n;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
    float lo = 0.0f, hi = 0.0f;
    if (live) {
      ox = o[3 * ray];
      oy = o[3 * ray + 1];
      oz = o[3 * ray + 2];
      dx = d[3 * ray];
      dy = d[3 * ray + 1];
      dz = d[3 * ray + 2];
      lo = t_min ? t_min[ray] : t_min_s;
      hi = t_max ? t_max[ray] : t_max_s;
    }
    const Ray r = make_ray(ox, oy, oz, dx, dy, dz);
    const float a = (dx * dx + dy * dy) + dz * dz;
    const float inv_a = 1.0f / a;
    const int2* ord = order + r.oct * m;
    float best = CUDART_INF_F;
    int best_i = 0;
    int node = live ? 0 : m;
    bool at_leaf = false;  // at a hit leaf, not yet tested
    int first = 0, count = 0;
    while (__any_sync(kAll, node < m || at_leaf)) {
      if (node < m && !at_leaf) {
        const float4 bl = __ldg(nodes + 2 * node);
        const float4 bh = __ldg(nodes + 2 * node + 1);
        const int2 next = __ldg(ord + node);
        const bool hit = slab_rows(bl, bh, r, lo, minp(best, hi));
        count = __float_as_int(bh.w);
        first = __float_as_int(bl.w);
        at_leaf = hit && count > 0;
        node = hit ? next.x : next.y;
      }
      unsigned todo = __ballot_sync(kAll, at_leaf);
      if (todo == 0) continue;
      const unsigned walking = __ballot_sync(kAll, node < m && !at_leaf);
      if (walking != 0 && 2 * __popc(todo) < __popc(todo | walking))
        continue;
      // The leaf's limit: the slab test's, best has not moved since.
      const float lim = minp(best, hi);
      const int longest =
          static_cast<int>(__reduce_max_sync(kAll, at_leaf ? count : 0));
      if (kWarpLeafCost * __popc(todo) >= longest) {
        if (at_leaf) {
          for (int k = 0; k < count; ++k) {
            const int si = min(first + k, s - 1);
            const float root = sphere_root(__ldg(sph + si), ox, oy, oz, dx,
                                           dy, dz, a, inv_a, lo,
                                           minp(best, hi));
            if (root < best || (root == best && si < best_i)) {
              best = root;
              best_i = si;
            }
          }
        }
        at_leaf = false;
        continue;
      }
      at_leaf = false;
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int sfirst = __shfl_sync(kAll, first, src);
        const int scount = __shfl_sync(kAll, count, src);
        const float sox = __shfl_sync(kAll, ox, src);
        const float soy = __shfl_sync(kAll, oy, src);
        const float soz = __shfl_sync(kAll, oz, src);
        const float sdx = __shfl_sync(kAll, dx, src);
        const float sdy = __shfl_sync(kAll, dy, src);
        const float sdz = __shfl_sync(kAll, dz, src);
        const float sa = __shfl_sync(kAll, a, src);
        const float sinv = __shfl_sync(kAll, inv_a, src);
        const float slo = __shfl_sync(kAll, lo, src);
        const float slim = __shfl_sync(kAll, lim, src);
        float root = CUDART_INF_F;
        int si = 0x7fffffff;
        if (lane < scount) {
          si = min(sfirst + lane, s - 1);
          root = sphere_root(__ldg(sph + si), sox, soy, soz, sdx, sdy, sdz,
                             sa, sinv, slo, slim);
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float r2 = __shfl_xor_sync(kAll, root, off);
          const int i2 = __shfl_xor_sync(kAll, si, off);
          if (r2 < root || (r2 == root && i2 < si)) {
            root = r2;
            si = i2;
          }
        }
        if (lane == src && (root < best || (root == best && si < best_i))) {
          best = root;
          best_i = si;
        }
      }
    }
    if (live) {
      t_out[ray] = best;
      i_out[ray] = best_i;
    }
  }
}

// B6: persistent warps, each ray in its own octant's order.
__global__ void __launch_bounds__(kThreads)
tri_bvh_kernel(const float4* __restrict__ nodes,
               const int2* __restrict__ order, int m,
               const float4* __restrict__ tris, int n_tris,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_min,
               const float* __restrict__ t_max, int n,
               float* __restrict__ t_out, int* __restrict__ i_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               int* counter) {
  for_each_ray<true, false>(n, counter, d, [&](int ray, int oct) {
    const Ray r = load_ray(o, d, ray);
    const float lo = t_min[ray], hi = t_max[ray];
    const int2* ord = order + oct * m;
    Best b{CUDART_INF_F, 0.0f, 0.0f, 0, 0};
    int node = 0;
    while (node < m)
      node = visit<false>(nodes, ord, tris, n_tris, node, r, lo, hi, 0, b);
    t_out[ray] = b.t;
    i_out[ray] = b.tri;
    u_out[ray] = b.u;
    v_out[ray] = b.v;
  });
}

struct TlasTables {
  const float4* tnodes;
  const int2* torder;
  const float4* inst;
  const int2* imeta;
  const float4* bnodes;
  const int2* border;
  const float4* tris;
  int mt, ni, mb, n_tris;
};

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// The tables' bytes, in TlasTables order.
__host__ __device__ __forceinline__ void tlas_sizes(const TlasTables& tb,
                                                    int bytes[7]) {
  bytes[0] = tb.mt * 32;
  bytes[1] = tb.mt * 64;
  bytes[2] = tb.ni * 48;
  bytes[3] = tb.ni * 8;
  bytes[4] = tb.mb * 32;
  bytes[5] = tb.mb * 64;
  bytes[6] = tb.n_tris * 48;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The block copies `bytes` (a multiple of 8) from global to shared memory
// with cp.async; an 8-byte tail goes by a plain load and store.  Returns
// the next table's place, 16-byte aligned.
__device__ __forceinline__ unsigned char* stage(unsigned char* dst,
                                                const void* src, int bytes) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const int n16 = bytes / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    cp_async16(dst + 16 * i, s + 16 * i);
  if (bytes % 16 != 0 && threadIdx.x == 0)
    *reinterpret_cast<int2*>(dst + 16 * n16) =
        *reinterpret_cast<const int2*>(s + 16 * n16);
  return dst + align16(bytes);
}

// B7's walk of one ray: a state machine over (TLAS node, instance, BLAS
// node), one node visit an iteration, so that the lanes of a warp in the
// TLAS and in a BLAS step on together.  The TLAS in the octant `oct`'s
// order, a BLAS in the octant of the ray in instance space; a TLAS
// leaf's successor is where the walk resumes after the instance.
template <bool kShared>
__device__ __forceinline__ void trace_tlas(const TlasTables& tb,
                                           const Ray& r, int oct, float lo,
                                           float hi, Best& b) {
  const int2* tord = tb.torder + oct * tb.mt;
  const int2* bord = tb.border;
  int tnode = 0, inst = -1, bnode = 0, bend = 0, resume = 0;
  Ray lr = r;
  while (inst >= 0 || tnode < tb.mt) {
    if (inst >= 0) {
      const int next = visit<kShared>(tb.bnodes, bord, tb.tris, tb.n_tris,
                                      bnode, lr, lo, hi, inst, b);
      if (next >= bend) {
        inst = -1;
        tnode = resume;
      } else {
        bnode = next;
      }
      continue;
    }
    const float4 bl = ld<kShared>(tb.tnodes + 2 * tnode);
    const float4 bh = ld<kShared>(tb.tnodes + 2 * tnode + 1);
    const int2 next = ld<kShared>(tord + tnode);
    const bool hit = slab_rows(bl, bh, r, lo, minp(b.t, hi));
    const int leaf = __float_as_int(bl.w);
    if (hit && leaf >= 0) {
      // Rows R00 R01 R02 R10 | R11 R12 R20 R21 | R22 t0 t1 t2.
      const float4* row = tb.inst + 3 * leaf;
      const float4 a = ld<kShared>(row), c = ld<kShared>(row + 1),
                   e = ld<kShared>(row + 2);
      lr = make_ray(((a.x * r.ox + a.y * r.oy) + a.z * r.oz) + e.y,
                    ((a.w * r.ox + c.x * r.oy) + c.y * r.oz) + e.z,
                    ((c.z * r.ox + c.w * r.oy) + e.x * r.oz) + e.w,
                    (a.x * r.dx + a.y * r.dy) + a.z * r.dz,
                    (a.w * r.dx + c.x * r.dy) + c.y * r.dz,
                    (c.z * r.dx + c.w * r.dy) + e.x * r.dz);
      const int2 im = ld<kShared>(tb.imeta + leaf);
      inst = leaf;
      bnode = im.x;
      bend = im.y;
      resume = next.y;
      bord = tb.border + lr.oct * tb.mb;
    } else {
      tnode = hit ? next.x : next.y;
    }
  }
}

// B7: the TLAS in its warp's octant order.  In shared memory each block
// first copies the tables, and its warps then fetch rays until none are
// left (persistent), so that one copy serves many rays; from global
// memory one thread a ray.
template <bool kShared>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kThreads)
tlas_kernel(const TlasTables g, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ t_min,
            const float* __restrict__ t_max, int n,
            float* __restrict__ t_out, int* __restrict__ inst_out,
            int* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out, int* counter) {
  TlasTables tb = g;
  if constexpr (kShared) {
    extern __shared__ __align__(16) unsigned char smem[];
    int bytes[7];
    tlas_sizes(g, bytes);
    unsigned char* p = smem;
    tb.tnodes = reinterpret_cast<const float4*>(p);
    p = stage(p, g.tnodes, bytes[0]);
    tb.torder = reinterpret_cast<const int2*>(p);
    p = stage(p, g.torder, bytes[1]);
    tb.inst = reinterpret_cast<const float4*>(p);
    p = stage(p, g.inst, bytes[2]);
    tb.imeta = reinterpret_cast<const int2*>(p);
    p = stage(p, g.imeta, bytes[3]);
    tb.bnodes = reinterpret_cast<const float4*>(p);
    p = stage(p, g.bnodes, bytes[4]);
    tb.border = reinterpret_cast<const int2*>(p);
    p = stage(p, g.border, bytes[5]);
    tb.tris = reinterpret_cast<const float4*>(p);
    stage(p, g.tris, bytes[6]);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  for_each_ray<kShared, true>(n, counter, d, [&](int ray, int oct) {
    const Ray r = load_ray(o, d, ray);
    Best b{CUDART_INF_F, 0.0f, 0.0f, -1, 0};
    trace_tlas<kShared>(tb, r, oct, t_min[ray], t_max[ray], b);
    t_out[ray] = b.t;
    inst_out[ray] = b.inst;
    tri_out[ray] = b.tri;
    u_out[ray] = b.u;
    v_out[ray] = b.v;
  });
}

// Blocks that fill the card with `fn` at `threads` and `smem` bytes of
// dynamic shared memory (a persistent grid), cached: the occupancy
// query runs once a kernel, size and device, outside any graph capture.
int resident_blocks(const void* fn, int threads, size_t smem) {
  struct Entry {
    const void* fn;
    size_t smem;
    int dev, blocks;
  };
  static Entry cache[32];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].smem == smem && cache[i].dev == dev)
      return cache[i].blocks;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int blocks = per_sm * sms;
  if (used < 32) cache[used++] = Entry{fn, smem, dev, blocks};
  return blocks;
}

// Lets `fn` take `smem` bytes of dynamic shared memory (raised once a
// kernel and size, before a capture replays it).
cudaError_t allow_smem(const void* fn, size_t smem) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
  };
  static Entry cache[16];
  static int used = 0;
  static std::mutex lock;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].dev == dev && cache[i].smem >= smem)
      return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && used < 16) cache[used++] = Entry{fn, dev, smem};
  return err;
}

// Grid of a launch over n rays: one thread a ray, or a persistent grid
// (no more blocks than the rays need).
int grid(const void* fn, int threads, size_t smem, int n, bool persistent) {
  const int blocks = (n + threads - 1) / threads;
  if (!persistent) return blocks;
  const int resident = resident_blocks(fn, threads, smem);
  return resident < blocks ? resident : blocks;
}

}  // namespace

// knodes, order: the tree's packed nodes and octant threading (as B6's);
// sph: the BVH-ordered rows.  A null t_min / t_max takes the scalar
// t_min_s / t_max_s for every ray.
extern "C" int mrt_sphere_bvh(const float* knodes, const int* order, int m,
                              const float* sph, int s, const float* o,
                              const float* d, const float* t_min,
                              float t_min_s, const float* t_max,
                              float t_max_s, int n, float* t_out,
                              int* i_out, int* counter,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const void* key = reinterpret_cast<const void*>(&sphere_bvh_kernel);
  const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  sphere_bvh_kernel<<<grid(key, kThreads, 0, n, true), kThreads, 0,
                      stream>>>(
      reinterpret_cast<const float4*>(knodes),
      reinterpret_cast<const int2*>(order), m,
      reinterpret_cast<const float4*>(sph), s, o, d, t_min, t_min_s, t_max,
      t_max_s, n, t_out, i_out, counter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrt_tri_bvh(const float* knodes, const int* order, int m,
                           const float* tris, int n_tris, const float* o,
                           const float* d, const float* t_min,
                           const float* t_max, int n, float* t_out,
                           int* i_out, float* u_out, float* v_out,
                           int* counter, cudaStream_t stream) {
  if (n <= 0) return 0;
  const void* key = reinterpret_cast<const void*>(&tri_bvh_kernel);
  const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tri_bvh_kernel<<<grid(key, kThreads, 0, n, true), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(knodes),
      reinterpret_cast<const int2*>(order), m,
      reinterpret_cast<const float4*>(tris), n_tris, o, d, t_min, t_max, n,
      t_out, i_out, u_out, v_out, counter);
  return static_cast<int>(cudaGetLastError());
}

// Tables in TlasTables order; shared != 0 copies them into each block's
// shared memory (the launch is refused past the card's limit).
extern "C" int mrt_tlas(const float* tnodes, const int* torder,
                        const float* inst, const int* imeta,
                        const float* bnodes, const int* border,
                        const float* tris, int mt, int ni, int mb,
                        int n_tris, const float* o, const float* d,
                        const float* t_min, const float* t_max, int n,
                        float* t_out, int* inst_out, int* tri_out,
                        float* u_out, float* v_out, int* counter,
                        int shared, cudaStream_t stream) {
  if (n <= 0) return 0;
  const TlasTables tb{reinterpret_cast<const float4*>(tnodes),
                      reinterpret_cast<const int2*>(torder),
                      reinterpret_cast<const float4*>(inst),
                      reinterpret_cast<const int2*>(imeta),
                      reinterpret_cast<const float4*>(bnodes),
                      reinterpret_cast<const int2*>(border),
                      reinterpret_cast<const float4*>(tris),
                      mt, ni, mb, n_tris};
  auto fn = shared ? &tlas_kernel<true> : &tlas_kernel<false>;
  const int threads = shared ? kSharedThreads : kThreads;
  size_t smem = 0;
  if (shared) {
    int bytes[7];
    tlas_sizes(tb, bytes);
    for (int b : bytes) smem += align16(b);
  }
  const void* key = reinterpret_cast<const void*>(fn);
  cudaError_t err = allow_smem(key, smem);
  if (err == cudaSuccess && shared)
    err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid(key, threads, smem, n, shared), threads, smem, stream>>>(
      tb, o, d, t_min, t_max, n, t_out, inst_out, tri_out, u_out, v_out,
      counter);
  return static_cast<int>(cudaGetLastError());
}
