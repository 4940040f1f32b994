// Kernel B1: nearest ray-sphere hit over all spheres of a set, for a
// wavefront of rays.
//
// Replaces the TPU kernels mrt/ops/pallas_spheres.py::_kernel (direct
// form, wrapper nearest_t) and ::_kernel_x (expanded form with per-lane
// t_min, wrapper nearest_t_x).  One kernel serves both: per-lane or
// scalar t_min and t_max, and the expanded per-pair arithmetic of the
// reference scan in mrt/geometry/spheres.py::nearest_t,
//
//   half_b = o.d - c.d
//   c_term = (o.o - 2 c.o) + (|c|^2 - r^2)
//   disc   = half_b^2 - a c_term
//
// in the same operation order.  The library is built with --fmad=false,
// so no multiply-add is contracted and the results match the plain
// PyTorch version (mrt_torch/ops/spheres.py::nearest_t_plain) exactly.
//
// Root rule: the near root if it lies in [t_min, t_max], else the far
// root if it does; +inf and index 0 on a miss.  Equal roots go to the
// lower scene index, by explicit comparison (rows are reordered).
// Padding rows (radius 0) carry ccrr = +inf and never hit.  A zero
// direction gives NaN roots and so a miss.
//
// Layout (ops/spheres.py::group_table): rows float4 (cx, cy, cz, ccrr),
// the n_big ungrouped (large) spheres first, then groups of up to 32
// rows in the Morton order of their centres; index int, each row's
// scene index; boxes float4 x2 a group, (bmin xyz, reach),
// (bmax xyz, 0); order int (8, G), the groups front to back in each
// direction octant.
//
// Walk: one thread a ray.  Every lane tests the ungrouped rows.  Then
// its warp visits the groups in the order of its majority octant (on
// each axis the sign of most of its rays), slab-tests the group's box
// on every lane against [t_min, min(best, t_max)], and skips the group
// when no lane's segment enters it (__any_sync); else every lane tests
// the group's rows, all lanes reading the same row (a broadcast).  The
// box test can only keep a group the brute force would not need, never
// drop one it needs: the box grows by PAD (|o| + reach), past the
// farthest a computed root's point can lie outside its sphere, its t
// interval widens by SLACK, and a NaN keeps the group.  So the winner is
// the brute force's, bit for bit.
//
// With `shared` (ops/spheres.py: tables up to SHARED_MAX_BYTES, 48 KB;
// RTIOW's 484 spheres take 10,704 B) each block first copies the tables
// into its shared memory; else they are read from global memory through
// the read-only cache.
//
// Bound: FP32 issue rate.  A ray-sphere pair costs ~20 operations, a
// box test ~40; the ray and result traffic (~40 bytes a ray) is small
// beside them.  The culling cuts the pairs a ray (RTIOW main path: about
// a third of the 484 remain); the warp's lanes stay converged.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 32;
constexpr float kPad = 4e-3f;     // ops/spheres.py PAD
constexpr float kSlack = 1e-5f;   // ops/spheres.py SLACK

struct Groups {
  const float4* rows;
  const int* index;
  const float4* boxes;
  const int* order;
  int r, g, n_big;
};

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int table_bytes(const Groups& t) {
  return align16(t.r * 16) + align16(t.g * 32) + align16(t.r * 4) +
         align16(t.g * 32);
}

// NaN-propagating min / max (torch.minimum / torch.maximum).
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The block copies `bytes` (a multiple of 4) into shared memory; returns
// the next table's place, 16-byte aligned.
__device__ __forceinline__ unsigned char* stage(unsigned char* dst,
                                                const void* src, int bytes) {
  const int* s = static_cast<const int*>(src);
  int* t = reinterpret_cast<int*>(dst);
  for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x) t[i] = s[i];
  return dst + align16(bytes);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, od, oo, a, inv_a, lo, hi;
};

// Rows [k0, k1) against one ray: the running (best, best_i) updated.
template <bool kShared>
__device__ __forceinline__ void test_rows(const Groups& tb, int k0, int k1,
                                          const Ray& r, float& best,
                                          int& best_i) {
  for (int k = k0; k < k1; ++k) {
    const float4 c = ld<kShared>(tb.rows + k);
    const float cd = (c.x * r.dx + c.y * r.dy) + c.z * r.dz;
    const float co = (c.x * r.ox + c.y * r.oy) + c.z * r.oz;
    const float half_b = r.od - cd;
    const float c_term = (r.oo - 2.0f * co) + c.w;
    const float disc = half_b * half_b - r.a * c_term;
    if (!(disc >= 0.0f)) continue;
    const float sq = sqrtf(disc);
    const float r0 = (-half_b - sq) * r.inv_a;
    const float r1 = (-half_b + sq) * r.inv_a;
    float root = CUDART_INF_F;
    if (r0 >= r.lo && r0 <= r.hi) {
      root = r0;
    } else if (r1 >= r.lo && r1 <= r.hi) {
      root = r1;
    }
    if (root < CUDART_INF_F && root <= best) {
      const int idx = ld<kShared>(tb.index + k);
      if (root < best || idx < best_i) {
        best = root;
        best_i = idx;
      }
    }
  }
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

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
nearest_t_kernel(const Groups g, const float* __restrict__ o,
                 const float* __restrict__ d,
                 const float* __restrict__ t_min, float t_min_s,
                 const float* __restrict__ t_max, float t_max_s, int n,
                 float* __restrict__ t_out, int* __restrict__ i_out) {
  Groups tb = g;
  if constexpr (kShared) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* p = smem;
    tb.rows = reinterpret_cast<const float4*>(p);
    p = stage(p, g.rows, g.r * 16);
    tb.boxes = reinterpret_cast<const float4*>(p);
    p = stage(p, g.boxes, g.g * 32);
    tb.index = reinterpret_cast<const int*>(p);
    p = stage(p, g.index, g.r * 4);
    tb.order = reinterpret_cast<const int*>(p);
    stage(p, g.order, g.g * 32);
    __syncthreads();
  }
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  Ray r{0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    r.ox = o[3 * ray];
    r.oy = o[3 * ray + 1];
    r.oz = o[3 * ray + 2];
    r.dx = d[3 * ray];
    r.dy = d[3 * ray + 1];
    r.dz = d[3 * ray + 2];
    r.lo = t_min ? t_min[ray] : t_min_s;
    r.hi = t_max ? t_max[ray] : t_max_s;
  }
  r.od = (r.ox * r.dx + r.oy * r.dy) + r.oz * r.dz;
  r.oo = (r.ox * r.ox + r.oy * r.oy) + r.oz * r.oz;
  r.a = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  r.inv_a = 1.0f / r.a;

  float best = CUDART_INF_F;
  int best_i = 0;
  test_rows<kShared>(tb, 0, tb.n_big, r, best, best_i);

  const int oct = warp_octant(live, r.dx, r.dy, r.dz);
  const int* ord = tb.order + oct * tb.g;
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const float reach = sqrtf(r.oo);
  for (int step = 0; step < tb.g; ++step) {
    const int gi = ld<kShared>(ord + step);
    const float4 bl = ld<kShared>(tb.boxes + 2 * gi);
    const float4 bh = ld<kShared>(tb.boxes + 2 * gi + 1);
    const float pad = kPad * (reach + bl.w);
    const float t0x = ((bl.x - pad) - r.ox) * ix;
    const float t1x = ((bh.x + pad) - r.ox) * ix;
    const float t0y = ((bl.y - pad) - r.oy) * iy;
    const float t1y = ((bh.y + pad) - r.oy) * iy;
    const float t0z = ((bl.z - pad) - r.oz) * iz;
    const float t1z = ((bh.z + pad) - r.oz) * iz;
    float near = maxp(
        maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z)), r.lo);
    float far = minp(
        minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z)),
        minp(best, r.hi));
    near = near - fabsf(near) * kSlack;
    far = far + fabsf(far) * kSlack;
    const bool inside = live && !(near > far);  // NaN: tested
    if (!__any_sync(0xffffffffu, inside)) continue;
    const int first = tb.n_big + kGroup * gi;
    test_rows<kShared>(tb, first, min(first + kGroup, tb.r), r, best,
                       best_i);
  }
  if (live) {
    t_out[ray] = best;
    i_out[ray] = best_i;
  }
}

}  // namespace

// rows, index, boxes, order: ops/spheres.py::group_table's tables (r
// rows, g groups, n_big ungrouped rows first).  A null t_min / t_max
// takes the scalar t_min_s / t_max_s for every ray.  shared != 0 copies
// the tables into each block's shared memory (refused past 48 KB).
extern "C" int mrt_nearest_t(const float* rows, const int* index,
                             const float* boxes, const int* order, int r,
                             int g, int n_big, const float* o,
                             const float* d, const float* t_min,
                             float t_min_s, const float* t_max,
                             float t_max_s, int n, float* t_out, int* i_out,
                             int shared, cudaStream_t stream) {
  if (n <= 0) return 0;
  const Groups tb{reinterpret_cast<const float4*>(rows), index,
                  reinterpret_cast<const float4*>(boxes), order, r, g,
                  n_big};
  const int blocks = (n + kThreads - 1) / kThreads;
  if (shared) {
    const int bytes = table_bytes(tb);
    nearest_t_kernel<true><<<blocks, kThreads, bytes, stream>>>(
        tb, o, d, t_min, t_min_s, t_max, t_max_s, n, t_out, i_out);
  } else {
    nearest_t_kernel<false><<<blocks, kThreads, 0, stream>>>(
        tb, o, d, t_min, t_min_s, t_max, t_max_s, n, t_out, i_out);
  }
  return static_cast<int>(cudaGetLastError());
}
