// Kernels B5 (sphere-BVH closest hit), B6 (triangle-BVH closest hit) and
// B7 (two-level TLAS closest hit).
//
// B5 replaces mrt/ops/pallas_bvh.py::_kernel (wrapper
// intersect_bvh_spheres).  B6 replaces pallas_bvh.py::_tri_kernel (wrapper
// traverse_bvh_tris): the single-level mesh walk of the world-flattened
// TLAS routes and of a scene's own mesh BVH.  B7 replaces pallas_bvh.py::_tlas_kernel and
// ::_tlas_kernel_ordered (wrapper intersect_tlas), and also
// mrt/ops/pallas_stream.py::_build_kernel: that kernel pages tables past
// the TPU's 448 KB of SMEM in from HBM; here every table is read from
// global memory through the read-only cache at any size, so B7 is its
// counterpart too.  The TPU kernels walk one traversal cursor per
// 1024-ray packet; here each thread walks its own ray, so no ray visits
// a node that its own slab test culled.
//
// All three walk the flattened BVH stacklessly: a hit inner node continues at
// node + 1, anything else at its escape index.  The arithmetic mirrors
// the plain PyTorch versions in mrt_torch/ops/bvh.py operation for
// operation (the library is built with --fmad=false, so nothing is
// contracted into an FMA) and results are bit-equal to them:
//   - the slab test propagates NaN like torch.minimum/maximum (fminf and
//     fmaxf would drop it): a ray on a slab plane with a zero direction
//     component gets 0 * inf = NaN and culls the box;
//   - B5 leaf test in the reference traversal's own form
//     (mrt/geometry/bvh.py:459-479): oc = o - c, half_b = oc.d,
//     c = oc.oc - r^2, disc = half_b^2 - a c, roots (-half_b -+ sq) / a
//     as a multiply by 1/a; near root first; equal t -> lower index;
//   - B6 and B7 share the leaf test (tri_test): Möller–Trumbore with
//     DET_EPS = 1e-6 and inv_det = 1 / (det_ok ? det : 1), t accepted in
//     [t_min, t_max]; the slab's far limit is min(best, t_max).  B6: equal
//     t -> the lower triangle index.  B7 first warps the ray into the
//     instance as ((r0 ox + r1 oy) + r2 oz) + t0 (the Pallas order,
//     pallas_bvh.py:577-586); equal t -> the lexicographically lower
//     (instance, triangle).  So the visit order never changes the winner.
//
// Tables (row-major, one row per node / primitive):
//   nodes  float4 x2 per node: (bmin xyz, 0), (bmax xyz, 0)
//   meta   int4 per node: (first, count, escape, 0); count 0 = inner node
//   sph    float4 per sphere: (center xyz, radius)
//   tnodes as nodes; tmeta int4: (instance or -1, escape, 0, 0)
//   inst   12 floats per instance: inverse rows R00..R22, then t0 t1 t2
//   imeta  int2 per instance: (blas_root, blas_end)
//   tris   9 floats per triangle: va, e_ab, e_ac
//
// Bound: FP32 issue rate.  A node visit costs ~26 operations (slab test
// and advance), a sphere test ~32, a triangle test ~58; the tables of
// sphere_grid (1,023 nodes, 10,000 spheres: 209 KB), of an 8,000-
// instance TLAS (~1.2 MB) and of a lucy flat part (~6,000 triangles,
// ~230 KB) stay in L2, and rays and results move ~40-52 bytes a ray.
// Threads of a warp diverge in their walks; these first kernels do
// nothing about it (no packets, no ray sorting, no front-to-back order,
// no shared-memory tables).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kDetEps = 1e-6f;

// NaN-propagating min / max (torch.minimum / torch.maximum).
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ bool slab(const float4* __restrict__ nodes,
                                     int node, float ox, float oy, float oz,
                                     float ix, float iy, float iz,
                                     float t_min, float t_max) {
  const float4 lo = __ldg(nodes + 2 * node);
  const float4 hi = __ldg(nodes + 2 * node + 1);
  const float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
  const float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
  const float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
  const float near = maxp(
      maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z)), t_min);
  const float far = minp(
      minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z)), t_max);
  return near <= far;
}

// Möller–Trumbore against triangle row `tr` (va, e_ab, e_ac): true if the
// ray hits it at t in [lo, hi]; t, u, v out.
__device__ __forceinline__ bool tri_test(const float* __restrict__ tr,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float lo, float hi, float& t,
                                         float& u, float& v) {
  const float vax = __ldg(tr + 0), vay = __ldg(tr + 1), vaz = __ldg(tr + 2);
  const float abx = __ldg(tr + 3), aby = __ldg(tr + 4), abz = __ldg(tr + 5);
  const float acx = __ldg(tr + 6), acy = __ldg(tr + 7), acz = __ldg(tr + 8);
  const float px = dy * acz - dz * acy;
  const float py = dz * acx - dx * acz;
  const float pz = dx * acy - dy * acx;
  const float det = (abx * px + aby * py) + abz * pz;
  const bool det_ok = fabsf(det) >= kDetEps;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float tvx = ox - vax, tvy = oy - vay, tvz = oz - vaz;
  u = ((tvx * px + tvy * py) + tvz * pz) * inv_det;
  const float qx = tvy * abz - tvz * aby;
  const float qy = tvz * abx - tvx * abz;
  const float qz = tvx * aby - tvy * abx;
  v = ((dx * qx + dy * qy) + dz * qz) * inv_det;
  t = ((acx * qx + acy * qy) + acz * qz) * inv_det;
  return det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= lo && t <= hi;
}

__global__ void __launch_bounds__(kThreads)
sphere_bvh_kernel(const float4* __restrict__ nodes,
                  const int4* __restrict__ meta, int m,
                  const float4* __restrict__ sph, int s,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_min,
                  const float* __restrict__ t_max, int n,
                  float* __restrict__ t_out, int* __restrict__ i_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float lo = t_min[ray], hi = t_max[ray];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float a = (dx * dx + dy * dy) + dz * dz;
  const float inv_a = 1.0f / a;

  float best = CUDART_INF_F;
  int best_i = 0;
  int node = 0;
  while (node < m) {
    const int4 row = __ldg(meta + node);
    const bool hit = slab(nodes, node, ox, oy, oz, ix, iy, iz, lo,
                          minp(best, hi));
    if (hit && row.y > 0) {
      for (int k = 0; k < row.y; ++k) {
        const int si = min(row.x + k, s - 1);
        const float4 c = __ldg(sph + si);
        const float ocx = ox - c.x, ocy = oy - c.y, ocz = oz - c.z;
        const float half_b = (ocx * dx + ocy * dy) + ocz * dz;
        const float cterm = ((ocx * ocx + ocy * ocy) + ocz * ocz) - c.w * c.w;
        const float disc = half_b * half_b - a * cterm;
        const bool ok = disc >= 0.0f;
        const float sq = sqrtf(ok ? fmaxf(disc, 0.0f) : 1.0f);
        const float r0 = (-half_b - sq) * inv_a;
        const float r1 = (-half_b + sq) * inv_a;
        const float lim = minp(best, hi);
        float root = CUDART_INF_F;
        if (ok && r0 >= lo && r0 <= lim) {
          root = r0;
        } else if (ok && r1 >= lo && r1 <= lim) {
          root = r1;
        }
        if (root < best || (root == best && si < best_i)) {
          best = root;
          best_i = si;
        }
      }
    }
    node = (hit && row.y == 0) ? node + 1 : row.z;
  }
  t_out[ray] = best;
  i_out[ray] = best_i;
}

__global__ void __launch_bounds__(kThreads)
tri_bvh_kernel(const float4* __restrict__ nodes, const int4* __restrict__ meta,
               int m, const float* __restrict__ tris, int n_tris,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_min,
               const float* __restrict__ t_max, int n,
               float* __restrict__ t_out, int* __restrict__ i_out,
               float* __restrict__ u_out, float* __restrict__ v_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float lo = t_min[ray], hi = t_max[ray];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best = CUDART_INF_F, bu = 0.f, bv = 0.f;
  int best_i = 0;
  int node = 0;
  while (node < m) {
    const int4 row = __ldg(meta + node);
    const bool hit = slab(nodes, node, ox, oy, oz, ix, iy, iz, lo,
                          minp(best, hi));
    if (hit && row.y > 0) {
      for (int k = 0; k < row.y; ++k) {
        const int ti = min(row.x + k, n_tris - 1);
        float t, u, v;
        if (tri_test(tris + 9 * ti, ox, oy, oz, dx, dy, dz, lo, hi, t, u,
                     v) &&
            (t < best || (t == best && ti < best_i))) {
          best = t;
          best_i = ti;
          bu = u;
          bv = v;
        }
      }
    }
    node = (hit && row.y == 0) ? node + 1 : row.z;
  }
  t_out[ray] = best;
  i_out[ray] = best_i;
  u_out[ray] = bu;
  v_out[ray] = bv;
}

__global__ void __launch_bounds__(kThreads)
tlas_kernel(const float4* __restrict__ tnodes, const int4* __restrict__ tmeta,
            int mt, const float* __restrict__ inst_rows,
            const int2* __restrict__ imeta, const float4* __restrict__ bnodes,
            const int4* __restrict__ bmeta, const float* __restrict__ tris,
            int n_tris, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ t_min,
            const float* __restrict__ t_max, int n,
            float* __restrict__ t_out, int* __restrict__ inst_out,
            int* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float lo = t_min[ray], hi = t_max[ray];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  // Walk state: TLAS node, current instance (-1 = in the TLAS), BLAS
  // node, the TLAS node to resume at, and the ray in the instance.
  int tnode = 0, inst = -1, bnode = 0, resume = 0, blas_end = 0;
  float lox = 0.f, loy = 0.f, loz = 0.f, ldx = 0.f, ldy = 0.f, ldz = 0.f;
  float lix = 0.f, liy = 0.f, liz = 0.f;

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f;
  int b_inst = -1, b_tri = 0;
  while (inst >= 0 || tnode < mt) {
    const float lim = minp(bt, hi);
    if (inst < 0) {
      const int4 row = __ldg(tmeta + tnode);
      const bool hit = slab(tnodes, tnode, ox, oy, oz, ix, iy, iz, lo, lim);
      if (hit && row.x >= 0) {
        const float* r = inst_rows + 12 * row.x;
        lox = ((__ldg(r + 0) * ox + __ldg(r + 1) * oy) + __ldg(r + 2) * oz)
              + __ldg(r + 9);
        loy = ((__ldg(r + 3) * ox + __ldg(r + 4) * oy) + __ldg(r + 5) * oz)
              + __ldg(r + 10);
        loz = ((__ldg(r + 6) * ox + __ldg(r + 7) * oy) + __ldg(r + 8) * oz)
              + __ldg(r + 11);
        ldx = (__ldg(r + 0) * dx + __ldg(r + 1) * dy) + __ldg(r + 2) * dz;
        ldy = (__ldg(r + 3) * dx + __ldg(r + 4) * dy) + __ldg(r + 5) * dz;
        ldz = (__ldg(r + 6) * dx + __ldg(r + 7) * dy) + __ldg(r + 8) * dz;
        lix = 1.0f / ldx;
        liy = 1.0f / ldy;
        liz = 1.0f / ldz;
        const int2 im = __ldg(imeta + row.x);
        inst = row.x;
        bnode = im.x;
        blas_end = im.y;
        resume = row.y;
      } else {
        tnode = hit ? tnode + 1 : row.y;
      }
      continue;
    }
    const int4 row = __ldg(bmeta + bnode);
    const bool hit = slab(bnodes, bnode, lox, loy, loz, lix, liy, liz, lo,
                          lim);
    if (hit && row.y > 0) {
      for (int k = 0; k < row.y; ++k) {
        const int ti = min(row.x + k, n_tris - 1);
        float t, u, v;
        if (tri_test(tris + 9 * ti, lox, loy, loz, ldx, ldy, ldz, lo, hi, t,
                     u, v) &&
            (t < bt ||
             (t == bt && (inst < b_inst || (inst == b_inst && ti < b_tri))))) {
          bt = t;
          b_inst = inst;
          b_tri = ti;
          bu = u;
          bv = v;
        }
      }
    }
    const int next = (hit && row.y == 0) ? bnode + 1 : row.z;
    if (next >= blas_end) {
      inst = -1;
      tnode = resume;
    } else {
      bnode = next;
    }
  }
  t_out[ray] = bt;
  inst_out[ray] = b_inst;
  tri_out[ray] = b_tri;
  u_out[ray] = bu;
  v_out[ray] = bv;
}

}  // namespace

extern "C" int mrt_sphere_bvh(const float* nodes, const int* meta, int m,
                              const float* sph, int s, const float* o,
                              const float* d, const float* t_min,
                              const float* t_max, int n, float* t_out,
                              int* i_out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  sphere_bvh_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const int4*>(meta), m,
      reinterpret_cast<const float4*>(sph), s, o, d, t_min, t_max, n, t_out,
      i_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrt_tri_bvh(const float* nodes, const int* meta, int m,
                           const float* tris, int n_tris, const float* o,
                           const float* d, const float* t_min,
                           const float* t_max, int n, float* t_out,
                           int* i_out, float* u_out, float* v_out,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  tri_bvh_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const int4*>(meta), m, tris, n_tris, o, d, t_min,
      t_max, n, t_out, i_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrt_tlas(const float* tnodes, const int* tmeta, int mt,
                        const float* inst, const int* imeta,
                        const float* bnodes, const int* bmeta,
                        const float* tris, int n_tris, const float* o,
                        const float* d, const float* t_min,
                        const float* t_max, int n, float* t_out,
                        int* inst_out, int* tri_out, float* u_out,
                        float* v_out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  tlas_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(tnodes),
      reinterpret_cast<const int4*>(tmeta), mt, inst,
      reinterpret_cast<const int2*>(imeta),
      reinterpret_cast<const float4*>(bnodes),
      reinterpret_cast<const int4*>(bmeta), tris, n_tris, o, d, t_min, t_max,
      n, t_out, inst_out, tri_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
