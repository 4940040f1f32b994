// Kernel H1, L2 intersection (ops/hits.py): a scene's whole hit record
// from its primitive sets' winners, in one launch.
//
//   H1 hit_record_kernel: for lane p, the sets fold in scene order, from
//   geometry/hit.py::Hits.none (t = +inf, zeros elsewhere):
//     spheres   (t, index) of kernel B1 or B5, expanded as
//               geometry/spheres.py::make_hits;
//     instances (t, instance, triangle, u, v) of kernel B7 or of the flat
//               parts' B6 walk, expanded as geometry/instance.py::
//               expand_winner;
//   a set takes the lane where its t (+inf unless finite) is strictly
//   below the record's, so on equal t the earlier set keeps it, and hit
//   is the OR of the sets' hits (geometry/hit.py::Hits.closer_of).
//
// It replaces no Pallas kernel: the reference builds its records in XLA
// (mrt/geometry/scene.py).  It is a kernel because the eager chain is
// ~51 launches a call with spheres alone and ~150 with spheres and
// instances, each near the launch floor and each ~10 us of host dispatch,
// while a lane's data is ~120 bytes in and out.  A set's record is
// computed only on the lanes it takes: the others keep the fold's values,
// as the eager chain's where() keeps them.
//
// Rounding: every float operation is one of the eager chain's, in its
// order.  The build passes --fmad=false, so no product is contracted into
// an add, and no fast-math intrinsics are used: sqrtf and the divisions
// round as PyTorch's CUDA kernels do.  The rules that matter:
//   - dot products are (x*x' + y*y') + z*z' (math/vec.py::dot), and the
//     transform's rows dot the local vector the same way;
//   - the barycentric weight is (1 - u) - v, and an interpolation is
//     (a*w + b*u) + c*v;
//   - a sphere's outward normal is (point - c) / r, three IEEE divisions;
//     a triangle's world normal is divided by clamp(|n|, 1e-20), the bound
//     rounded from double as PyTorch rounds a scalar;
//   - the cross product is (ay*bz - az*by, az*bx - ax*bz, ax*by - ay*bx);
//   - the shading row's material is round-half-even, then truncated.
// The record is bit-equal to the eager chain's on the card
// (tests/test_torch_gpu.py, chip_smoke.py phase 26).
//
// Bound: bytes.  One thread a lane (grid-stride) reads its ray (24 B) and
// the sets' winners (8 B and 20 B), and writes the record's ten columns
// (70 B); the taken set's table rows (a sphere's 20 B; a shading row's
// 116 B, a transform's 36 B and an override's 4 B) are L2-resident.
// Rows are read at clamped indices, as the eager chain's clamp does.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "rows.cuh"

namespace {

using mrt_rows::kThreads;

// geometry/triangles.py::shading_table's row: na, nb, nc (0:9), uva, uvb,
// uvc (9:15), has_uv (15), material (16), tangent (17:20), bitangent
// (20:23), e_ab (23:26), e_ac (26:29).
constexpr int kShadingCols = 29;

// expand_winner's clamp(norm, 1e-20), the bound rounded as PyTorch rounds
// a Python scalar for a float32 tensor.
constexpr float kNormFloor = static_cast<float>(1e-20);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ V3 ldg3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}
__device__ __forceinline__ void store3(float* __restrict__ p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// (a*w + b*u) + c*v, componentwise.
__device__ __forceinline__ V3 interp3(V3 a, V3 b, V3 c, float w, float u,
                                      float v) {
  return add(add(scale(a, w), scale(b, u)), scale(c, v));
}

// torch.clamp(x, min=lo) on the card.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ int clamp_index(int i, int rows) {
  return i < 0 ? 0 : (i > rows - 1 ? rows - 1 : i);
}

// A lane's record as the fold builds it.
struct Record {
  float t = INFINITY;
  V3 point{0.0f, 0.0f, 0.0f}, normal{0.0f, 0.0f, 0.0f};
  V3 tangent{0.0f, 0.0f, 0.0f}, bitangent{0.0f, 0.0f, 0.0f};
  float u = 0.0f, v = 0.0f, prim_area = 0.0f;
  int material = 0;
  bool front_face = false, hit = false;
};

// The winner's t as the set's record holds it: +inf unless finite.
__device__ __forceinline__ float record_t(float t) {
  return isfinite(t) ? t : INFINITY;
}

__global__ void __launch_bounds__(kThreads)
hit_record_kernel(const float* __restrict__ o_in,
                  const float* __restrict__ d_in, int n,
                  const float* __restrict__ sph_t,
                  const int* __restrict__ sph_index,
                  const float* __restrict__ center,
                  const float* __restrict__ radius,
                  const int* __restrict__ sph_material, int spheres,
                  const float* __restrict__ inst_t,
                  const int* __restrict__ inst_id,
                  const int* __restrict__ inst_tri,
                  const float* __restrict__ inst_u,
                  const float* __restrict__ inst_v,
                  const float* __restrict__ shading, int tris,
                  const float* __restrict__ transform,
                  const int* __restrict__ override_tab, int instances,
                  float* __restrict__ t_out, float* __restrict__ point_out,
                  float* __restrict__ normal_out,
                  bool* __restrict__ front_face_out,
                  float* __restrict__ uv_out, int* __restrict__ material_out,
                  bool* __restrict__ hit_out,
                  float* __restrict__ tangent_out,
                  float* __restrict__ bitangent_out,
                  float* __restrict__ prim_area_out) {
  const int stride = static_cast<int>(gridDim.x) * kThreads;
  for (int p = static_cast<int>(blockIdx.x) * kThreads +
               static_cast<int>(threadIdx.x);
       p < n; p += stride) {
    Record rec;
    const V3 o = load3(o_in, p);
    const V3 d = load3(d_in, p);

    // Spheres: spheres.make_hits, then closer_of.
    if (sph_t != nullptr) {
      const float t = sph_t[p];
      const bool hit = isfinite(t);
      rec.hit = rec.hit || hit;
      if (record_t(t) < rec.t && spheres > 0) {
        const int s = clamp_index(sph_index[p], spheres);
        const V3 c = ldg3(center + 3 * s);
        const float r = __ldg(radius + s);
        const V3 point = add(o, scale(d, hit ? t : 0.0f));
        const V3 rel = sub(point, c);
        const V3 outward{rel.x / r, rel.y / r, rel.z / r};
        const bool front = dot(d, outward) < 0.0f;
        rec = Record{};
        rec.hit = true;
        rec.t = t;
        rec.point = point;
        rec.normal = front ? outward : neg(outward);
        rec.front_face = front;
        rec.material = __ldg(sph_material + s);
        rec.prim_area = -r;  // < 0: a sphere (the MIS pdf)
      }
    }

    // Instances: instance.expand_winner, then closer_of.
    if (inst_t != nullptr) {
      const float t = inst_t[p];
      const bool hit = isfinite(t);
      const bool any_hit = rec.hit || hit;
      if (record_t(t) < rec.t && instances > 0 && tris > 0) {
        const int i = clamp_index(inst_id[p], instances);
        const float* row = shading + kShadingCols * static_cast<int64_t>(
            clamp_index(inst_tri[p], tris));
        const float bu = inst_u[p], bv = inst_v[p];
        const float w = (1.0f - bu) - bv;
        const V3 normal_l = interp3(ldg3(row), ldg3(row + 3), ldg3(row + 6),
                                    w, bu, bv);
        const float uva[2] = {__ldg(row + 9), __ldg(row + 10)};
        const float uvb[2] = {__ldg(row + 11), __ldg(row + 12)};
        const float uvc[2] = {__ldg(row + 13), __ldg(row + 14)};
        const bool has_uv = __ldg(row + 15) > 0.5f;
        const float* m = transform + 16 * static_cast<int64_t>(i);
        const V3 lin0 = ldg3(m), lin1 = ldg3(m + 4), lin2 = ldg3(m + 8);
        const auto apply = [&](V3 x) -> V3 {
          return {dot(lin0, x), dot(lin1, x), dot(lin2, x)};
        };
        V3 normal_w = apply(normal_l);
        const float norm =
            clamp_min(sqrtf(dot(normal_w, normal_w)), kNormFloor);
        normal_w = {normal_w.x / norm, normal_w.y / norm, normal_w.z / norm};
        const int ov = __ldg(override_tab + i);
        const bool front = dot(d, normal_w) < 0.0f;
        const V3 e_ab = apply(ldg3(row + 23));
        const V3 e_ac = apply(ldg3(row + 26));
        const V3 cr = cross(e_ab, e_ac);
        rec = Record{};
        rec.t = t;
        rec.point = add(o, scale(d, hit ? t : 0.0f));
        rec.normal = front ? normal_w : neg(normal_w);
        rec.front_face = front;
        if (has_uv) {
          rec.u = (uva[0] * w + uvb[0] * bu) + uvc[0] * bv;
          rec.v = (uva[1] * w + uvb[1] * bu) + uvc[1] * bv;
        }
        rec.material =
            ov >= 0 ? ov : static_cast<int>(nearbyintf(__ldg(row + 16)));
        rec.tangent = apply(ldg3(row + 17));
        rec.bitangent = apply(ldg3(row + 20));
        rec.prim_area = 0.5f * sqrtf(dot(cr, cr));
      }
      rec.hit = any_hit;
    }

    t_out[p] = rec.t;
    store3(point_out, p, rec.point);
    store3(normal_out, p, rec.normal);
    front_face_out[p] = rec.front_face;
    uv_out[2 * p] = rec.u;
    uv_out[2 * p + 1] = rec.v;
    material_out[p] = rec.material;
    hit_out[p] = rec.hit;
    store3(tangent_out, p, rec.tangent);
    store3(bitangent_out, p, rec.bitangent);
    prim_area_out[p] = rec.prim_area;
  }
}

}  // namespace

// Rays: o, d (n, 3) float32.  Spheres (sph_t null: none): the winners'
// sph_t (n,) float32 and sph_index (n,) int32, the set's center (spheres,
// 3), radius (spheres,) float32 and material (spheres,) int32.  Instances
// (inst_t null: none): the winners' inst_t, inst_u, inst_v (n,) float32
// and inst_id, inst_tri (n,) int32, the TLAS's shading (tris, 29) and
// transform (instances, 4, 4) float32 and override (instances,) int32.
// Outputs: t, prim_area (n,) and point, normal, tangent, bitangent (n, 3)
// and uv (n, 2) float32, front_face and hit (n,) bool, material (n,)
// int32.  Returns a cudaError_t.
extern "C" int mrt_hit_record(
    const float* o, const float* d, int n, const float* sph_t,
    const int* sph_index, const float* center, const float* radius,
    const int* sph_material, int spheres, const float* inst_t,
    const int* inst_id, const int* inst_tri, const float* inst_u,
    const float* inst_v, const float* shading, int tris,
    const float* transform, const int* override_tab, int instances,
    float* t, float* point, float* normal, bool* front_face, float* uv,
    int* material, bool* hit, float* tangent, float* bitangent,
    float* prim_area, cudaStream_t stream) {
  if (n <= 0) return 0;
  return static_cast<int>(mrt_rows::launch_lanes(
      hit_record_kernel, n, stream, o, d, n, sph_t, sph_index, center, radius,
      sph_material, spheres, inst_t, inst_id, inst_tri, inst_u, inst_v,
      shading, tris, transform, override_tab, instances, t, point, normal,
      front_face, uv, material, hit, tangent, bitangent, prim_area));
}
