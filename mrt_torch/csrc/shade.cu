// Kernel M1, L3 shading (ops/shade.py): what materials/shade.py::shade_hit
// returns for a wavefront on a material table with no texture atlas and
// no Mix rows, in one launch.
//
//   M1 shade_kernel: for lane p with row r = material[p],
//     emitted[p]   = hit[p] ? emit[r] * (mtype[r] == DiffuseLight) : 0
//     attenuation[p], new_direction[p], scattered[p], lobe[p]
//                  = the scatter of mtype[r] (Lambertian, Metal,
//                    Dielectric, Isotropic, Specular; any other class,
//                    DiffuseLight and Null among them, does not scatter)
//   from the hit's normal and face, the incoming direction d_in[p] and the
//   four uniforms u1..u4 of the scatter sampler's next4 (kernel R1).
//
// It replaces no Pallas kernel: the reference shades in XLA
// (mrt/materials/shade.py).  It is a kernel because the eager composition
// is ~165 elementwise launches a wavefront step, each near the launch
// floor and each ~14-20 us of host dispatch, while the lanes' data is
// ~90 bytes in and out.  Every class is evaluated for every lane and the
// result selected by class, as the eager composition does; that keeps its
// values on every lane, the missed lanes too.
//
// Rounding: every float operation is one of the eager composition's, in
// its order.  The build passes --fmad=false, so no product is contracted
// into an add, and no fast-math intrinsics are used: sqrtf, sinf, cosf
// and the division round as PyTorch's CUDA kernels do.  The rules that
// matter:
//   - dot products are (x*x' + y*y') + z*z' (math/vec.py::dot);
//   - Python scalars are rounded to float32 first, as PyTorch rounds a
//     scalar operand to a float32 tensor's type (2*pi, 1e-5, 2^-25);
//   - torch.clamp is fmaxf/fminf with NaN passed through;
//   - the cube root of in_unit_sphere is pow(u, 1/3) in double, rounded;
//   - 1.0 / ior is PyTorch's reciprocal (1 / ior) times 1;
//   - Schlick's powers are x^2 = x*x, x^5 = x * ((x*x) * (x*x));
//   - refract's parallel part is n * -(k > 0 ? sqrt(k) : 0), so its zeros
//     keep the eager composition's signs.
// The outputs are bit-equal to the eager composition's on the card
// (tests/test_torch_gpu.py, chip_smoke.py phase 25).
//
// Bound: bytes.  One thread a lane reads the hit's normal, face, row and
// hit flag, its incoming direction and its four uniforms (46 B), its
// table row (class, albedo, fuzz, ior, emission: 40 B through the
// read-only path; the tables are L2-resident, 5 to 9,996 rows), and
// writes emission, attenuation and direction (36 B), the scattered flag
// and the lobe (5 B).  A row outside the table (which the eager
// composition's indexing refuses) reads nothing and shades as a class
// that does not scatter.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "rows.cuh"

namespace {

using mrt_rows::kThreads;

// materials/table.py's classes.
constexpr int kLambertian = 0;
constexpr int kMetal = 1;
constexpr int kDielectric = 2;
constexpr int kDiffuseLight = 3;
constexpr int kIsotropic = 4;
constexpr int kSpecular = 5;

// The Python constants as float32 operands: math/sampling.py's TAU
// (2 * math.pi), math/vec.py's NEAR_ZERO_EPS and in_unit_sphere's floor.
constexpr float kTau = static_cast<float>(6.283185307179586);
constexpr float kNearZero = static_cast<float>(1e-5);
constexpr float kCbrtFloor = 0x1p-25f;

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
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi) on the card.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* __restrict__ p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// vec.reflect: v - n * (2 * dot(v, n)).
__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  return sub(v, scale(n, 2.0f * dot(v, n)));
}

// vec.refract of the unit vector uv about n with the ratio eta, after its
// cos_theta = clamp(dot(-uv, n), max=1) (passed in: shading has it).
__device__ __forceinline__ V3 refract(V3 uv, V3 n, float cos_theta,
                                      float eta) {
  const V3 perp = scale(add(uv, scale(n, cos_theta)), eta);
  const float k = fabsf(1.0f - dot(perp, perp));
  const float safe = sqrtf(k > 0.0f ? k : 1.0f);
  const V3 parallel = scale(n, -(k > 0.0f ? safe : 0.0f));
  return add(perp, parallel);
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(const int* __restrict__ mtype_tab,
             const float* __restrict__ albedo_tab,
             const float* __restrict__ fuzz_tab,
             const float* __restrict__ ior_tab,
             const float* __restrict__ emit_tab, int rows,
             const float* __restrict__ normal_in,
             const bool* __restrict__ front_face_in,
             const int* __restrict__ material_in,
             const bool* __restrict__ hit_in,
             const float* __restrict__ d_in,
             const float* __restrict__ u1_in,
             const float* __restrict__ u2_in,
             const float* __restrict__ u3_in,
             const float* __restrict__ u4_in, int n,
             float* __restrict__ emitted_out, float* __restrict__ atten_out,
             float* __restrict__ dir_out, bool* __restrict__ scattered_out,
             int* __restrict__ lobe_out) {
  const int p = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (p >= n) return;
  const V3 normal = load3(normal_in, p);
  const V3 d = load3(d_in, p);
  const bool front_face = front_face_in[p];
  const bool hit = hit_in[p];
  const float u1 = u1_in[p], u2 = u2_in[p], u3 = u3_in[p], u4 = u4_in[p];

  // The lane's table row (a row outside the table: no class, zeros).
  const int row = material_in[p];
  int mtype = -1;
  V3 albedo{0.0f, 0.0f, 0.0f}, emit{0.0f, 0.0f, 0.0f};
  float fuzz = 0.0f, ior = 0.0f;
  if (static_cast<unsigned>(row) < static_cast<unsigned>(rows)) {
    mtype = __ldg(mtype_tab + row);
    albedo = {__ldg(albedo_tab + 4 * row), __ldg(albedo_tab + 4 * row + 1),
              __ldg(albedo_tab + 4 * row + 2)};
    fuzz = __ldg(fuzz_tab + row);
    ior = __ldg(ior_tab + row);
    emit = {__ldg(emit_tab + 3 * row), __ldg(emit_tab + 3 * row + 1),
            __ldg(emit_tab + 3 * row + 2)};
  }

  // Emission: emit * is_light, zero on a miss.
  const float light = mtype == kDiffuseLight ? 1.0f : 0.0f;
  const V3 e = hit ? scale(emit, light) : V3{0.0f, 0.0f, 0.0f};

  // sampling.unit_vector(u1, u2) and in_unit_sphere(u1, u2, u3).
  const float z = 1.0f - 2.0f * u1;
  const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = kTau * u2;
  const V3 rand_unit{r * cosf(phi), r * sinf(phi), z};
  const float cbrt = static_cast<float>(
      pow(static_cast<double>(clamp_min(u3, kCbrtFloor)), 1.0 / 3.0));
  const V3 unit_sphere = scale(rand_unit, cbrt);
  const float len = sqrtf(dot(d, d));
  const V3 unit_d{d.x / len, d.y / len, d.z / len};

  // Lambertian: normal + a random unit vector, the normal where that is
  // near zero.
  V3 lam_dir = add(normal, rand_unit);
  if (fabsf(lam_dir.x) <= kNearZero && fabsf(lam_dir.y) <= kNearZero &&
      fabsf(lam_dir.z) <= kNearZero) {
    lam_dir = normal;
  }

  // Metal: the mirror direction fuzzed; absorbed below the surface.
  const V3 refl_dir = reflect(unit_d, normal);
  const V3 metal_dir = add(refl_dir, scale(unit_sphere, fuzz));
  const bool metal_ok = dot(metal_dir, normal) > 0.0f;

  // Dielectric and Specular: the shared Fresnel choice.
  const float ratio = front_face ? (1.0f / ior) * 1.0f : ior;
  const float cos_theta = clamp_max(dot(neg(unit_d), normal), 1.0f);
  const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
  const bool cannot_refract = ratio * sin_theta > 1.0f;
  float r0 = (1.0f - ratio) / (ratio + 1.0f);
  r0 = r0 * r0;
  const float x = 1.0f - cos_theta;
  const float x2 = x * x;
  const float schlick = r0 + (1.0f - r0) * (x * (x2 * x2));
  const bool rc = cannot_refract || schlick > u4;
  const V3 refr_dir = refract(unit_d, normal, cos_theta, ratio);
  const V3 diel_dir = pick(rc, refl_dir, refr_dir);
  const V3 spec_dir = pick(rc, refl_dir, lam_dir);
  const V3 one{1.0f, 1.0f, 1.0f};

  const bool is_lam = mtype == kLambertian;
  const bool is_metal = mtype == kMetal;
  const bool is_diel = mtype == kDielectric;
  const bool is_iso = mtype == kIsotropic;
  const bool is_spec = mtype == kSpecular;
  const V3 dir = is_lam     ? lam_dir
                 : is_metal ? metal_dir
                 : is_diel  ? diel_dir
                 : is_iso   ? unit_sphere
                 : is_spec  ? spec_dir
                            : normal;
  const V3 atten = (is_lam || is_metal || is_iso) ? albedo
                   : is_spec                     ? pick(rc, one, albedo)
                                                 : one;
  const bool scattered =
      hit && (is_lam || is_diel || is_iso || is_spec || (is_metal && metal_ok));
  // 1: a cosine lobe (Lambertian, Specular's Lambertian outcome); 2: the
  // isotropic phase; 0 otherwise and where nothing scattered.
  const int lobe = !scattered                   ? 0
                   : (is_lam || (is_spec && !rc)) ? 1
                   : is_iso                       ? 2
                                                  : 0;

  store3(emitted_out, p, e);
  store3(atten_out, p, atten);
  store3(dir_out, p, dir);
  scattered_out[p] = scattered;
  lobe_out[p] = lobe;
}

}  // namespace

// Table: mtype (rows,) int32, albedo (rows, 4) float32 (its alpha unread),
// fuzz and ior (rows,), emit (rows, 3).  Lanes: normal and d_in (n, 3),
// front_face and hit (n,) bool, material (n,) int32, u1..u4 (n,) float32.
// Outputs: emitted, atten, dir (n, 3) float32, scattered (n,) bool, lobe
// (n,) int32.  Returns a cudaError_t.
extern "C" int mrt_shade(const int* mtype, const float* albedo,
                         const float* fuzz, const float* ior,
                         const float* emit, int rows, const float* normal,
                         const bool* front_face, const int* material,
                         const bool* hit, const float* d_in, const float* u1,
                         const float* u2, const float* u3, const float* u4,
                         int n, float* emitted, float* atten, float* dir,
                         bool* scattered, int* lobe, cudaStream_t stream) {
  if (n <= 0) return 0;
  return static_cast<int>(mrt_rows::launch_lanes(
      shade_kernel, n, stream, mtype, albedo, fuzz, ior, emit, rows, normal,
      front_face, material, hit, d_in, u1, u2, u3, u4, n, emitted, atten,
      dir, scattered, lobe));
}
