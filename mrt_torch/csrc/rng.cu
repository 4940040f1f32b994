// Kernel R1, the sampler's draw (ops/rng.py): four uniform floats a lane
// from the PCG4D hash of (ray_id, salt + 0x9E3779B9 * draw, seed,
// (seed << 8) ^ draw), as math/rng.py::Sampler.next4 computes them.
//
//   R1 pcg4d_kernel: out[r, p] = (h_r >> 8) * 2^-24, r = 0..3, where
//   (h_0, h_1, h_2, h_3) = pcg4d(x, y, z, w) for lane p.
//
// It replaces no Pallas kernel: the reference draws in XLA
// (mrt/math/rng.py).  It is a kernel because PyTorch has no unsigned
// 32-bit arithmetic on every device, so the plain version carries uint32
// values in int64 tensors, builds each 32-bit product from 16-bit halves
// and masks every result: about 137 launches a draw, and the persistent
// pass draws twice a step.  Here each lane computes in native uint32,
// whose wrap-around is the plain version's masking, so the two agree bit
// for bit; the top 24 bits convert to float exactly and the scale is a
// power of two.
//
// Bound: bytes.  One thread a lane reads its ray id (8 bytes; a
// per-lane salt 8 more) and writes four floats, one a row of the (4, N)
// output, so each row's stores are coalesced.  The seed and a 0-d salt
// are read from device memory where they are tensors, so a CUDA graph
// can replay the kernel with new values; an int seed or salt and the
// draw counter come as arguments.  The low 32 bits of each int64 are
// taken, which is the plain version's & 0xFFFFFFFF for negative values
// too.

#include <cuda_runtime.h>

#include <cstdint>

#include "rows.cuh"

namespace {

using mrt_rows::kThreads;

constexpr uint32_t kMul = 1664525u;
constexpr uint32_t kInc = 1013904223u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ float unit_float(uint32_t u) {
  return static_cast<float>(u >> 8) * 0x1p-24f;
}

__global__ void __launch_bounds__(kThreads)
pcg4d_kernel(const long long* __restrict__ ray_id, int n,
             const long long* __restrict__ seed_ptr, uint32_t seed,
             const long long* __restrict__ salt_ptr, int salt_per_lane,
             uint32_t salt, uint32_t draw, float* __restrict__ out) {
  const int p = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (p >= n) return;
  if (seed_ptr != nullptr) seed = static_cast<uint32_t>(__ldg(seed_ptr));
  if (salt_ptr != nullptr) {
    salt = static_cast<uint32_t>(__ldg(salt_ptr + (salt_per_lane ? p : 0)));
  }
  uint32_t x = static_cast<uint32_t>(__ldg(ray_id + p));
  uint32_t y = salt + kGolden * draw;
  uint32_t z = seed;
  uint32_t w = (seed << 8) ^ draw;
  x = x * kMul + kInc;
  y = y * kMul + kInc;
  z = z * kMul + kInc;
  w = w * kMul + kInc;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  const long long row = n;
  out[p] = unit_float(x);
  out[row + p] = unit_float(y);
  out[2 * row + p] = unit_float(z);
  out[3 * row + p] = unit_float(w);
}

}  // namespace

// ray_id: n int64; seed_ptr, salt_ptr: int64 in device memory or null (then
// the value argument is used); salt_per_lane: salt_ptr holds n values, else
// one; out: (4, n) float32.  Returns a cudaError_t.
extern "C" int mrt_pcg4d(const long long* ray_id, int n,
                         const long long* seed_ptr, uint32_t seed,
                         const long long* salt_ptr, int salt_per_lane,
                         uint32_t salt, uint32_t draw, float* out,
                         cudaStream_t stream) {
  if (n <= 0) return 0;
  return static_cast<int>(mrt_rows::launch_lanes(
      pcg4d_kernel, n, stream, ray_id, n, seed_ptr, seed, salt_ptr,
      salt_per_lane, salt, draw, out));
}
