// The lane coherence sorter's two kernels (ops/sort.py):
//
//   S1 sort_key_kernel: each lane's 30-bit coherence key,
//     key = (morton3(origin cell) << 12) | morton3(direction cell)
//   with 6 bits an axis of the origin's cell over a box (lo, inv) and 4
//   bits an axis of the unit direction's cell; an idle lane (item >=
//   total) gets INT_MAX, so it sorts after every active lane.
//
//   S2 permute_lanes_kernel: every per-lane column of the persistent
//   pool rewritten in the sorted order, out[p] = in[perm[p]], in one
//   launch.
//
// Neither replaces a Pallas kernel: the reference computes its sorter in
// XLA (mrt/integrator/persistent.py::_make_sorter, with jnp.argsort
// between the two halves; here torch.sort, stable, between S1 and S2).
// They are kernels because in PyTorch the key is two six-round Morton
// interleaves, ~150 launches a sort, and the permutation a gather a
// column, and the passes are paced by launches.
//
// S1 rounds like the reference, operation for operation: |d|^2 summed
// x, y, z; the root's reciprocal correctly rounded (__frsqrt_rn: the
// plain version takes it in float64 and rounds once); every product and
// sum with its own rounding (the __f*_rn intrinsics are never
// contracted).  A NaN propagates through the max as in jnp.maximum, and
// a NaN cell truncates to 0, as XLA converts it.
//
// Bound: bytes.  One thread a lane; S1 reads 8 + 12 + 12 bytes and writes
// 4, S2 reads its index and a lane's 64 bytes of columns (80 with the
// pend film mode's accumulator, moved as one float4) and writes them.
// The box is six floats in device memory, so a pass never syncs for it.

#include <cuda_runtime.h>

#include <climits>

#include "rows.cuh"

namespace {

using mrt_rows::kThreads;

// Interleave three 6-bit coordinates into an 18-bit Morton code (bit b
// of x at 3b, of y at 3b + 1, of z at 3b + 2).
__device__ __forceinline__ unsigned morton3(const unsigned (&c)[3]) {
  unsigned out = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    out |= (((c[0] >> b) & 1u) << (3 * b)) |
           (((c[1] >> b) & 1u) << (3 * b + 1)) |
           (((c[2] >> b) & 1u) << (3 * b + 2));
  }
  return out;
}

// trunc(clip(v, 0, hi)) with a NaN cell 0 (fmaxf returns the non-NaN
// operand).
__device__ __forceinline__ unsigned cell(float v, float hi) {
  return static_cast<unsigned>(fminf(fmaxf(v, 0.0f), hi));
}

__global__ void __launch_bounds__(kThreads)
sort_key_kernel(const long long* __restrict__ item,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ box, long long total, int lanes,
                int* __restrict__ keys) {
  const int p = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (p >= lanes) return;
  if (__ldg(item + p) >= total) {
    keys[p] = INT_MAX;
    return;
  }
  const long long base = 3ll * p;
  float dv[3], ov[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dv[c] = __ldg(d + base + c);
    ov[c] = __ldg(o + base + c);
  }
  float s = __fadd_rn(__fadd_rn(__fmul_rn(dv[0], dv[0]),
                                __fmul_rn(dv[1], dv[1])),
                      __fmul_rn(dv[2], dv[2]));
  s = s < 1e-20f ? 1e-20f : s;  // a NaN stays NaN, as in jnp.maximum
  const float r = __frsqrt_rn(s);
  unsigned dc[3], oc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dc[c] = cell(__fmul_rn(__fadd_rn(__fmul_rn(dv[c], r), 1.0f), 8.0f),
                 15.0f);
    oc[c] = cell(__fmul_rn(__fsub_rn(ov[c], __ldg(box + c)),
                           __ldg(box + 3 + c)),
                 63.0f);
  }
  keys[p] = static_cast<int>((morton3(oc) << 12) | morton3(dc));
}

struct Lanes {
  const long long* item;
  const long long* bounce;
  const long long* ray_id;
  const float* o;
  const float* d;
  const float* throughput;
  const float* prev_pdf;
  const float* acc;  // (P, 4), 16-byte aligned, or null
};

struct LanesOut {
  long long* item;
  long long* bounce;
  long long* ray_id;
  float* o;
  float* d;
  float* throughput;
  float* prev_pdf;
  float* acc;
};

__global__ void __launch_bounds__(kThreads)
permute_lanes_kernel(const long long* __restrict__ perm, int lanes,
                     Lanes in, LanesOut out) {
  const int p = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (p >= lanes) return;
  const long long q = __ldg(perm + p);
  out.item[p] = __ldg(in.item + q);
  out.bounce[p] = __ldg(in.bounce + q);
  out.ray_id[p] = __ldg(in.ray_id + q);
  out.prev_pdf[p] = __ldg(in.prev_pdf + q);
  const long long src = 3 * q, dst = 3ll * p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.o[dst + c] = __ldg(in.o + src + c);
    out.d[dst + c] = __ldg(in.d + src + c);
    out.throughput[dst + c] = __ldg(in.throughput + src + c);
  }
  if (in.acc != nullptr) {
    reinterpret_cast<float4*>(out.acc)[p] =
        __ldg(reinterpret_cast<const float4*>(in.acc) + q);
  }
}

}  // namespace

// box: lo[0..2] then inv[0..2], float32 on the device.  Returns a
// cudaError_t.
extern "C" int mrt_sort_keys(const long long* item, const float* o,
                             const float* d, const float* box,
                             long long total, int lanes, int* keys,
                             cudaStream_t stream) {
  if (lanes <= 0) return 0;
  return static_cast<int>(mrt_rows::launch_lanes(
      sort_key_kernel, lanes, stream, item, o, d, box, total, lanes, keys));
}

// perm: a permutation of [0, lanes) (int64).  The eight inputs, then the
// eight outputs, in Lanes' order; acc and acc_out both null or both set.
extern "C" int mrt_permute_lanes(
    const long long* perm, int lanes, const long long* item,
    const long long* bounce, const long long* ray_id, const float* o,
    const float* d, const float* throughput, const float* prev_pdf,
    const float* acc, long long* item_out, long long* bounce_out,
    long long* ray_id_out, float* o_out, float* d_out,
    float* throughput_out, float* prev_pdf_out, float* acc_out,
    cudaStream_t stream) {
  if (lanes <= 0) return 0;
  if ((acc == nullptr) != (acc_out == nullptr)) return cudaErrorInvalidValue;
  const Lanes in{item, bounce, ray_id, o, d, throughput, prev_pdf, acc};
  const LanesOut out{item_out, bounce_out, ray_id_out, o_out,
                     d_out, throughput_out, prev_pdf_out, acc_out};
  return static_cast<int>(mrt_rows::launch_lanes(
      permute_lanes_kernel, lanes, stream, perm, lanes, in, out));
}
