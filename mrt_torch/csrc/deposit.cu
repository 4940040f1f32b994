// Kernel B2: film segment-add.
//
//   film[idx[p], c] += vals[p, c]   for every valid lane p
//
// A lane is valid where 0 <= idx[p] < n_rows and, if a mask is given,
// mask[p] is set; no other lane's values are read.
//
// Replaces the TPU kernels mrt/ops/pallas_onehot.py::_kernel (wrapper
// onehot_deposit) and ::_kernel_f32 (onehot_deposit_f32).  Those build a
// one-hot matrix and sum through the matrix unit, with each f32 value
// split into three bf16 terms; here each lane adds its row into the film
// with atomics, which computes the same segment-sum directly.  With
// drop_nonfinite a non-finite value adds +0.0 in its place, as
// _kernel_f32 and the film's NaN guard drop it (and as the plain version
// adds it, so the two agree on a -0.0 film entry too).
//
// Bound: bytes, and at the main path's 2^17 lanes the launch itself.
// One thread a lane, the column count compiled in (rows.cuh): a lane reads
// its index (and mask byte) once, loads its row and adds it.  At C = 4
// (the film: radiance and bounce count) that is one 16-byte load and one
// atomicAdd(float4*, float4), Hopper's vector atomic (global memory, each
// element atomic on its own): a quarter of the L2 atomic operations of one
// float atomic an element; at C = 2 one atomicAdd(float2*, float2); other
// counts, C float atomics from the one thread.  As compaction's placer
// (ops/compact.py) every row is hit once.  Atomics make the order of the
// adds vary from run to run: sums agree with the plain version to f32
// reassociation; the integer bounce counts (< 2^24) stay exact, and unique
// rows are bit-equal.

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

using mrt_rows::kThreads;

template <int C, bool drop>
__global__ void __launch_bounds__(kThreads)
deposit_kernel(float* __restrict__ film, int n_rows,
               const int* __restrict__ idx,
               const unsigned char* __restrict__ mask,
               const float* __restrict__ vals, int lanes) {
  const int p = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (p >= lanes) return;
  const int row = mrt_rows::lane_row(idx, mask, n_rows, p);
  if (row < 0) return;
  float v[C];
  mrt_rows::load_row<C>(vals + static_cast<long long>(p) * C, v);
  if (drop) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = isfinite(v[c]) ? v[c] : 0.0f;
  }
  float* dst = film + static_cast<long long>(row) * C;
  if constexpr (C == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dst + c, v[c]);
  }
}

// Kernel B4: the pend film mode's masked deposit.
//
//   dest[slot[p], c] += val[p, c]   for every lane p with die[p] and any
//                                   val[p, :] != 0, 0 <= slot[p] < n_rows
//
// Replaces the TPU kernel mrt/ops/pallas_deposit.py::_kernel (wrapper
// deposit_add).  That one stages the lanes' slots and values through
// SMEM and runs a serial read-modify-write of each dying lane's 4 floats
// (the TPU has no scatter that can collide).  Here one thread takes one
// lane and column: it leaves at once where the lane does not
// die or its four values are all zero (a third or fewer of the lanes die
// in a step), and the rest do one float atomicAdd.  Several lanes can die
// into one pixel in one step (claims are pixel-major, spp > 1), so plain
// stores would lose adds.  The sums agree with the plain version to f32
// reassociation; the integer bounce counts (< 2^24) stay exact.
//
// Bound: bytes.  Each lane's die flag (1 B) and slot (4 B) are read, the
// dying lanes' values (16 B) and their film rows (16 B read and written).
__global__ void __launch_bounds__(kThreads)
deposit_pending_kernel(float* __restrict__ dest, int n_rows,
                       const int* __restrict__ slot,
                       const float* __restrict__ val,
                       const unsigned char* __restrict__ die, int lanes) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(lanes) * 4) return;
  const int lane = static_cast<int>(e >> 2);
  if (!die[lane]) return;
  const float* v = val + static_cast<long long>(lane) * 4;
  if (v[0] == 0.0f && v[1] == 0.0f && v[2] == 0.0f && v[3] == 0.0f) return;
  const int row = slot[lane];
  if (row < 0 || row >= n_rows) return;
  const int col = static_cast<int>(e & 3);
  atomicAdd(dest + static_cast<long long>(row) * 4 + col, v[col]);
}

}  // namespace

extern "C" int mrt_deposit_pending(float* dest, int n_rows, const int* slot,
                                   const float* val, const unsigned char* die,
                                   int lanes, cudaStream_t stream) {
  const long long total = static_cast<long long>(lanes) * 4;
  if (total <= 0) return 0;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  deposit_pending_kernel<<<blocks, kThreads, 0, stream>>>(dest, n_rows, slot,
                                                          val, die, lanes);
  return static_cast<int>(cudaGetLastError());
}

// mask: one byte a lane (a bool tensor) or null.  Returns a cudaError_t;
// cudaErrorInvalidValue for a column count outside 1..kMaxCols.
extern "C" int mrt_deposit(float* film, int n_rows, int cols, const int* idx,
                           const unsigned char* mask, const float* vals,
                           int lanes, int drop_nonfinite,
                           cudaStream_t stream) {
  if (lanes <= 0) return 0;
  return static_cast<int>(mrt_rows::by_cols(cols, [&](auto c) {
    constexpr int C = decltype(c)::value;
    auto kernel = drop_nonfinite ? deposit_kernel<C, true>
                                 : deposit_kernel<C, false>;
    return mrt_rows::launch_lanes(kernel, lanes, stream, film, n_rows, idx,
                                  mask, vals, lanes);
  }));
}

extern "C" const char* mrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
