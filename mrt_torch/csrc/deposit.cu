// Kernels B2, film segment-add, and B4, the pend film mode's masked
// deposit: one template, deposit_kernel<C, drop, pend>.
//
//   B2: film[idx[p], c] += vals[p, c]   for every valid lane p
//
// A lane is valid where 0 <= idx[p] < n_rows and, if a mask is given,
// mask[p] is set; no other lane's values are read.
//
// B2 replaces the TPU kernels mrt/ops/pallas_onehot.py::_kernel (wrapper
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
//
//   B4: dest[slot[p], c] += val[p, c]   for every lane p with die[p],
//                                       0 <= slot[p] < n_rows and any
//                                       val[p, :] != 0
//
// B4 replaces the TPU kernel mrt/ops/pallas_deposit.py::_kernel (wrapper
// deposit_add), which stages the lanes' slots and values through SMEM and
// runs a serial read-modify-write of each dying lane's 4 floats (the TPU
// has no scatter that can collide).  It is B2's kernel at C = 4 with
// pend set: the die flags are the mask, read before the slot, so a lane
// that does not die (about two thirds of them in a step) loads one byte
// and leaves; a dying lane then reads its slot, its four values in one
// 16-byte load, leaves where all four are zero, and adds them with one
// atomicAdd(float4*, float4).  Several lanes can die into one pixel in a
// step (claims are pixel-major, spp > 1), so plain stores would lose adds.
// Bound: bytes, the die byte of every lane; the slot of each dying lane
// and its 16 B of values where the slot is in range (read before the
// all-zero test can skip the lane); and 16 B read and written on each
// film row that a depositing lane touches; at
// the main path's 2^17 lanes that is well under the card's launch floor
// (1.16-1.38 us on the H100), so the design spends nothing beyond one
// load a byte for the lanes that stay and one vector atomic a deposit.
// The sums agree with the plain version to f32 reassociation and the
// bounce counts stay exact.  A lane that deposits nothing adds nothing
// here, where the plain version adds +0.0 to row 0: the same on a film
// whose row 0 is not -0.0 (the film starts at +0.0).

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

using mrt_rows::kThreads;

template <int C, bool drop, bool pend>
__global__ void __launch_bounds__(kThreads)
deposit_kernel(float* __restrict__ film, int n_rows,
               const int* __restrict__ idx,
               const unsigned char* __restrict__ mask,
               const float* __restrict__ vals, int lanes) {
  const int p = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (p >= lanes) return;
  const int row = mrt_rows::lane_row<pend>(idx, mask, n_rows, p);
  if (row < 0) return;
  float v[C];
  mrt_rows::load_row<C>(vals + static_cast<long long>(p) * C, v);
  if constexpr (drop) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = isfinite(v[c]) ? v[c] : 0.0f;
  }
  if constexpr (pend) {
    bool zero = true;
#pragma unroll
    for (int c = 0; c < C; ++c) zero = zero && v[c] == 0.0f;
    if (zero) return;
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

}  // namespace

// B4: die is one byte a lane (a bool tensor), never null.
extern "C" int mrt_deposit_pending(float* dest, int n_rows, const int* slot,
                                   const float* val, const unsigned char* die,
                                   int lanes, cudaStream_t stream) {
  if (lanes <= 0) return 0;
  return static_cast<int>(mrt_rows::launch_lanes(
      deposit_kernel<4, false, true>, lanes, stream, dest, n_rows, slot, die,
      val, lanes));
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
    auto kernel = drop_nonfinite ? deposit_kernel<C, true, false>
                                 : deposit_kernel<C, false, false>;
    return mrt_rows::launch_lanes(kernel, lanes, stream, film, n_rows, idx,
                                  mask, vals, lanes);
  }));
}

extern "C" const char* mrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
