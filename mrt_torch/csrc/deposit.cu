// Kernel B2: film segment-add.
//
//   film[idx[p], c] += vals[p, c]   for every lane p with 0 <= idx[p] < n_rows
//
// Replaces the TPU kernels mrt/ops/pallas_onehot.py::_kernel (wrapper
// onehot_deposit) and ::_kernel_f32 (onehot_deposit_f32).  Those build a
// one-hot matrix and sum through the matrix unit, with each f32 value
// split into three bf16 terms; here each element is one float atomicAdd
// into the film, which computes the same segment-sum directly.  Lanes
// with an index outside [0, n_rows) are dropped.  With drop_nonfinite,
// non-finite values are skipped, as _kernel_f32 and the film's NaN guard
// do.
//
// Bound: atomic throughput to the film rows (about 2^17 x 4 updates a
// step on the main path, spread over a 1920x1080 film).  Neighbouring
// threads take neighbouring columns of one lane, so a lane's four adds
// hit one 16-byte row.  Atomics make the order of the adds vary from run
// to run: sums agree with the plain version to f32 reassociation; the
// integer bounce counts (< 2^24) stay exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
deposit_kernel(float* __restrict__ film, int n_rows, int cols,
               const int* __restrict__ idx, const float* __restrict__ vals,
               int lanes, int drop_nonfinite) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(lanes) * cols) return;
  const int lane = static_cast<int>(e / cols);
  const int col = static_cast<int>(e - static_cast<long long>(lane) * cols);
  const int row = idx[lane];
  if (row < 0 || row >= n_rows) return;
  const float v = vals[e];
  if (drop_nonfinite && !isfinite(v)) return;
  atomicAdd(film + static_cast<long long>(row) * cols + col, v);
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
// lane and column, as B2 does: it leaves at once where the lane does not
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

extern "C" int mrt_deposit(float* film, int n_rows, int cols, const int* idx,
                           const float* vals, int lanes, int drop_nonfinite,
                           cudaStream_t stream) {
  const long long total = static_cast<long long>(lanes) * cols;
  if (total <= 0) return 0;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  deposit_kernel<<<blocks, kThreads, 0, stream>>>(film, n_rows, cols, idx,
                                                  vals, lanes, drop_nonfinite);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
