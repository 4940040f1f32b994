// Rows of C floats, one lane a thread: what kernels B2 (deposit.cu) and
// B3 (gather.cu) share.
//
// The column count C is a template parameter (1 to kMaxCols, the TPU
// gather's limit, mrt/ops/pallas_onehot.py::gather_usable), so a lane's
// offsets are multiplications by a constant and the row's loads and
// stores unroll.  A row of 4 floats moves as one 16-byte access, a row of
// 2 as one 8-byte access: the rows must be aligned to it, which the
// wrappers check (ops/_build.py::check_aligned).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace mrt_rows {

constexpr int kThreads = 256;  // lanes a block
constexpr int kMaxCols = 10;

// The row of C floats at src, through the read-only data path.
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(src + c);
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&v)[C]) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = v[c];
  }
}

// Lane p's row: idx[p] where the lane is valid (no mask or mask[p] set,
// and 0 <= idx[p] < rows), else -1.  The index is read once.
__device__ __forceinline__ int lane_row(const int* __restrict__ idx,
                                        const unsigned char* __restrict__ mask,
                                        int rows, int p) {
  const int row = __ldg(idx + p);
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(rows)) return -1;
  if (mask != nullptr && !__ldg(mask + p)) return -1;
  return row;
}

// f(std::integral_constant<int, C>{}) for C = cols, a column count from 1
// to kMaxCols; cudaErrorInvalidValue for any other count.
template <int C = 1, typename F>
cudaError_t by_cols(int cols, F&& f) {
  if constexpr (C > kMaxCols) {
    return cudaErrorInvalidValue;
  } else {
    return cols == C ? f(std::integral_constant<int, C>{})
                     : by_cols<C + 1>(cols, f);
  }
}

// Launches `kernel` with one thread a lane on `stream`; returns the
// launch's error (a refused launch never runs, and a later sync does not
// report it).
template <typename... Params, typename... Args>
cudaError_t launch_lanes(void (*kernel)(Params...), int lanes,
                         cudaStream_t stream, Args... args) {
  const int blocks = (lanes + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace mrt_rows
