// Kernel B3: row gather.
//
//   out[p, c] = table[idx[p], c]   where the lane is valid, else 0
//
// A lane is valid where 0 <= idx[p] < rows and, if a mask is given,
// mask[p] is set (the expand half of lane compaction passes its prefix
// positions and its mask as they are, compact.expand_rows).
//
// Replaces the TPU kernel mrt/ops/pallas_onehot.py::_gather_kernel
// (wrapper onehot_gather).  The TPU builds a hi/lo one-hot matrix and
// multiplies it with a three-way bf16 split of the table, because its
// gathers lower to a serial loop; here each lane copies its row, so the
// copy is exact by construction.
//
// Bound: bytes, and at the main path's 2^17 lanes the launch itself.
// One thread a lane, the column count compiled in (rows.cuh): a lane
// reads its index (and mask byte) once, loads its row and stores it; at
// C = 4 (the atlas's RGBA) that is one 16-byte load and one 16-byte
// store.  The table rows are read at random; a compaction table (K x C
// floats, C <= 10) stays in L2.

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

using mrt_rows::kThreads;

template <int C>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ table, int rows,
                  const int* __restrict__ idx,
                  const unsigned char* __restrict__ mask, int lanes,
                  float* __restrict__ out) {
  const int p = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (p >= lanes) return;
  float v[C];
  const int row = mrt_rows::lane_row(idx, mask, rows, p);
  if (row >= 0) {
    mrt_rows::load_row<C>(table + static_cast<long long>(row) * C, v);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  }
  mrt_rows::store_row<C>(out + static_cast<long long>(p) * C, v);
}

}  // namespace

// mask: one byte a lane (a bool tensor) or null.  Returns a cudaError_t;
// cudaErrorInvalidValue for a column count outside 1..kMaxCols.
extern "C" int mrt_gather(const float* table, int rows, int cols,
                          const int* idx, const unsigned char* mask,
                          int lanes, float* out, cudaStream_t stream) {
  if (lanes <= 0) return 0;
  return static_cast<int>(mrt_rows::by_cols(cols, [&](auto c) {
    return mrt_rows::launch_lanes(row_gather_kernel<decltype(c)::value>,
                                  lanes, stream, table, rows, idx, mask,
                                  lanes, out);
  }));
}
