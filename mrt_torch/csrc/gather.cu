// Kernel B3: row gather.
//
//   out[p, c] = table[idx[p], c]   for 0 <= idx[p] < rows, else 0
//
// Replaces the TPU kernel mrt/ops/pallas_onehot.py::_gather_kernel
// (wrapper onehot_gather), the expand half of lane compaction
// (compact.expand_rows).  The TPU builds a hi/lo one-hot matrix and
// multiplies it with a three-way bf16 split of the table, because its
// gathers lower to a serial loop; here each output element is one load
// from the table, so the copy is exact by construction.
//
// Bound: bytes.  Each lane's index is read once (a block stages its
// lanes' indices in shared memory), each output element is written once,
// and neighbouring threads write neighbouring elements of the block's
// contiguous (lanes x cols) tile.  The table rows are read at random; a
// compaction table (K x C floats, C <= 10) stays in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;  // lanes per block, one index each thread

__global__ void __launch_bounds__(kLanes)
row_gather_kernel(const float* __restrict__ table, int rows, int cols,
                  const int* __restrict__ idx, int lanes,
                  float* __restrict__ out) {
  __shared__ int row_of[kLanes];
  const long long first = static_cast<long long>(blockIdx.x) * kLanes;
  const int n = static_cast<int>(min(static_cast<long long>(kLanes),
                                     lanes - first));
  if (static_cast<int>(threadIdx.x) < n) {
    row_of[threadIdx.x] = idx[first + threadIdx.x];
  }
  __syncthreads();
  float* dst = out + first * cols;
  const int elems = n * cols;
  for (int e = threadIdx.x; e < elems; e += kLanes) {
    const int lane = e / cols;
    const int row = row_of[lane];
    const int col = e - lane * cols;
    dst[e] = (row >= 0 && row < rows)
                 ? __ldg(table + static_cast<long long>(row) * cols + col)
                 : 0.0f;
  }
}

}  // namespace

extern "C" int mrt_gather(const float* table, int rows, int cols,
                          const int* idx, int lanes, float* out,
                          cudaStream_t stream) {
  if (lanes <= 0 || cols <= 0) return 0;
  const int blocks = (lanes + kLanes - 1) / kLanes;
  row_gather_kernel<<<blocks, kLanes, 0, stream>>>(table, rows, cols, idx,
                                                   lanes, out);
  return static_cast<int>(cudaGetLastError());
}
