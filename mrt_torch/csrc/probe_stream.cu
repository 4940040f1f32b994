// Probes P1-P3: can traversal tables be paged into on-chip memory, and
// how much on-chip memory does a block get?  Hopper counterparts of the
// TPU probes tools/probe_stream.py::probe_a (P1), probe_b (P2) and
// probe_c (P3), which asked the same of the TPU's SMEM.
//
// P1  one block copies page k (256 columns of each row) of an (8, 1024)
//     f32 and a (2, 1024) i32 table from global into shared memory with
//     cp.async, waits, and sums f[1, 256k + 7] + i[0, 256k + 3] over
//     k = 0..3.  Thread 0 times each page's copy in SM cycles (clock64).
// P2  one thread walks a 1,024-entry i32 chain (next = chain[e], until
//     -1) and counts the entries it visits.  Variant 0 keeps a 2-slot
//     page cache of 256 entries in shared memory (tags, round-robin
//     victim) and copies a page from global memory inside the loop on a
//     miss, as the TPU probe does, and counts its fills (0 for the other
//     variants); variant 1 reads global memory directly
//     through L2 (ld.global.cg, no L1); variant 2 walks a copy of the
//     whole chain in shared memory.  The walk is timed in SM cycles: the
//     cycles per dependent step are the residency numbers (a miss-paged
//     cache, L2, shared memory) that a traversal kernel's table placement
//     needs.
//     Variant 0's miss is one bulk asynchronous copy (cp.async.bulk, the
//     copy engine Hopper added beside the SM: one instruction moves the
//     1 KB page, and the engine counts the bytes it delivers on an
//     mbarrier in shared memory) where the thread would otherwise start
//     64 16-byte cp.async itself and wait on their group.  The thread
//     arms the barrier with the page's 1,024 bytes, starts the copy and
//     waits on the barrier's phase, which flips once a fill; a fence
//     orders its earlier reads of the victim slot before the copy engine
//     overwrites it.  The chain and the slots are 16-byte aligned and a
//     page is a multiple of 16 bytes, as the copy needs (the wrapper
//     checks the chain).
// P3  a block with a dynamic shared buffer of `bytes` writes its first
//     and last word (x and 2x) and returns their sum, 3x.  Past the
//     card's opt-in limit the attribute or the launch is refused; the
//     caller expects that and reports it.
//
// Bound: bytes (each moves at most 40 KB; launch latency dominates).

#include <cuda_runtime.h>

namespace {

constexpr int kPage = 256;
constexpr int kCols = 4 * kPage;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier that one arrival completes, made visible to the copy
// engine (the async proxy) before its first use.
__device__ __forceinline__ void mbarrier_init(unsigned long long* bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n"
      "fence.proxy.async.shared::cta;\n" ::"r"(smem_addr(bar))
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, its completion counted on `bar`: the
// calling thread's arrival, with the bytes the barrier must then see.
// The fence orders this thread's earlier generic reads of `smem` before
// the copy engine's write.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbarrier_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__global__ void probe_a_kernel(const float* __restrict__ f,
                               const int* __restrict__ i, float* out,
                               long long* cycles) {
  __shared__ __align__(16) float fpage[8][kPage];
  __shared__ __align__(16) int ipage[2][kPage];
  float acc = 0.0f;
  for (int k = 0; k < 4; ++k) {
    long long t0 = clock64();
    // 8 rows x 256 f32 = 512 chunks of 16 B, then 2 x 256 i32 = 128.
    for (int c = threadIdx.x; c < 640; c += blockDim.x) {
      if (c < 512) {
        const int r = c / 64, off = (c % 64) * 4;
        cp_async16(&fpage[r][off], f + r * kCols + k * kPage + off);
      } else {
        const int r = (c - 512) / 64, off = ((c - 512) % 64) * 4;
        cp_async16(&ipage[r][off], i + r * kCols + k * kPage + off);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x == 0) {
      cycles[k] = clock64() - t0;
      acc = acc + fpage[1][7] + static_cast<float>(ipage[0][3]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

__global__ void probe_b_kernel(const int* __restrict__ chain, int n,
                               int variant, int* visited, int* fills,
                               long long* cycles) {
  __shared__ __align__(16) int page[2][kPage];
  __shared__ int tags[2];
  __shared__ __align__(8) unsigned long long filled;
  extern __shared__ int whole[];
  if (variant == 2) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) whole[j] = chain[j];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  tags[0] = tags[1] = -1;
  if (variant == 0) mbarrier_init(&filled);
  unsigned phase = 0;
  int victim = 0, count = 0, misses = 0, e = 0;
  const long long t0 = clock64();
  while (e >= 0) {
    int next;
    if (variant == 0) {
      const int p = e / kPage;
      int slot = tags[0] == p ? 0 : (tags[1] == p ? 1 : -1);
      if (slot < 0) {
        slot = victim;
        victim ^= 1;
        bulk_copy(page[slot], chain + p * kPage, kPage * sizeof(int),
                  &filled);
        mbarrier_wait(&filled, phase);
        phase ^= 1;
        tags[slot] = p;
        ++misses;
      }
      next = page[slot][e - p * kPage];
    } else if (variant == 1) {
      next = __ldcg(chain + e);
    } else {
      next = whole[e];
    }
    e = next;
    ++count;
  }
  cycles[0] = clock64() - t0;
  visited[0] = count;
  fills[0] = misses;
}

__global__ void probe_c_kernel(const float* __restrict__ x, float* out,
                               int words) {
  extern __shared__ float scratch[];
  scratch[0] = x[0];
  scratch[words - 1] = x[0] * 2.0f;
  __syncthreads();
  out[0] = scratch[0] + scratch[words - 1];
}

}  // namespace

extern "C" int mrt_probe_a(const float* f, const int* i, float* out,
                           long long* cycles, cudaStream_t stream) {
  probe_a_kernel<<<1, 256, 0, stream>>>(f, i, out, cycles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrt_probe_b(const int* chain, int n, int variant,
                           int* visited, int* fills, long long* cycles,
                           cudaStream_t stream) {
  const size_t whole = variant == 2 ? n * sizeof(int) : 0;
  probe_b_kernel<<<1, 256, whole, stream>>>(chain, n, variant, visited,
                                            fills, cycles);
  return static_cast<int>(cudaGetLastError());
}

// Writes to host memory codes[0], the answer to raising the block's
// dynamic shared memory to `bytes`, and codes[1], the launch's (0 or a
// refusal: both are results); returns 0.
extern "C" int mrt_probe_c(const float* x, float* out, int bytes,
                           int* codes, cudaStream_t stream) {
  codes[0] = static_cast<int>(cudaFuncSetAttribute(
      probe_c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  cudaGetLastError();  // the launch below reports for itself
  probe_c_kernel<<<1, 1, bytes, stream>>>(x, out, bytes / 4);
  codes[1] = static_cast<int>(cudaGetLastError());
  return 0;
}

// The device attributes the probes report beside their results.
extern "C" int mrt_probe_attributes(int* smem_optin, int* clock_khz,
                                    cudaStream_t) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev);
  return static_cast<int>(err);
}
