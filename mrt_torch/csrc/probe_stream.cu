// Probes P1-P3: can traversal tables be paged into on-chip memory, and
// how much on-chip memory does a block get?  Hopper counterparts of the
// TPU probes tools/probe_stream.py::probe_a (P1), probe_b (P2) and
// probe_c (P3), which asked the same of the TPU's SMEM.
//
// P1  one block copies page k (256 columns of each row) of an (8, 1024)
//     f32 and a (2, 1024) i32 table from global into shared memory and
//     sums f[1, 256k + 7] + i[0, 256k + 3] over k = 0..3, in that order.
//     Bound: the 40 KB it moves, a few ns at the card's memory rate; what
//     it pays is the round trip to L2/HBM, 457-478 ns a page, once per
//     page when the pages are copied one after another.  All four page
//     addresses are known at launch, so the design puts all four in
//     flight at once: each page has its own buffers and its own mbarrier,
//     armed by thread 0 with the page's 10,240 bytes; the page moves as
//     ten 1 KB bulk copies (cp.async.bulk, one a row), and all 40 are
//     started before the first wait.  A thread starts one bulk copy about
//     every 25 ns (lanes of one warp take turns), while copies from
//     different warps overlap, so the copies come from ten warps: warp r
//     starts row r of pages 0, 1, 2, 3 in turn.  Thread 0 then waits on
//     the barriers in page order.  No buffer is reused, so no fence
//     orders a read before a copy.  A 2-D TMA tensor map would move a
//     page of f in one instruction, but needs the driver's
//     cuTensorMapEncodeTiled; ten 1-D copies need nothing beyond the
//     runtime.  cycles[k] is the SM cycles (clock64) from just before the
//     first copy starts to thread 0 seeing page k's barrier complete: the
//     arrival time of page k with every page in flight, the cost of a
//     page prefetched behind other work.
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
//     and last word (x and 2x) and returns their sum, 3x.  Bound: one
//     launch (the card's floor, 1.2-1.5 us) and 8 bytes; on an SM whose
//     previous kernel ran with another shared-memory/L1 split, the switch
//     to the largest carveout too.  A block may have more than 48 KB of
//     dynamic shared memory only once the kernel's attribute allows it.
//     The TPU compiled a program for each scratch size; here the
//     attribute is raised once a device and process, at the first call,
//     to the card's opt-in limit, whatever size that call asks for.  A
//     call is then one launch, which a CUDA graph can capture, and a size
//     past the limit is refused by the launch itself.
//
// Bound: bytes (each moves at most 40 KB; launch latency dominates).

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kPage = 256;
constexpr int kCols = 4 * kPage;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialises n mbarriers, each completed by one arrival, and makes them
// visible to the copy engine (the async proxy) before their first use.
__device__ __forceinline__ void mbarrier_init(unsigned long long* bars,
                                              int n) {
  for (int b = 0; b < n; ++b)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bars + b))
                 : "memory");
  asm volatile(
      "fence.mbarrier_init.release.cluster;\n"
      "fence.proxy.async.shared::cta;\n" ::
          : "memory");
}

// The calling thread's arrival on `bar`, with the bytes of copies that
// the barrier must then see complete before its phase does.
__device__ __forceinline__ void mbarrier_expect(unsigned long long* bar,
                                                unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %0;\n" ::"r"(
          bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, its bytes counted on `bar` as they land.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One bulk copy that alone completes `bar`'s phase.  The fence orders
// this thread's earlier generic reads of `smem` before the copy engine's
// write.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbarrier_expect(bar, bytes);
  bulk_load(smem, gmem, bytes, bar);
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

// Ten warps: the launch is <<<1, 320>>>.
__global__ void probe_a_kernel(const float* __restrict__ f,
                               const int* __restrict__ i, float* out,
                               long long* cycles) {
  constexpr unsigned kRow = kPage * sizeof(float);  // 1 KB a row of a page
  __shared__ __align__(16) float fpage[4][8][kPage];
  __shared__ __align__(16) int ipage[4][2][kPage];
  __shared__ __align__(8) unsigned long long arrived[4];
  long long t0 = 0;  // thread 0's start
  if (threadIdx.x == 0) {
    mbarrier_init(arrived, 4);
    for (int k = 0; k < 4; ++k) mbarrier_expect(&arrived[k], 10 * kRow);
    t0 = clock64();
  }
  __syncthreads();
  const int r = threadIdx.x / 32;  // the row this warp copies
  if (threadIdx.x % 32 == 0) {
    for (int k = 0; k < 4; ++k) {
      if (r < 8)
        bulk_load(fpage[k][r], f + r * kCols + k * kPage, kRow, &arrived[k]);
      else
        bulk_load(ipage[k][r - 8], i + (r - 8) * kCols + k * kPage, kRow,
                  &arrived[k]);
    }
  }
  __syncthreads();  // all 40 copies in flight
  if (threadIdx.x != 0) return;
  long long t[4];
  float acc = 0.0f;
  for (int k = 0; k < 4; ++k) {
    mbarrier_wait(&arrived[k], 0);  // each barrier completes once
    t[k] = clock64() - t0;
    acc = acc + fpage[k][1][7] + static_cast<float>(ipage[k][0][3]);
  }
  for (int k = 0; k < 4; ++k) cycles[k] = t[k];
  out[0] = acc;
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
  if (variant == 0) mbarrier_init(&filled, 1);
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

// P3's attribute, raised once a device and process: its answer, kept.
constexpr int kMaxDevices = 64;
std::once_flag probe_c_raised[kMaxDevices];
int probe_c_answer[kMaxDevices];

}  // namespace

extern "C" int mrt_probe_a(const float* f, const int* i, float* out,
                           long long* cycles, cudaStream_t stream) {
  probe_a_kernel<<<1, 320, 0, stream>>>(f, i, out, cycles);
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
// dynamic shared memory to the card's opt-in limit (asked once a device
// and process, at the first call), and codes[1], this launch's (0, or a
// refusal for a size past the limit: both are results); returns 0, or
// the error of finding the device.
extern "C" int mrt_probe_c(const float* x, float* out, int bytes,
                           int* codes, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(probe_c_raised[dev], [dev] {
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(probe_c_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    probe_c_answer[dev] = static_cast<int>(e);
  });
  codes[0] = probe_c_answer[dev];
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
