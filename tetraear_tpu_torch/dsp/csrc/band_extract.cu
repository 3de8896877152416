// Per-carrier band extraction: contiguous slices of the wideband
// spectrum copied into a (C, ...) batch.
//
// Replaces band_extract_rows and band_extract
// (tetraear_tpu/dsp/pallas_kernels.py: _rows_kernel, _extract_kernel),
// which issue one DMA per carrier.  Hopper's counterpart of that engine
// is the TMA bulk copy (cp.async.bulk); the rows form moves its data
// with it, through shared memory.
//
// The rows form: planes (2, R, 128) float32 re/im planes; segment (c, pl)
// is bytes [(pl R + row_start[c]) 512, + P 512) -> out bytes
// (2 c + pl) P 512.  Bound by device memory: the distinct source bytes
// read once plus the output written once.  Bands overlap (on the 25 kHz
// grid carriers sit 2,844 bins apart with n_band 8192), so a copy of
// each band on its own reads most source bytes several times.  The host
// plan (cuda_kernels.ExtractPlan) sorts the segments by source offset,
// merges overlapping ones into runs, cuts each run into chunks of at
// most kStageBytes and lists the stores each chunk feeds: (destination,
// offset in the chunk, bytes), every one a multiple of 16 (a row is 512
// bytes).  extract_staged_kernel walks that table:
//   * a persistent grid (two CTAs an SM), each CTA a contiguous range of
//     chunks of about equal bytes;
//   * one elected thread keeps a ring of kStages stages loaded with
//     cp.async.bulk global -> shared, each completing on its mbarrier
//     (expect_tx: the chunk's bytes), kStages - 1 loads in flight;
//   * a loaded stage goes to every band that covers it with
//     cp.async.bulk shared -> global stores, one bulk group a chunk; a
//     stage is loaded again once cp.async.bulk.wait_group.read says
//     every group but the newest has read its stage.
//
// The pairs form: x (N, 2) float32 [re, im] pairs; out[c] =
// x[start[c] : start[c] + n_band].  Its callers' n_band is a power of two
// below 128 (the channelizer takes it only where n_band is no multiple
// of 128), so a band is at most 512 bytes and a launch is latency-bound:
// extract_pairs_kernel copies each band with its CTA's threads, no
// stage between.  An even start and n_band copy 16 bytes at a time; an
// odd start lies 8 bytes off a 16-byte boundary while its destination
// is on one, so two 8-byte loads make each 16-byte store; an odd n_band
// goes pair by pair.
#include "common.cuh"

namespace {

constexpr int kStages = 4;
constexpr int kStageBytes = 16384;
constexpr int kThreads = 32;
constexpr int kSmemBytes = kStages * kStageBytes + kStages * 8;

// the plan's table, after the CTAs' chunk bounds (n_ctas + 1 int64):
// n_chunks + 1 chunks (the last one a sentinel holding the store count),
// then the stores
struct Chunk {
  long long src;  // byte offset of the load, 16-byte aligned
  int bytes;      // a multiple of 16, at most kStageBytes
  int store0;     // the chunk's stores are [store0, next chunk's store0)
};
struct Store {
  long long dst;  // byte offset in the output
  int smem;       // byte offset in the stage
  int bytes;      // a multiple of 16
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(char* stage, const char* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(stage)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, const char* stage,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(stage)), "r"(bytes) : "memory");
}

// one warp a CTA, of which one thread issues every copy: the bulk copies
// take no thread's time
__global__ void __launch_bounds__(kThreads)
extract_staged_kernel(const char* __restrict__ src, char* __restrict__ out,
                      const long long* __restrict__ table, int n_ctas,
                      int n_chunks) {
  extern __shared__ __align__(128) char smem[];
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const Chunk* chunks = reinterpret_cast<const Chunk*>(table + n_ctas + 1);
  const Store* stores = reinterpret_cast<const Store*>(chunks + n_chunks + 1);
  const int first = static_cast<int>(table[blockIdx.x]);
  const int n = static_cast<int>(table[blockIdx.x + 1]) - first;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int j = 0; j < kStages - 1 && j < n; ++j) {
    const Chunk ch = chunks[first + j];
    bulk_load(smem + j * kStageBytes, src + ch.src, ch.bytes, &full[j]);
  }
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const char* stage = smem + st * kStageBytes;
    bar_wait(&full[st], (i / kStages) & 1);
    const int s1 = chunks[first + i + 1].store0;
    for (int k = chunks[first + i].store0; k < s1; ++k) {
      const Store d = stores[k];
      bulk_store(out + d.dst, stage + d.smem, d.bytes);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the stage of chunk i - 1 is read once only chunk i's group is left;
    // chunk i + kStages - 1 goes there
    asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    const int j = i + kStages - 1;
    if (j < n) {
      const Chunk ch = chunks[first + j];
      bulk_load(smem + (j % kStages) * kStageBytes, src + ch.src, ch.bytes,
                &full[j % kStages]);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(256)
extract_pairs_kernel(const float2* __restrict__ x,
                     const long long* __restrict__ start,
                     float2* __restrict__ out, int n_band) {
  const long long s = start[blockIdx.x];
  const float2* src = x + s;
  float2* dst = out + static_cast<long long>(blockIdx.x) * n_band;
  const int first = blockIdx.y * blockDim.x + threadIdx.x;
  const int stride = gridDim.y * blockDim.x;
  if (n_band & 1) {
    for (int i = first; i < n_band; i += stride) dst[i] = __ldg(src + i);
    return;
  }
  const int n_vec = n_band >> 1;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  if ((s & 1) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int v = first; v < n_vec; v += stride) dst4[v] = __ldg(src4 + v);
  } else {
    for (int v = first; v < n_vec; v += stride) {
      const float2 a = __ldg(src + 2 * v);
      const float2 b = __ldg(src + 2 * v + 1);
      dst4[v] = make_float4(a.x, a.y, b.x, b.y);
    }
  }
}

}  // namespace

extern "C" int tt_band_extract_staged(const void* src, void* out,
                                      const void* table, int n_ctas,
                                      int n_chunks, void* stream) {
  // the shared-memory limit once a device: a launch of a few
  // microseconds is otherwise paced by the host's calls
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!(ready >> dev & 1)) {
    e = cudaFuncSetAttribute(extract_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    ready |= 1ull << dev;
  }
  extract_staged_kernel<<<n_ctas, kThreads, kSmemBytes,
                          (cudaStream_t)stream>>>(
      (const char*)src, (char*)out, (const long long*)table, n_ctas,
      n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int tt_band_extract_pairs(const void* x, const void* start,
                                     void* out, int n_band, int n_carriers,
                                     void* stream) {
  // a warp for each 32 copies of a band up to 256 threads, so that the
  // short bands of the real grids (n_band 64: 32 copies) fill the SMs
  // with small CTAs
  const int copies = (n_band & 1) ? n_band : n_band / 2;
  const int threads = copies >= 256 ? 256 : (copies + 31) / 32 * 32;
  int chunks = copies / 1024;               // 4 copies a thread
  chunks = chunks < 1 ? 1 : (chunks > 16 ? 16 : chunks);
  extract_pairs_kernel<<<dim3(n_carriers, chunks), threads, 0,
                         (cudaStream_t)stream>>>(
      (const float2*)x, (const long long*)start, (float2*)out, n_band);
  return (int)cudaGetLastError();
}
