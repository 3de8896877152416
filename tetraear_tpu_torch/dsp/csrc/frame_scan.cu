// Standalone even-position sync + burst-CRC scan of bit rows.
//
// Replaces frame_scan_even (tetraear_tpu/dsp/pallas_kernels.py:
// _frame_scan_kernel / _scan_rows).  The TPU kernel evaluates the scan
// as im2col matmuls against selector tables on (C, R, 128) padded rows,
// shapes that exist for its matrix unit; none of that carries over.
// One block per (carrier row, segment of seg even positions), seg a
// multiple of SCAN_K chosen by the C entry so that the segments divide
// the row nearly evenly and a block's threads each take one run:
//   * packing: a thread builds one 32-bit word of z from the 32 bytes of
//     the row it covers, read as aligned 16-byte vectors (three when the
//     row's start is not 16-byte aligned, which is the rule: rows are n
//     bytes apart), each vector's 16 low bits gathered by a multiply and
//     a shift a word; bits past the row's end are zero (the reference's
//     zero pad).  No lane reads a single byte;
//   * scanning: a thread takes a run of SCAN_K neighbouring even
//     positions (scan_run, scan.cuh: the first in full, the rest by the
//     sliding step): corr[pe] = n_agree * (1/22) for pe < (n - 22)/2 + 1
//     and the forward CRC-16 syndrome weight crc_err[pe] for
//     pe < (n - 230)/2 + 1 (99 for an all-zero or all-one data view);
//   * storing: the verdicts are staged in shared memory (pitch SCAN_K + 1,
//     free of bank conflicts) and leave as 16-byte vectors; a plane's rows
//     start on 4-byte boundaries only, so up to three elements of head
//     and tail are stored singly.
// Both planes come out at their final widths.  The scan is forward-only:
// the reference's tables duplicate the forward columns into the reversed
// half, so its min(e_fwd, e_rev) is e_fwd.
//
// Bound by the integer instruction rate, not by bytes (n bytes in and 8 bytes
// out per even position, about 26 KB a carrier at n = 5266): see
// scan.cuh for the count and for what the sliding step saves.
#include <string.h>

#include "scan.cuh"

// positions a thread slides through: the blocks are small and many to an
// SM, so the longer run (fewer positions evaluated in full) is the faster
#define SCAN_K 16
#define SCAN_MAX_THREADS 256

namespace {

// the low bits of the 16 bytes of v, byte j to bit j
__device__ __forceinline__ unsigned pack16(uint4 v) {
  const unsigned m = 0x01010101u, g = 0x01020408u;
  return (((v.x & m) * g) >> 24) | ((((v.y & m) * g) >> 24) << 4)
         | ((((v.z & m) * g) >> 24) << 8) | ((((v.w & m) * g) >> 24) << 12);
}

__device__ __forceinline__ int staged(int i) { return i + i / SCAN_K; }

// count staged words to dst, in 16-byte vectors where dst allows
__device__ __forceinline__ void store_row(unsigned* dst, const unsigned* s,
                                          int count) {
  if (count <= 0) return;
  int head = (int)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3);
  if (head > count) head = count;
  const int nvec = (count - head) >> 2;
  const int tail0 = head + 4 * nvec;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = s[staged(threadIdx.x)];
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int i = head + 4 * v;
    *reinterpret_cast<uint4*>(dst + i) =
        make_uint4(s[staged(i)], s[staged(i + 1)], s[staged(i + 2)],
                   s[staged(i + 3)]);
  }
  const int i = tail0 + threadIdx.x;
  if (i < count) dst[i] = s[staged(i)];
}

__global__ void __launch_bounds__(SCAN_MAX_THREADS)
frame_scan_kernel(const unsigned char* __restrict__ bits,
                  long long total_bytes,
                  const __grid_constant__ tt::ScanTab tab,
                  float* __restrict__ corr, int* __restrict__ err, int n,
                  int pe_n, int pc_n, int seg) {
  extern __shared__ unsigned sm[];
  const int c = blockIdx.x;
  const int p0 = blockIdx.y * seg;            // first position, SCAN_K | p0
  const int cnt = min(seg, pe_n - p0);
  const int runs = (cnt + SCAN_K - 1) / SCAN_K;
  const int q0 = (2 * p0) >> 5;               // 32 | 2 p0
  const int n_words = ((2 * SCAN_K * runs) >> 5) + SCAN_RUN_WORDS;
  unsigned* z = sm;
  unsigned* corr_s = z + n_words;
  unsigned* err_s = corr_s + staged(SCAN_K * runs);
  const long long row = (long long)c * n;

  for (int lw = threadIdx.x; lw < n_words; lw += blockDim.x) {
    const int bit0 = 32 * (q0 + lw);
    unsigned word = 0;
    if (bit0 < n) {
      const long long at = row + bit0;
      const int a = (int)(at & 15);
      const uint4* src = reinterpret_cast<const uint4*>(bits + (at - a));
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const uint4 v0 = src[0];
      const uint4 v1 = at - a + 16 < total_bytes ? src[1] : zero;
      const uint4 v2 = (a > 0 && at - a + 32 < total_bytes) ? src[2] : zero;
      const unsigned long long v =
          (unsigned long long)(pack16(v0) | (pack16(v1) << 16))
          | ((unsigned long long)pack16(v2) << 32);
      word = (unsigned)(v >> a);
      const int valid = n - bit0;
      if (valid < 32) word &= (1u << valid) - 1u;
    }
    z[lw] = word;
  }
  __syncthreads();

  for (int run = threadIdx.x; run < runs; run += blockDim.x) {
    const int i0 = SCAN_K * run;
    tt::scan_run<SCAN_K>(z, 2 * i0, tab, [&](int t, int n_agree, int e) {
      corr_s[staged(i0 + t)] =
          __float_as_uint((float)n_agree * (1.0f / 22.0f));
      err_s[staged(i0 + t)] = (unsigned)e;
    });
  }
  __syncthreads();

  store_row(reinterpret_cast<unsigned*>(corr) + (long long)c * pe_n + p0,
            corr_s, cnt);
  store_row(reinterpret_cast<unsigned*>(err) + (long long)c * pc_n + p0,
            err_s, min(seg, pc_n - p0));
}

}  // namespace

// scan_tab: the SCAN_WORDS table words in host memory.  bits must be
// 16-byte aligned (the rows inside it need not be).
extern "C" int tt_frame_scan_even(const void* bits, const void* scan_tab,
                                  void* corr, void* err, int n, int pe_n,
                                  int pc_n, int n_rows, void* stream) {
  if (n_rows <= 0 || pe_n <= 0) return 0;
  tt::ScanTab tab;
  memcpy(tab.w, scan_tab, sizeof(tab.w));
  // segments of at most SCAN_MAX_THREADS runs, nearly even
  const int max_seg = SCAN_K * SCAN_MAX_THREADS;
  const int n_seg = (pe_n + max_seg - 1) / max_seg;
  const int per = (pe_n + n_seg - 1) / n_seg;
  const int seg = (per + SCAN_K - 1) / SCAN_K * SCAN_K;
  const int runs = seg / SCAN_K;
  const int threads = (runs + 31) / 32 * 32;
  const int n_words = ((2 * seg) >> 5) + SCAN_RUN_WORDS;
  const int smem = (n_words + 2 * (seg + runs)) * (int)sizeof(unsigned);
  frame_scan_kernel<<<dim3(n_rows, (pe_n + seg - 1) / seg), threads, smem,
                      (cudaStream_t)stream>>>(
      (const unsigned char*)bits, (long long)n_rows * n, tab, (float*)corr,
      (int*)err, n, pe_n, pc_n, seg);
  return (int)cudaGetLastError();
}
