// Standalone even-position sync + burst-CRC scan of bit rows.
//
// Replaces frame_scan_even (tetraear_tpu/dsp/pallas_kernels.py:
// _frame_scan_kernel / _scan_rows).  The TPU kernel evaluates the scan
// as im2col matmuls against selector tables on (C, R, 128) padded rows,
// shapes that exist for its matrix unit; none of that carries over.
// One block per carrier row:
//   * the row's n uint8 {0,1} bits are read as they are and packed LSB
//     first into 32-bit words in shared memory, one warp ballot a word;
//   * the 9 words the window of the last position reads past the row's
//     end are zero (the reference's zero pad);
//   * one thread per even position pe evaluates scan_window (scan.cuh):
//     corr[pe] = n_agree * (1/22) for pe < (n - 22)/2 + 1 and the
//     forward CRC-16 syndrome weight crc_err[pe] for pe < (n - 230)/2 + 1
//     (99 for an all-zero or all-one data view).
// Both planes come out at their final widths.  The scan is forward-only:
// the reference's tables duplicate the forward columns into the reversed
// half, so its min(e_fwd, e_rev) is e_fwd.
//
// Device memory and the scan's logic work bound it about equally: n
// bytes in and 8 bytes out per even position (about 26 KB a carrier at
// n = 5266), and about 194 logic operations and 19 population counts a
// position (scan.cuh), which at the float32 rate take as long as the
// bytes do.
#include <string.h>

#include "scan.cuh"

namespace {

__global__ void __launch_bounds__(256)
frame_scan_kernel(const unsigned char* __restrict__ bits,
                  const __grid_constant__ tt::ScanTab tab,
                  float* __restrict__ corr, int* __restrict__ err, int n,
                  int pe_n, int pc_n) {
  extern __shared__ unsigned z[];
  const int c = blockIdx.x;
  const int n_data = (n + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned char* row = bits + (long long)c * n;

  for (int w = warp; w < n_data; w += n_warps) {
    const int pos = 32 * w + lane;
    const int bit = pos < n ? (row[pos] != 0) : 0;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) z[w] = word;
  }
  for (int w = threadIdx.x; w < 9; w += blockDim.x) z[n_data + w] = 0u;
  __syncthreads();

  float* corrc = corr + (long long)c * pe_n;
  int* errc = err + (long long)c * pc_n;
  for (int pe = threadIdx.x; pe < pe_n; pe += blockDim.x) {
    int n_agree;
    const int e = tt::scan_window(z, 2 * pe, tab, &n_agree);
    corrc[pe] = (float)n_agree * (1.0f / 22.0f);
    if (pe < pc_n) errc[pe] = e;
  }
}

}  // namespace

// scan_tab: the SCAN_WORDS table words in host memory.
extern "C" int tt_frame_scan_even(const void* bits, const void* scan_tab,
                                  void* corr, void* err, int n, int pe_n,
                                  int pc_n, int n_rows, void* stream) {
  tt::ScanTab tab;
  memcpy(tab.w, scan_tab, sizeof(tab.w));
  const int smem = (((n + 31) >> 5) + 9) * (int)sizeof(unsigned);
  frame_scan_kernel<<<n_rows, 256, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)bits, tab, (float*)corr,
      (int*)err, n, pe_n, pc_n);
  return (int)cudaGetLastError();
}
