// Even-position sync + burst-CRC scan of a packed bit row.
//
// The device half of frame_scan_even / _scan_rows
// (tetraear_tpu/dsp/pallas_kernels.py); numpy reference:
// framescan.host_scan_rows_even.  Shared by the fused back-half kernel
// (backhalf.cu) and the standalone frame scan (frame_scan.cu).
//
// z holds the row's bits packed LSB first (bit j of word w is bit
// 32w + j of the row).  The table (framescan.scan_words, SCAN_WORDS
// uint32) holds 16 forward-CRC tap rows of 8 words over the 230-bit
// frame window, the 8-word data-view mask, the two 22-bit training
// sequences and the 16 bits of the all-zero message's CRC.
//
// The scan is integer work, and population counts run at a quarter of
// the logic rate: a syndrome bit is the parity of the window under its
// tap row, so the eight masked words are folded with exclusive-or first
// and counted once (16 counts a position where the sum of eight counts
// a row took 128), and the all-zero / all-one test of the data view is
// a comparison of masked words, no count.  The table travels as a kernel
// parameter (ScanTab), so its words are constant-bank operands of the
// logic operations and occupy neither registers nor shared memory.
#pragma once

#include "common.cuh"

#define SCAN_WORDS 139
#define SCAN_ONES 128
#define SCAN_TS1 136
#define SCAN_TS2 137
#define SCAN_C0 138

namespace tt {

struct ScanTab {
  unsigned w[SCAN_WORDS];
};

// Verdicts of the frame window whose 230 bits start at bit sh (< 32) of
// the nine words raw[0..8]:
//   *n_agree: best agreement count of its first 22 bits with TS1 / TS2;
//   return:   forward CRC-16 syndrome weight of the burst's data view,
//             99 when the view is all zeros or all ones.
__device__ __forceinline__ int scan_shifted(const unsigned (&raw)[9], int sh,
                                            const ScanTab& tab,
                                            int* n_agree) {
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = __funnelshift_r(raw[k], raw[k + 1], sh);
  const unsigned s22 = w[0] & 0x3FFFFFu;
  const int a1 = 22 - __popc(s22 ^ tab.w[SCAN_TS1]);
  const int a2 = 22 - __popc(s22 ^ tab.w[SCAN_TS2]);
  *n_agree = a1 > a2 ? a1 : a2;
  unsigned any = 0, missing = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned m = tab.w[SCAN_ONES + k];
    any |= w[k] & m;
    missing |= ~w[k] & m;
  }
  if (any == 0 || missing == 0) return 99;
  unsigned par = 0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    unsigned fold = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) fold ^= w[k] & tab.w[r * 8 + k];
    par |= (unsigned)(__popc(fold) & 1) << r;
  }
  return __popc(par ^ (tab.w[SCAN_C0] & 0xFFFFu));
}

// The same for the window starting at bit o of z: reads words
// z[o/32 .. o/32 + 8].
__device__ __forceinline__ int scan_window(const unsigned* z, int o,
                                           const ScanTab& tab,
                                           int* n_agree) {
  const int q = o >> 5;
  unsigned raw[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) raw[k] = z[q + k];
  return scan_shifted(raw, o & 31, tab, n_agree);
}

}  // namespace tt
