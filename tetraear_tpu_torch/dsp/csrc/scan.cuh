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
#pragma once

#include "common.cuh"

#define SCAN_WORDS 139
#define SCAN_ONES 128
#define SCAN_TS1 136
#define SCAN_TS2 137
#define SCAN_C0 138
#define SCAN_DATA_BITS 216

namespace tt {

// Verdicts of the frame window starting at bit o of z:
//   *n_agree: best agreement count of z[o, o+22) with TS1 / TS2;
//   return:   forward CRC-16 syndrome weight of the burst's data view,
//             99 when the view is all zeros or all ones.
// Reads words z[o/32 .. o/32 + 8].
__device__ __forceinline__ int scan_window(const unsigned* z, int o,
                                           const unsigned* tab,
                                           int* n_agree) {
  const int q = o >> 5;
  const int sh = o & 31;
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = sh ? (z[q + k] >> sh) | (z[q + k + 1] << (32 - sh)) : z[q + k];
  const unsigned s22 = w[0] & 0x3FFFFFu;
  const int a1 = 22 - __popc(s22 ^ tab[SCAN_TS1]);
  const int a2 = 22 - __popc(s22 ^ tab[SCAN_TS2]);
  *n_agree = a1 > a2 ? a1 : a2;
  int ones = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) ones += __popc(w[k] & tab[SCAN_ONES + k]);
  if (ones == 0 || ones == SCAN_DATA_BITS) return 99;
  const unsigned c0 = tab[SCAN_C0];
  int e = 0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) cnt += __popc(w[k] & tab[r * 8 + k]);
    e += (cnt & 1) ^ ((c0 >> r) & 1);
  }
  return e;
}

}  // namespace tt
