// Even-position sync + burst-CRC scan of a packed bit row, sliding.
//
// The device half of frame_scan_even / _scan_rows
// (tetraear_tpu/dsp/pallas_kernels.py); numpy references:
// framescan.host_scan_rows_even (the verdicts) and
// framescan.host_scan_rows_even_sliding (this header's own order of
// steps).  Shared by the fused back-half kernel (backhalf.cu) and the
// standalone frame scan (frame_scan.cu): the repo has one scan.
//
// z holds the row's bits packed LSB first (bit j of word w is bit
// 32w + j of the row).  The table (framescan.scan_words, SCAN_WORDS
// uint32) holds 16 forward-CRC tap rows of 8 words over the 230-bit
// frame window, the 8-word data-view mask, the two 22-bit training
// sequences, the 16 bits of the all-zero message's CRC, and the ten
// constants of the sliding step.
//
// What binds the scan is the integer instruction rate, not bytes: evaluated in
// full, a position costs 8 funnel shifts, 128 and-xor folds of the
// window under the 16 tap rows, 16 parities and the rest, about 210
// integer instructions (population counts at a quarter of the logic
// rate), against 2 bits in and 8 bytes out.  A faster scan has to do
// less a position, and it can: the tap rows are a polynomial remainder,
// so the 16-bit parity word of the window at bit o + 2 follows from that
// at o.  The data view is two runs of the window (offsets 0-107 and
// 122-229); a step takes the parity word through the fixed step matrix
// (a shift by two places and one constant for each of the two bits
// shifted out), takes out the four bits that leave the runs and puts in
// the four that enter (one 16-bit column each), and moves the data
// view's ones count by the same eight bits.  A thread evaluates the
// first position of a run of K in full and slides through the rest:
// about 45 logic instructions and 3 population counts a step.  The sync
// word is read anew at every position (a funnel shift and two counts).
// The table travels as a kernel parameter (ScanTab), so its words are
// constant-bank operands and occupy neither registers nor shared memory.
#pragma once

#include "common.cuh"

#define SCAN_WORDS 149
#define SCAN_ONES 128
#define SCAN_TS1 136
#define SCAN_TS2 137
#define SCAN_C0 138
#define SCAN_LEAVE 139    // columns of window bits 0, 1, 122, 123, stepped
#define SCAN_ENTER 143    // columns of old-window bits 108, 109, 230, 231
#define SCAN_STEP 147     // the step matrix's constants for bits 0 and 1
#define SCAN_DATA_BITS 216
// a run whose first position lies in word q reads z[q .. q + 9] at most
#define SCAN_RUN_WORDS 10

namespace tt {

struct ScanTab {
  unsigned w[SCAN_WORDS];
};

// The window whose 230 bits start at bit sh (< 32) of the nine words
// raw[0..8], in full: *par the 16 forward-CRC parity bits, *ones the
// ones count of the data view; w0 / w1 receive window bits 0-31 / 32-63.
__device__ __forceinline__ void scan_full(const unsigned (&raw)[9], int sh,
                                          const ScanTab& tab, unsigned* par,
                                          int* ones, unsigned* w0,
                                          unsigned* w1) {
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = __funnelshift_r(raw[k], raw[k + 1], sh);
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) cnt += __popc(w[k] & tab.w[SCAN_ONES + k]);
  unsigned p = 0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    unsigned fold = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) fold ^= w[k] & tab.w[r * 8 + k];
    p |= (unsigned)(__popc(fold) & 1) << r;
  }
  *par = p;
  *ones = cnt;
  *w0 = w[0];
  *w1 = w[1];
}

// 32 bits of z from bit o on
__device__ __forceinline__ unsigned scan_bits(const unsigned* z, int o) {
  const int q = o >> 5;
  return __funnelshift_r(z[q], z[q + 1], o & 31);
}

// Verdicts of the K (<= 16) even positions o0, o0 + 2, ... of z, o0 a
// multiple of 2: emit(t, n_agree, e) receives, for position o0 + 2t, the
// best agreement count of its first 22 bits with TS1 / TS2 and the
// forward CRC-16 syndrome weight of its data view (99 when the view is
// all zeros or all ones).  Reads words z[o0 / 32 .. (o0 + 230) / 32 + 1],
// SCAN_RUN_WORDS at most.
template <int K, class Emit>
__device__ __forceinline__ void scan_run(const unsigned* z, int o0,
                                         const ScanTab& tab, Emit emit) {
  static_assert(K >= 1 && K <= 16, "a run's bits must fit 32-bit words");
  const int q = o0 >> 5;
  unsigned raw[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) raw[k] = z[q + k];
  unsigned par, lo, hi;
  int ones;
  scan_full(raw, o0 & 31, tab, &par, &ones, &lo, &hi);
  // the bits that leave and enter over the run's steps: bit 2 (t - 1) + b
  // of each word is old-window bit off + b of step t
  const unsigned l122 = scan_bits(z, o0 + 122);
  const unsigned e108 = scan_bits(z, o0 + 108);
  const unsigned e230 = scan_bits(z, o0 + 230);
  const unsigned c0 = tab.w[SCAN_C0] & 0xFFFFu;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (t > 0) {
      const int s = 2 * (t - 1);
      unsigned nxt = par >> 2;
      if (par & 1u) nxt ^= tab.w[SCAN_STEP];
      if (par & 2u) nxt ^= tab.w[SCAN_STEP + 1];
      par = nxt;
#define TT_SCAN_BIT(word, b, col, d)          \
  if ((word) & (1u << (s + (b)))) {           \
    par ^= tab.w[(col)];                      \
    ones += (d);                              \
  }
      TT_SCAN_BIT(lo, 0, SCAN_LEAVE, -1)
      TT_SCAN_BIT(lo, 1, SCAN_LEAVE + 1, -1)
      TT_SCAN_BIT(l122, 0, SCAN_LEAVE + 2, -1)
      TT_SCAN_BIT(l122, 1, SCAN_LEAVE + 3, -1)
      TT_SCAN_BIT(e108, 0, SCAN_ENTER, 1)
      TT_SCAN_BIT(e108, 1, SCAN_ENTER + 1, 1)
      TT_SCAN_BIT(e230, 0, SCAN_ENTER + 2, 1)
      TT_SCAN_BIT(e230, 1, SCAN_ENTER + 3, 1)
#undef TT_SCAN_BIT
    }
    const unsigned s22 = __funnelshift_r(lo, hi, 2 * t) & 0x3FFFFFu;
    const int d1 = __popc(s22 ^ tab.w[SCAN_TS1]);
    const int d2 = __popc(s22 ^ tab.w[SCAN_TS2]);
    const int e = (ones == 0 || ones == SCAN_DATA_BITS)
                      ? 99 : __popc(par ^ c0);
    emit(t, 22 - (d1 < d2 ? d1 : d2), e);
  }
}

}  // namespace tt
