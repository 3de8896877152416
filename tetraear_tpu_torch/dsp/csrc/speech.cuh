// The ETSI ACELP speech decoder (EN 300 395-2) as device code: the
// saturating Word16 / Word32 basic operators, the exact reorderings of
// the decoder's saturating sums, and the steps of one subframe's decode,
// for the acelp_decode kernel (speech.cu).
//
// The operators and steps are the C++ decoder's (tetraear_tpu_torch/
// voice/csrc/etsi_dsp.h and etsi_acelp_dec.cpp, bit-exact against the
// reference sdecoder binary) with these changes: the operators keep no
// global Overflow / Carry flags (the decoder never reads them); norm_l
// and L_shl are closed forms of the reference's loops; the tables come
// from one int16 array in constant memory (c_tab, filled by
// voice/speech.py from voice/acelp_tables.py at the kOff* offsets below);
// and the sample recursions that the kernel spreads over lanes or runs
// on a short dependent chain use the exact reorderings below, which give
// the reference's words for every input.  Signed overflow never
// happens: products of two Word16 fit in 32 bits, every sum that could
// leave int32 is tested before it is formed (as in the host code, L_add
// / L_sub work on unsigned words), and the reordered sums wrap in
// unsigned words.
//
// The operators and the reorderings are __host__ __device__: the CPU
// tests compile this header with g++ and hold them against voice/fixed.py.
#pragma once

#include <stdint.h>

#define TT_HD __host__ __device__ __forceinline__

// A reordered sum that may have saturated is redone step by step; the
// host build of the tests counts those redos here (0 a Syn_Filt pass,
// 1 an interpolated sample).
#ifndef TT_FALLBACK
#define TT_FALLBACK(which) ((void)0)
#endif

namespace ttsp {

typedef int16_t Word16;
typedef int32_t Word32;

constexpr int L_FRAME = 240;
constexpr int L_SUBFR = 60;
constexpr int PIT_MAX = 143;
constexpr int L_INTER = 16;
constexpr int EXC_OFF = PIT_MAX + L_INTER;    // 159, one word over the
                                              // reference's 158
constexpr int EXC_LEN = EXC_OFF + L_FRAME + L_SUBFR;
constexpr int N_BITS = 138;                   // BFI + 137 serial bits

// the constant table: offsets of each named table, in int16 words
constexpr int kOffDico1 = 0;         // 256 x 3
constexpr int kOffDico2 = 768;       // 512 x 3
constexpr int kOffDico3 = 2304;      // 512 x 4
constexpr int kOffQuaEner = 4352;    // 64 x 2
constexpr int kOffCoef1 = 4480;      // 32
constexpr int kOffCoef2 = 4512;      // 32
constexpr int kOffLog2 = 4544;       // 33
constexpr int kOffPow2 = 4577;       // 33
constexpr int kOffLspoldInit = 4610; // 10
constexpr int kOffBitno = 4620;      // 23 parameter widths
constexpr int kTabLen = 4643;

__constant__ Word16 c_tab[kTabLen];
// the interpolation filters as Word32 (Inter32_1_3's 32, Inter32_M1_3's
// 32), then each filter's sum |c|: filled from c_tab's by the launch
__constant__ Word32 c_coef[66];

// ---- basic operators ------------------------------------------------------

TT_HD Word16 sature(Word32 L) {
  if (L > 0x00007fff) return 0x7fff;
  if (L < (Word32)0xffff8000) return (Word16)0x8000;
  return (Word16)L;
}

TT_HD Word16 add(Word16 a, Word16 b) {
  return sature((Word32)a + (Word32)b);
}

TT_HD Word16 sub(Word16 a, Word16 b) {
  return sature((Word32)a - (Word32)b);
}

TT_HD Word16 extract_h(Word32 L) {
  return (Word16)(L >> 16);
}

TT_HD Word16 extract_l(Word32 L) { return (Word16)L; }

TT_HD Word32 L_mult(Word16 a, Word16 b) {
  Word32 p = (Word32)a * (Word32)b;
  if (p != 0x40000000) return p * 2;
  return 0x7fffffff;
}

TT_HD Word32 L_mult0(Word16 a, Word16 b) {
  return (Word32)a * (Word32)b;
}

TT_HD Word16 mult(Word16 a, Word16 b) {
  Word32 p = ((Word32)a * (Word32)b) >> 15;
  if (p & 0x00010000) p |= (Word32)0xffff0000;
  return sature(p);
}

TT_HD Word32 L_add(Word32 a, Word32 b) {
  Word32 s = (Word32)((uint32_t)a + (uint32_t)b);
  if (((a ^ b) & (Word32)0x80000000) == 0 &&
      ((s ^ a) & (Word32)0x80000000) != 0)
    return (a < 0) ? (Word32)0x80000000 : 0x7fffffff;
  return s;
}

TT_HD Word32 L_sub(Word32 a, Word32 b) {
  Word32 d = (Word32)((uint32_t)a - (uint32_t)b);
  if (((a ^ b) & (Word32)0x80000000) != 0 &&
      ((d ^ a) & (Word32)0x80000000) != 0)
    return (a < 0) ? (Word32)0x80000000 : 0x7fffffff;
  return d;
}

TT_HD Word32 L_mac(Word32 L, Word16 a, Word16 b) {
  return L_add(L, L_mult(a, b));
}

TT_HD Word32 L_msu(Word32 L, Word16 a, Word16 b) {
  return L_sub(L, L_mult(a, b));
}

TT_HD Word32 L_mac0(Word32 L, Word16 a, Word16 b) {
  return L_add(L, L_mult0(a, b));
}

TT_HD Word32 L_msu0(Word32 L, Word16 a, Word16 b) {
  return L_sub(L, L_mult0(a, b));
}

TT_HD Word32 L_negate(Word32 L) {
  return (L == (Word32)0x80000000) ? 0x7fffffff : -L;
}

TT_HD Word32 L_deposit_h(Word16 a) {
  return (Word32)((uint32_t)(int32_t)a << 16);
}

TT_HD Word32 L_deposit_l(Word16 a) { return (Word32)a; }

// the shifts as in etsi_dsp.h, where a negative count shifts the other
// way; written as one-way helpers so that no two functions call each
// other
TT_HD Word16 shr_pos(Word16 a, Word16 n) {
  if (n >= 15) return (Word16)(a < 0 ? -1 : 0);
  if (a < 0) return (Word16)(~((~a) >> n));
  return (Word16)(a >> n);
}

TT_HD Word16 shl_pos(Word16 a, Word16 n) {
  if (n > 15) return (Word16)(a == 0 ? 0 : (a > 0 ? 0x7fff : 0x8000));
  Word32 r = (Word32)a * ((Word32)1 << n);
  if (r != (Word32)((Word16)r)) return (Word16)(a > 0 ? 0x7fff : 0x8000);
  return (Word16)r;
}

TT_HD Word16 shr(Word16 a, Word16 n) {
  return n < 0 ? shl_pos(a, (Word16)-n) : shr_pos(a, n);
}

TT_HD Word16 shl(Word16 a, Word16 n) {
  return n < 0 ? shr_pos(a, (Word16)-n) : shl_pos(a, n);
}

TT_HD Word32 L_shr_pos(Word32 L, Word16 n) {
  if (n >= 31) return (L < 0) ? -1 : 0;
  if (L < 0) return ~((~L) >> n);
  return L >> n;
}

TT_HD int tt_clz(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __clz((int)u);
#else
  return u ? __builtin_clz(u) : 32;
#endif
}

// norm_l in closed form (the reference shifts until the top bits differ):
// the redundant sign bits, 0 for 0
TT_HD Word16 norm_l(Word32 L) {
  if (L == 0) return 0;
  return (Word16)(tt_clz((uint32_t)(L < 0 ? ~L : L)) - 1);
}

// L_shl by n > 0 in closed form (the reference doubles n times, testing
// each step): it saturates exactly where n exceeds the headroom norm_l(L)
TT_HD Word32 L_shl_pos(Word32 L, Word16 n) {
  if (L == 0 || n <= 0) return L;
  if (n > norm_l(L)) return L < 0 ? (Word32)0x80000000 : 0x7fffffff;
  return (Word32)((uint32_t)L << n);
}

TT_HD Word32 L_shr(Word32 L, Word16 n) {
  return n < 0 ? L_shl_pos(L, (Word16)-n) : L_shr_pos(L, n);
}

TT_HD Word32 L_shl(Word32 L, Word16 n) {
  return n <= 0 ? L_shr_pos(L, (Word16)-n) : L_shl_pos(L, n);
}

TT_HD Word32 L_shr_r(Word32 L, Word16 n) {
  if (n > 31) return 0;
  Word32 r = L_shr(L, n);
  if (n > 0 && (L & ((Word32)1 << (n - 1))) != 0) r++;
  return r;
}

TT_HD Word16 round_w(Word32 L) {
  return extract_h(L_add(L, 0x00008000));
}

TT_HD Word32 Load_sh(Word16 a, Word16 shift) {
  return L_msu0(0, a, (Word16)-(1 << shift));
}

TT_HD Word32 add_sh(Word32 L, Word16 a, Word16 shift) {
  return L_msu0(L, a, (Word16)-(1 << shift));
}

TT_HD Word32 sub_sh(Word32 L, Word16 a, Word16 shift) {
  return L_mac0(L, a, (Word16)-(1 << shift));
}

TT_HD Word32 Load_sh16(Word16 a) {
  return L_msu(0, a, (Word16)0x8000);
}

TT_HD Word32 sub_sh16(Word32 L, Word16 a) {
  return L_mac(L, a, (Word16)0x8000);
}

// SHR.0-table truncating store: extract_l(L >> (16 - shift))
TT_HD Word16 store_hi(Word32 L, Word16 shift) {
  return extract_l(L_shr(L, (Word16)(16 - shift)));
}

TT_HD void L_extract(Word32 L, Word16* hi, Word16* lo) {
  *hi = extract_h(L_shl(L, 1));
  *lo = extract_l(sub_sh(L, *hi, 15));
}

TT_HD Word32 mpy_mix(Word16 hi1, Word16 lo1,
                                          Word16 lo2) {
  Word16 p1 = extract_h(L_mult0(lo1, lo2));
  Word32 L = L_mult0(hi1, lo2);
  return add_sh(L, p1, 1);
}

// ---- table-driven transcendentals ----------------------------------------

__device__ void Log2_(Word32 L_x, Word16* exponent, Word16* fraction) {
  if (L_x <= 0) {
    *exponent = 0;
    *fraction = 0;
    return;
  }
  Word16 e = norm_l(L_x);
  L_x = L_shl(L_x, e);
  *exponent = sub(30, e);
  L_x = L_shr(L_x, 9);
  Word16 i = extract_h(L_x);
  L_x = L_shr(L_x, 1);
  Word16 a = (Word16)(extract_l(L_x) & 0x7fff);
  i = sub(i, 32);
  Word32 L_y = L_deposit_h(c_tab[kOffLog2 + i]);
  Word16 tmp = sub(c_tab[kOffLog2 + i], c_tab[kOffLog2 + i + 1]);
  L_y = L_msu(L_y, tmp, a);
  *fraction = extract_h(L_y);
}

__device__ Word32 Pow2_(Word16 exponent, Word16 fraction) {
  Word32 L_x = L_deposit_l(fraction);
  L_x = L_shl(L_x, 6);
  Word16 i = extract_h(L_x);
  L_x = L_shr(L_x, 1);
  Word16 a = (Word16)(extract_l(L_x) & 0x7fff);
  L_x = L_deposit_h(c_tab[kOffPow2 + i]);
  Word16 tmp = sub(c_tab[kOffPow2 + i], c_tab[kOffPow2 + i + 1]);
  L_x = L_msu(L_x, tmp, a);
  Word16 exp2 = sub(30, exponent);
  return L_shr_r(L_x, exp2);
}

// ---- LSP ------------------------------------------------------------------

// D_Lsp334 up to its last test: the codebook LSPs with the joint
// corrections; returns whether they fail the ordering test, where the
// reference takes the last frame's set instead
__device__ __forceinline__ bool D_Lsp334_cand(const Word16* index,
                                              Word16* lsp) {
  for (int k = 0; k < 3; k++) {
    lsp[k] = c_tab[kOffDico1 + 3 * index[0] + k];
    lsp[3 + k] = c_tab[kOffDico2 + 3 * index[1] + k];
  }
  for (int k = 0; k < 4; k++) lsp[6 + k] = c_tab[kOffDico3 + 4 * index[2] + k];

  Word16 tmp = sub(917, lsp[2]);
  tmp = add(tmp, lsp[3]);
  if (tmp > 0) {
    tmp = shr(tmp, 1);
    lsp[2] = add(lsp[2], tmp);
    lsp[3] = sub(lsp[3], tmp);
  }
  tmp = sub(1245, lsp[5]);
  tmp = add(tmp, lsp[6]);
  if (tmp > 0) {
    tmp = shr(tmp, 1);
    lsp[5] = add(lsp[5], tmp);
    lsp[6] = sub(lsp[6], tmp);
  }
  bool bad = false;
  for (int i = 0; i <= 8; i++)
    if (sub(lsp[i], lsp[i + 1]) <= 0) bad = true;
  return bad;
}

// the four subframes' pitch lags of a good frame from its parameters
// p[0..22]: subframe 1's from its index, the others' from the window
// around it
__device__ __forceinline__ void pitch_lags(const Word16* p, Word16* t0,
                                           Word16* frac) {
  Word16 index = p[3], tmp, tmp2;
  if (sub(index, 196) <= 0) {
    tmp = add(index, 2);
    tmp = mult(tmp, 0x2aab);
    t0[0] = add(tmp, 19);
    tmp2 = add(add(t0[0], t0[0]), t0[0]);
    tmp2 = sub(58, tmp2);
    frac[0] = add(index, tmp2);
  } else {
    t0[0] = sub(index, 112);
    frac[0] = 0;
  }
  Word16 t0_min = sub(t0[0], 5);
  if (sub(t0_min, 19) <= 0) t0_min = 20;
  Word16 t0_max = add(t0_min, 9);
  if (sub(t0_max, 143) > 0) {
    t0_max = 143;
    t0_min = sub(t0_max, 9);
  }
  for (int k = 1; k < 4; k++) {
    index = p[3 + 5 * k];
    tmp = add(index, 2);
    tmp = mult(tmp, 0x2aab);
    tmp = sub(tmp, 1);
    t0[k] = add(t0_min, tmp);
    tmp2 = add(add(tmp, tmp), tmp);
    tmp2 = add(tmp2, 2);
    frac[k] = sub(index, tmp2);
  }
}

// Get_Lsp_Pol with the reference's walking pointer written as indices
// (m from i down to 2), so that f stays in registers
__device__ __forceinline__ void Get_Lsp_Pol(const Word16* lsp, Word32* f) {
  f[0] = Load_sh(4096, 12);
  f[1] = sub_sh(0, lsp[0], 10);
#pragma unroll
  for (int i = 2; i <= 5; i++) {
    const Word16 l = lsp[2 * (i - 1)];
    f[i] = f[i - 2];
#pragma unroll
    for (int m = i; m >= 2; m--) {
      Word16 hi, lo;
      L_extract(f[m - 1], &hi, &lo);
      const Word32 t0 = L_shl(mpy_mix(hi, lo, l), 1);
      f[m] = L_add(f[m], f[m - 2]);
      f[m] = L_sub(f[m], t0);
    }
    f[1] = sub_sh(f[1], l, 10);
  }
}

__device__ __forceinline__ void Lsp_Az(const Word16* lsp, Word16* a) {
  Word32 f1[6], f2[6];
  Get_Lsp_Pol(&lsp[0], f1);
  Get_Lsp_Pol(&lsp[1], f2);
#pragma unroll
  for (int i = 5; i > 0; i--) {
    f1[i] = L_add(f1[i], f1[i - 1]);
    f2[i] = L_sub(f2[i], f2[i - 1]);
  }
  a[0] = 4096;
#pragma unroll
  for (int i = 1; i <= 5; i++) {
    a[i] = extract_l(L_shr_r(L_add(f1[i], f2[i]), 13));
    a[11 - i] = extract_l(L_shr_r(L_sub(f1[i], f2[i]), 13));
  }
}

// Int_Lpc4 for one subframe k (0..3): the LSPs interpolated between the
// last frame's and this one's (weights 3:1, 1:1, 1:3, then the new set
// alone), turned into the LPC a[0..10]
__device__ __forceinline__ void Int_Lpc_sub(const Word16* lsp_old,
                                            const Word16* lsp_new, int k,
                                            Word16* a) {
  Word16 lsp[10];
  const Word16 fac_old = (Word16)(0x6000 - 0x2000 * k);
  const Word16 fac_new = (Word16)(0x2000 + 0x2000 * k);
#pragma unroll
  for (int i = 0; i <= 9; i++) {
    Word32 L = L_mult(lsp_old[i], fac_old);
    L = L_mac(L, lsp_new[i], fac_new);
    lsp[i] = k == 3 ? lsp_new[i] : extract_h(L);
  }
  Lsp_Az(lsp, a);
}

__device__ __forceinline__ void Pond_Ai(const Word16* a, const Word16* fac,
                                        Word16* a_exp) {
  a_exp[0] = a[0];
#pragma unroll
  for (int i = 1; i <= 10; i++)
    a_exp[i] = round_w(L_mult(a[i], fac[i - 1]));
}

__device__ void Fac_Pond(Word16 gamma, Word16* fac) {
  fac[0] = gamma;
  for (Word16 i = 1; i <= 9; i++)
    fac[i] = round_w(L_mult(fac[i - 1], gamma));
}

// ---- exact reorderings of the saturating sums ----------------------------
//
// L_add saturates, so a sum taken in another order than the reference's
// is in general another number.  Two reorderings are exact for every
// input:
//   * a sum of non-negative terms saturates only at 2^31 - 1 and stays
//     there, so it is min(exact sum, 2^31 - 1) in any order (sat_add_pos,
//     sq_chain);
//   * a signed chain whose every prefix stays inside int32 is its exact
//     sum.  |L0| + sum |terms| bounds every prefix, so where that bound
//     fits in int32 the chain is one wrapping 32-bit sum in any order,
//     and where it does not the chain is redone step by step in the
//     reference's order (mac0_chain32, syn_filt).  The bound is formed
//     beside the sum, off its dependent chain.

// min(a + b, 2^31 - 1) for a, b in [0, 2^31 - 1]
TT_HD uint32_t sat_add_pos(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s > 0x7fffffffu ? 0x7fffffffu : s;
}

// L = L0 (>= 0); L = L_mac0(L, x[i], x[i]) for i < n
TT_HD Word32 sq_chain(Word32 L0, const Word16* x, int n) {
  uint64_t s = (uint32_t)L0;
  for (int i = 0; i < n; i++) s += (uint32_t)((Word32)x[i] * x[i]);
  return s > 0x7fffffffu ? 0x7fffffff : (Word32)s;
}

// L = 0; L = L_mac0(L, x[k], c[k]) for k < 32, in that order, the
// coefficients as Word32 values in Word16's range with sum |c| = sum_c:
// where max |x| * sum_c fits int32 no prefix can leave it, else the
// bound sum |x[k]| |c[k]| decides; four partial sums keep the chain
// short
TT_HD Word32 mac0_chain32(const Word16* x, const Word32* c, uint32_t sum_c) {
  uint32_t e0 = 0, e1 = 0, e2 = 0, e3 = 0;
  Word32 x_max = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    const Word32 v0 = x[k], v1 = x[k + 1], v2 = x[k + 2], v3 = x[k + 3];
    e0 += (uint32_t)(v0 * c[k]);
    e1 += (uint32_t)(v1 * c[k + 1]);
    e2 += (uint32_t)(v2 * c[k + 2]);
    e3 += (uint32_t)(v3 * c[k + 3]);
    const Word32 u0 = v0 < 0 ? -v0 : v0, u1 = v1 < 0 ? -v1 : v1,
                 u2 = v2 < 0 ? -v2 : v2, u3 = v3 < 0 ? -v3 : v3;
    const Word32 m01 = u0 > u1 ? u0 : u1, m23 = u2 > u3 ? u2 : u3;
    const Word32 m = m01 > m23 ? m01 : m23;
    x_max = m > x_max ? m : x_max;
  }
  if ((uint64_t)x_max * sum_c <= 0x7fffffffu)
    return (Word32)(e0 + e1 + e2 + e3);
  uint64_t b = 0;
  for (int k = 0; k < 32; k++)
    b += (uint32_t)(x[k] < 0 ? -(Word32)x[k] : x[k])
         * (uint32_t)(c[k] < 0 ? -c[k] : c[k]);
  if (b <= 0x7fffffffu) return (Word32)(e0 + e1 + e2 + e3);
  TT_FALLBACK(1);
  Word32 L = 0;
  for (int k = 0; k < 32; k++) L = L_mac0(L, x[k], (Word16)c[k]);
  return L;
}

// Syn_Filt over one subframe, in the reference's order: y[i] from the
// input x[i] (x[i] for i < nx, 0 after), the Q12 LPC a[1..10] and the
// ten outputs before it (mem, oldest first, for i < 10):
//   L = Load_sh(x, 12); L = L_msu0(L, a[j], y[i - j]), j = 1..10;
//   L = add_sh(L, 1, 11); y[i] = extract_h(L_shl(L, 4)).
// update: mem takes the last ten outputs.  y must not overlap x or mem.
TT_HD void syn_filt_serial(const Word16* a, const Word16* x, int nx,
                           Word16* y, Word16* mem, bool update) {
  for (int i = 0; i < L_SUBFR; i++) {
    Word32 L = Load_sh(i < nx ? x[i] : (Word16)0, 12);
    for (int j = 1; j <= 10; j++)
      L = L_msu0(L, a[j], i - j >= 0 ? y[i - j] : mem[10 + i - j]);
    L = add_sh(L, 1, 11);
    L = L_shl(L, 4);
    y[i] = extract_h(L);
  }
  if (update)
    for (int q = 0; q < 10; q++) mem[q] = y[L_SUBFR - 10 + q];
}

// The same filter with each sample's chain reordered.  Where no prefix
// of the chain leaves int32, the chain is its exact sum
// E = x * 4096 - sum a[j] y[i - j], and with the + 2048 the rest of the
// reference's steps (add_sh saturating at the top, L_shl by 4
// saturating, extract_h) are y = clamp((E + 2048) >> 12, -32768, 32767).
// The sums wrap in 32 bits.  Each output is added into the pending sums
// of the ten samples after it as soon as it is known, so the dependent
// chain from y[i - 1] to y[i] is one multiply-add, a shift and the
// clamp, and the other nine products run beside it.  One bound serves
// the whole pass:
//   4096 max|x| + 2048 + (sum |a[j]|) max|y| <= 2^31 - 1,
// max|y| over mem and the outputs (or 32768, which bounds every Word16),
// bounds every prefix of every sample (the first sample whose chain
// saturated would have had its bound from right outputs).  Where it
// fails, each sample's own bound
// 4096 |x[i]| + 2048 + sum |a[j]| |y[i - j]| is tried (the same
// argument, sample by sample).  syn_filt_pass returns whether its
// outputs are the reference's (where not, the caller redoes the pass
// serially); mem is read only.
TT_HD bool syn_filt_pass(const Word16* a, const Word16* x, int nx,
                        Word16* y, const Word16* mem, uint32_t x_max,
                        uint32_t sum_a) {
  uint32_t a1 = (uint32_t)-(Word32)a[1];
#ifdef __CUDA_ARCH__
  // a1 as a value of its own: folded into the multiply, the negation
  // would land on y[i - 1], on the chain
  asm("" : "+r"(a1));
#endif
  const uint32_t a2 = (uint32_t)-(Word32)a[2], a3 = (uint32_t)-(Word32)a[3],
                 a4 = (uint32_t)-(Word32)a[4], a5 = (uint32_t)-(Word32)a[5],
                 a6 = (uint32_t)-(Word32)a[6], a7 = (uint32_t)-(Word32)a[7],
                 a8 = (uint32_t)-(Word32)a[8], a9 = (uint32_t)-(Word32)a[9],
                 a10 = (uint32_t)-(Word32)a[10];
  // q1..q10: the sums of samples i .. i + 9 so far, their inputs with
  // the rounding and the outputs up to y[i - 2]; each output is added
  // into the nine sums after the next one as the loop reaches it, so
  // y[i] waits on one multiply-add, by y[i - 1]
  const uint32_t m1 = (uint32_t)mem[1], m2 = (uint32_t)mem[2],
                 m3 = (uint32_t)mem[3], m4 = (uint32_t)mem[4],
                 m5 = (uint32_t)mem[5], m6 = (uint32_t)mem[6],
                 m7 = (uint32_t)mem[7], m8 = (uint32_t)mem[8];
  auto in = [&](int i) -> uint32_t {
    return ((uint32_t)(i < nx ? (Word32)x[i] : 0) << 12) + 2048u;
  };
  uint32_t q1 = in(0) + a2 * m8 + a3 * m7 + a4 * m6 + a5 * m5 + a6 * m4
                + a7 * m3 + a8 * m2 + a9 * m1 + a10 * (uint32_t)mem[0];
  uint32_t q2 = in(1) + a3 * m8 + a4 * m7 + a5 * m6 + a6 * m5 + a7 * m4
                + a8 * m3 + a9 * m2 + a10 * m1;
  uint32_t q3 = in(2) + a4 * m8 + a5 * m7 + a6 * m6 + a7 * m5 + a8 * m4
                + a9 * m3 + a10 * m2;
  uint32_t q4 = in(3) + a5 * m8 + a6 * m7 + a7 * m6 + a8 * m5 + a9 * m4
                + a10 * m3;
  uint32_t q5 = in(4) + a6 * m8 + a7 * m7 + a8 * m6 + a9 * m5 + a10 * m4;
  uint32_t q6 = in(5) + a7 * m8 + a8 * m7 + a9 * m6 + a10 * m5;
  uint32_t q7 = in(6) + a8 * m8 + a9 * m7 + a10 * m6;
  uint32_t q8 = in(7) + a9 * m8 + a10 * m7;
  uint32_t q9 = in(8) + a10 * m8;
  uint32_t q10 = in(9);
  uint32_t v = (uint32_t)mem[9];            // y[i - 1]
#pragma unroll 10
  for (int i = 0; i < L_SUBFR; i++) {
    // the one multiply-add on the chain, then the rounding and clamp
    Word32 w = (Word32)(q1 + a1 * v) >> 12;
    w = w > 32767 ? 32767 : (w < -32768 ? -32768 : w);
    y[i] = (Word16)w;
    // y[i - 1] into the sums of samples i + 1 .. i + 9
    q1 = q2 + a2 * v;
    q2 = q3 + a3 * v;
    q3 = q4 + a4 * v;
    q4 = q5 + a5 * v;
    q5 = q6 + a6 * v;
    q6 = q7 + a7 * v;
    q7 = q8 + a8 * v;
    q8 = q9 + a9 * v;
    q9 = q10 + a10 * v;
    q10 = in(i + 10);
    v = (uint32_t)w;
  }
  // the bound with |y| <= 32768, then with the pass's largest |y|, then
  // each sample's own (no dependent chain, ~10 instructions a sample)
  const uint64_t base = ((uint64_t)x_max << 12) + 2048u;
  if (base + (uint64_t)sum_a * 32768u <= 0x7fffffffu) return true;
  Word32 y_max = 0;
  for (int q = 0; q < 10 + L_SUBFR; q++) {
    const Word32 w = q < 10 ? mem[q] : y[q - 10];
    const Word32 m = w < 0 ? -w : w;
    y_max = m > y_max ? m : y_max;
  }
  if (base + (uint64_t)sum_a * (uint64_t)y_max > 0x7fffffffu) {
    for (int i = 0; i < L_SUBFR; i++) {
      const Word32 xv = i < nx ? x[i] : 0;
      uint64_t bi = ((uint64_t)(uint32_t)(xv < 0 ? -xv : xv) << 12) + 2048u;
      for (int j = 1; j <= 10; j++) {
        const Word32 w = i - j >= 0 ? y[i - j] : mem[10 + i - j];
        const Word32 aj = a[j] < 0 ? -(Word32)a[j] : a[j];
        bi += (uint32_t)aj * (uint32_t)(w < 0 ? -w : w);
      }
      if (bi > 0x7fffffffu) return false;
    }
  }
  return true;
}

// Syn_Filt by the reordered pass where it holds, else step by step;
// x_max >= max |x[i]| over i < nx (the callers know it without a pass)
TT_HD void syn_filt(const Word16* a, const Word16* x, int nx,
                    uint32_t x_max, Word16* y, Word16* mem, bool update) {
  uint32_t sum_a = 0;
  for (int j = 1; j <= 10; j++)
    sum_a += (uint32_t)(a[j] < 0 ? -(Word32)a[j] : a[j]);
  if (!syn_filt_pass(a, x, nx, y, mem, x_max, sum_a)) {
    TT_FALLBACK(0);
    syn_filt_serial(a, x, nx, y, mem, update);
    return;
  }
  if (update)
    for (int q = 0; q < 10; q++) mem[q] = y[L_SUBFR - 10 + q];
}

// ---- one subframe's steps -------------------------------------------------

// Inter32_1_3 (frac = +1) and Inter32_M1_3 (frac = -1) at x = &exc[i - t0]
__device__ __forceinline__ Word16 Inter32(const Word16* x, Word16 frac) {
  const Word32 L = frac > 0 ? mac0_chain32(x - 16, c_coef, c_coef[64])
                            : mac0_chain32(x - 15, c_coef + 32, c_coef[65]);
  return round_w(L_add(L, L));
}

// D_D4i60: the algebraic code vector from the sharpened impulse response
// h (zero before its start)
__device__ __forceinline__ void D_D4i60(Word16 index, Word16 sign,
                                        Word16 shift, const Word16* h,
                                        Word16* cod) {
  const int p0 = shl((Word16)(index & 0x1f), 1);
  const int p1 = add(shr((Word16)(index & 0xe0), 2), 2);
  const int p2 = add(shr((Word16)(index & 0x700), 5), 4);
  const int p3 = add(shr((Word16)(index & 0x3800), 8), 6);
  for (int i = 0; i <= 59; i++) {
    const int j = i - shift;
    const Word16 f0 = j - p0 >= 0 ? h[j - p0] : (Word16)0;
    const Word16 f1 = j - p1 >= 0 ? h[j - p1] : (Word16)0;
    const Word16 f2 = j - p2 >= 0 ? h[j - p2] : (Word16)0;
    const Word16 f3 = j - p3 >= 0 ? h[j - p3] : (Word16)0;
    Word32 L = L_mult0(f0, 0x0b50);             // sqrt(2) in Q11
    L = sub_sh(L, f1, 11);
    L = add_sh(L, f2, 11);
    L = sub_sh(L, f3, 11);
    if (sign != 0) L = L_negate(L);
    cod[i] = store_hi(L, 5);
  }
}

// Ener_Measure's two halves: the prediction energy from prd_lt's sum of
// squares (taken from 1) and the code energy from the code's (from 0),
// each with the LPC gain g_lpc in [0x4000, 0x7fff] and exp_lpc in
// [0, 30] of Lpc_Gain (its energy is at least 0x400^2).  The prediction
// half is on the excitation chain, so its steps that cannot saturate are
// plain arithmetic: L in [1, 2^31 - 1] shifted by its headroom, a
// product below 2^30, and after Log2 (exponent in [0, 30]) sums below
// 2^23 (Load_sh16, add_sh, sub_sh16, add_sh; L_shr by 8 is the
// arithmetic shift).
__device__ Word16 ener_pit_of(Word32 L, Word16 g_lpc, Word16 exp_lpc) {
  Word16 e16, frac;
  const Word16 exp_plt = norm_l(L);
  const Word16 tmp16 = (Word16)(((uint32_t)L << exp_plt) >> 16);
  Log2_((Word32)tmp16 * g_lpc, &e16, &frac);
  L = (Word32)e16 * 65536 + 2 * (Word32)frac
      - (Word32)(exp_plt + exp_lpc) * 65536 + 0x6ae * 256;
  return extract_l(L >> 8);
}

__device__ Word16 ener_cod_of(Word32 L, Word16 g_lpc, Word16 exp_lpc) {
  Word16 e16, frac;
  const Word16 tmp16 = extract_h(L);
  L = L_mult0(tmp16, g_lpc);
  Log2_(L, &e16, &frac);
  L = Load_sh16(e16);
  L = add_sh(L, frac, 1);
  L = sub_sh16(L, exp_lpc);
  L = sub_sh(L, 0x1152, 8);
  L = L_shr(L, 8);
  return extract_l(L);
}

// the predicted energies after one subframe: Ener_Update from the gain
// index, or the BFI decrement
__device__ __forceinline__ void Ener_Update(Word16 index, Word16 bfi,
                                            Word16* last_pit,
                                            Word16* last_cod) {
  if (bfi != 0) {
    *last_pit = sub(*last_pit, 128);
    if (*last_pit < 0) *last_pit = 0;
    *last_cod = sub(*last_cod, 128);
    if (*last_cod < 0) *last_cod = 0;
    return;
  }
  Word32 L;
  L = Load_sh(*last_pit, 8);
  L = add_sh(L, *last_cod, 7);
  L = sub_sh(L, 0x300, 9);
  if (L < 0) L = 0;
  const Word16 pred_pit = store_hi(L, 7);
  L = Load_sh(*last_cod, 8);
  L = add_sh(L, *last_pit, 7);
  L = sub_sh(L, 0x300, 9);
  if (L < 0) L = 0;
  const Word16 pred_cod = store_hi(L, 7);
  const Word16 j = shl(index, 1);
  *last_pit = add(c_tab[kOffQuaEner + j], pred_pit);
  *last_cod = add(c_tab[kOffQuaEner + j + 1], pred_cod);
  if (sub(*last_pit, 0x1b00) > 0) *last_pit = 0x1b00;
  if (sub(*last_cod, 0x1900) > 0) *last_cod = 0x1900;
}

// Ener_Gains' two halves.  The pitch half is on the excitation chain:
// with Word16 inputs its sums stay below 2^23, so Load_sh, sub_sh,
// add_sh and L_extract (hi = L >> 15, lo = L & 0x7fff) are plain
// arithmetic, and the cap compares without L_sub.
__device__ Word16 gain_pit_of(Word16 last_pit, Word16 ener_pit) {
  const Word32 L = (Word32)last_pit * 64 - (Word32)ener_pit * 64 + 12 * 32768;
  Word32 g = Pow2_((Word16)(L >> 15), (Word16)(L & 0x7fff));
  if (g > 0x1333) g = 0x1333;
  return extract_l(g);
}

__device__ Word16 gain_cod_of(Word16 last_cod, Word16 ener_cod) {
  Word16 e16, frac;
  Word32 L = Load_sh(last_cod, 6);
  L = sub_sh(L, ener_cod, 6);
  L_extract(L, &e16, &frac);
  return extract_l(Pow2_(e16, frac));
}

}  // namespace ttsp
