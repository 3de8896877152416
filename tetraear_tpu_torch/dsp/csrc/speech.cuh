// The ETSI ACELP speech decoder (EN 300 395-2) as device code: the
// saturating Word16 / Word32 basic operators and one slot's decode of a
// frame, for the acelp_decode kernel (speech.cu).
//
// The code is the C++ decoder's (tetraear_tpu_torch/voice/csrc/
// etsi_dsp.h and etsi_acelp_dec.cpp, bit-exact against the reference
// sdecoder binary) with three changes: the operators do not keep the
// global Overflow / Carry flags (the decoder never reads them), the
// tables come from one int16 array in constant memory (c_tab, filled by
// voice/speech.py from voice/acelp_tables.py at the kOff* offsets
// below), and Fac_Pond's factors are computed per thread.  Signed
// overflow never happens: products of two Word16 fit in 32 bits, and
// every sum that could leave int32 is tested before it is formed (as in
// the host code, L_add / L_sub work on unsigned words).
#pragma once

#include <stdint.h>

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

// ---- basic operators ------------------------------------------------------

__device__ __forceinline__ Word16 sature(Word32 L) {
  if (L > 0x00007fff) return 0x7fff;
  if (L < (Word32)0xffff8000) return (Word16)0x8000;
  return (Word16)L;
}

__device__ __forceinline__ Word16 add(Word16 a, Word16 b) {
  return sature((Word32)a + (Word32)b);
}

__device__ __forceinline__ Word16 sub(Word16 a, Word16 b) {
  return sature((Word32)a - (Word32)b);
}

__device__ __forceinline__ Word16 extract_h(Word32 L) {
  return (Word16)(L >> 16);
}

__device__ __forceinline__ Word16 extract_l(Word32 L) { return (Word16)L; }

__device__ __forceinline__ Word32 L_mult(Word16 a, Word16 b) {
  Word32 p = (Word32)a * (Word32)b;
  if (p != 0x40000000) return p * 2;
  return 0x7fffffff;
}

__device__ __forceinline__ Word32 L_mult0(Word16 a, Word16 b) {
  return (Word32)a * (Word32)b;
}

__device__ __forceinline__ Word16 mult(Word16 a, Word16 b) {
  Word32 p = ((Word32)a * (Word32)b) >> 15;
  if (p & 0x00010000) p |= (Word32)0xffff0000;
  return sature(p);
}

__device__ __forceinline__ Word32 L_add(Word32 a, Word32 b) {
  Word32 s = (Word32)((uint32_t)a + (uint32_t)b);
  if (((a ^ b) & (Word32)0x80000000) == 0 &&
      ((s ^ a) & (Word32)0x80000000) != 0)
    return (a < 0) ? (Word32)0x80000000 : 0x7fffffff;
  return s;
}

__device__ __forceinline__ Word32 L_sub(Word32 a, Word32 b) {
  Word32 d = (Word32)((uint32_t)a - (uint32_t)b);
  if (((a ^ b) & (Word32)0x80000000) != 0 &&
      ((d ^ a) & (Word32)0x80000000) != 0)
    return (a < 0) ? (Word32)0x80000000 : 0x7fffffff;
  return d;
}

__device__ __forceinline__ Word32 L_mac(Word32 L, Word16 a, Word16 b) {
  return L_add(L, L_mult(a, b));
}

__device__ __forceinline__ Word32 L_msu(Word32 L, Word16 a, Word16 b) {
  return L_sub(L, L_mult(a, b));
}

__device__ __forceinline__ Word32 L_mac0(Word32 L, Word16 a, Word16 b) {
  return L_add(L, L_mult0(a, b));
}

__device__ __forceinline__ Word32 L_msu0(Word32 L, Word16 a, Word16 b) {
  return L_sub(L, L_mult0(a, b));
}

__device__ __forceinline__ Word32 L_negate(Word32 L) {
  return (L == (Word32)0x80000000) ? 0x7fffffff : -L;
}

__device__ __forceinline__ Word32 L_deposit_h(Word16 a) {
  return (Word32)((uint32_t)(int32_t)a << 16);
}

__device__ __forceinline__ Word32 L_deposit_l(Word16 a) { return (Word32)a; }

// the shifts as in etsi_dsp.h, where a negative count shifts the other
// way; written as one-way helpers so that no two functions call each
// other
__device__ __forceinline__ Word16 shr_pos(Word16 a, Word16 n) {
  if (n >= 15) return (Word16)(a < 0 ? -1 : 0);
  if (a < 0) return (Word16)(~((~a) >> n));
  return (Word16)(a >> n);
}

__device__ __forceinline__ Word16 shl_pos(Word16 a, Word16 n) {
  if (n > 15) return (Word16)(a == 0 ? 0 : (a > 0 ? 0x7fff : 0x8000));
  Word32 r = (Word32)a * ((Word32)1 << n);
  if (r != (Word32)((Word16)r)) return (Word16)(a > 0 ? 0x7fff : 0x8000);
  return (Word16)r;
}

__device__ __forceinline__ Word16 shr(Word16 a, Word16 n) {
  return n < 0 ? shl_pos(a, (Word16)-n) : shr_pos(a, n);
}

__device__ __forceinline__ Word16 shl(Word16 a, Word16 n) {
  return n < 0 ? shr_pos(a, (Word16)-n) : shl_pos(a, n);
}

__device__ __forceinline__ Word32 L_shr_pos(Word32 L, Word16 n) {
  if (n >= 31) return (L < 0) ? -1 : 0;
  if (L < 0) return ~((~L) >> n);
  return L >> n;
}

__device__ __forceinline__ Word32 L_shl_pos(Word32 L, Word16 n) {
  for (; n > 0; n--) {
    if (L > 0x3fffffff) return 0x7fffffff;
    if (L < (Word32)0xc0000000) return (Word32)0x80000000;
    L *= 2;
  }
  return L;
}

__device__ __forceinline__ Word32 L_shr(Word32 L, Word16 n) {
  return n < 0 ? L_shl_pos(L, (Word16)-n) : L_shr_pos(L, n);
}

__device__ __forceinline__ Word32 L_shl(Word32 L, Word16 n) {
  return n <= 0 ? L_shr_pos(L, (Word16)-n) : L_shl_pos(L, n);
}

__device__ __forceinline__ Word32 L_shr_r(Word32 L, Word16 n) {
  if (n > 31) return 0;
  Word32 r = L_shr(L, n);
  if (n > 0 && (L & ((Word32)1 << (n - 1))) != 0) r++;
  return r;
}

__device__ __forceinline__ Word16 round_w(Word32 L) {
  return extract_h(L_add(L, 0x00008000));
}

__device__ __forceinline__ Word16 norm_l(Word32 L) {
  if (L == 0) return 0;
  if (L == (Word32)0xffffffff) return 31;
  if (L < 0) L = ~L;
  Word16 n = 0;
  for (; L < (Word32)0x40000000; n++) L <<= 1;
  return n;
}

__device__ __forceinline__ Word32 Load_sh(Word16 a, Word16 shift) {
  return L_msu0(0, a, (Word16)-(1 << shift));
}

__device__ __forceinline__ Word32 add_sh(Word32 L, Word16 a, Word16 shift) {
  return L_msu0(L, a, (Word16)-(1 << shift));
}

__device__ __forceinline__ Word32 sub_sh(Word32 L, Word16 a, Word16 shift) {
  return L_mac0(L, a, (Word16)-(1 << shift));
}

__device__ __forceinline__ Word32 Load_sh16(Word16 a) {
  return L_msu(0, a, (Word16)0x8000);
}

__device__ __forceinline__ Word32 sub_sh16(Word32 L, Word16 a) {
  return L_mac(L, a, (Word16)0x8000);
}

// SHR.0-table truncating store: extract_l(L >> (16 - shift))
__device__ __forceinline__ Word16 store_hi(Word32 L, Word16 shift) {
  return extract_l(L_shr(L, (Word16)(16 - shift)));
}

__device__ __forceinline__ void L_extract(Word32 L, Word16* hi, Word16* lo) {
  *hi = extract_h(L_shl(L, 1));
  *lo = extract_l(sub_sh(L, *hi, 15));
}

__device__ __forceinline__ Word32 mpy_mix(Word16 hi1, Word16 lo1,
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

__device__ void D_Lsp334(const Word16* index, Word16* lsp,
                         const Word16* old_lsp) {
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
  int bad = 0;
  for (int i = 0; i <= 8; i++)
    if (sub(lsp[i], lsp[i + 1]) <= 0) bad = 1;
  if (bad)
    for (int i = 0; i <= 9; i++) lsp[i] = old_lsp[i];
}

__device__ void Get_Lsp_Pol(const Word16* lsp, Word32* f) {
  Word16 hi, lo;
  *f = Load_sh(4096, 12);
  f++;
  *f = 0;
  *f = sub_sh(*f, *lsp, 10);
  f++;
  lsp += 2;
  for (Word16 i = 2; i <= 5; i++) {
    *f = f[-2];
    for (Word16 j = 1; j < i; j++, f--) {
      L_extract(f[-1], &hi, &lo);
      Word32 t0 = mpy_mix(hi, lo, *lsp);
      t0 = L_shl(t0, 1);
      *f = L_add(*f, f[-2]);
      *f = L_sub(*f, t0);
    }
    *f = sub_sh(*f, *lsp, 10);
    f += i;
    lsp += 2;
  }
}

__device__ void Lsp_Az(const Word16* lsp, Word16* a) {
  Word32 f1[6], f2[6];
  Get_Lsp_Pol(&lsp[0], f1);
  Get_Lsp_Pol(&lsp[1], f2);
  for (Word16 i = 5; i > 0; i--) {
    f1[i] = L_add(f1[i], f1[i - 1]);
    f2[i] = L_sub(f2[i], f2[i - 1]);
  }
  a[0] = 4096;
  for (Word16 i = 1, j = 10; i <= 5; i++, j--) {
    a[i] = extract_l(L_shr_r(L_add(f1[i], f2[i]), 13));
    a[j] = extract_l(L_shr_r(L_sub(f1[i], f2[i]), 13));
  }
}

__device__ void Int_Lpc4(const Word16* lsp_old, const Word16* lsp_new,
                         Word16* a) {
  Word16 lsp[10];
  Word16 fac_new = 0x2000;
  Word16 fac_old = 0x6000;
  for (Word16 k = 0; k <= 32; k += 11) {
    for (Word16 i = 0; i <= 9; i++) {
      Word32 L = L_mult(lsp_old[i], fac_old);
      L = L_mac(L, lsp_new[i], fac_new);
      lsp[i] = extract_h(L);
    }
    Lsp_Az(lsp, &a[k]);
    fac_old = sub(fac_old, 0x2000);
    fac_new = add(fac_new, 0x2000);
  }
  Lsp_Az(lsp_new, &a[33]);
}

__device__ void Pond_Ai(const Word16* a, const Word16* fac, Word16* a_exp) {
  a_exp[0] = a[0];
  for (Word16 i = 1; i <= 10; i++)
    a_exp[i] = round_w(L_mult(a[i], fac[i - 1]));
}

__device__ void Fac_Pond(Word16 gamma, Word16* fac) {
  fac[0] = gamma;
  for (Word16 i = 1; i <= 9; i++)
    fac[i] = round_w(L_mult(fac[i - 1], gamma));
}

// ---- filters --------------------------------------------------------------

__device__ void Syn_Filt(const Word16* a, const Word16* x, Word16* y,
                         Word16 lg, Word16* mem, Word16 update) {
  Word16 tmp[10 + L_SUBFR];
  Word16* ptr = tmp;
  for (Word16 i = 0; i <= 9; i++) *ptr++ = mem[i];
  for (Word16 i = 0; i < lg; i++) {
    Word32 L = Load_sh(x[i], 12);
    for (Word16 j = 1; j <= 10; j++) L = L_msu0(L, a[j], ptr[-j]);
    L = add_sh(L, 1, 11);
    L = L_shl(L, 4);
    *ptr++ = extract_h(L);
  }
  for (Word16 i = 0; i < lg; i++) y[i] = tmp[i + 10];
  if (update)
    for (Word16 i = 0; i <= 9; i++) mem[i] = y[lg - 10 + i];
}

__device__ Word32 Lpc_Gain(const Word16* a) {
  Word16 h[L_SUBFR];
  h[0] = 0x400;
  for (int i = 1; i < L_SUBFR; i++) h[i] = 0;
  Syn_Filt(a, h, h, L_SUBFR, &h[1], 0);
  Word32 L = 0;
  for (int i = 0; i < L_SUBFR; i++) L = L_mac0(L, h[i], h[i]);
  return L;
}

// ---- adaptive codebook ----------------------------------------------------

__device__ Word16 Inter32_1_3(const Word16* x) {
  Word32 L = 0;
  for (Word16 i = 0; i <= 31; i++)
    L = L_mac0(L, x[i - 16], c_tab[kOffCoef1 + i]);
  return round_w(L_add(L, L));
}

__device__ Word16 Inter32_M1_3(const Word16* x) {
  Word32 L = 0;
  for (Word16 i = 0; i <= 31; i++)
    L = L_mac0(L, x[i - 15], c_tab[kOffCoef2 + i]);
  return round_w(L_add(L, L));
}

__device__ void Pred_Lt(Word16* exc, Word16 t0, Word16 frac,
                        Word16 l_subfr) {
  if (frac == 0) {
    for (Word16 i = 0; i < l_subfr; i++) exc[i] = exc[i - t0];
  } else if (sub(frac, 1) == 0) {
    for (Word16 i = 0; i < l_subfr; i++) exc[i] = Inter32_1_3(&exc[i - t0]);
  } else if (sub(frac, -1) == 0) {
    for (Word16 i = 0; i < l_subfr; i++)
      exc[i] = Inter32_M1_3(&exc[i - t0]);
  }
}

// ---- algebraic codebook ---------------------------------------------------

__device__ void D_D4i60(Word16 index, Word16 sign, Word16 shift,
                        const Word16* F, Word16* cod) {
  Word16 p0 = shl((Word16)(index & 0x1f), 1);
  Word16 p1 = add(shr((Word16)(index & 0xe0), 2), 2);
  Word16 p2 = add(shr((Word16)(index & 0x700), 5), 4);
  Word16 p3 = add(shr((Word16)(index & 0x3800), 8), 6);
  F -= shift;
  const Word16* f0 = F - p0;
  const Word16* f1 = F - p1;
  const Word16* f2 = F - p2;
  const Word16* f3 = F - p3;
  for (Word16 i = 0; i <= 59; i++) {
    Word32 L = L_mult0(f0[i], 0x0b50);          // sqrt(2) in Q11
    L = sub_sh(L, f1[i], 11);
    L = add_sh(L, f2[i], 11);
    L = sub_sh(L, f3[i], 11);
    if (sign != 0) L = L_negate(L);
    cod[i] = store_hi(L, 5);
  }
}

// ---- gains -----------------------------------------------------------------

__device__ void Ener_Measure(const Word16* a, const Word16* prd_lt,
                             const Word16* code, Word16 l_subfr,
                             Word16* ener_pit, Word16* ener_cod) {
  Word16 exp_lpc, g_lpc, exp_plt, tmp16, e16, frac;
  Word32 L;
  L = Lpc_Gain(a);
  exp_lpc = norm_l(L);
  g_lpc = extract_h(L_shl(L, exp_lpc));

  L = 1;
  for (Word16 i = 0; i < l_subfr; i++) L = L_mac0(L, prd_lt[i], prd_lt[i]);
  exp_plt = norm_l(L);
  tmp16 = extract_h(L_shl(L, exp_plt));
  L = L_mult0(tmp16, g_lpc);
  exp_plt = add(exp_plt, exp_lpc);
  Log2_(L, &e16, &frac);
  L = Load_sh16(e16);
  L = add_sh(L, frac, 1);
  L = sub_sh16(L, exp_plt);
  L = add_sh(L, 0x6ae, 8);
  L = L_shr(L, 8);
  *ener_pit = extract_l(L);

  L = 0;
  for (Word16 i = 0; i < l_subfr; i++) L = L_mac0(L, code[i], code[i]);
  tmp16 = extract_h(L);
  L = L_mult0(tmp16, g_lpc);
  Log2_(L, &e16, &frac);
  L = Load_sh16(e16);
  L = add_sh(L, frac, 1);
  L = sub_sh16(L, exp_lpc);
  L = sub_sh(L, 0x1152, 8);
  L = L_shr(L, 8);
  *ener_cod = extract_l(L);
}

__device__ void Ener_Update(Word16 index, Word16* last_pit,
                            Word16* last_cod) {
  Word32 L;
  Word16 pred_pit, pred_cod, j;
  L = Load_sh(*last_pit, 8);
  L = add_sh(L, *last_cod, 7);
  L = sub_sh(L, 0x300, 9);
  if (L < 0) L = 0;
  pred_pit = store_hi(L, 7);
  L = Load_sh(*last_cod, 8);
  L = add_sh(L, *last_pit, 7);
  L = sub_sh(L, 0x300, 9);
  if (L < 0) L = 0;
  pred_cod = store_hi(L, 7);
  j = shl(index, 1);
  *last_pit = add(c_tab[kOffQuaEner + j], pred_pit);
  *last_cod = add(c_tab[kOffQuaEner + j + 1], pred_cod);
  if (sub(*last_pit, 0x1b00) > 0) *last_pit = 0x1b00;
  if (sub(*last_cod, 0x1900) > 0) *last_cod = 0x1900;
}

__device__ void Ener_Gains(Word16 last_pit, Word16 last_cod,
                           Word16 ener_pit, Word16 ener_cod,
                           Word16* gain_pit, Word16* gain_cod) {
  Word16 e16, frac;
  Word32 L;
  L = Load_sh(last_pit, 6);
  L = sub_sh(L, ener_pit, 6);
  L = add_sh(L, 12, 15);
  L_extract(L, &e16, &frac);
  L = Pow2_(e16, frac);
  if (L_sub(L, 0x1333) > 0) L = 0x1333;
  *gain_pit = extract_l(L);
  L = Load_sh(last_cod, 6);
  L = sub_sh(L, ener_cod, 6);
  L_extract(L, &e16, &frac);
  L = Pow2_(e16, frac);
  *gain_cod = extract_l(L);
}

// ---- one decoder slot ------------------------------------------------------

struct Decoder {
  Word16 old_exc[EXC_LEN];       // history + frame + scratch
  Word16 lspold[10];
  Word16 lspnew[10];
  Word16 mem_syn[10];
  Word16 old_parm[23];
  Word16 old_t0;
  Word16 last_ener_pit;
  Word16 last_ener_cod;
  Word16 f_gamma3[10];
  Word16 f_gamma4[10];

  __device__ void dec_ener(Word16 index, Word16 bfi, const Word16* a,
                           const Word16* prd_lt, const Word16* code,
                           Word16 l_subfr, Word16* gain_pit,
                           Word16* gain_cod) {
    Word16 ener_pit, ener_cod;
    Ener_Measure(a, prd_lt, code, l_subfr, &ener_pit, &ener_cod);
    if (bfi != 0) {
      last_ener_pit = sub(last_ener_pit, 128);
      if (last_ener_pit < 0) last_ener_pit = 0;
      last_ener_cod = sub(last_ener_cod, 128);
      if (last_ener_cod < 0) last_ener_cod = 0;
    } else {
      Ener_Update(index, &last_ener_pit, &last_ener_cod);
    }
    Ener_Gains(last_ener_pit, last_ener_cod, ener_pit, ener_cod, gain_pit,
               gain_cod);
  }

  // parm: [BFI, 23 parameters]; synth: 240 samples before Post_Process
  __device__ void decode(const Word16* parm, Word16* synth) {
    Word16 A_t[44];
    Word16 Ap3[11], Ap4[11];
    Word16 F[64 + L_SUBFR];            // zero history + impulse response
    Word16* h = &F[64];
    Word16 code[L_SUBFR];
    Word16* exc = &old_exc[EXC_OFF];
    Word16 t0 = 0, t0_min = 0, t0_max, frac = 0;
    Word16 gain_pit, gain_cod, index, bfi, tmp, tmp2;
    Word32 L;

    for (int i = 0; i < 64; i++) F[i] = 0;

    bfi = *parm++;
    if (bfi == 0) {
      D_Lsp334(parm, lspnew, lspold);
      for (int i = 0; i <= 22; i++) old_parm[i] = parm[i];
    } else {
      for (int i = 1; i <= 9; i++) lspnew[i] = lspold[i];
      parm = old_parm;     // concealment replays the previous parameters
    }
    const Word16* p = parm + 3;

    Int_Lpc4(lspold, lspnew, A_t);
    for (int i = 0; i <= 9; i++) lspold[i] = lspnew[i];

    const Word16* a = A_t;
    for (Word16 i_subfr = 0; i_subfr <= L_FRAME - L_SUBFR;
         i_subfr += L_SUBFR) {
      index = *p++;
      if (i_subfr == 0) {
        if (bfi == 0) {
          if (sub(index, 196) <= 0) {
            tmp = add(index, 2);
            tmp = mult(tmp, 0x2aab);
            t0 = add(tmp, 19);
            tmp2 = add(add(t0, t0), t0);
            tmp2 = sub(58, tmp2);
            frac = add(index, tmp2);
          } else {
            t0 = sub(index, 112);
            frac = 0;
          }
        } else {
          t0 = old_t0;
          frac = 0;
        }
        t0_min = sub(t0, 5);
        if (sub(t0_min, 19) <= 0) t0_min = 20;
        t0_max = add(t0_min, 9);
        if (sub(t0_max, 143) > 0) {
          t0_max = 143;
          t0_min = sub(t0_max, 9);
        }
      } else if (bfi == 0) {
        tmp = add(index, 2);
        tmp = mult(tmp, 0x2aab);
        tmp = sub(tmp, 1);
        t0 = add(t0_min, tmp);
        tmp2 = add(add(tmp, tmp), tmp);
        tmp2 = add(tmp2, 2);
        frac = sub(index, tmp2);
      }

      Pred_Lt(&exc[i_subfr], t0, frac, L_SUBFR);

      Pond_Ai(a, f_gamma3, Ap3);
      Pond_Ai(a, f_gamma4, Ap4);
      for (int i = 0; i <= 10; i++) h[i] = Ap3[i];
      for (int i = 11; i <= 59; i++) h[i] = 0;
      Syn_Filt(Ap4, h, h, L_SUBFR, &h[11], 0);

      for (Word16 i = t0; i <= 59; i++) {     // pitch-sharpen
        tmp = mult(h[i - t0], 0x6668);
        h[i] = add(h[i], tmp);
      }

      Word16 code_index = *p++;
      Word16 sign = *p++;
      Word16 shift16 = *p++;
      D_D4i60(code_index, sign, shift16, h, code);

      index = *p++;
      dec_ener(index, bfi, a, &exc[i_subfr], code, L_SUBFR, &gain_pit,
               &gain_cod);

      for (int i = 0; i <= 59; i++) {
        L = L_mult0(gain_pit, exc[i_subfr + i]);
        L = L_mac0(L, gain_cod, code[i]);
        exc[i_subfr + i] = (Word16)L_shr_r(L, 12);
      }

      Syn_Filt(a, &exc[i_subfr], &synth[i_subfr], L_SUBFR, mem_syn, 1);
      a += 11;
    }

    // the full EXC_OFF-word history: exc[-1] is this frame's last
    // excitation sample
    for (int i = 0; i < EXC_OFF; i++) old_exc[i] = old_exc[i + L_FRAME];
    old_t0 = t0;
  }
};

// Bits2prm: [BFI + 137 serial words] (only the low bit of each serial
// word counts) -> [BFI, 23 parameters], MSB first, widths from c_tab
__device__ void bits2prm(const int32_t* bits, Word16* prm) {
  prm[0] = bits[0] != 0;
  const int32_t* b = bits + 1;
  for (int i = 0; i < 23; i++) {
    int v = 0;
    for (int k = 0; k < c_tab[kOffBitno + i]; k++) v = (v << 1) | (*b++ & 1);
    prm[1 + i] = (Word16)v;
  }
}

}  // namespace ttsp
