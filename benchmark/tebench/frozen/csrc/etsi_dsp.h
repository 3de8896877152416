/* ETSI TETRA codec fixed-point arithmetic (basic operators).
 *
 * The standard saturating 16/32-bit operator set used by the ETSI
 * TS 300 395-2 reference codec (the classic ETSI/ITU-T basicop
 * semantics: Word16/Word32, saturation to [-32768, 32767] /
 * [-2^31, 2^31-1], global Overflow/Carry flags), plus the codec's
 * double-precision helpers (L_comp/L_extract/mpy_32/mpy_mix) and the
 * table-driven Log2/pow2/inv_sqrt.  Each operator is verified
 * bit-exact against the reference binary's implementation in
 * tests/codec/test_acelp_oracle.py (via the ms_abi oracle loader).
 *
 * Implementation is original; semantics are the published basicop
 * definitions.  Header-only for easy reuse.
 */

#ifndef ETSI_DSP_H
#define ETSI_DSP_H

#include <stdint.h>

namespace etsi {

typedef int16_t Word16;
typedef int32_t Word32;

extern thread_local int Overflow;   /* defined in etsi_acelp_dec.cpp */
extern thread_local int Carry;      /* thread_local: pool-safe */

inline Word16 sature(Word32 L_var1) {
  if (L_var1 > 0x00007fffL) {
    Overflow = 1;
    return 0x7fff;
  }
  if (L_var1 < (Word32)0xffff8000L) {
    Overflow = 1;
    return (Word16)0x8000;
  }
  Overflow = 0;
  return (Word16)L_var1;
}

inline Word16 add(Word16 a, Word16 b) {
  return sature((Word32)a + (Word32)b);
}

inline Word16 sub(Word16 a, Word16 b) {
  return sature((Word32)a - (Word32)b);
}

inline Word16 abs_s(Word16 a) {
  if (a == (Word16)0x8000) return 0x7fff;
  return (Word16)(a < 0 ? -a : a);
}

inline Word16 negate(Word16 a) {
  return (a == (Word16)0x8000) ? (Word16)0x7fff : (Word16)(-a);
}

inline Word16 extract_h(Word32 L) { return (Word16)(L >> 16); }
inline Word16 extract_l(Word32 L) { return (Word16)L; }

inline Word32 L_mult(Word16 a, Word16 b) {
  Word32 p = (Word32)a * (Word32)b;
  if (p != 0x40000000L) return p * 2;
  Overflow = 1;
  return 0x7fffffffL;
}

inline Word32 L_mult0(Word16 a, Word16 b) {
  return (Word32)a * (Word32)b;
}

inline Word16 mult(Word16 a, Word16 b) {
  Word32 p = ((Word32)a * (Word32)b) >> 15;
  if (p & 0x00010000L) p |= 0xffff0000L;
  return sature(p);
}

inline Word16 mult_r(Word16 a, Word16 b) {
  Word32 p = (Word32)a * (Word32)b + 0x4000L;
  p >>= 15;
  if (p & 0x00010000L) p |= 0xffff0000L;
  return sature(p);
}

inline Word32 L_add(Word32 a, Word32 b) {
  Word32 s = (Word32)((uint32_t)a + (uint32_t)b);
  if (((a ^ b) & 0x80000000L) == 0 && ((s ^ a) & 0x80000000L) != 0) {
    Overflow = 1;
    return (a < 0) ? (Word32)0x80000000L : 0x7fffffffL;
  }
  return s;
}

inline Word32 L_sub(Word32 a, Word32 b) {
  Word32 d = (Word32)((uint32_t)a - (uint32_t)b);
  if (((a ^ b) & 0x80000000L) != 0 && ((d ^ a) & 0x80000000L) != 0) {
    Overflow = 1;
    return (a < 0L) ? (Word32)0x80000000L : 0x7fffffffL;
  }
  return d;
}

inline Word32 L_mac(Word32 L, Word16 a, Word16 b) {
  return L_add(L, L_mult(a, b));
}

inline Word32 L_msu(Word32 L, Word16 a, Word16 b) {
  return L_sub(L, L_mult(a, b));
}

inline Word32 L_mac0(Word32 L, Word16 a, Word16 b) {
  return L_add(L, L_mult0(a, b));
}

inline Word32 L_msu0(Word32 L, Word16 a, Word16 b) {
  return L_sub(L, L_mult0(a, b));
}

inline Word32 L_negate(Word32 L) {
  return (L == (Word32)0x80000000L) ? 0x7fffffffL : -L;
}

inline Word32 L_deposit_h(Word16 a) { return (Word32)a << 16; }
inline Word32 L_deposit_l(Word16 a) { return (Word32)a; }

inline Word32 L_abs(Word32 L) {
  if (L == (Word32)0x80000000L) return 0x7fffffffL;
  return L < 0 ? -L : L;
}

inline Word16 shl(Word16 a, Word16 n);

inline Word16 shr(Word16 a, Word16 n) {
  if (n < 0) return shl(a, (Word16)-n);
  if (n >= 15) return (Word16)(a < 0 ? -1 : 0);
  if (a < 0) return (Word16)(~((~a) >> n));
  return (Word16)(a >> n);
}

inline Word16 shl(Word16 a, Word16 n) {
  if (n < 0) return shr(a, (Word16)-n);
  Word32 r = (Word32)a * ((Word32)1 << n);
  if ((n > 15 && a != 0) || r != (Word32)((Word16)r)) {
    Overflow = 1;
    return (Word16)(a > 0 ? 0x7fff : 0x8000);
  }
  return (Word16)r;
}

inline Word32 L_shl(Word32 L, Word16 n);

inline Word32 L_shr(Word32 L, Word16 n) {
  if (n < 0) return L_shl(L, (Word16)-n);
  if (n >= 31) return (L < 0L) ? -1L : 0L;
  if (L < 0) return ~((~L) >> n);
  return L >> n;
}

inline Word32 L_shl(Word32 L, Word16 n) {
  if (n <= 0) return L_shr(L, (Word16)-n);
  for (; n > 0; n--) {
    if (L > 0x3fffffffL) {
      Overflow = 1;
      return 0x7fffffffL;
    }
    if (L < (Word32)0xc0000000L) {
      Overflow = 1;
      return (Word32)0x80000000L;
    }
    L *= 2;
  }
  return L;
}

inline Word32 L_shr_r(Word32 L, Word16 n) {
  if (n > 31) return 0;
  Word32 r = L_shr(L, n);
  if (n > 0 && (L & ((Word32)1 << (n - 1))) != 0) r++;
  return r;
}

inline Word16 round_w(Word32 L) {
  return extract_h(L_add(L, 0x00008000L));
}

inline Word16 norm_s(Word16 a) {
  if (a == 0) return 0;
  if (a == (Word16)0xffff) return 15;
  if (a < 0) a = (Word16)~a;
  Word16 n = 0;
  for (; a < 0x4000; n++) a = (Word16)(a << 1);
  return n;
}

inline Word16 norm_l(Word32 L) {
  if (L == 0) return 0;
  if (L == (Word32)0xffffffffL) return 31;
  if (L < 0) L = ~L;
  Word16 n = 0;
  for (; L < (Word32)0x40000000L; n++) L <<= 1;
  return n;
}

inline Word16 div_s(Word16 num, Word16 denom) {
  /* standard basicop fractional divide, num/denom in Q15, requires
   * 0 <= num <= denom, denom > 0 */
  if (num == 0) return 0;
  if (num == denom) return 0x7fff;
  Word32 L_num = L_deposit_l(num);
  Word32 L_denom = L_deposit_l(denom);
  Word16 var_out = 0;
  for (int i = 0; i < 15; i++) {
    var_out = (Word16)(var_out << 1);
    L_num <<= 1;
    if (L_num >= L_denom) {
      L_num = L_sub(L_num, L_denom);
      var_out = add(var_out, 1);
    }
  }
  return var_out;
}

/* ---- TETRA DPF helpers (tetra_op.c semantics, recovered from the
 * reference binary's disassembly: L = hi*2^15 + lo) ------------------- */

/* POW2-table shifted add/sub/load: x << shift implemented through
 * L_msu0/L_mac0 with POW2[shift] = -2^shift, so saturation matches the
 * reference exactly. */
inline Word32 Load_sh(Word16 a, Word16 shift) {
  return L_msu0(0, a, (Word16)-(1 << shift));
}

inline Word32 add_sh(Word32 L, Word16 a, Word16 shift) {
  return L_msu0(L, a, (Word16)-(1 << shift));
}

inline Word32 sub_sh(Word32 L, Word16 a, Word16 shift) {
  return L_mac0(L, a, (Word16)-(1 << shift));
}

inline Word32 Load_sh16(Word16 a) { return L_msu(0, a, (Word16)0x8000); }
inline Word32 add_sh16(Word32 L, Word16 a) {
  return L_msu(L, a, (Word16)0x8000);
}
inline Word32 sub_sh16(Word32 L, Word16 a) {
  return L_mac(L, a, (Word16)0x8000);
}

/* SHR.0-table truncating store: extract_l(L >> (16 - shift)). */
inline Word16 store_hi(Word32 L, Word16 shift) {
  static const Word16 kShr0[8] = {16, 15, 14, 13, 12, 11, 10, 9};
  return extract_l(L_shr(L, kShr0[shift]));
}

inline Word32 norm_v(Word32 L, Word16 v, Word16 *shift) {
  Word16 n = norm_l(L);
  if (sub(n, v) > 0) n = v;
  *shift = n;
  return L_shl(L, n);
}

inline Word32 L_comp(Word16 hi, Word16 lo) {
  return add_sh(Load_sh(lo, 0), hi, 15);     /* hi<<15 + lo */
}

inline void L_extract(Word32 L, Word16 *hi, Word16 *lo) {
  *hi = extract_h(L_shl(L, 1));
  *lo = extract_l(sub_sh(L, *hi, 15));
}

inline Word32 mpy_32(Word16 hi1, Word16 lo1, Word16 hi2, Word16 lo2) {
  Word16 p1 = extract_h(L_mult0(hi1, lo2));
  Word16 p2 = extract_h(L_mult0(lo1, hi2));
  Word32 L = L_mult0(hi1, hi2);
  L = add_sh(L, p1, 1);
  return add_sh(L, p2, 1);
}

inline Word32 mpy_mix(Word16 hi1, Word16 lo1, Word16 lo2) {
  Word16 p1 = extract_h(L_mult0(lo1, lo2));
  Word32 L = L_mult0(hi1, lo2);
  return add_sh(L, p1, 1);
}

inline Word32 div_32(Word32 L_num, Word16 denom_hi, Word16 denom_lo) {
  Word16 approx = div_s((Word16)0x3fff, denom_hi);
  Word32 L_32 = mpy_mix(denom_hi, denom_lo, approx);
  L_32 = L_sub(0x40000000L, L_32);
  Word16 hi, lo;
  L_extract(L_32, &hi, &lo);
  L_32 = mpy_mix(hi, lo, approx);
  L_extract(L_32, &hi, &lo);
  Word16 n_hi, n_lo;
  L_extract(L_num, &n_hi, &n_lo);
  L_32 = mpy_32(n_hi, n_lo, hi, lo);
  return L_shl(L_32, 2);
}

}  // namespace etsi

#endif /* ETSI_DSP_H */
