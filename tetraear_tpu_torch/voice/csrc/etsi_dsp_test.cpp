/* C-ABI wrappers around etsi_dsp.h for the oracle fuzz tests
 * (tests/codec/test_acelp_oracle.py). */

#include "etsi_dsp.h"

using namespace etsi;

extern "C" {

#define OP2_16(name) \
  int16_t etsi_##name(int16_t a, int16_t b) { return name(a, b); }
#define OP1_16(name) \
  int16_t etsi_##name(int16_t a) { return name(a); }

OP2_16(add)
OP2_16(sub)
OP2_16(mult)
OP2_16(mult_r)
OP2_16(shl)
OP2_16(shr)
OP2_16(div_s)
OP1_16(abs_s)
OP1_16(negate)
OP1_16(norm_s)

int32_t etsi_L_add(int32_t a, int32_t b) { return L_add(a, b); }
int32_t etsi_L_sub(int32_t a, int32_t b) { return L_sub(a, b); }
int32_t etsi_L_mult(int16_t a, int16_t b) { return L_mult(a, b); }
int32_t etsi_L_mult0(int16_t a, int16_t b) { return L_mult0(a, b); }
int32_t etsi_L_mac(int32_t L, int16_t a, int16_t b) { return L_mac(L, a, b); }
int32_t etsi_L_msu(int32_t L, int16_t a, int16_t b) { return L_msu(L, a, b); }
int32_t etsi_L_mac0(int32_t L, int16_t a, int16_t b) {
  return L_mac0(L, a, b);
}
int32_t etsi_L_msu0(int32_t L, int16_t a, int16_t b) {
  return L_msu0(L, a, b);
}
int32_t etsi_L_shl(int32_t L, int16_t n) { return L_shl(L, n); }
int32_t etsi_L_shr(int32_t L, int16_t n) { return L_shr(L, n); }
int32_t etsi_L_shr_r(int32_t L, int16_t n) { return L_shr_r(L, n); }
int32_t etsi_L_negate(int32_t L) { return L_negate(L); }
int32_t etsi_L_abs(int32_t L) { return L_abs(L); }
int32_t etsi_L_deposit_h(int16_t a) { return L_deposit_h(a); }
int32_t etsi_L_deposit_l(int16_t a) { return L_deposit_l(a); }
int16_t etsi_extract_h(int32_t L) { return extract_h(L); }
int16_t etsi_extract_l(int32_t L) { return extract_l(L); }
int16_t etsi_round(int32_t L) { return round_w(L); }
int16_t etsi_norm_l(int32_t L) { return norm_l(L); }
int16_t etsi_sature(int32_t L) { return sature(L); }

int32_t etsi_L_comp(int16_t hi, int16_t lo) { return L_comp(hi, lo); }
void etsi_L_extract(int32_t L, int16_t *hi, int16_t *lo) {
  L_extract(L, hi, lo);
}
int32_t etsi_mpy_32(int16_t h1, int16_t l1, int16_t h2, int16_t l2) {
  return mpy_32(h1, l1, h2, l2);
}
int32_t etsi_mpy_mix(int16_t h1, int16_t l1, int16_t l2) {
  return mpy_mix(h1, l1, l2);
}
int32_t etsi_Load_sh(int16_t a, int16_t s) { return Load_sh(a, s); }
int32_t etsi_Load_sh16(int16_t a) { return Load_sh16(a); }
int32_t etsi_add_sh(int32_t L, int16_t a, int16_t s) {
  return add_sh(L, a, s);
}
int32_t etsi_sub_sh(int32_t L, int16_t a, int16_t s) {
  return sub_sh(L, a, s);
}
int32_t etsi_add_sh16(int32_t L, int16_t a) { return add_sh16(L, a); }
int32_t etsi_sub_sh16(int32_t L, int16_t a) { return sub_sh16(L, a); }
int16_t etsi_store_hi(int32_t L, int16_t s) { return store_hi(L, s); }
int32_t etsi_norm_v(int32_t L, int16_t v, int16_t *s) {
  return norm_v(L, v, s);
}
int32_t etsi_div_32(int32_t L, int16_t hi, int16_t lo) {
  return div_32(L, hi, lo);
}

}  /* extern "C" */
