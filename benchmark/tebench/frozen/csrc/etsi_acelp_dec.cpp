/* ETSI EN 300 395-2 ACELP speech DECODER — spec-exact reimplementation.
 *
 * Bit-exact port of the reference sdecoder's decode path, reconstructed
 * from the reference binary the upstream app ships (symbols
 * Decod_Tetra / D_Lsp334 / D_D4i60 / Dec_Ener / Pred_Lt / Syn_Filt /
 * Post_Process and the tables in etsi_acelp_tables.h).  Every function
 * is verified against the original binary via the ms_abi oracle loader
 * (tests/codec/test_acelp_oracle.py): same inputs -> same Word16
 * outputs, including the saturating fixed-point corner cases.
 *
 * Decoder structure per 30 ms frame (240 samples, 23 parameters):
 *   prm[0..2]   LSP indices (8/9/9 bits, codebooks 256x3/512x3/512x4)
 *   prm[3]      subframe-1 pitch lag (8 bits, 1/3 resolution 19..85 +
 *               integer 85..143)
 *   per subframe (4 x 60 samples):
 *     algebraic code index (14 bits -> 4 offsets into the weighted
 *     impulse response F), sign (1), shift (1), energy VQ index (6);
 *     subframes 2..4 send a 5-bit delta lag instead of prm[3].
 *   Excitation = gain_pit * pred_lt + gain_cod * code, synthesis
 *   through 1/A(z), gains decoded predictively in the log2 domain.
 */

#include "tetra_codec.h"
#include "etsi_dsp.h"
#include "etsi_acelp_tables.h"

#include <cstring>
#include <new>

namespace etsi {

/* thread_local: the basic ops run concurrently on distinct decoder
 * handles from the voice synthesis pool (api._synth_voice_parallel);
 * plain globals would be an unsynchronized cross-thread write. */
thread_local int Overflow = 0;
thread_local int Carry = 0;

constexpr int L_FRAME = 240;
constexpr int L_SUBFR = 60;
constexpr int PIT_MAX = 143;
constexpr int L_INTER = 16;                  /* Inter32_1_3 taps x[i-16] */
constexpr int EXC_OFF = PIT_MAX + L_INTER;   /* 159: exc history.  The
 * reference allots 158 and reads one word out of bounds on a t0=143,
 * frac=+1 stream; the extra word is semantics-preserving otherwise. */

/* ---- table-driven transcendentals (tetra_op semantics) -------------- */

void Log2_(Word32 L_x, Word16 *exponent, Word16 *fraction) {
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
  Word32 L_y = L_deposit_h(ETSI_TAB_LOG2[i]);
  Word16 tmp = sub(ETSI_TAB_LOG2[i], ETSI_TAB_LOG2[i + 1]);
  L_y = L_msu(L_y, tmp, a);
  *fraction = extract_h(L_y);
}

Word32 Pow2_(Word16 exponent, Word16 fraction) {
  Word32 L_x = L_deposit_l(fraction);
  L_x = L_shl(L_x, 6);
  Word16 i = extract_h(L_x);
  L_x = L_shr(L_x, 1);
  Word16 a = (Word16)(extract_l(L_x) & 0x7fff);
  L_x = L_deposit_h(ETSI_TAB_POW2[i]);
  Word16 tmp = sub(ETSI_TAB_POW2[i], ETSI_TAB_POW2[i + 1]);
  L_x = L_msu(L_x, tmp, a);
  Word16 exp2 = sub(30, exponent);
  return L_shr_r(L_x, exp2);
}

/* ---- LSP dequantization --------------------------------------------- */

void D_Lsp334(const Word16 *index, Word16 *lsp, const Word16 *old_lsp) {
  lsp[0] = ETSI_DICO1_CLSP[3 * index[0]];
  lsp[1] = ETSI_DICO1_CLSP[3 * index[0] + 1];
  lsp[2] = ETSI_DICO1_CLSP[3 * index[0] + 2];
  lsp[3] = ETSI_DICO2_CLSP[3 * index[1]];
  lsp[4] = ETSI_DICO2_CLSP[3 * index[1] + 1];
  lsp[5] = ETSI_DICO2_CLSP[3 * index[1] + 2];
  lsp[6] = ETSI_DICO3_CLSP[4 * index[2]];
  lsp[7] = ETSI_DICO3_CLSP[4 * index[2] + 1];
  lsp[8] = ETSI_DICO3_CLSP[4 * index[2] + 2];
  lsp[9] = ETSI_DICO3_CLSP[4 * index[2] + 3];

  /* minimum-gap enforcement at the sub-vector joints */
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
  /* monotonicity (cosine domain: strictly decreasing) */
  int bad = 0;
  for (int i = 0; i <= 8; i++)
    if (sub(lsp[i], lsp[i + 1]) <= 0) bad = 1;
  if (bad)
    for (int i = 0; i <= 9; i++) lsp[i] = old_lsp[i];
}

/* ---- LSP -> LPC ------------------------------------------------------ */

void Get_Lsp_Pol(const Word16 *lsp, Word32 *f) {
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

void Lsp_Az(const Word16 *lsp, Word16 *a) {
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

void Int_Lpc4(const Word16 *lsp_old, const Word16 *lsp_new, Word16 *a) {
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

void Pond_Ai(const Word16 *a, const Word16 *fac, Word16 *a_exp) {
  a_exp[0] = a[0];
  for (Word16 i = 1; i <= 10; i++)
    a_exp[i] = round_w(L_mult(a[i], fac[i - 1]));
}

void Fac_Pond(Word16 gamma, Word16 *fac) {
  fac[0] = gamma;
  for (Word16 i = 1; i <= 9; i++)
    fac[i] = round_w(L_mult(fac[i - 1], gamma));
}

/* ---- synthesis filter ------------------------------------------------ */

void Syn_Filt(const Word16 *a, const Word16 *x, Word16 *y, Word16 lg,
              Word16 *mem, Word16 update) {
  Word16 tmp[10 + L_SUBFR];
  Word16 *ptr = tmp;
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

Word32 Lpc_Gain(const Word16 *a) {
  Word16 h[L_SUBFR];
  h[0] = 0x400;
  for (int i = 1; i < L_SUBFR; i++) h[i] = 0;
  Syn_Filt(a, h, h, L_SUBFR, &h[1], 0);
  Word32 L = 0;
  for (int i = 0; i < L_SUBFR; i++) L = L_mac0(L, h[i], h[i]);
  return L;
}

/* ---- adaptive codebook ----------------------------------------------- */

Word16 Inter32_1_3(const Word16 *x) {
  Word32 L = 0;
  for (Word16 i = 0; i <= 31; i++)
    L = L_mac0(L, x[i - 16], ETSI_COEF1[i]);
  return round_w(L_add(L, L));
}

Word16 Inter32_M1_3(const Word16 *x) {
  Word32 L = 0;
  for (Word16 i = 0; i <= 31; i++)
    L = L_mac0(L, x[i - 15], ETSI_COEF2[i]);
  return round_w(L_add(L, L));
}

void Pred_Lt(Word16 *exc, Word16 t0, Word16 frac, Word16 l_subfr) {
  if (frac == 0) {
    for (Word16 i = 0; i < l_subfr; i++) exc[i] = exc[i - t0];
  } else if (sub(frac, 1) == 0) {
    for (Word16 i = 0; i < l_subfr; i++)
      exc[i] = Inter32_1_3(&exc[i - t0]);
  } else if (sub(frac, -1) == 0) {
    for (Word16 i = 0; i < l_subfr; i++)
      exc[i] = Inter32_M1_3(&exc[i - t0]);
  }
}

/* ---- algebraic codebook ---------------------------------------------- */

void D_D4i60(Word16 index, Word16 sign, Word16 shift, const Word16 *F,
             Word16 *cod) {
  Word16 p0 = shl((Word16)(index & 0x1f), 1);
  Word16 p1 = add(shr((Word16)(index & 0xe0), 2), 2);
  Word16 p2 = add(shr((Word16)(index & 0x700), 5), 4);
  Word16 p3 = add(shr((Word16)(index & 0x3800), 8), 6);
  F -= shift;
  const Word16 *f0 = F - p0;
  const Word16 *f1 = F - p1;
  const Word16 *f2 = F - p2;
  const Word16 *f3 = F - p3;
  for (Word16 i = 0; i <= 59; i++) {
    Word32 L = L_mult0(f0[i], 0x0b50);       /* sqrt(2) in Q11 */
    L = sub_sh(L, f1[i], 11);
    L = add_sh(L, f2[i], 11);
    L = sub_sh(L, f3[i], 11);
    if (sign != 0) L = L_negate(L);
    cod[i] = store_hi(L, 5);
  }
}


/* ---- gain decoding (split for reuse by the encoder's AbS search) ----- */

void Ener_Measure(const Word16 *a, const Word16 *prd_lt,
                  const Word16 *code, Word16 l_subfr, Word16 *ener_pit,
                  Word16 *ener_cod) {
  Word16 exp_lpc, g_lpc, exp_plt, tmp16, e16, frac;
  Word32 L;
  L = Lpc_Gain(a);
  exp_lpc = norm_l(L);
  g_lpc = extract_h(L_shl(L, exp_lpc));

  L = 1;
  for (Word16 i = 0; i < l_subfr; i++)
    L = L_mac0(L, prd_lt[i], prd_lt[i]);
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
  for (Word16 i = 0; i < l_subfr; i++)
    L = L_mac0(L, code[i], code[i]);
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

void Ener_Update(Word16 index, Word16 *last_pit, Word16 *last_cod) {
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
  *last_pit = add(ETSI_T_QUA_ENER[j], pred_pit);
  *last_cod = add(ETSI_T_QUA_ENER[j + 1], pred_cod);
  if (sub(*last_pit, 0x1b00) > 0) *last_pit = 0x1b00;
  if (sub(*last_cod, 0x1900) > 0) *last_cod = 0x1900;
}

void Ener_Gains(Word16 last_pit, Word16 last_cod, Word16 ener_pit,
                Word16 ener_cod, Word16 *gain_pit, Word16 *gain_cod) {
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

/* ---- decoder state ---------------------------------------------------- */


struct EtsiDecoder {
  Word16 old_exc[EXC_OFF + L_FRAME + L_SUBFR];   /* history + frame */
  Word16 *exc;
  Word16 lspold[10];
  Word16 lspnew[10];
  Word16 mem_syn[10];
  Word16 old_parm[23];
  Word16 old_t0;
  Word16 last_ener_pit;
  Word16 last_ener_cod;
  Word16 f_gamma3[10];
  Word16 f_gamma4[10];

  EtsiDecoder() { init(); }

  void init() {
    old_t0 = 60;
    std::memset(old_parm, 0, sizeof(old_parm));
    std::memset(old_exc, 0, sizeof(old_exc));
    exc = &old_exc[EXC_OFF];
    last_ener_cod = 0;
    last_ener_pit = 0;
    std::memset(mem_syn, 0, sizeof(mem_syn));
    for (int i = 0; i <= 9; i++) lspold[i] = ETSI_LSPOLD_INIT[i];
    std::memset(lspnew, 0, sizeof(lspnew));
    Fac_Pond(0x6000, f_gamma3);
    Fac_Pond(0x6ccd, f_gamma4);
  }

  Word16 dec_ener(Word16 index, Word16 bfi, const Word16 *a,
                  const Word16 *prd_lt, const Word16 *code,
                  Word16 l_subfr, Word16 *gain_pit, Word16 *gain_cod) {
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
    Ener_Gains(last_ener_pit, last_ener_cod, ener_pit, ener_cod,
               gain_pit, gain_cod);
    return index;
  }

  void decode(const Word16 *parm, Word16 *synth) {
    Word16 A_t[44];
    Word16 Ap3[11], Ap4[11];
    Word16 F[64 + L_SUBFR];            /* zero history + impulse resp */
    Word16 *h = &F[64];
    Word16 code[L_SUBFR];
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
      /* concealment replays the previous frame's parameters */
      parm = old_parm;
    }
    const Word16 *p = parm + 3;

    Int_Lpc4(lspold, lspnew, A_t);
    for (int i = 0; i <= 9; i++) lspold[i] = lspnew[i];

    const Word16 *a = A_t;
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

      /* pitch-sharpen the impulse response */
      for (Word16 i = t0; i <= 59; i++) {
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

    /* Keep the full EXC_OFF-word history: exc[-1] must be the previous
     * frame's last excitation sample (a hardcoded 158-word copy went
     * stale when EXC_OFF grew to 159 for the x[i-16] guard word). */
    for (int i = 0; i < EXC_OFF; i++) old_exc[i] = old_exc[i + L_FRAME];
    old_t0 = t0;
  }
};

}  // namespace etsi

/* ---- C API ------------------------------------------------------------ */

extern "C" {

static const short kEtsiBitno[23] = {8, 9, 9, 8, 14, 1, 1, 6, 5, 14, 1,
                                     1, 6, 5, 14, 1, 1, 6, 5, 14, 1, 1,
                                     6};

void tetra_etsi_bits2prm(const int16_t *bits /*1+137 serial*/,
                         int16_t *prm /*1+23*/) {
  prm[0] = bits[0];                     /* BFI word */
  const int16_t *b = bits + 1;
  for (int i = 0; i < 23; i++) {
    int v = 0;
    for (int k = 0; k < kEtsiBitno[i]; k++) v = (v << 1) | (*b++ & 1);
    prm[1 + i] = (int16_t)v;
  }
}

void tetra_etsi_prm2bits(const int16_t *prm /*1+23*/,
                         int16_t *bits /*1+137*/) {
  bits[0] = prm[0];
  int16_t *b = bits + 1;
  for (int i = 0; i < 23; i++) {
    int v = prm[1 + i];
    for (int k = kEtsiBitno[i] - 1; k >= 0; k--)
      *b++ = (int16_t)((v >> k) & 1);
  }
}

void *tetra_etsi_decoder_new(void) {
  return new (std::nothrow) etsi::EtsiDecoder();
}

void tetra_etsi_decoder_free(void *dec) {
  delete static_cast<etsi::EtsiDecoder *>(dec);
}

/* ---- decoder state (de)serialization for checkpoint/resume ----------
 * The state is a fixed set of Word16 arrays plus one internal pointer
 * (exc) at a constant offset, so a flat little-endian int16 image is a
 * complete, portable snapshot.  Field order is part of the format. */

enum { ETSI_DEC_EXC_WORDS = etsi::EXC_OFF + etsi::L_FRAME + etsi::L_SUBFR,
       ETSI_DEC_STATE_WORDS = ETSI_DEC_EXC_WORDS + 10 + 10 + 10 + 23 + 3 };

int tetra_etsi_decoder_state_size(void) {
  return ETSI_DEC_STATE_WORDS * (int)sizeof(int16_t);
}

void tetra_etsi_decoder_get_state(const void *dec, int16_t *buf) {
  const auto *d = static_cast<const etsi::EtsiDecoder *>(dec);
  std::memcpy(buf, d->old_exc, sizeof(d->old_exc));
  buf += ETSI_DEC_EXC_WORDS;
  std::memcpy(buf, d->lspold, sizeof(d->lspold));   buf += 10;
  std::memcpy(buf, d->lspnew, sizeof(d->lspnew));   buf += 10;
  std::memcpy(buf, d->mem_syn, sizeof(d->mem_syn)); buf += 10;
  std::memcpy(buf, d->old_parm, sizeof(d->old_parm)); buf += 23;
  buf[0] = d->old_t0;
  buf[1] = d->last_ener_pit;
  buf[2] = d->last_ener_cod;
}

void tetra_etsi_decoder_set_state(void *dec, const int16_t *buf) {
  auto *d = static_cast<etsi::EtsiDecoder *>(dec);
  std::memcpy(d->old_exc, buf, sizeof(d->old_exc));
  buf += ETSI_DEC_EXC_WORDS;
  std::memcpy(d->lspold, buf, sizeof(d->lspold));   buf += 10;
  std::memcpy(d->lspnew, buf, sizeof(d->lspnew));   buf += 10;
  std::memcpy(d->mem_syn, buf, sizeof(d->mem_syn)); buf += 10;
  std::memcpy(d->old_parm, buf, sizeof(d->old_parm)); buf += 23;
  d->old_t0 = buf[0];
  d->last_ener_pit = buf[1];
  d->last_ener_cod = buf[2];
  d->exc = &d->old_exc[etsi::EXC_OFF];  /* re-derive internal pointer */
}

/* params: [BFI, p1..p23]; synth: 240 samples (NOT yet Post_Process'd:
 * apply tetra_etsi_post_process for the reference's x2 output scale). */
int tetra_etsi_decode_frame(void *dec, const int16_t *params,
                            int16_t *synth) {
  if (!dec || !params || !synth) return 1;
  static_cast<etsi::EtsiDecoder *>(dec)->decode(params, synth);
  return 0;
}

void tetra_etsi_post_process(int16_t *signal, int16_t lg) {
  for (int16_t i = 0; i < lg; i++)
    signal[i] = etsi::add(signal[i], signal[i]);
}

}  /* extern "C" */
