/* Shared internals of the ETSI ACELP implementation (decoder core,
 * reused by the ETSI-format encoder's analysis-by-synthesis loop). */

#ifndef ETSI_ACELP_INTERNAL_H
#define ETSI_ACELP_INTERNAL_H

#include "etsi_dsp.h"

namespace etsi {

constexpr int kFrameLen = 240;
constexpr int kSubfrLen = 60;
constexpr int kPitMax = 143;
constexpr int kPitMin = 20;
/* Excitation history depth.  Pred_Lt with frac=+1 reads back t0+16
 * samples (Inter32_1_3 taps x[i-16]); 143+15 would under-allocate by
 * one word for the t0=143, frac=+1 corner, an out-of-bounds read the
 * reference build shares (sdec_tet.c equivalent).  One extra history
 * word is semantics-preserving for every in-range stream. */
constexpr int kExcOff = 143 + 16;

void Log2_(Word32 L_x, Word16 *exponent, Word16 *fraction);
Word32 Pow2_(Word16 exponent, Word16 fraction);
void D_Lsp334(const Word16 *index, Word16 *lsp, const Word16 *old_lsp);
void Get_Lsp_Pol(const Word16 *lsp, Word32 *f);
void Lsp_Az(const Word16 *lsp, Word16 *a);
void Int_Lpc4(const Word16 *lsp_old, const Word16 *lsp_new, Word16 *a);
void Pond_Ai(const Word16 *a, const Word16 *fac, Word16 *a_exp);
void Fac_Pond(Word16 gamma, Word16 *fac);
void Syn_Filt(const Word16 *a, const Word16 *x, Word16 *y, Word16 lg,
              Word16 *mem, Word16 update);
Word32 Lpc_Gain(const Word16 *a);
Word16 Inter32_1_3(const Word16 *x);
Word16 Inter32_M1_3(const Word16 *x);
void Pred_Lt(Word16 *exc, Word16 t0, Word16 frac, Word16 l_subfr);
void D_D4i60(Word16 index, Word16 sign, Word16 shift, const Word16 *F,
             Word16 *cod);
void Ener_Measure(const Word16 *a, const Word16 *prd_lt,
                  const Word16 *code, Word16 l_subfr, Word16 *ener_pit,
                  Word16 *ener_cod);
void Ener_Update(Word16 index, Word16 *last_pit, Word16 *last_cod);
void Ener_Gains(Word16 last_pit, Word16 last_cod, Word16 ener_pit,
                Word16 ener_cod, Word16 *gain_pit, Word16 *gain_cod);

}  // namespace etsi

#endif /* ETSI_ACELP_INTERNAL_H */
