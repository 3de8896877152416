/* ETSI-format ACELP speech ENCODER (analysis by synthesis).
 *
 * Produces ETSI EN 300 395-2 parameter frames (the 23-parameter layout
 * the spec-exact decoder in etsi_acelp_dec.cpp consumes), so encoded
 * speech is decodable by ANY conforming TETRA decoder — including the
 * reference sdecoder binary (tests/codec/test_acelp_oracle.py closes
 * the loop: our encoder -> reference decoder -> intelligible speech).
 *
 * Design: the bitstream format is defined by the decoder, not by the
 * reference encoder, so this is an original analysis-by-synthesis
 * encoder that reuses our exact decoder machinery for the synthesis
 * side (same fixed-point Int_Lpc4 / Pred_Lt / D_D4i60 / Ener_* / exc
 * update), guaranteeing the local decode of every chosen parameter is
 * exactly what a conforming receiver reproduces.  The parameter
 * SEARCHES (LSP quantization, open/closed-loop pitch, algebraic
 * codebook, gain index) are float-assisted and deliberately simpler
 * than the reference's — quality, not conformance, is the only
 * difference.
 */

#include "tetra_codec.h"
#include "etsi_acelp_internal.h"
#include "etsi_acelp_tables.h"

#include <cmath>
#include <cstring>
#include <new>

namespace etsi {
namespace {

/* ---- float LPC analysis --------------------------------------------- */

void lpc_analysis(const int16_t *pcm, const float *hist10,
                  float a[11]) {
  /* Hamming-windowed autocorrelation + Levinson on the 240 frame */
  float w[kFrameLen];
  for (int n = 0; n < kFrameLen; n++) {
    float win = 0.54f - 0.46f * std::cos(2.0f * 3.14159265f * n /
                                         (kFrameLen - 1));
    w[n] = (float)pcm[n] * win;
  }
  double r[11];
  for (int k = 0; k <= 10; k++) {
    double acc = 0.0;
    for (int n = k; n < kFrameLen; n++) acc += (double)w[n] * w[n - k];
    r[k] = acc;
  }
  r[0] *= 1.0001;                 /* white-noise correction */
  if (r[0] < 1.0) r[0] = 1.0;
  for (int k = 1; k <= 10; k++) r[k] *= std::exp(-0.5 * k * k * 1e-4);

  double A[11] = {1.0}, tmp[11];
  double err = r[0];
  for (int i = 1; i <= 10; i++) {
    double acc = r[i];
    for (int j = 1; j < i; j++) acc += A[j] * r[i - j];
    double ki = -acc / err;
    if (ki > 0.999) ki = 0.999;
    if (ki < -0.999) ki = -0.999;
    for (int j = 0; j <= i; j++) tmp[j] = A[j];
    A[i] = ki;
    for (int j = 1; j < i; j++) A[j] = tmp[j] + ki * tmp[i - j];
    err *= (1.0 - ki * ki);
    if (err < 1e-9) err = 1e-9;
  }
  for (int i = 0; i <= 10; i++) a[i] = (float)A[i];
  (void)hist10;
}

/* LPC -> LSP in the TETRA cosine domain (Q15 of cos(w), decreasing).
 * Chebyshev-grid sign-change search on the sum/difference polys. */

double cheb_eval(const double *f, double x) {
  /* f[0..5]: coefficients of F(z) in the x = cos(w) domain.  Double
   * precision: near-coincident LSP triples (gap ~2e-3 rad) put the
   * polynomial values inside float32 cancellation noise, which flips
   * signs and derails the alternating search. */
  double b2 = f[0], b1 = f[1] + 2.0 * x * b2, t;
  for (int i = 2; i <= 4; i++) {
    t = f[i] + 2.0 * x * b1 - b2;
    b2 = b1;
    b1 = t;
  }
  /* the recurrence accumulates 2*sum(f[i] cos((5-i)w)); the constant
   * term enters once, hence the 0.5 (same as ITU Chebps' f[n]/2) */
  return 0.5 * f[5] + x * b1 - b2;
}

void lpc_to_lsp(const float a[11], Word16 lsp[10]) {
  double f1[6], f2[6];
  f1[0] = 1.0;
  f2[0] = 1.0;
  for (int i = 1; i <= 5; i++) {
    f1[i] = (double)a[i] + a[11 - i] - f1[i - 1];
    f2[i] = (double)a[i] - a[11 - i] + f2[i - 1];
  }
  double found[10];
  int n_found = 0;
  const int GRID = 240;
  bool use_f1 = true;
  double xprev = 1.0;
  double y1prev = cheb_eval(f1, xprev);
  double y2prev = cheb_eval(f2, xprev);
  /* Robust alternating scan.  Two subtleties beyond the naive grid
   * search, both hit by near-coincident LSP clusters:
   *  (a) after a root of the active polynomial is found, the scan
   *      RESUMES FROM THAT ROOT with the other polynomial, so two
   *      interlaced roots sharing one grid interval are both caught;
   *  (b) a near-coincident PAIR of active-poly roots inside one grid
   *      interval leaves the active endpoint signs unchanged (the
   *      crossings cancel) — but interlacing places one root of the
   *      OTHER polynomial between them, whose endpoint sign change IS
   *      visible.  When that happens, bisect the other poly first and
   *      split the interval at its root to recover the hidden pair. */
  for (int g = 1; g <= GRID && n_found < 10;) {
    double x = std::cos(3.14159265358979 * g / GRID);
    double v1 = cheb_eval(f1, x), v2 = cheb_eval(f2, x);
    double va = use_f1 ? v1 : v2, ya = use_f1 ? y1prev : y2prev;
    const double *fa = use_f1 ? f1 : f2;
    const double *fo = use_f1 ? f2 : f1;
    auto bisect = [](const double *f, double lo, double hi, double yhi) {
      for (int it = 0; it < 40; it++) {
        double mid = 0.5 * (lo + hi);
        if (cheb_eval(f, mid) * yhi <= 0.0) lo = mid; else hi = mid;
      }
      return 0.5 * (lo + hi);
    };
    if (va * ya <= 0.0) {
      double root = bisect(fa, x, xprev, ya);
      found[n_found++] = root;
      use_f1 = !use_f1;        /* roots of F1/F2 interlace */
      xprev = root;
      y1prev = cheb_eval(f1, root);
      y2prev = cheb_eval(f2, root);
      /* g unchanged: re-examine [x, root] with the new polynomial */
      continue;
    }
    double vo = use_f1 ? v2 : v1, yo = use_f1 ? y2prev : y1prev;
    if (vo * yo <= 0.0 && n_found <= 7) {
      double rna = bisect(fo, x, xprev, yo);
      double a_mid = cheb_eval(fa, rna);
      if (a_mid * ya < 0.0) {        /* genuine hidden active pair */
        found[n_found++] = bisect(fa, rna, xprev, ya);
        found[n_found++] = rna;
        found[n_found++] = bisect(fa, x, rna, a_mid);
        use_f1 = !use_f1;            /* net parity after 3 roots */
        xprev = found[n_found - 1];
        y1prev = cheb_eval(f1, xprev);
        y2prev = cheb_eval(f2, xprev);
        continue;                    /* re-examine [x, lowest root] */
      }
    }
    xprev = x;
    y1prev = v1;
    y2prev = v2;
    g++;
  }
  /* If the search degenerates (sub-noise root cluster), fill the
   * remainder with an even spread from the last found root down to
   * cos(pi*10/11) — monotonic by construction, one-frame impact. */
  if (n_found < 10) {
    double top = n_found ? found[n_found - 1] : 1.0;
    double bot = std::cos(3.14159265358979 * 10.0 / 11.0);
    if (bot >= top) bot = top - 0.05 * (10 - n_found);
    for (int i = n_found; i < 10; i++)
      found[i] = top + (bot - top) * (i - n_found + 1) / (10 - n_found);
  }
  for (int i = 0; i < 10; i++) {
    double v = found[i] * 32768.0;
    if (v > 32767.0) v = 32767.0;
    if (v < -32768.0) v = -32768.0;
    lsp[i] = (Word16)v;
  }
}

void quant_lsp(const Word16 lsp[10], Word16 idx[3]) {
  long best;
  best = 1L << 62;
  for (int c = 0; c < 256; c++) {
    long e = 0;
    for (int k = 0; k < 3; k++) {
      long d = (long)lsp[k] - ETSI_DICO1_CLSP[3 * c + k];
      e += d * d;
    }
    if (e < best) { best = e; idx[0] = (Word16)c; }
  }
  best = 1L << 62;
  for (int c = 0; c < 512; c++) {
    long e = 0;
    for (int k = 0; k < 3; k++) {
      long d = (long)lsp[3 + k] - ETSI_DICO2_CLSP[3 * c + k];
      e += d * d;
    }
    if (e < best) { best = e; idx[1] = (Word16)c; }
  }
  best = 1L << 62;
  for (int c = 0; c < 512; c++) {
    long e = 0;
    for (int k = 0; k < 4; k++) {
      long d = (long)lsp[6 + k] - ETSI_DICO3_CLSP[4 * c + k];
      e += d * d;
    }
    if (e < best) { best = e; idx[2] = (Word16)c; }
  }
}

}  // namespace

void lpc_to_lsp_export(const float *a, Word16 *lsp) {
  float af[11];
  for (int i = 0; i <= 10; i++) af[i] = a[i];
  lpc_to_lsp(af, lsp);
}

/* ---- encoder state ---------------------------------------------------- */

struct EtsiEncoder {
  /* decoder replica (the AbS target state) */
  Word16 old_exc[kExcOff + kFrameLen + kSubfrLen];
  Word16 *exc;
  Word16 lspold[10];
  Word16 last_ener_pit, last_ener_cod;
  Word16 f_gamma3[10], f_gamma4[10];
  Word16 mem_syn[10];              /* decoder-replica synthesis memory */
  float res_hist[10];              /* residual-filter input history */
  int16_t pcm_hist[10];
  /* perceptual-weighting filter W(z) = A(z/g1)/A(z/g2) state: past
   * values of the coding error e = s - s_hat (the W input continued
   * across subframes) and of the weighted error ew = W(e) (the W
   * output).  Matching in the W domain shapes the coding noise under
   * the formants instead of spreading it flat (the reference
   * encoder's weighting; plain-synthesis-domain matching was the
   * acknowledged quality gap). */
  float wu_hist[10];
  float wy_hist[10];

  EtsiEncoder() {
    std::memset(old_exc, 0, sizeof(old_exc));
    exc = &old_exc[kExcOff];
    for (int i = 0; i < 10; i++) lspold[i] = ETSI_LSPOLD_INIT[i];
    last_ener_pit = last_ener_cod = 0;
    Fac_Pond(0x6000, f_gamma3);
    Fac_Pond(0x6ccd, f_gamma4);
    std::memset(mem_syn, 0, sizeof(mem_syn));
    std::memset(res_hist, 0, sizeof(res_hist));
    std::memset(pcm_hist, 0, sizeof(pcm_hist));
    std::memset(wu_hist, 0, sizeof(wu_hist));
    std::memset(wy_hist, 0, sizeof(wy_hist));
  }

  void encode(const int16_t *pcm, Word16 prm[24]) {
    prm[0] = 0;                        /* BFI */

    float a_f[11];
    lpc_analysis(pcm, res_hist, a_f);
    Word16 lsp_raw[10];
    lpc_to_lsp(a_f, lsp_raw);
    Word16 idx[3];
    quant_lsp(lsp_raw, idx);
    prm[1] = idx[0];
    prm[2] = idx[1];
    prm[3] = idx[2];

    /* decode the LSPs exactly as the receiver will */
    Word16 lspnew[10];
    D_Lsp334(idx, lspnew, lspold);
    Word16 A_t[44];
    Int_Lpc4(lspold, lspnew, A_t);
    for (int i = 0; i < 10; i++) lspold[i] = lspnew[i];

    /* target: LPC residual of the input through the QUANTIZED A(z) */
    float res[kFrameLen];
    {
      const Word16 *a = A_t;
      for (int s = 0; s < 4; s++) {
        for (int n = 0; n < kSubfrLen; n++) {
          int gi = s * kSubfrLen + n;
          float acc = (float)pcm[gi] * 4096.0f;
          for (int j = 1; j <= 10; j++) {
            float past = (gi - j >= 0) ? (float)pcm[gi - j]
                                       : (float)pcm_hist[j - gi - 1];
            acc += (float)a[j] * past;
          }
          res[gi] = acc / 4096.0f;
        }
        a += 11;
      }
      for (int j = 0; j < 10; j++)
        pcm_hist[j] = pcm[kFrameLen - 1 - j];
    }

    int prm_i = 3;        /* prm[1..3] = LSP; next is prm[4] (lag 1) */

    /* open-loop pitch on the whole frame's residual */
    int t_ol = kPitMin;
    {
      double best = -1e30;
      for (int lag = kPitMin; lag <= kPitMax; lag++) {
        double num = 0.0, den = 1e-6;
        for (int n = lag; n < kFrameLen; n++) {
          num += (double)res[n] * res[n - lag];
          den += (double)res[n - lag] * res[n - lag];
        }
        double score = num * num / den;
        if (score > best) { best = score; t_ol = lag; }
      }
    }

    Word16 t0 = (Word16)t_ol, t0_min = kPitMin, t0_max = kPitMax;
    const Word16 *a = A_t;
    for (int s = 0; s < 4; s++) {
      int i_subfr = s * kSubfrLen;

      /* synthesis impulse response of 1/A_q (float) */
      float hs[kSubfrLen];
      for (int n = 0; n < kSubfrLen; n++) {
        float acc = (n == 0) ? 4096.0f : 0.0f;
        for (int j = 1; j <= 10 && j <= n; j++)
          acc -= (float)a[j] * hs[n - j];
        hs[n] = acc / 4096.0f;
      }
      /* weighted synthesis impulse response hw = impulse of
       * W(z)/A_q(z), W = A(z/g1)/A(z/g2): run hs through the FIR
       * A(z/g1) then the IIR 1/A(z/g2), zero states (code/adaptive
       * images are zero-past by construction, so their weighted images
       * are plain convolutions with hw) */
      const float kG1 = 0.90f, kG2 = 0.60f;
      float aw1[11], aw2[11];
      {
        float g1p = 1.0f, g2p = 1.0f;
        for (int j = 0; j <= 10; j++) {
          aw1[j] = (float)a[j] / 4096.0f * g1p;
          aw2[j] = (float)a[j] / 4096.0f * g2p;
          g1p *= kG1;
          g2p *= kG2;
        }
      }
      float hw[kSubfrLen];
      for (int n = 0; n < kSubfrLen; n++) {
        float acc = 0.0f;
        for (int j = 0; j <= 10 && j <= n; j++)
          acc += aw1[j] * hs[n - j];
        for (int j = 1; j <= 10 && j <= n; j++)
          acc -= aw2[j] * hw[n - j];
        hw[n] = acc;
      }
      /* target x = input minus zero-input response of the decoder's
       * synthesis filter (decoder-exact Word16 memory) */
      Word16 zeros[kSubfrLen] = {0};
      Word16 zir[kSubfrLen];
      {
        Word16 mem_copy[10];
        std::memcpy(mem_copy, mem_syn, sizeof(mem_copy));
        Syn_Filt(a, zeros, zir, kSubfrLen, mem_copy, 0);
      }
      float x[kSubfrLen];
      for (int n = 0; n < kSubfrLen; n++)
        x[n] = (float)pcm[i_subfr + n] - (float)zir[n];
      /* weighted target xw = W applied to x with the carried error
       * histories: past W inputs are the true coding errors e = s -
       * s_hat, past W outputs the true weighted errors ew — so xw is
       * exactly W(e) minus the (still unknown) zero-state images of
       * this subframe's excitation, which the searches subtract */
      float xw[kSubfrLen];
      for (int n = 0; n < kSubfrLen; n++) {
        float acc = 0.0f;
        for (int j = 0; j <= 10; j++) {
          float u = (n - j >= 0) ? x[n - j]
                                 : wu_hist[10 + (n - j)];
          acc += aw1[j] * u;
        }
        for (int j = 1; j <= 10; j++) {
          float v = (n - j >= 0) ? xw[n - j]
                                 : wy_hist[10 + (n - j)];
          acc -= aw2[j] * v;
        }
        xw[n] = acc;
      }

      /* adaptive search in the synthesis domain around the open-loop
       * lag (subframe 1) / the encoded window (subframes 2-4) */
      int lo, hi;
      if (s == 0) {
        lo = t_ol - 3;
        hi = t_ol + 3;
        if (lo < kPitMin) lo = kPitMin;
        if (hi > kPitMax) hi = kPitMax;
      } else {
        lo = t0_min;
        hi = t0_max;
      }
      int best_lag = lo, best_frac = 0;
      double best_score = -1e30, gp_f = 0.0;
      float y[kSubfrLen];
      /* 1/3-resolution closed loop: every (lag, frac) candidate's
       * adaptive vector is built DECODER-EXACTLY by running Pred_Lt on
       * a scratch copy of the excitation history, then scored in the
       * synthesis domain.  frac index validity follows the decoder's
       * lag coding (etsi_acelp_dec.cpp:421-453): subframe 1 needs
       * 0 <= 3*t0-58+frac <= 196 (integer-only above 85); frac=+1
       * reads back t0+16 so lags above 142 stay integer. */
      Word16 scratch[kExcOff + kSubfrLen];
      for (int lag = lo; lag <= hi; lag++) {
        for (int fr = -1; fr <= 1; fr++) {
          if (fr != 0 && lag > 142) continue;
          if (s == 0 && fr != 0) {
            if (lag > 85) continue;
            int idx0 = 3 * lag - 58 + fr;
            if (idx0 < 0 || idx0 > 196) continue;
          }
          std::memcpy(scratch, &old_exc[i_subfr],
                      kExcOff * sizeof(Word16));
          Pred_Lt(&scratch[kExcOff], (Word16)lag, (Word16)fr,
                  kSubfrLen);
          double num = 0.0, den = 1e-6;
          for (int n = 0; n < kSubfrLen; n++) {
            float yy = 0.0f;
            for (int j = 0; j <= n; j++)
              yy += (float)scratch[kExcOff + j] * hw[n - j];
            num += (double)xw[n] * yy;
            den += (double)yy * yy;
          }
          double score = num * num / den;
          if (score > best_score) {
            best_score = score;
            best_lag = lag;
            best_frac = fr;
            gp_f = num / den;
          }
        }
      }
      t0 = (Word16)best_lag;
      Word16 frac = (Word16)best_frac;
      if (gp_f < 0.0) gp_f = 0.0;
      if (gp_f > 1.2) gp_f = 1.2;

      if (s == 0) {
        prm[1 + prm_i++] = (t0 <= 85) ? (Word16)(3 * t0 - 58 + frac)
                                      : (Word16)(t0 + 112);
        t0_min = sub(t0, 5);
        if (sub(t0_min, 19) <= 0) t0_min = 20;
        t0_max = add(t0_min, 9);
        if (sub(t0_max, 143) > 0) {
          t0_max = 143;
          t0_min = sub(t0_max, 9);
        }
      } else {
        int d = t0 - t0_min;
        if (d < 0) d = 0;
        if (d > 9) d = 9;
        t0 = (Word16)(t0_min + d);
        prm[1 + prm_i++] = (Word16)(3 * d + 2 + frac);
      }

      /* decoder-exact adaptive vector + its WEIGHTED-domain image */
      Pred_Lt(&exc[i_subfr], t0, frac, kSubfrLen);
      for (int n = 0; n < kSubfrLen; n++) {
        float yy = 0.0f;
        for (int j = 0; j <= n; j++)
          yy += (float)exc[i_subfr + j] * hw[n - j];
        y[n] = yy;
      }
      {
        double num = 0.0, den = 1e-6;
        for (int n = 0; n < kSubfrLen; n++) {
          num += (double)xw[n] * y[n];
          den += (double)y[n] * y[n];
        }
        gp_f = num / den;
        if (gp_f < 0.0) gp_f = 0.0;
        if (gp_f > 1.2) gp_f = 1.2;
      }
      float x2[kSubfrLen];
      for (int n = 0; n < kSubfrLen; n++)
        x2[n] = xw[n] - (float)gp_f * y[n];

      /* decoder-exact weighted impulse response F (pitch sharpened) */
      Word16 Ap3[11], Ap4[11];
      Word16 F[64 + kSubfrLen];
      Word16 *h = &F[64];
      for (int i = 0; i < 64; i++) F[i] = 0;
      Pond_Ai(a, f_gamma3, Ap3);
      Pond_Ai(a, f_gamma4, Ap4);
      for (int i = 0; i <= 10; i++) h[i] = Ap3[i];
      for (int i = 11; i <= 59; i++) h[i] = 0;
      Syn_Filt(Ap4, h, h, kSubfrLen, &h[11], 0);
      for (int i = t0; i <= 59; i++)
        h[i] = add(h[i], mult(h[i - t0], 0x6668));

      /* algebraic search: exact joint optimization over the D4i60
       * candidate space.  Each code vector is a +-combination of four
       * track pulses into the F response; its synthesis-domain image is
       * the same combination of per-track images, so with per-track
       * images, correlations and gram matrices precomputed the full
       * 32x8x8x8x2x2 space scores in O(1) per candidate. */
      double d0[2][32], d1[2][8], d2[2][8], d3[2][8];
      double E0[2][32], E1[2][8], E2[2][8], E3[2][8];
      double G01[2][32][8], G02[2][32][8], G03[2][32][8];
      double G12[2][8][8], G13[2][8][8], G23[2][8][8];
      static thread_local float tr0[2][32][kSubfrLen];
      static thread_local float tr1[2][8][kSubfrLen];
      static thread_local float tr2[2][8][kSubfrLen];
      static thread_local float tr3[2][8][kSubfrLen];
      for (int sh = 0; sh < 2; sh++) {
        auto track_image = [&](int pos, float *out) {
          const Word16 *f = h - sh - pos;
          for (int n = 0; n < kSubfrLen; n++) {
            float yy = 0.0f;
            for (int j = 0; j <= n; j++)
              yy += (float)f[j] * hw[n - j];
            out[n] = yy;
          }
        };
        for (int k = 0; k < 32; k++) track_image(2 * k, tr0[sh][k]);
        for (int k = 0; k < 8; k++) track_image(8 * k + 2, tr1[sh][k]);
        for (int k = 0; k < 8; k++) track_image(8 * k + 4, tr2[sh][k]);
        for (int k = 0; k < 8; k++) track_image(8 * k + 6, tr3[sh][k]);
        auto dot = [&](const float *u, const float *v) {
          double acc = 0.0;
          for (int n = 0; n < kSubfrLen; n++) acc += (double)u[n] * v[n];
          return acc;
        };
        for (int k = 0; k < 32; k++) {
          d0[sh][k] = dot(x2, tr0[sh][k]);
          E0[sh][k] = dot(tr0[sh][k], tr0[sh][k]);
        }
        for (int k = 0; k < 8; k++) {
          d1[sh][k] = dot(x2, tr1[sh][k]);
          E1[sh][k] = dot(tr1[sh][k], tr1[sh][k]);
          d2[sh][k] = dot(x2, tr2[sh][k]);
          E2[sh][k] = dot(tr2[sh][k], tr2[sh][k]);
          d3[sh][k] = dot(x2, tr3[sh][k]);
          E3[sh][k] = dot(tr3[sh][k], tr3[sh][k]);
        }
        for (int i = 0; i < 32; i++)
          for (int j = 0; j < 8; j++) {
            G01[sh][i][j] = dot(tr0[sh][i], tr1[sh][j]);
            G02[sh][i][j] = dot(tr0[sh][i], tr2[sh][j]);
            G03[sh][i][j] = dot(tr0[sh][i], tr3[sh][j]);
          }
        for (int i = 0; i < 8; i++)
          for (int j = 0; j < 8; j++) {
            G12[sh][i][j] = dot(tr1[sh][i], tr2[sh][j]);
            G13[sh][i][j] = dot(tr1[sh][i], tr3[sh][j]);
            G23[sh][i][j] = dot(tr2[sh][i], tr3[sh][j]);
          }
      }
      const double R2 = 1.4142135623730951;
      int best_idx = 0, best_sign = 0, best_shift = 0;
      double best_cb_score = -1e30;
      for (int sh = 0; sh < 2; sh++)
        for (int k0 = 0; k0 < 32; k0++)
          for (int k1 = 0; k1 < 8; k1++)
            for (int k2 = 0; k2 < 8; k2++) {
              double base_d = R2 * d0[sh][k0] - d1[sh][k1] + d2[sh][k2];
              double base_e = 2.0 * E0[sh][k0] + E1[sh][k1] + E2[sh][k2]
                  - 2.0 * R2 * G01[sh][k0][k1]
                  + 2.0 * R2 * G02[sh][k0][k2]
                  - 2.0 * G12[sh][k1][k2];
              for (int k3 = 0; k3 < 8; k3++) {
                double dd = base_d - d3[sh][k3];
                double ee = base_e + E3[sh][k3]
                    - 2.0 * R2 * G03[sh][k0][k3]
                    + 2.0 * G13[sh][k1][k3]
                    - 2.0 * G23[sh][k2][k3] + 1e-6;
                double score = dd * dd / ee;     /* sign-free */
                if (score > best_cb_score) {
                  best_cb_score = score;
                  best_idx = k0 | (k1 << 5) | (k2 << 8) | (k3 << 11);
                  best_sign = dd < 0.0 ? 1 : 0;
                  best_shift = sh;
                }
              }
            }
      prm[1 + prm_i++] = (Word16)best_idx;
      prm[1 + prm_i++] = (Word16)best_sign;
      prm[1 + prm_i++] = (Word16)best_shift;

      Word16 code[kSubfrLen];
      D_D4i60((Word16)best_idx, (Word16)best_sign, (Word16)best_shift,
              h, code);
      float yc[kSubfrLen];
      for (int n = 0; n < kSubfrLen; n++) {
        float yy = 0.0f;
        for (int j = 0; j <= n; j++)
          yy += (float)code[j] * hw[n - j];
        yc[n] = yy;
      }

      /* energy index: decoder-exact trial of all 64 indices, selecting
       * the one whose DECODED gains best reconstruct the target in the
       * WEIGHTED domain */
      Word16 ener_pit, ener_cod;
      Ener_Measure(a, &exc[i_subfr], code, kSubfrLen, &ener_pit,
                   &ener_cod);
      int best_ei = 0;
      double best_err = 1e30;
      Word16 sel_gp = 0, sel_gc = 0;
      for (int ei = 0; ei < 64; ei++) {
        Word16 lp = last_ener_pit, lc = last_ener_cod, gp, gc;
        Ener_Update((Word16)ei, &lp, &lc);
        Ener_Gains(lp, lc, ener_pit, ener_cod, &gp, &gc);
        double err = 0.0;
        for (int n = 0; n < kSubfrLen; n++) {
          double e = xw[n] - ((double)gp / 4096.0) * y[n]
                     - ((double)gc / 4096.0) * yc[n];
          err += e * e;
        }
        if (err < best_err) {
          best_err = err;
          best_ei = ei;
          sel_gp = gp;
          sel_gc = gc;
        }
      }
      prm[1 + prm_i++] = (Word16)best_ei;
      Ener_Update((Word16)best_ei, &last_ener_pit, &last_ener_cod);

      /* decoder-exact excitation update + synthesis memory update */
      for (int i = 0; i < kSubfrLen; i++) {
        Word32 L = L_mult0(sel_gp, exc[i_subfr + i]);
        L = L_mac0(L, sel_gc, code[i]);
        exc[i_subfr + i] = (Word16)L_shr_r(L, 12);
      }
      Word16 synth_loc[kSubfrLen];
      Syn_Filt(a, &exc[i_subfr], synth_loc, kSubfrLen, mem_syn, 1);
      /* carry the W-filter state: true error e = s - s_hat (input
       * side) and the realized weighted error (output side, via the
       * DECODED gains so it matches what any receiver reproduces) */
      for (int i = 0; i < 10; i++) {
        int n = kSubfrLen - 10 + i;
        wu_hist[i] = (float)pcm[i_subfr + n] - (float)synth_loc[n];
        wy_hist[i] = xw[n] - ((float)sel_gp / 4096.0f) * y[n]
                     - ((float)sel_gc / 4096.0f) * yc[n];
      }
      a += 11;
    }

    /* Full kExcOff-word shift — exc[-1] must be last frame's final
     * excitation sample (see the matching fix in etsi_acelp_dec.cpp). */
    for (int i = 0; i < kExcOff; i++) old_exc[i] = old_exc[i + kFrameLen];
  }
};

}  // namespace etsi

extern "C" {

void *tetra_etsi_encoder_new(void) {
  return new (std::nothrow) etsi::EtsiEncoder();
}

void tetra_etsi_encoder_free(void *enc) {
  delete static_cast<etsi::EtsiEncoder *>(enc);
}

int tetra_etsi_encode_frame(void *enc, const int16_t *pcm,
                            int16_t *prm /*1+23*/) {
  if (!enc || !pcm || !prm) return 1;
  static_cast<etsi::EtsiEncoder *>(enc)->encode(pcm, prm);
  return 0;
}

}  /* extern "C" */

/* test/debug exports of the gain machinery */
extern "C" {
void tetra_etsi_ener_measure(const int16_t *a, const int16_t *prd_lt,
                             const int16_t *code, int16_t l,
                             int16_t *ep, int16_t *ec) {
  etsi::Ener_Measure(a, prd_lt, code, l, ep, ec);
}
void tetra_etsi_ener_gains_for(int16_t index, int16_t last_pit,
                               int16_t last_cod, int16_t ep, int16_t ec,
                               int16_t *out /* [gp, gc, new_lp, new_lc] */) {
  int16_t lp = last_pit, lc = last_cod, gp, gc;
  etsi::Ener_Update(index, &lp, &lc);
  etsi::Ener_Gains(lp, lc, ep, ec, &gp, &gc);
  out[0] = gp; out[1] = gc; out[2] = lp; out[3] = lc;
}
}

/* test export: float LPC -> TETRA cosine-domain LSPs */
extern "C" void tetra_etsi_lpc_to_lsp(const float *a, int16_t *lsp) {
  etsi::lpc_to_lsp_export(a, lsp);
}
