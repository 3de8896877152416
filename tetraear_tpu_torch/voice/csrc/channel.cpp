/* TETRA speech channel codec — ETSI EN 300 395-2 TCH/S coding.
 *
 * Spec-exact: class partition, RCPC puncturing, CRC and interleaving
 * follow the ETSI reference channel codec bit for bit (constants and
 * structure recovered from the reference binaries the upstream app
 * ships — see etsi_tables.h; verified against the reference
 * Channel_Encoding in tests/codec/test_etsi_oracle.py).  A 432-soft-bit
 * block captured off the air therefore channel-decodes here exactly as
 * it does through cdecoder.exe: same class bits, same CRC verdict (BFI).
 *
 * Coding pipeline for one 60 ms block (2 x 137-bit speech frames):
 *
 *   frames A,B --TAB0/1/2--> ordered[286]:
 *        [0..101] class 0 (A/B pair-interleaved), [102..213] class 1,
 *        [214..273] class 2, [274..281] CRC-8, [282..285] zero tail
 *   ordered[102..285] --RCPC K=5 r=1/3 G={0x1F,0x1B,0x15}, punctured
 *        8/12 (class 1) and 8/18 (class 2+CRC+tail)--> 330 code bits
 *   [class0 102 | code 330] as +-127 soft --18x24 block interleave--> 432
 *
 * Frame stealing (one frame -> 216-bit half slot) uses the same pipeline
 * with single-frame classes, CRC-4 and the (101*(i+1)) mod 216
 * interleaver.
 *
 * The Viterbi decoder is an original soft-decision implementation of
 * this code (correlation metric, forced zero end state, deterministic
 * first-max tie-break — mirrored exactly by the batched JAX decoder in
 * tetraear_tpu/voice/jviterbi.py).
 */

#include "tetra_codec.h"
#include "etsi_tables.h"

#include <cstring>

namespace {

constexpr int kStates = 16;
constexpr int kSoftBits = TETRA_BLOCK_SOFT_BITS;          /* 432 */
constexpr int kHalfBits = kSoftBits / 2;                  /* 216 */
constexpr int kFrameBits = TETRA_FRAME_PARAM_WORDS;       /* 137 */
constexpr int kMaxSteps = 184;            /* class1 + class2 + CRC + tail */

inline int parity(unsigned x) { return __builtin_parity(x); }

/* ---- mode descriptors ------------------------------------------------ */

struct Mode {
  int n0, n1, n2, ncrc;        /* ordered-array section sizes */
  const short *a2;             /* V3 select pattern (step mod 8) */
};
constexpr Mode kSpeech = {102, 112, 60, 8, ETSI_A2};
constexpr Mode kStolen = {51, 56, 30, 4, ETSI_FS_A2};

inline int conv_steps(const Mode &m) { return m.n1 + m.n2 + m.ncrc + 4; }
inline int coded_bits(const Mode &m) {
  /* V1 every step; V2 on class1 even steps and every class2 step; V3
   * per a2 pattern over the class2 span. */
  int n = m.n0 + m.n1;                 /* class0 + class1 V1 */
  for (int i = 0; i < m.n1; ++i) n += ETSI_A1[i % 8];
  int span2 = m.n2 + m.ncrc + 4;
  n += 2 * span2;
  for (int i = 0; i < span2; ++i) n += m.a2[i % 8];
  return n;
}

/* Per-step stream presence: fills present[step] bits (1|2|4 = V1|V2|V3).
 * Returns total punctured code bits (excluding class 0). */
int puncture_schedule(const Mode &m, uint8_t *present) {
  int total = 0;
  int steps = conv_steps(m);
  for (int i = 0; i < steps; ++i) {
    uint8_t p;
    if (i < m.n1) {
      p = (uint8_t)(1 | (ETSI_A1[i % 8] ? 2 : 0));
    } else {
      int a = (i - m.n1) % 8;
      p = (uint8_t)(1 | 2 | (m.a2[a] ? 4 : 0));
    }
    present[i] = p;
    total += (p & 1) + ((p >> 1) & 1) + ((p >> 2) & 1);
  }
  return total;
}

/* ---- ordered-array construction ------------------------------------- */

void build_ordered_speech(const int16_t *frame_a, const int16_t *frame_b,
                          uint8_t *ordered /*286*/) {
  for (int k = 0; k < 51; ++k) {
    ordered[2 * k] = (uint8_t)(frame_a[ETSI_TAB0[k] - 1] & 1);
    ordered[2 * k + 1] = (uint8_t)(frame_b[ETSI_TAB0[k] - 1] & 1);
  }
  for (int k = 0; k < 56; ++k) {
    ordered[102 + 2 * k] = (uint8_t)(frame_a[ETSI_TAB1[k] - 1] & 1);
    ordered[102 + 2 * k + 1] = (uint8_t)(frame_b[ETSI_TAB1[k] - 1] & 1);
  }
  for (int k = 0; k < 30; ++k) {
    ordered[214 + 2 * k] = (uint8_t)(frame_a[ETSI_TAB2[k] - 1] & 1);
    ordered[214 + 2 * k + 1] = (uint8_t)(frame_b[ETSI_TAB2[k] - 1] & 1);
  }
  for (int k = 0; k < 8; ++k) {       /* CRC over the class-2 block */
    int acc = 0;
    for (int i = 0; i < ETSI_TAB_CRC_LEN[k]; ++i)
      acc ^= ordered[214 + ETSI_TAB_CRC[k][i] - 1];
    ordered[274 + k] = (uint8_t)(acc & 1);
  }
  for (int k = 0; k < 4; ++k) ordered[282 + k] = 0;
}

void unbuild_ordered_speech(const uint8_t *ordered, int16_t *frame_a,
                            int16_t *frame_b) {
  for (int k = 0; k < 51; ++k) {
    frame_a[ETSI_TAB0[k] - 1] = ordered[2 * k];
    frame_b[ETSI_TAB0[k] - 1] = ordered[2 * k + 1];
  }
  for (int k = 0; k < 56; ++k) {
    frame_a[ETSI_TAB1[k] - 1] = ordered[102 + 2 * k];
    frame_b[ETSI_TAB1[k] - 1] = ordered[102 + 2 * k + 1];
  }
  for (int k = 0; k < 30; ++k) {
    frame_a[ETSI_TAB2[k] - 1] = ordered[214 + 2 * k];
    frame_b[ETSI_TAB2[k] - 1] = ordered[214 + 2 * k + 1];
  }
}

void build_ordered_stolen(const int16_t *frame, uint8_t *ordered /*145*/) {
  for (int k = 0; k < 51; ++k)
    ordered[k] = (uint8_t)(frame[ETSI_TAB0[k] - 1] & 1);
  for (int k = 0; k < 56; ++k)
    ordered[51 + k] = (uint8_t)(frame[ETSI_TAB1[k] - 1] & 1);
  for (int k = 0; k < 30; ++k)
    ordered[107 + k] = (uint8_t)(frame[ETSI_TAB2[k] - 1] & 1);
  for (int k = 0; k < 4; ++k) {
    int acc = 0;
    for (int i = 0; i < 16; ++i)
      acc ^= ordered[107 + ETSI_FS_TAB_CRC[k][i] - 1];
    ordered[137 + k] = (uint8_t)(acc & 1);
  }
  for (int k = 0; k < 4; ++k) ordered[141 + k] = 0;
}

/* ---- RCPC encode ------------------------------------------------------ */

/* ordered bits -> +-127 soft code stream (class 0 passed through). */
void rcpc_encode(const Mode &m, const uint8_t *ordered, int16_t *out) {
  for (int i = 0; i < m.n0; ++i) out[i] = ordered[i] ? -127 : 127;
  uint8_t present[kMaxSteps];
  puncture_schedule(m, present);
  unsigned reg = 0;
  int j = m.n0;
  int steps = conv_steps(m);
  for (int i = 0; i < steps; ++i) {
    unsigned b = ordered[m.n0 + i];
    unsigned lsb = reg & 1;
    reg = (reg >> 1) | (b << 3);
    unsigned w = (reg << 1) | lsb;         /* 5-bit window, bit4 newest */
    if (present[i] & 1) out[j++] = parity(w & ETSI_G1) ? -127 : 127;
    if (present[i] & 2) out[j++] = parity(w & ETSI_G2) ? -127 : 127;
    if (present[i] & 4) out[j++] = parity(w & ETSI_G3) ? -127 : 127;
  }
}

/* ---- soft Viterbi decode ---------------------------------------------- */

/* soft code stream (after de-interleave, class 0 stripped) -> ordered
 * conv-input bits.  Deterministic: predecessors scanned in (state, bit)
 * order, strict-greater replacement — the JAX decoder mirrors this. */
void rcpc_decode(const Mode &m, const int16_t *soft, uint8_t *bits) {
  constexpr int NEG = -(1 << 28);
  uint8_t present[kMaxSteps];
  puncture_schedule(m, present);
  int steps = conv_steps(m);

  int metric[kStates], next[kStates];
  static thread_local uint8_t decisions[kMaxSteps][kStates];
  for (int s = 0; s < kStates; ++s) metric[s] = (s == 0) ? 0 : NEG;

  int j = 0;
  for (int i = 0; i < steps; ++i) {
    int r1 = (present[i] & 1) ? soft[j++] : 0;
    int r2 = (present[i] & 2) ? soft[j++] : 0;
    int r3 = (present[i] & 4) ? soft[j++] : 0;
    for (int s = 0; s < kStates; ++s) next[s] = NEG;
    for (int s = 0; s < kStates; ++s) {
      if (metric[s] <= NEG) continue;
      for (unsigned b = 0; b < 2; ++b) {
        unsigned ns = ((unsigned)s >> 1) | (b << 3);
        unsigned w = (ns << 1) | ((unsigned)s & 1);
        int e1 = parity(w & ETSI_G1) ? -1 : 1;
        int e2 = parity(w & ETSI_G2) ? -1 : 1;
        int e3 = parity(w & ETSI_G3) ? -1 : 1;
        int mtr = metric[s] + e1 * r1 + e2 * r2 + e3 * r3;
        if (mtr > next[ns]) {
          next[ns] = mtr;
          decisions[i][ns] = (uint8_t)((s << 1) | b);
        }
      }
    }
    std::memcpy(metric, next, sizeof(metric));
  }

  int state = 0;                       /* zero tail forces end state 0 */
  for (int i = steps - 1; i >= 0; --i) {
    uint8_t d = decisions[i][state];
    bits[i] = (uint8_t)(d & 1);
    state = d >> 1;
  }
}

/* ---- interleaving ----------------------------------------------------- */

void interleave_speech(const int16_t *in, int16_t *out) {
  for (int a = 0; a < 18; ++a)
    for (int b = 0; b < 24; ++b)
      out[24 * a + b] = in[18 * b + a];
}

void deinterleave_speech(const int16_t *in, int16_t *out) {
  for (int a = 0; a < 18; ++a)
    for (int b = 0; b < 24; ++b)
      out[18 * b + a] = in[24 * a + b];
}

void interleave_stolen(const int16_t *in, int16_t *out) {
  for (int i = 0; i < kHalfBits; ++i)
    out[(101 * (i + 1)) % kHalfBits] = in[i];
}

void deinterleave_stolen(const int16_t *in, int16_t *out) {
  for (int i = 0; i < kHalfBits; ++i)
    out[i] = in[(101 * (i + 1)) % kHalfBits];
}

/* ---- block (wire) layout ---------------------------------------------- */

/* .tet frame: 6 sub-blocks of (header 0x6B21+k, 114 payload words); the
 * 432 slot bits occupy the first 432 payload positions
 * (reference Write_Tetra_File; tetraear/ui/modern.py:2302-2416). */
struct Span { int lo, hi; };
constexpr Span kSpans[4] = {{1, 115}, {116, 230}, {231, 345}, {346, 436}};

void block_to_soft(const int16_t *block, int16_t *soft /*432*/) {
  int idx = 0;
  for (const auto &s : kSpans)
    for (int i = s.lo; i < s.hi && idx < kSoftBits; ++i)
      soft[idx++] = block[i];
  while (idx < kSoftBits) soft[idx++] = 0;
}

void soft_to_block(const int16_t *soft, int16_t *block) {
  std::memset(block, 0, sizeof(int16_t) * TETRA_BLOCK_WORDS);
  for (int k = 0; k < 6; ++k)
    block[115 * k] = (int16_t)(TETRA_HEADER + k);
  int idx = 0;
  for (const auto &s : kSpans)
    for (int i = s.lo; i < s.hi && idx < kSoftBits; ++i)
      block[i] = soft[idx++];
}

}  // namespace

/* ---- public API ------------------------------------------------------- */

extern "C" int tetra_channel_encode_slot(const int16_t *frame_a,
                                         const int16_t *frame_b,
                                         int16_t *soft432) {
  if (!frame_a || !frame_b || !soft432) return 1;
  uint8_t ordered[286];
  build_ordered_speech(frame_a, frame_b, ordered);
  int16_t enc[kSoftBits];
  rcpc_encode(kSpeech, ordered, enc);
  interleave_speech(enc, soft432);
  return 0;
}

extern "C" int tetra_channel_decode_slot(const int16_t *soft432,
                                         int16_t *frame_a,
                                         int16_t *frame_b) {
  if (!soft432 || !frame_a || !frame_b) return 1;
  int16_t de[kSoftBits];
  deinterleave_speech(soft432, de);
  uint8_t ordered[286] = {0};
  rcpc_decode(kSpeech, de + kSpeech.n0, ordered + kSpeech.n0);
  for (int i = 0; i < kSpeech.n0; ++i)
    ordered[i] = (uint8_t)(de[i] < 0);           /* Untransform_Class_0 */
  int bfi = 0;
  for (int k = 0; k < 8; ++k) {
    int acc = 0;
    for (int i = 0; i < ETSI_TAB_CRC_LEN[k]; ++i)
      acc ^= ordered[214 + ETSI_TAB_CRC[k][i] - 1];
    if ((acc & 1) != ordered[274 + k]) bfi = 1;
  }
  unbuild_ordered_speech(ordered, frame_a, frame_b);
  return bfi ? -1 : 0;
}

extern "C" int tetra_channel_encode_stolen(const int16_t *frame,
                                           int16_t *soft216) {
  if (!frame || !soft216) return 1;
  uint8_t ordered[145];
  build_ordered_stolen(frame, ordered);
  int16_t enc[kHalfBits];
  rcpc_encode(kStolen, ordered, enc);
  interleave_stolen(enc, soft216);
  return 0;
}

extern "C" int tetra_channel_decode_stolen(const int16_t *soft216,
                                           int16_t *frame) {
  if (!soft216 || !frame) return 1;
  int16_t de[kHalfBits];
  deinterleave_stolen(soft216, de);
  uint8_t ordered[145] = {0};
  rcpc_decode(kStolen, de + kStolen.n0, ordered + kStolen.n0);
  for (int i = 0; i < kStolen.n0; ++i) ordered[i] = (uint8_t)(de[i] < 0);
  int bfi = 0;
  for (int k = 0; k < 4; ++k) {
    int acc = 0;
    for (int i = 0; i < 16; ++i)
      acc ^= ordered[107 + ETSI_FS_TAB_CRC[k][i] - 1];
    if ((acc & 1) != ordered[137 + k]) bfi = 1;
  }
  for (int k = 0; k < 51; ++k) frame[ETSI_TAB0[k] - 1] = ordered[k];
  for (int k = 0; k < 56; ++k) frame[ETSI_TAB1[k] - 1] = ordered[51 + k];
  for (int k = 0; k < 30; ++k) frame[ETSI_TAB2[k] - 1] = ordered[107 + k];
  return bfi ? -1 : 0;
}

extern "C" int tetra_channel_encode(const int16_t *params, int16_t *block) {
  if (!params || !block) return 1;
  const int16_t *fa = params + 1;
  const int16_t *fb = params + (1 + kFrameBits) + 1;
  int16_t soft[kSoftBits];
  if (tetra_channel_encode_slot(fa, fb, soft)) return 1;
  soft_to_block(soft, block);
  return 0;
}

extern "C" int tetra_channel_decode(const int16_t *block, int16_t *out) {
  if (!block || !out) return 1;
  if ((uint16_t)block[0] != TETRA_HEADER) return 2;
  int16_t soft[kSoftBits];
  block_to_soft(block, soft);
  int16_t fa[kFrameBits], fb[kFrameBits];
  int bfi = tetra_channel_decode_slot(soft, fa, fb) ? 1 : 0;
  out[0] = (int16_t)bfi;
  std::memcpy(out + 1, fa, sizeof(fa));
  out[1 + kFrameBits] = (int16_t)bfi;
  std::memcpy(out + 2 + kFrameBits, fb, sizeof(fb));
  return 0;
}
