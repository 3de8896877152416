/* Public speech-codec API (tetra_codec.h) over the ETSI ACELP codec.
 *
 * tetra_speech_decode consumes the [BFI + 137 serial bits] frames the
 * channel decoder emits, unpacks them with the spec's 23-parameter
 * layout (Bits2prm) and synthesizes through the spec-exact decoder
 * (etsi_acelp_dec.cpp, bit-exact vs the reference sdecoder binary) +
 * Post_Process — so genuinely off-air TETRA voice decodes to real
 * speech.  tetra_speech_encode produces ETSI-format frames via the
 * analysis-by-synthesis encoder (etsi_acelp_enc.cpp); any conforming
 * decoder (ours or the reference) reconstructs them.
 */

#include "tetra_codec.h"
#include "etsi_acelp_internal.h"

#include <cstring>

extern "C" {

void *tetra_etsi_decoder_new(void);
void tetra_etsi_decoder_free(void *);
int tetra_etsi_decode_frame(void *, const int16_t *, int16_t *);
void tetra_etsi_post_process(int16_t *, int16_t);
void tetra_etsi_bits2prm(const int16_t *, int16_t *);
void tetra_etsi_prm2bits(const int16_t *, int16_t *);
void *tetra_etsi_encoder_new(void);
void tetra_etsi_encoder_free(void *);
int tetra_etsi_encode_frame(void *, const int16_t *, int16_t *);

int tetra_etsi_decoder_state_size(void);
void tetra_etsi_decoder_get_state(const void *, int16_t *);
void tetra_etsi_decoder_set_state(void *, const int16_t *);

void *tetra_speech_decoder_new(void) { return tetra_etsi_decoder_new(); }

void tetra_speech_decoder_free(void *dec) { tetra_etsi_decoder_free(dec); }

int tetra_speech_decoder_state_size(void) {
  return tetra_etsi_decoder_state_size();
}

void tetra_speech_decoder_get_state(const void *dec, int16_t *buf) {
  tetra_etsi_decoder_get_state(dec, buf);
}

void tetra_speech_decoder_set_state(void *dec, const int16_t *buf) {
  tetra_etsi_decoder_set_state(dec, buf);
}

int tetra_speech_decode(void *dec, const int16_t *params, int16_t *pcm) {
  if (!dec || !params || !pcm) return 1;
  int16_t prm[24];
  tetra_etsi_bits2prm(params, prm);     /* params = [BFI, 137 bits] */
  if (tetra_etsi_decode_frame(dec, prm, pcm)) return 1;
  tetra_etsi_post_process(pcm, TETRA_SAMPLES_PER_FRAME);
  return 0;
}

int tetra_speech_decode_many(void *dec, const int16_t *params,
                             int32_t n_frames, int16_t *pcm) {
  /* n_frames sequential decodes on one state in ONE foreign call: the
   * per-frame ctypes round trip holds the Python GIL long enough that
   * threaded per-carrier synthesis ran SLOWER than sequential (GIL
   * convoy); batching a carrier's whole slot list keeps the GIL
   * released for the full run.  Stops at the first failing frame
   * (same state advancement as the per-frame loop it replaces) and
   * returns its 1-based index, 0 on success. */
  if (!dec || !params || !pcm || n_frames < 0) return -1;
  for (int32_t i = 0; i < n_frames; i++) {
    if (tetra_speech_decode(dec, params + (size_t)i * 138,
                            pcm + (size_t)i * TETRA_SAMPLES_PER_FRAME))
      return (int)i + 1;
  }
  return 0;
}

void *tetra_speech_encoder_new(void) { return tetra_etsi_encoder_new(); }

void tetra_speech_encoder_free(void *enc) { tetra_etsi_encoder_free(enc); }

int tetra_speech_encode(void *enc, const int16_t *pcm, int16_t *params) {
  if (!enc || !pcm || !params) return 1;
  /* the synthesis side applies Post_Process (x2): pre-compensate so
   * a loopback returns at input level */
  int16_t half[TETRA_SAMPLES_PER_FRAME];
  for (int i = 0; i < TETRA_SAMPLES_PER_FRAME; i++)
    half[i] = (int16_t)(pcm[i] / 2);
  int16_t prm[24];
  if (tetra_etsi_encode_frame(enc, half, prm)) return 1;
  tetra_etsi_prm2bits(prm, params);     /* params[0] = BFI = 0 */
  return 0;
}

}  /* extern "C" */
