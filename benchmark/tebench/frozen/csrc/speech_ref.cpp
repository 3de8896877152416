/* The speech decoding the benchmark's reference runs: a carrier's frames
 * [BFI, 137 parameter bits] in order on one ETSI decoder state, each
 * frame's 240 samples Post_Process'd (x2), as the standard's decoder
 * gives them. */
#include <stdint.h>

extern "C" {
void *tetra_etsi_decoder_new(void);
void tetra_etsi_decoder_free(void *);
int tetra_etsi_decode_frame(void *, const int16_t *, int16_t *);
void tetra_etsi_post_process(int16_t *, int16_t);
void tetra_etsi_bits2prm(const int16_t *, int16_t *);

int ref_decode_stream(const int16_t *frames, int32_t n, int16_t *pcm) {
  void *dec = tetra_etsi_decoder_new();
  if (!dec) return -1;
  for (int32_t i = 0; i < n; i++) {
    int16_t prm[24];
    tetra_etsi_bits2prm(frames + (long)i * 138, prm);
    if (tetra_etsi_decode_frame(dec, prm, pcm + (long)i * 240)) {
      tetra_etsi_decoder_free(dec);
      return (int)i + 1;
    }
    tetra_etsi_post_process(pcm + (long)i * 240, 240);
  }
  tetra_etsi_decoder_free(dec);
  return 0;
}
}
