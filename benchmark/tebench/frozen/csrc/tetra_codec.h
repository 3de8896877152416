/* TETRA voice codec library — C API.
 *
 * In-process replacement for the four ETSI TS 300 395-2 reference
 * executables the reference app shells out to per frame
 * (tetraear/audio/voice.py:124-183; tetraear/tetra_codec/bin exes):
 *
 *   tetra_channel_decode  ~ cdecoder.exe   (soft bits -> params + BFI)
 *   tetra_speech_decode   ~ sdecoder.exe   (params -> 8 kHz PCM)
 *   tetra_channel_encode  ~ ccoder.exe     (params -> soft-bit block)
 *   tetra_speech_encode   ~ scoder.exe     (PCM -> params)
 *
 * Wire format is byte-compatible with the reference at the block level:
 * a codec block is 690 little-endian int16 words (header 0x6B21 + 689
 * soft bits in [-127,127] laid out per Write_Tetra_File), and the channel
 * decoder emits (BFI + 137 parameter words) x 2 speech frames.
 *
 * The channel codec is ETSI EN 300 395-2 TCH/S spec-exact (class
 * partition, RCPC puncturing, CRC, interleaving — see etsi_tables.h and
 * channel.cpp; encoder verified bit-exact against the reference
 * Channel_Encoding binary in tests/codec/test_etsi_oracle.py).  The
 * ACELP *speech* bit allocation is still an original design: a real
 * off-air block channel-decodes to the spec's 137-bit frames with a
 * correct BFI, while speech synthesis from those frames awaits the
 * ETSI ACELP tables.
 */

#ifndef TETRA_CODEC_H
#define TETRA_CODEC_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define TETRA_BLOCK_WORDS 690
#define TETRA_BLOCK_SOFT_BITS 432
#define TETRA_FRAME_PARAM_WORDS 137   /* bits per 30 ms speech frame */
#define TETRA_FRAMES_PER_BLOCK 2
#define TETRA_SAMPLES_PER_FRAME 240   /* 30 ms at 8 kHz */
#define TETRA_HEADER 0x6B21

/* Channel decode: block[690] soft words -> out[2*(1+137)] int16:
 * for each speech frame, out[0] = BFI (0 ok, 1 bad), out[1..137] = bits.
 * Returns 0 on success, nonzero on malformed input. */
int tetra_channel_decode(const int16_t *block, int16_t *out);

/* Channel encode: params[2*(1+137)] -> block[690] (header + hard +-127
 * soft bits).  Returns 0 on success. */
int tetra_channel_encode(const int16_t *params, int16_t *block);

/* Raw slot-level API (no .tet block framing), ETSI EN 300 395-2:
 * two 137-bit frames <-> 432 +-127 soft bits; decode returns 0 on CRC
 * pass, -1 on BFI (frames still filled with the best-path bits). */
int tetra_channel_encode_slot(const int16_t *frame_a,
                              const int16_t *frame_b, int16_t *soft432);
int tetra_channel_decode_slot(const int16_t *soft432, int16_t *frame_a,
                              int16_t *frame_b);

/* Frame-stealing half slot: one 137-bit frame <-> 216 soft bits. */
int tetra_channel_encode_stolen(const int16_t *frame, int16_t *soft216);
int tetra_channel_decode_stolen(const int16_t *soft216, int16_t *frame);

/* Speech decoder instance (carries LPC/excitation memory). */
void *tetra_speech_decoder_new(void);
void tetra_speech_decoder_free(void *dec);

/* params[1+137] ([BFI, bits...]) -> pcm[240].  On BFI the previous
 * frame's parameters are reused with damped gains (ETSI-style
 * concealment).  Returns 0 on success. */
int tetra_speech_decode(void *dec, const int16_t *params, int16_t *pcm);

/* n_frames x params[138] -> n_frames x pcm[240] on one state in ONE
 * call (keeps the caller's GIL released for the whole run; see
 * etsi_speech_api.cpp).  Returns 0 on success, the 1-based index of
 * the first failing frame otherwise (state advanced through it). */
int tetra_speech_decode_many(void *dec, const int16_t *params,
                             int32_t n_frames, int16_t *pcm);

/* Decoder state (de)serialization for checkpoint/resume: a flat
 * little-endian int16 image of the LPC/excitation memory (field order
 * is part of the format).  get/set buffers must hold
 * tetra_speech_decoder_state_size() bytes. */
int tetra_speech_decoder_state_size(void);
void tetra_speech_decoder_get_state(const void *dec, int16_t *buf);
void tetra_speech_decoder_set_state(void *dec, const int16_t *buf);

/* Speech encoder instance. */
void *tetra_speech_encoder_new(void);
void tetra_speech_encoder_free(void *enc);

/* pcm[240] -> params[1+137] (BFI always 0).  Returns 0 on success. */
int tetra_speech_encode(void *enc, const int16_t *pcm, int16_t *params);

#ifdef __cplusplus
}
#endif

#endif /* TETRA_CODEC_H */
