/* ETSI EN 300 395-2 TCH/S channel-coding constants.
 *
 * Recovered by disassembling the reference codec binaries the upstream
 * app ships (tetraear/tetra_codec/bin/{ccoder,cdecoder}.exe — the ETSI
 * reference implementation compiled from the TS 300 395-2 source
 * archive; symbols Build_Sensitivity_Classes / Init_Rcpc_Coding /
 * Rcpc_Coding / Build_Crc / Interleaving_Speech and the .rdata tables
 * TAB0/TAB1/TAB2, A1/A2/Fs_A2, TAB_CRC1..8, Fs_TAB_CRC1..4).  These are
 * the spec's published constants, not code: the implementation around
 * them is original.
 *
 * Structure of the 60 ms speech block (2 x 137-bit frames -> 432 bits):
 *
 *   sensitivity classes per frame: class0 51 + class1 56 + class2 30
 *   ordered array (frames A/B pair-interleaved):
 *     [0..101]   class 0  (unprotected, transmitted as-is)
 *     [102..213] class 1
 *     [214..273] class 2
 *     [274..281] 8 CRC bits over the class-2 block
 *     [282..285] 4 zero tail bits
 *   RCPC: K=5 mother code rate 1/3, window w = newest..oldest 5 input
 *   bits, generators G1=0x1F, G2=0x1B, G3=0x15 (parity of w & G);
 *   class 1 emits V1 always + V2 on even steps (rate 8/12); class 2 +
 *   CRC + tail emit V1,V2 always + V3 on steps 0,4 mod 8 (rate 8/18);
 *   102 + 168 + 162 = 432.  Code bit 0 -> +127, 1 -> -127.
 *   Interleaver: out[24*a + b] = in[18*b + a], a<18, b<24.
 *
 * Frame stealing (single 137-bit frame -> 216-bit half slot):
 *   classes NOT pair-interleaved; 4 CRC bits (Fs_TAB_CRC1..4 over the
 *   30 class-2 bits); V3 on step 0 mod 8 only; 51 + 84 + 81 = 216;
 *   interleaver: out[(101 * (i+1)) mod 216] = in[i].
 */

#ifndef ETSI_TABLES_H
#define ETSI_TABLES_H

/* 1-based bit indices into the 137-bit speech frame, by sensitivity. */
static const short ETSI_TAB0[51] = {
    35, 36, 37, 38, 39, 40, 41, 42, 43, 47, 48, 56, 61, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 74, 75, 83, 88, 89, 90, 91, 92, 93, 94, 95, 96,
    97, 101, 102, 110, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124,
    128, 129, 137};

static const short ETSI_TAB1[56] = {
    58, 85, 112, 54, 81, 108, 135, 50, 77, 104, 131, 45, 72, 99, 126, 55,
    82, 109, 136, 5, 13, 34, 8, 16, 17, 22, 23, 24, 25, 26, 6, 14, 7, 15,
    60, 87, 114, 46, 73, 100, 127, 44, 71, 98, 125, 33, 49, 76, 103, 130,
    59, 86, 113, 57, 84, 111};

static const short ETSI_TAB2[30] = {
    18, 19, 20, 21, 31, 32, 53, 80, 107, 134, 1, 2, 3, 4, 9, 10, 11, 12,
    27, 28, 29, 30, 52, 79, 106, 133, 51, 78, 105, 132};

/* Puncturing select patterns, indexed by step mod 8. */
static const short ETSI_A1[8] = {1, 0, 1, 0, 1, 0, 1, 0};      /* V2, class1 */
static const short ETSI_A2[8] = {1, 0, 0, 0, 1, 0, 0, 0};      /* V3, class2 */
static const short ETSI_FS_A2[8] = {1, 0, 0, 0, 0, 0, 0, 0};   /* V3, stolen */

/* Generator masks over the 5-bit window (bit4 = newest input). */
#define ETSI_G1 0x1F
#define ETSI_G2 0x1B
#define ETSI_G3 0x15

/* CRC parity-check taps: 1-based indices into the interleaved class-2
 * block (60 bits for speech, via TAB_CRC1..8; 30 bits stolen, via
 * Fs_TAB_CRC1..4).  CRC bit k = XOR of the listed class-2 bits. */
static const short ETSI_TAB_CRC_LEN[8] = {29, 29, 29, 30, 30, 29, 29, 35};
static const short ETSI_TAB_CRC[8][35] = {
    {1, 5, 8, 9, 13, 15, 16, 17, 19, 21, 22, 24, 25, 31, 32, 35, 36, 38,
     40, 43, 44, 45, 48, 49, 50, 51, 53, 54, 56},
    {2, 6, 9, 10, 14, 16, 17, 18, 20, 22, 23, 25, 26, 32, 33, 36, 37, 39,
     41, 44, 45, 46, 49, 50, 51, 52, 54, 55, 57},
    {3, 7, 10, 11, 15, 17, 18, 19, 21, 23, 24, 26, 27, 33, 34, 37, 38,
     40, 42, 45, 46, 47, 50, 51, 52, 53, 55, 56, 58},
    {1, 4, 5, 9, 11, 12, 13, 15, 17, 18, 20, 21, 27, 28, 31, 32, 34, 36,
     39, 40, 41, 44, 45, 46, 47, 49, 50, 52, 57, 59},
    {2, 5, 6, 10, 12, 13, 14, 16, 18, 19, 21, 22, 28, 29, 32, 33, 35, 37,
     40, 41, 42, 45, 46, 47, 48, 50, 51, 53, 58, 60},
    {3, 6, 7, 11, 13, 14, 15, 17, 19, 20, 22, 23, 29, 30, 33, 34, 36, 38,
     41, 42, 43, 46, 47, 48, 49, 51, 52, 54, 59},
    {4, 7, 8, 12, 14, 15, 16, 18, 20, 21, 23, 24, 30, 31, 34, 35, 37, 39,
     42, 43, 44, 47, 48, 49, 50, 52, 53, 55, 60},
    {1, 2, 3, 4, 8, 13, 14, 16, 19, 20, 22, 23, 25, 26, 27, 28, 29, 30,
     32, 33, 34, 36, 37, 40, 41, 42, 44, 48, 50, 53, 56, 57, 58, 59, 60},
};

static const short ETSI_FS_TAB_CRC[4][16] = {
    {1, 4, 5, 7, 9, 10, 11, 12, 16, 19, 20, 22, 24, 25, 26, 27},
    {1, 2, 4, 6, 7, 8, 9, 13, 16, 17, 19, 21, 22, 23, 24, 28},
    {2, 3, 5, 7, 8, 9, 10, 14, 17, 18, 20, 22, 23, 24, 25, 29},
    {3, 4, 6, 8, 9, 10, 11, 15, 18, 19, 21, 23, 24, 25, 26, 30},
};

#endif /* ETSI_TABLES_H */
