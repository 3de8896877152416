// ETSI speech channel decoding (EN 300 395-2, TCH/S) of a batch of voice
// blocks of 432 soft bits: deinterleave, the class-0 signs, a 16-state
// Viterbi over the 184-step punctured RCPC trellis, traceback from state
// 0, and the CRC-8 recheck of class 2 that gives the bad-frame flag.
//
// Replaces the XLA program of the reference's batched voice channel
// decoder (tetraear_tpu/voice/jviterbi.py channel_decode_batch_traced, a
// lax.scan; it has no Pallas kernel), which is bit-exact against the C++
// decoder (voice/csrc/channel.cpp rcpc_decode / tetra_channel_decode):
// int32 path metrics, 0 for state 0 and -(1 << 28) for the others at the
// start, the predecessors of post-state ns are 2 * (ns & 7) and + 1, and
// the odd one wins only when its metric is strictly greater.
//
// Design: one half-warp a voice block, two blocks a warp; lane ns & 15
// holds the path metric of state ns.
//  * Every global load (the rows as 16-byte loads, the sums' step codes,
//    the lane's code, the CRC taps) is issued before the first is used.
//    The rows are deinterleaved into shared memory (the 18 x 24 block
//    interleave is arithmetic: transmitted i = 24a + b holds encoded
//    18b + a); [432, 436) is a zero pad for punctured positions; the
//    class-0 signs become bit words by ballot.
//  * Branch sums off the chain: a step's branch metric for (state,
//    parity) is s0 r0 + s1 r1 + s2 r2 with signs +-1, i.e. +-q for one of
//    the four sums q = r0 +- r1 +- r2.  The warp's lanes compute every
//    step's four sums from the staged rows, in parallel across steps,
//    before the forward pass; a lane keeps its state's (index, sign) for
//    both parities.  The sums wrap as int32 in any order (two's
//    complement), so the metrics are bit-equal to the reference's.
//  * Forward pass: a step is two __shfl_sync within the half-warp, two
//    multiply-adds by the +-1 sign and a max; the compare (the decision)
//    and the 16 decisions of both blocks as one __ballot_sync word are
//    off the chain.  Shuffles and shared loads and stores share one pipe,
//    so the sums lie as four rows by step (one 16-byte load of the
//    lane's row gives four steps, for each parity) and four ballot words
//    go out as one 16-byte store.
//  * Traceback: one lane a block keeps the path's decisions as a history
//    register h (the state is its low four bits), so a step is a rotate of
//    the decision word by h and a shift-or: a decoded bit is the decision
//    taken four steps later, and h after every 32 steps is a word of
//    decoded bits.  The decision loads (their addresses do not depend on
//    the state) run ahead of that chain.  The CRC taps are checked with
//    population counts.
//  * Output: the lane packs class 0 ++ the decoded bits as bit words; the
//    warp writes both output rows as 32-bit words, four bits expanded to
//    four bytes by one multiply.
//  * The tables (each step's three positions, each state's index and
//    sign, the CRC taps) are one int32 tensor uploaded once a device
//    (voice/viterbi.py); a call copies nothing from the host.
//  * A CTA is 1, 2 or 4 warps (voice/viterbi.py cta_warps): a batch of
//    ~170 blocks spreads over ~85 SMs instead of stacking 8 warps on 11.
//
// Bound by integer instructions and the shared-memory pipe at large B (per
// step and block ~16 x (two shuffles, two multiply-adds, a max, a compare)
// and a ballot); at the live path's B (~170) by the latency of one block's
// chain: 184 shuffle-add-max steps and 192 rotate-shift steps (12 on the
// zero pad).
#include "common.cuh"

namespace {

constexpr int kSoft = 432;
constexpr int kN0 = 102;          // class 0: sent uncoded
constexpr int kSteps = 184;       // trellis steps (class 1, 2, CRC, tail)
constexpr int kWords = 6;         // decoded bits as words: 192 >= 184
constexpr int kDec = 32 * kWords + 4;   // decisions with their zero pad
constexpr int kOrdered = 286;     // class 0 ++ the decoded bits
constexpr int kRow = 436;         // staged row; [432, 436) is the zero pad
// a block's sums: four rows (one a sum) of kSteps, padded so that the
// rows' 16-byte loads of one step fall on different banks
constexpr int kSumRow = kSteps + 4;
// the table: step codes, lane codes, CRC words (voice/viterbi.py _K_TABLE)
constexpr int kTabLane = kSteps;
constexpr int kTabCrc = kSteps + 16;
constexpr int kRowLoads = (2 * kSoft / 4 + 31) / 32;   // 7 a lane
constexpr int kSumLoads = (2 * kSteps + 31) / 32;      // 12 a lane
constexpr int kOutWords = (2 * kOrdered / 4 + 31) / 32; // 5 a lane

struct WarpSmem {
  int row[2][kRow];
  int sums[2][4][kSumRow];
  unsigned dec[kDec];
  unsigned ob[2][10];             // class 0 ++ decoded bits, + a zero word
  unsigned crc[24];
};

__device__ __forceinline__ unsigned lane_sign(unsigned code, int parity) {
  return (code >> (2 + 3 * parity)) & 1u ? 0xFFFFFFFFu : 1u;
}

__device__ __forceinline__ int lane_idx(unsigned code, int parity) {
  return (int)((code >> (3 * parity)) & 3u);
}

__global__ void viterbi_kernel(const int* __restrict__ soft,
                               const int* __restrict__ tab,
                               uint8_t* __restrict__ ordered,
                               uint8_t* __restrict__ bfi, int n_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem_raw)[warp];
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int ns = lane & 15;
  const long long b0 =
      2LL * ((long long)blockIdx.x * (blockDim.x >> 5) + warp);
  if (b0 >= n_blocks) return;       // the whole warp leaves together
  const int n_here = n_blocks - b0 >= 2 ? 2 : 1;

  // every global load first, so that their latencies overlap: the
  // warp's two rows (16-byte loads; a missing second block reads zeros),
  // the step codes of the sums below, the lane's code, the CRC taps
  const int4* src = reinterpret_cast<const int4*>(soft + b0 * kSoft);
  int4 v[kRowLoads];
#pragma unroll
  for (int u = 0; u < kRowLoads; ++u) {
    const int t = lane + 32 * u;
    v[u] = t < n_here * (kSoft / 4) ? __ldg(src + t) : make_int4(0, 0, 0, 0);
  }
  unsigned code[kSumLoads];
#pragma unroll
  for (int u = 0; u < kSumLoads; ++u) {
    const int t = lane + 32 * u;
    code[u] = t < 2 * kSteps
                  ? (unsigned)__ldg(tab + (t >= kSteps ? t - kSteps : t))
                  : 0u;
  }
  const unsigned lc = (unsigned)__ldg(tab + kTabLane + ns);
  if (lane < 24) sm.crc[lane] = (unsigned)__ldg(tab + kTabCrc + lane);

  // deinterleave the rows into shared memory
#pragma unroll
  for (int u = 0; u < kRowLoads; ++u) {
    const int t = lane + 32 * u;
    if (t < 2 * kSoft / 4) {
      const int blk = t >= kSoft / 4 ? 1 : 0;
      const int i = 4 * (t - blk * (kSoft / 4));
      int* row = sm.row[blk];
      row[18 * (i % 24) + i / 24] = v[u].x;
      row[18 * ((i + 1) % 24) + (i + 1) / 24] = v[u].y;
      row[18 * ((i + 2) % 24) + (i + 2) / 24] = v[u].z;
      row[18 * ((i + 3) % 24) + (i + 3) / 24] = v[u].w;
    }
  }
  if (lane < 8) sm.row[lane >> 2][kSoft + (lane & 3)] = 0;
  if (lane < kDec - kSteps) sm.dec[kSteps + lane] = 0u;
  __syncwarp();

  // the class-0 signs as bit words (bits 102.. of word 3 stay 0)
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int j = 32 * (u & 3) + lane;
    const unsigned w =
        __ballot_sync(0xffffffffu, j < kN0 && sm.row[u >> 2][j] < 0);
    if (lane == 0) sm.ob[u >> 2][u & 3] = w;
  }
  // every step's four sums r0 + r1 + r2, r0 + r1 - r2, r0 - r1 + r2,
  // r0 - r1 - r2, for both blocks
#pragma unroll
  for (int u = 0; u < kSumLoads; ++u) {
    const int t = lane + 32 * u;
    if (t < 2 * kSteps) {
      const int blk = t >= kSteps ? 1 : 0;
      const int i = t - blk * kSteps;
      const int* row = sm.row[blk];
      const unsigned r0 = (unsigned)row[code[u] & 1023u];
      const unsigned r1 = (unsigned)row[(code[u] >> 10) & 1023u];
      const unsigned r2 = (unsigned)row[code[u] >> 20];
      const unsigned a = r0 + r1, d = r0 - r1;
      sm.sums[blk][0][i] = (int)(a + r2);
      sm.sums[blk][1][i] = (int)(a - r2);
      sm.sums[blk][2][i] = (int)(d + r2);
      sm.sums[blk][3][i] = (int)(d - r2);
    }
  }
  const unsigned sg0 = lane_sign(lc, 0), sg1 = lane_sign(lc, 1);
  __syncwarp();

  // four steps a pass: one 16-byte load of the lane's sum row for each
  // parity, and the four ballot words stored as one 16-byte word
  const int* q0row = sm.sums[half][lane_idx(lc, 0)];
  const int* q1row = sm.sums[half][lane_idx(lc, 1)];
  const int p0 = 2 * (ns & 7);
  int m = ns == 0 ? 0 : -(1 << 28);
#pragma unroll 2
  for (int i = 0; i < kSteps; i += 4) {
    const int4 a = *reinterpret_cast<const int4*>(q0row + i);
    const int4 b = *reinterpret_cast<const int4*>(q1row + i);
    const int qa[4] = {a.x, a.y, a.z, a.w};
    const int qb[4] = {b.x, b.y, b.z, b.w};
    unsigned dw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned m0 = (unsigned)__shfl_sync(0xffffffffu, m, p0, 16);
      const unsigned m1 = (unsigned)__shfl_sync(0xffffffffu, m, p0 + 1, 16);
      const int c0 = (int)((unsigned)qa[j] * sg0 + m0);
      const int c1 = (int)((unsigned)qb[j] * sg1 + m1);
      // strict: a tie keeps the even one; the survivor's metric is the
      // larger either way, so the chain takes max and the compare only
      // feeds the ballot
      m = max(c0, c1);
      dw[j] = __ballot_sync(0xffffffffu, c1 > c0);
    }
    if (lane == 0)
      *reinterpret_cast<uint4*>(&sm.dec[i]) =
          make_uint4(dw[0], dw[1], dw[2], dw[3]);
  }
  __syncwarp();

  if (ns == 0 && half < n_here) {
    // h: bit k is the decision k + 1 steps later in time than the state
    // h & 15 (steps past 183 decide 0, so h starts as state 0).  After
    // step 32k + 4, h holds the decisions of steps 32k + 4 .. 32k + 35,
    // which are the decoded bits of steps 32k .. 32k + 31.
    const unsigned sel = half ? 0x3232u : 0x1010u;   // this half, twice
    unsigned h = 0u, wd[kWords];
#pragma unroll
    for (int k = kWords - 1; k >= 0; --k) {
      unsigned d[32];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        d[j] = __byte_perm(sm.dec[32 * k + 4 + j], 0u, sel);
#pragma unroll
      for (int j = 31; j >= 0; --j)
        h = (h << 1) | (__funnelshift_r(d[j], d[j], h) & 1u);
      wd[k] = h;
    }
    // ordered[214:282] is decoded bits 112 .. 179
    const unsigned c0 = __funnelshift_r(wd[3], wd[4], 16);
    const unsigned c1 = __funnelshift_r(wd[4], wd[5], 16);
    const unsigned c2 = (wd[5] >> 16) & 0xFu;
    int bad = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      bad |= (__popc(c0 & sm.crc[3 * k]) + __popc(c1 & sm.crc[3 * k + 1]) +
              __popc(c2 & sm.crc[3 * k + 2])) & 1;
    bfi[b0 + half] = (uint8_t)bad;
    // class 0 (bits 0 .. 101) ++ the decoded bits (102 .. 285)
    unsigned* ob = sm.ob[half];
    ob[3] |= wd[0] << 6;
#pragma unroll
    for (int k = 4; k < 9; ++k)
      ob[k] = __funnelshift_r(wd[k - 4], wd[k - 3], 26);
    ob[9] = 0u;
  }
  __syncwarp();
  // both rows as 32-bit words (b0 is even, so the warp's 572 bytes start
  // on a word), four bits to four bytes by a multiply; word 71 holds the
  // last two bytes of row 0 and the first two of row 1
  uint8_t* dst = ordered + b0 * kOrdered;
  const int n_bytes = n_here * kOrdered;
#pragma unroll
  for (int u = 0; u < kOutWords; ++u) {
    const int w = lane + 32 * u;
    const int t = 4 * w;
    if (t >= n_bytes) continue;
    unsigned x;
    if (t + 4 <= kOrdered || t >= kOrdered) {
      const int blk = t >= kOrdered ? 1 : 0;
      const int j = t - blk * kOrdered;
      x = __funnelshift_r(sm.ob[blk][j >> 5], sm.ob[blk][(j >> 5) + 1],
                          j & 31) & 15u;
    } else {
      x = ((sm.ob[0][8] >> 28) & 3u) | (sm.ob[1][0] & 3u) << 2;
    }
    const unsigned bytes = (x * 0x00204081u) & 0x01010101u;
    if (t + 4 <= n_bytes) {
      reinterpret_cast<unsigned*>(dst)[w] = bytes;
    } else {
      for (int e = 0; t + e < n_bytes; ++e)
        dst[t + e] = (uint8_t)(bytes >> (8 * e));
    }
  }
}

}  // namespace

// soft: (B, 432) int32 soft bits, transmitted order, 16-byte aligned;
// tab: the int32 table on the card (voice/viterbi.py _K_TABLE); ordered:
// (B, 286) uint8, 4-byte aligned; bfi: (B,) one byte each (0 / 1); warps:
// 1, 2 or 4 a CTA.
extern "C" int tt_viterbi(const void* soft, const void* tab, void* ordered,
                          void* bfi, int n_blocks, int warps, void* stream) {
  if (n_blocks < 1 || warps < 1 || warps > 4 ||
      reinterpret_cast<uintptr_t>(soft) % 16 ||
      reinterpret_cast<uintptr_t>(ordered) % 4)
    return (int)cudaErrorInvalidValue;
  const int per_cta = 2 * warps;
  const unsigned grid = (unsigned)((n_blocks + per_cta - 1) / per_cta);
  viterbi_kernel<<<grid, warps * 32, warps * sizeof(WarpSmem),
                   (cudaStream_t)stream>>>(
      (const int*)soft, (const int*)tab, (uint8_t*)ordered, (uint8_t*)bfi,
      n_blocks);
  return (int)cudaGetLastError();
}
