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
// holds the path metric of state ns.  The warp stages its two blocks in
// shared memory with coalesced loads, deinterleaving on the way in (the
// 18 x 24 block interleave is arithmetic: transmitted i = 24a + b holds
// encoded 18b + a).  A step reads its three received values from the
// staged row (one address a half-warp: a broadcast; punctured positions
// read a zero pad), fetches both predecessors' metrics with __shfl_sync
// within the half-warp, and keeps the step's 16 decisions of both blocks
// as one __ballot_sync word in shared memory.  One lane a block then walks
// the 184 words back from state 0, collects class 2 + CRC as three words
// and checks them against the eight CRC taps with population counts.
// The ordered bits go out through shared memory as contiguous rows.
//
// Bound by integer instructions: per step and block about 16 branch-sum
// operations and 16 x (two additions, a compare, a select, a decision
// bit), against 1728 bytes in and 287 out a block.  This half-warp form
// issues about four times the instructions of one thread a block (the
// branch sums are computed by every lane, the shuffles cost issue slots)
// in exchange for 16 independent chains a block instead of one.
#include "common.cuh"

namespace {

constexpr int kSoft = 432;
constexpr int kN0 = 102;          // class 0: sent uncoded
constexpr int kSteps = 184;       // trellis steps (class 1, 2, CRC, tail)
constexpr int kOrdered = 286;     // class 0 ++ the decoded bits
constexpr int kRow = 436;         // staged row; [432, 436) is the zero pad
constexpr int kCrcLo = 214;       // ordered[214:282]: class 2 + CRC
constexpr int kCrcBits = 68;
constexpr int kWarps = 8;

// step i's V1 / V2 / V3 as an index into the staged (deinterleaved) row,
// kSoft where the schedule punctures it
__constant__ short c_pos[kSteps * 3];
// expected sign (+1 / -1) of V1 / V2 / V3 for post-state ns and
// predecessor parity p: [ns][p][j]
__constant__ signed char c_sign[16 * 2 * 3];
// CRC check k: its taps over ordered[214:282], as three 32-bit words
__constant__ unsigned c_crc[8 * 3];

__global__ void __launch_bounds__(kWarps * 32)
viterbi_kernel(const int* __restrict__ soft, uint8_t* __restrict__ ordered,
               uint8_t* __restrict__ bfi, int n_blocks) {
  __shared__ int s_row[kWarps][2][kRow];
  __shared__ unsigned s_dec[kWarps][kSteps];
  __shared__ uint8_t s_out[kWarps][2 * kOrdered];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int ns = lane & 15;
  const long long b0 = 2LL * ((long long)blockIdx.x * kWarps + warp);
  if (b0 >= n_blocks) return;       // the whole warp leaves together
  const int n_here = n_blocks - b0 >= 2 ? 2 : 1;

  // stage both rows, deinterleaved; a missing second block reads zeros
  const int* src = soft + b0 * kSoft;
  for (int t = lane; t < 2 * kSoft; t += 32) {
    const int blk = t >= kSoft ? 1 : 0;
    const int i = t - blk * kSoft;
    const int v = blk < n_here ? __ldg(src + t) : 0;
    s_row[warp][blk][18 * (i % 24) + i / 24] = v;
  }
  if (lane < 8) s_row[warp][lane >> 2][kSoft + (lane & 3)] = 0;
  __syncwarp();
  for (int t = lane; t < 2 * kN0; t += 32) {
    const int blk = t >= kN0 ? 1 : 0;
    const int k = t - blk * kN0;
    s_out[warp][blk * kOrdered + k] = s_row[warp][blk][k] < 0 ? 1 : 0;
  }

  const int* row = s_row[warp][half];
  int sg[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) sg[j] = c_sign[ns * 6 + j];
  const int p0 = 2 * (ns & 7);
  int m = ns == 0 ? 0 : -(1 << 28);
  for (int i = 0; i < kSteps; ++i) {
    const int r0 = row[c_pos[3 * i]];
    const int r1 = row[c_pos[3 * i + 1]];
    const int r2 = row[c_pos[3 * i + 2]];
    const int m0 = __shfl_sync(0xffffffffu, m, p0, 16);
    const int m1 = __shfl_sync(0xffffffffu, m, p0 + 1, 16);
    const int c0 = m0 + (sg[0] * r0 + sg[1] * r1 + sg[2] * r2);
    const int c1 = m1 + (sg[3] * r0 + sg[4] * r1 + sg[5] * r2);
    const bool take1 = c1 > c0;       // strict: a tie keeps the even one
    m = take1 ? c1 : c0;
    const unsigned dec = __ballot_sync(0xffffffffu, take1);
    if (lane == 0) s_dec[warp][i] = dec;
  }
  __syncwarp();

  if (ns == 0 && half < n_here) {
    uint8_t* out = s_out[warp] + half * kOrdered;
    unsigned w[3] = {0u, 0u, 0u};
    int state = 0;
    for (int i = kSteps - 1; i >= 0; --i) {
      const int bit = state >> 3;
      out[kN0 + i] = (uint8_t)bit;
      const int q = kN0 + i - kCrcLo;
      if (q >= 0 && q < kCrcBits) w[q >> 5] |= (unsigned)bit << (q & 31);
      state = 2 * (state & 7) + ((s_dec[warp][i] >> (half * 16 + state)) & 1);
    }
    int bad = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      bad |= (__popc(w[0] & c_crc[3 * k]) + __popc(w[1] & c_crc[3 * k + 1]) +
              __popc(w[2] & c_crc[3 * k + 2])) & 1;
    bfi[b0 + half] = (uint8_t)bad;
  }
  __syncwarp();
  uint8_t* dst = ordered + b0 * kOrdered;
  for (int t = lane; t < n_here * kOrdered; t += 32) dst[t] = s_out[warp][t];
}

}  // namespace

// soft: (B, 432) int32 soft bits, transmitted order; ordered: (B, 286)
// uint8; bfi: (B,) uint8.  pos (552 int16), sign (96 int8) and crc (24
// uint32) are the host's tables (voice/viterbi.py), copied to constant
// memory on the stream ahead of the launch.
extern "C" int tt_viterbi(const void* soft, void* ordered, void* bfi,
                          int n_blocks, const void* pos, const void* sign,
                          const void* crc, void* stream) {
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_pos, pos, sizeof(c_pos), 0,
                                          cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_sign, sign, sizeof(c_sign), 0,
                                cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_crc, crc, sizeof(c_crc), 0,
                                cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const int per_cta = 2 * kWarps;
  const unsigned grid = (unsigned)((n_blocks + per_cta - 1) / per_cta);
  viterbi_kernel<<<grid, kWarps * 32, 0, s>>>(
      (const int*)soft, (uint8_t*)ordered, (uint8_t*)bfi, n_blocks);
  return (int)cudaGetLastError();
}
