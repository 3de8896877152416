// Bit placement of the fused back half: the scan row z and the carried
// tail.
//
// The TPU kernel places the decided bits with 0/1 "sandwich" matmuls
// (E @ (pm @ F) per shift class; perf/place_probe.py times that chain
// alone) because its vector unit cannot shuffle lanes.  Here placement
// is a warp ballot for the carried tail, a 16-symbol pack for the
// decisions and a bit gather for the next tail.  Shared by the fused
// back-half kernel (backhalf.cu) and the placement probe (probes.cu).
//
// z is the row's bits packed LSB first into nw 32-bit words: 1200 carried
// tail bits, then the two bits of symbol i at 1200 + 2i (most significant
// first), zero where no valid symbol stands.  Every thread of the block
// calls each function; blockDim.x is a multiple of 32.
#pragma once

#include "common.cuh"

#define TAILBITS 1200
#define TAILWORDS 38            // words that hold carried tail bits

namespace tt {

// Words 0 .. TAILWORDS-1 of z from the carried tail btc (floats, one a
// bit, the first TAILBITS read coalesced), one ballot a word.
__device__ __forceinline__ void place_tail(const float* __restrict__ btc,
                                           unsigned* z) {
  const int lane = threadIdx.x & 31;
  for (int pos = threadIdx.x; pos < 32 * TAILWORDS; pos += blockDim.x) {
    const int bit = pos < TAILBITS ? (btc[pos] != 0.f) : 0;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) z[pos >> 5] = word;
  }
}

// Words TAILWORDS-1 .. nw-1 of z from the decisions hard[i] = 2 msb + lsb
// (0 for an invalid symbol): word w holds symbols 16 w - 600 + (0..15).
// place_tail's words must be visible (a barrier lies between the two).
__device__ __forceinline__ void place_symbols(const unsigned char* hard,
                                              int ns, int nw, unsigned* z) {
  for (int w = TAILWORDS - 1 + threadIdx.x; w < nw; w += blockDim.x) {
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = 16 * w - TAILBITS / 2 + k;
      if (i >= 0 && i < ns) {
        const unsigned h = hard[i];
        word |= ((h >> 1) | ((h & 1u) << 1)) << (2 * k);
      }
    }
    if (w == TAILWORDS - 1) word |= z[w];
    z[w] = word;
  }
}

// The next carried tail, bt2c[pos] = bit off + pos of z for pos <
// TAILBITS (zero past the row's end and in the rest of the tr rows of
// 128), as 16-byte vectors.
__device__ __forceinline__ void place_next_tail(const unsigned* z, int nw,
                                                int off, int tr,
                                                float* __restrict__ bt2c) {
  const int zbits = 32 * nw;
  for (int pos = 4 * threadIdx.x; pos < tr * 128; pos += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int src = off + pos + e;
      v[e] = (pos + e < TAILBITS && src < zbits)
                 ? (float)((z[src >> 5] >> (src & 31)) & 1u) : 0.f;
    }
    *(float4*)(bt2c + pos) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace tt
