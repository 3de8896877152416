// Register butterflies for the transforms of fft2p.cu and band_synth.cu.
//
// A transform of 2^lgn points runs as 3-4 radix-8 / radix-16 stages,
// decimation in frequency and in place: a thread loads a radix's points,
// transforms them in registers (dft<R>), applies the stage twiddles and
// writes them back; a padded shared-memory tile (sidx) carries only the
// exchange between two stages.  Bin k = p_0 + R_0 (p_1 + R_1 (...)) ends
// at tile position p_0 L/R_0 + p_1 L/(R_0 R_1) + ... + p_last
// (bin_of_pos); the sources fold that digit reversal into the last
// stage's addresses.
#pragma once

#include "common.cuh"

namespace tt {

struct Plan {
  int lgn;     // log2 of the transform length
  int ns;      // radix stages
  int lg[4];   // log2 of each stage's radix, first stage first
};

__host__ __device__ constexpr Plan make_plan(int lgn) {
  // radix 8 stages first, radix 16 last: 3 a + 4 b = lgn
  Plan p = {};
  p.lgn = lgn;
  int a = 0;
  while ((lgn - 3 * a) % 4) ++a;
  const int b = (lgn - 3 * a) / 4;
  p.ns = a + b;
  for (int s = 0; s < 4; ++s) p.lg[s] = s < a ? 3 : 4;
  return p;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ void bfly(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}
// times -i, times w_8^1 and w_8^3
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}
#define TT_R2 0.70710678118654752f
__device__ __forceinline__ float2 mul_w8_1(float2 a) {
  return make_float2((a.x + a.y) * TT_R2, (a.y - a.x) * TT_R2);
}
__device__ __forceinline__ float2 mul_w8_3(float2 a) {
  return make_float2((a.y - a.x) * TT_R2, -(a.x + a.y) * TT_R2);
}

// In-register forward DFTs, decimation in frequency: v[i] leaves as
// output bin bitrev(i).
__device__ __forceinline__ void dft4(float2* v) {
  bfly(v[0], v[2]);
  bfly(v[1], v[3]);
  v[3] = mul_mi(v[3]);
  bfly(v[0], v[1]);
  bfly(v[2], v[3]);
}
__device__ __forceinline__ void dft8(float2* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) bfly(v[i], v[i + 4]);
  v[5] = mul_w8_1(v[5]);
  v[6] = mul_mi(v[6]);
  v[7] = mul_w8_3(v[7]);
  dft4(v);
  dft4(v + 4);
}
#define TT_C1 0.92387953251128674f   // cos(pi / 8)
#define TT_S1 0.38268343236508977f   // sin(pi / 8)
__device__ __forceinline__ void dft16(float2* v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) bfly(v[i], v[i + 8]);
  v[9] = tt::cmul(v[9], make_float2(TT_C1, -TT_S1));
  v[10] = mul_w8_1(v[10]);
  v[11] = tt::cmul(v[11], make_float2(TT_S1, -TT_C1));
  v[12] = mul_mi(v[12]);
  v[13] = tt::cmul(v[13], make_float2(-TT_S1, -TT_C1));
  v[14] = mul_w8_3(v[14]);
  v[15] = tt::cmul(v[15], make_float2(-TT_C1, -TT_S1));
  dft8(v);
  dft8(v + 8);
}
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 16) dft16(v); else dft8(v);
}

template <int R>
__device__ __forceinline__ constexpr int brev(int i) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// v[i] *= w^{bitrev(i)} with w = tw[t] = exp(-2 pi i t / L); tw holds
// t < L / 2, and (R / 2) t stays below that for every stage but the last
// (which has no twiddles).
template <int R>
__device__ __forceinline__ void stage_twiddles(float2* v,
                                               const float2* __restrict__ tw,
                                               int t) {
  float2 w[R];
  w[1] = __ldg(tw + t);
  w[2] = __ldg(tw + 2 * t);
  w[4] = __ldg(tw + 4 * t);
  w[3] = tt::cmul(w[1], w[2]);
  w[5] = tt::cmul(w[4], w[1]);
  w[6] = tt::cmul(w[4], w[2]);
  w[7] = tt::cmul(w[4], w[3]);
  if constexpr (R == 16) {
    w[8] = __ldg(tw + 8 * t);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[8 + i] = tt::cmul(w[8], w[i]);
  }
#pragma unroll
  for (int i = 1; i < R; ++i) v[i] = tt::cmul(v[i], w[brev<R>(i)]);
}

// Tile index of position pos of column r.  pad.x = log2 of the last
// stage's radix, pad.y = log2 of the first stage's sub-block: one pad
// element per last-stage butterfly keeps that stage's accesses (a thread
// per butterfly) off each other's banks, one per first-stage sub-block
// those of pass 1's last stage (neighbouring lanes on neighbouring
// sub-blocks).
__device__ __forceinline__ int sidx(int pos, int r, int2 pad, int lgt) {
  return ((pos + (pos >> pad.x) + (pos >> pad.y)) << lgt) + r;
}

// The transforms run in place, so bin k = p_0 + R_0 (p_1 + R_1 (...))
// ends at tile position p_0 L/R_0 + p_1 L/(R_0 R_1) + ... + p_last.
__device__ __forceinline__ int bin_of_pos(const Plan& pl, int pos) {
  int k = 0, cum = 0;
  for (int s = 0; s < pl.ns; ++s) {
    const int p = (pos >> (pl.lgn - cum - pl.lg[s])) & ((1 << pl.lg[s]) - 1);
    k += p << cum;
    cum += pl.lg[s];
  }
  return k;
}

}  // namespace tt
