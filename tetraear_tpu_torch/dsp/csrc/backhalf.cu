// Fused back half: phase ramp, interpolation, pi/4-DQPSK and frame scan.
//
// Replaces fused_backhalf (tetraear_tpu/dsp/pallas_kernels.py).  One
// block per carrier c, on the raw band-synthesis samples y (k = t P + s):
//   1. x[k] = y[k] * rr[t] rc[s] (per-block rotation, 1/decim, the
//      natural-order (-1)^s sign and the quantized-extraction ramp);
//   2. the previous block's 4-sample interpolation tail replaces
//      x[drop-4, drop);
//   3. symbol i = sum_j c_j x[(drop - 4 + 4i + bsel + j) mod n]
//      (Catmull-Rom at the symbol instants), previous symbol = symbol
//      i-1 or the carried one for i = 0; pi/4-DQPSK decision and soft
//      bits (-Im d, -Re d)/|d| with |d| = sqrt(re^2 + im^2) + 1e-12;
//   4. the z bit row: 1200 carried tail bits, then the two bits of
//      each VALID symbol i at 1200 + 2i (bits 1200..1279 of the carried
//      tail rows are zero by construction and are not read), packed
//      into 32-bit words in shared memory;
//   5. the even-position sync + CRC scan of z (scan.cuh) at every
//      pe < 64 M: corr = n_agree * (1/22), err = syndrome weight;
//   6. next carried tail = z[2 k_max - 4 + 2 dsel + (0..1200)], the
//      corrected last sample row, and the last valid symbol.
// The 0/1 "sandwich" matmuls and row-selection tables of the TPU kernel
// exist because Mosaic cannot shuffle lanes; here the same layout work
// is indexed loads and bit packing.
//
// Bound by device memory (64 KB of samples in per carrier, ~40 KB of
// verdicts and soft bits out) and, about as much, by the scan's integer
// work at the integer instruction rate.  What the design does about it:
//   * the samples are never staged: the four taps of symbol i are the
//     16-byte groups drop/4 - 1 + i and the next of each plane (one
//     symbol per group, every sample used once), so a thread reads its
//     two groups as float4 straight from device memory, corrects them in
//     registers and interpolates once; the wrap is a compare and
//     subtract.  The block keeps 36 KB of shared memory (symbols, staged
//     soft bits, decisions, z) where the whole band took 64 KB, and 256
//     threads under 80 registers, so at least three blocks share an SM
//     and one carrier's loads run under another's scan;
//   * the previous symbol comes from the shared symbol row;
//   * soft bits are transposed through shared memory (row pitch P/4 + 1,
//     free of bank conflicts) and leave as whole 512-byte rows;
//   * the carried tail is read coalesced and packed by warp ballot, the
//     symbol bits from the staged decisions, 16 symbols a word
//     (place.cuh, which the placement probe of probes.cu runs alone);
//   * the scan is bound by the integer instruction rate, not by bytes: a
//     thread takes a run of 8 neighbouring even positions, evaluates the
//     first in full and slides through the rest (scan.cuh: about 45
//     logic instructions and 3 population counts a step where the full
//     form takes about 210), and writes corr and err 16 bytes at a time;
//   * last, bt2 and misc leave as 16-byte vectors.
// Every float expression keeps the reference's order of operations
// (contraction off), so decisions match the plain version bit for bit.
#include <string.h>

#include "place.cuh"
#include "scan.cuh"

// positions a thread slides through: 64 | npos makes 8 or 16 the choices;
// at 8 the 2688 positions of an 8192-point band are 336 runs, which keep
// every warp of the block busy where 16 leave a third of them idle (the
// step is a chain of dependent operations, so warps, not run length,
// hide its latency)
#define BACKHALF_K 8

namespace {

__device__ __forceinline__ float pick(int b, float a0, float a1, float a2,
                                      float a3) {
  return b == 0 ? a0 : b == 1 ? a1 : b == 2 ? a2 : a3;
}

struct Carrier {
  const float* y;       // (2, n)
  const float* rr;      // (2, 128)
  const float* rc;      // (2, p)
  const float* sc;      // (16,)
  int p, n, d0;
};

// The corrected samples x[k .. k+3] of the 16-byte group at k (4 | k).
__device__ __forceinline__ void load_group(const Carrier& c, int k,
                                           float* xr, float* xi) {
  if (k == c.d0) {               // the carried interpolation tail
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xr[e] = c.sc[7 + e];
      xi[e] = c.sc[11 + e];
    }
    return;
  }
  const int t = k / c.p;
  const int s = k - t * c.p;
  const float4 yr = *(const float4*)(c.y + k);
  const float4 yi = *(const float4*)(c.y + c.n + k);
  const float4 cre = *(const float4*)(c.rc + s);
  const float4 cim = *(const float4*)(c.rc + c.p + s);
  const float rre = c.rr[t], rim = c.rr[128 + t];
  const float yrv[4] = {yr.x, yr.y, yr.z, yr.w};
  const float yiv[4] = {yi.x, yi.y, yi.z, yi.w};
  const float crv[4] = {cre.x, cre.y, cre.z, cre.w};
  const float civ[4] = {cim.x, cim.y, cim.z, cim.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float cor_re = rre * crv[e] - rim * civ[e];
    const float cor_im = rre * civ[e] + rim * crv[e];
    xr[e] = yrv[e] * cor_re - yiv[e] * cor_im;
    xi[e] = yrv[e] * cor_im + yiv[e] * cor_re;
  }
}

__global__ void __launch_bounds__(256, 3)
fused_backhalf_kernel(const float* __restrict__ y,
                      const float* __restrict__ bt,
                      const float* __restrict__ rr,
                      const float* __restrict__ rc,
                      const float* __restrict__ sc,
                      const int* __restrict__ bsel,
                      const int* __restrict__ dsel,
                      const __grid_constant__ tt::ScanTab tab,
                      float* __restrict__ corr, int* __restrict__ err,
                      float* __restrict__ soft, float* __restrict__ bt2,
                      float* __restrict__ last, float* __restrict__ misc,
                      int p, int drop, int k_max, int tr, int z_rows) {
  extern __shared__ float2 sym[];                // ns symbols, then:
  __shared__ float s_last_sym[2];
  const int n = 128 * p;
  const int sy = p / 4;
  const int ns = 128 * sy;
  const int pitch = sy + 1;
  const int nw = 4 * z_rows;
  float* stage = (float*)(sym + ns);             // 2 planes of 128 * pitch
  unsigned* z = (unsigned*)(stage + 2 * 128 * pitch);
  unsigned char* hard = (unsigned char*)(z + nw);
  const int cidx = blockIdx.x;
  Carrier c;
  c.y = y + (long long)cidx * 2 * n;
  c.rr = rr + (long long)cidx * 256;
  c.rc = rc + (long long)cidx * 2 * p;
  c.sc = sc + (long long)cidx * 16;
  c.p = p;
  c.n = n;
  c.d0 = drop - 4;

  if (threadIdx.x == 0) {
    s_last_sym[0] = 0.f;
    s_last_sym[1] = 0.f;
  }

  // 1-3a. corrected samples and the interpolated symbols
  const float c0 = c.sc[0], c1 = c.sc[1], c2 = c.sc[2], c3 = c.sc[3];
  const float nv = c.sc[4];
  const int b = bsel[cidx];
  const int g_first = c.d0 >> 2;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    int g0 = g_first + i;
    if (g0 >= ns) g0 -= ns;
    int g1 = g0 + 1;
    if (g1 >= ns) g1 -= ns;
    float xr[8], xi[8];
    load_group(c, 4 * g0, xr, xi);
    load_group(c, 4 * g1, xr + 4, xi + 4);
    const float r0 = pick(b, xr[0], xr[1], xr[2], xr[3]);
    const float r1 = pick(b, xr[1], xr[2], xr[3], xr[4]);
    const float r2 = pick(b, xr[2], xr[3], xr[4], xr[5]);
    const float r3 = pick(b, xr[3], xr[4], xr[5], xr[6]);
    const float i0 = pick(b, xi[0], xi[1], xi[2], xi[3]);
    const float i1 = pick(b, xi[1], xi[2], xi[3], xi[4]);
    const float i2 = pick(b, xi[2], xi[3], xi[4], xi[5]);
    const float i3 = pick(b, xi[3], xi[4], xi[5], xi[6]);
    sym[i] = make_float2(((c0 * r0 + c1 * r1) + c2 * r2) + c3 * r3,
                         ((c0 * i0 + c1 * i1) + c2 * i2) + c3 * i3);
  }

  // the corrected last sample row
  float* lastc = last + (long long)cidx * 2 * p;
  for (int s = 4 * threadIdx.x; s < p; s += 4 * blockDim.x) {
    float xr[4], xi[4];
    load_group(c, 127 * p + s, xr, xi);
    *(float4*)(lastc + s) = make_float4(xr[0], xr[1], xr[2], xr[3]);
    *(float4*)(lastc + p + s) = make_float4(xi[0], xi[1], xi[2], xi[3]);
  }

  // 4a. the carried tail bits of z, one ballot a word
  tt::place_tail(bt + (long long)cidx * tr * 128, z);
  __syncthreads();

  // 3b. differential decisions and soft bits
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const float2 s = sym[i];
    const float2 prv = i == 0 ? make_float2(c.sc[5], c.sc[6]) : sym[i - 1];
    const float dre = s.x * prv.x + s.y * prv.y;
    const float dim = s.y * prv.x - s.x * prv.y;
    const float mag = sqrtf(dre * dre + dim * dim) + 1e-12f;
    const int tq = i / sy;
    const int u = i - tq * sy;
    stage[tq * pitch + u] = -dim / mag;
    stage[128 * pitch + tq * pitch + u] = -dre / mag;
    const float fi = (float)i;
    const bool valid = fi < nv;
    hard[i] = valid ? (unsigned char)(((dim < 0.f) ? 2 : 0)
                                      | ((dre < 0.f) ? 1 : 0))
                    : (unsigned char)0;
    if (fi == nv - 1.0f) {
      s_last_sym[0] = s.x;
      s_last_sym[1] = s.y;
    }
  }
  __syncthreads();

  // soft bits out: soft[plane][u][t], whole rows of 128
  float* softc = soft + (long long)cidx * 2 * ns;
  for (int e = threadIdx.x; e < 2 * ns; e += blockDim.x) {
    const int t = e & 127;
    const int row = e >> 7;                      // plane * sy + u
    const int plane = row >= sy;
    const int u = row - plane * sy;
    softc[e] = stage[plane * 128 * pitch + t * pitch + u];
  }

  float* miscc = misc + (long long)cidx * 128;
  for (int l = 4 * threadIdx.x; l < 128; l += 4 * blockDim.x)
    *(float4*)(miscc + l) = l == 0
        ? make_float4(s_last_sym[0], s_last_sym[1], 0.f, 0.f)
        : make_float4(0.f, 0.f, 0.f, 0.f);

  // 4b. the symbol bits of z: word w holds symbols 16 w - 600 + (0..15)
  tt::place_symbols(hard, ns, nw, z);
  __syncthreads();

  // 5. even-position sync + CRC scan, a run of BACKHALF_K positions a
  // thread (64 | npos): the first in full, the rest by the sliding step
  const int npos = 64 * (z_rows - 2);
  float* corrc = corr + (long long)cidx * npos;
  int* errc = err + (long long)cidx * npos;
  for (int pe = BACKHALF_K * threadIdx.x; pe < npos;
       pe += BACKHALF_K * blockDim.x) {
    float cv[4];
    int ev[4];
    tt::scan_run<BACKHALF_K>(z, 2 * pe, tab, [&](int t, int n_agree, int e) {
      cv[t & 3] = (float)n_agree * (1.0f / 22.0f);
      ev[t & 3] = e;
      if ((t & 3) == 3) {
        *(float4*)(corrc + pe + t - 3) =
            make_float4(cv[0], cv[1], cv[2], cv[3]);
        *(int4*)(errc + pe + t - 3) = make_int4(ev[0], ev[1], ev[2], ev[3]);
      }
    });
  }

  // 6. next carried tail bits
  tt::place_next_tail(z, nw, 2 * k_max - 4 + 2 * dsel[cidx], tr,
                      bt2 + (long long)cidx * tr * 128);
}

}  // namespace

// scan_tab: the SCAN_WORDS table words in host memory.
extern "C" int tt_fused_backhalf(const void* y, const void* bt,
                                 const void* rr, const void* rc,
                                 const void* sc, const void* bsel,
                                 const void* dsel, const void* scan_tab,
                                 void* corr, void* err, void* soft,
                                 void* bt2, void* last, void* misc, int p,
                                 int drop, int k_max, int tr, int z_rows,
                                 int n_carriers, void* stream) {
  tt::ScanTab tab;
  memcpy(tab.w, scan_tab, sizeof(tab.w));
  const int sy = p / 4;
  const int ns = 128 * sy;
  const int smem = ns * (int)sizeof(float2) + 2 * 128 * (sy + 1) * 4
                   + 4 * z_rows * 4 + ns;
  cudaError_t e = cudaFuncSetAttribute(
      fused_backhalf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  fused_backhalf_kernel<<<n_carriers, 256, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)bt, (const float*)rr,
      (const float*)rc, (const float*)sc, (const int*)bsel,
      (const int*)dsel, tab, (float*)corr, (int*)err, (float*)soft,
      (float*)bt2, (float*)last, (float*)misc, p, drop, k_max, tr, z_rows);
  return (int)cudaGetLastError();
}
