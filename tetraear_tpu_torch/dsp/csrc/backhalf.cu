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
// is indexed shared-memory loads and bit packing.
//
// Bound by device memory: 64 KB of samples in per carrier, ~40 KB of
// verdicts and soft bits out; the scan is ~0.2 M popcounts a carrier.
// Design: the corrected band stays in 64 KB of shared memory; every
// float expression keeps the reference's order of operations
// (contraction off), so decisions match the plain version bit for bit.
#include "scan.cuh"

#define TAILBITS 1200

namespace {

__device__ __forceinline__ float2 interp4(const float2* x, int n, int k,
                                          float c0, float c1, float c2,
                                          float c3) {
  const float2 x0 = x[k % n];
  const float2 x1 = x[(k + 1) % n];
  const float2 x2 = x[(k + 2) % n];
  const float2 x3 = x[(k + 3) % n];
  return make_float2(((c0 * x0.x + c1 * x1.x) + c2 * x2.x) + c3 * x3.x,
                     ((c0 * x0.y + c1 * x1.y) + c2 * x2.y) + c3 * x3.y);
}

__global__ void __launch_bounds__(512)
fused_backhalf_kernel(const float* __restrict__ y,
                      const float* __restrict__ bt,
                      const float* __restrict__ rr,
                      const float* __restrict__ rc,
                      const float* __restrict__ sc,
                      const int* __restrict__ bsel,
                      const int* __restrict__ dsel,
                      const unsigned* __restrict__ scan_tab,
                      float* __restrict__ corr, int* __restrict__ err,
                      float* __restrict__ soft, float* __restrict__ bt2,
                      float* __restrict__ last, float* __restrict__ misc,
                      int p, int drop, int k_max, int tr, int z_rows) {
  extern __shared__ float2 x[];                  // n samples, then z, hard
  __shared__ unsigned tab[SCAN_WORDS];
  __shared__ float s_last_sym[2];
  const int n = 128 * p;
  const int sy = p / 4;
  const int ns = 128 * sy;
  const int nw = 4 * z_rows;
  unsigned* z = (unsigned*)(x + n);
  unsigned char* hard = (unsigned char*)(z + nw);
  const int c = blockIdx.x;
  const float* scc = sc + (long long)c * 16;

  for (int i = threadIdx.x; i < SCAN_WORDS; i += blockDim.x)
    tab[i] = scan_tab[i];
  if (threadIdx.x == 0) {
    s_last_sym[0] = 0.f;
    s_last_sym[1] = 0.f;
  }

  // 1. phase ramp / rotation: x = y * (rr[t] rc[s])
  const float* yc = y + (long long)c * 2 * n;
  const float* rrc = rr + (long long)c * 256;
  const float* rcc = rc + (long long)c * 2 * p;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int t = k / p;
    const int s = k - t * p;
    const float rre = rrc[t], rim = rrc[128 + t];
    const float cre = rcc[s], cim = rcc[p + s];
    const float cor_re = rre * cre - rim * cim;
    const float cor_im = rre * cim + rim * cre;
    const float yr = yc[k], yi = yc[n + k];
    x[k] = make_float2(yr * cor_re - yi * cor_im, yr * cor_im + yi * cor_re);
  }
  __syncthreads();

  // 2. splice the carried interpolation tail over [drop-4, drop)
  const int d0 = drop - 4;
  if (threadIdx.x < 4) {
    const int j = threadIdx.x;
    x[d0 + j] = make_float2(scc[7 + j], scc[11 + j]);
  }
  __syncthreads();

  float* lastc = last + (long long)c * 2 * p;
  for (int s = threadIdx.x; s < p; s += blockDim.x) {
    const float2 v = x[127 * p + s];
    lastc[s] = v.x;
    lastc[p + s] = v.y;
  }

  // 3. symbols, differential decisions, soft bits
  const float c0 = scc[0], c1 = scc[1], c2 = scc[2], c3 = scc[3];
  const float nv = scc[4];
  const int b = bsel[c];
  float* softc = soft + (long long)c * 2 * ns;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const float2 sym = interp4(x, n, d0 + 4 * i + b, c0, c1, c2, c3);
    const float2 prv = i == 0 ? make_float2(scc[5], scc[6])
                              : interp4(x, n, d0 + 4 * (i - 1) + b,
                                        c0, c1, c2, c3);
    const float dre = sym.x * prv.x + sym.y * prv.y;
    const float dim = sym.y * prv.x - sym.x * prv.y;
    const float mag = sqrtf(dre * dre + dim * dim) + 1e-12f;
    const int tq = i / sy;
    const int u = i - tq * sy;
    softc[u * 128 + tq] = -dim / mag;
    softc[ns + u * 128 + tq] = -dre / mag;
    const float fi = (float)i;
    const bool valid = fi < nv;
    hard[i] = valid ? (unsigned char)(((dim < 0.f) ? 2 : 0)
                                      | ((dre < 0.f) ? 1 : 0))
                    : (unsigned char)0;
    if (fi == nv - 1.0f) {
      s_last_sym[0] = sym.x;
      s_last_sym[1] = sym.y;
    }
  }
  __syncthreads();

  float* miscc = misc + (long long)c * 128;
  for (int l = threadIdx.x; l < 128; l += blockDim.x)
    miscc[l] = l < 2 ? s_last_sym[l] : 0.f;

  // 4. the z bit row, packed
  const float* btc = bt + (long long)c * tr * 128;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    unsigned word = 0;
    for (int j = 0; j < 32; ++j) {
      const int pos = 32 * w + j;
      unsigned bit;
      if (pos < TAILBITS) {
        bit = btc[pos] != 0.f ? 1u : 0u;
      } else {
        const int rel = pos - TAILBITS;
        const int i = rel >> 1;
        bit = i < ns ? (unsigned)(hard[i] >> (1 - (rel & 1))) & 1u : 0u;
      }
      word |= bit << j;
    }
    z[w] = word;
  }
  __syncthreads();

  // 5. even-position sync + CRC scan
  const int npos = 64 * (z_rows - 2);
  float* corrc = corr + (long long)c * npos;
  int* errc = err + (long long)c * npos;
  for (int pe = threadIdx.x; pe < npos; pe += blockDim.x) {
    int n_agree;
    const int e = tt::scan_window(z, 2 * pe, tab, &n_agree);
    corrc[pe] = (float)n_agree * (1.0f / 22.0f);
    errc[pe] = e;
  }

  // 6. next carried tail bits
  const int off = 2 * k_max - 4 + 2 * dsel[c];
  const int zbits = 32 * nw;
  float* bt2c = bt2 + (long long)c * tr * 128;
  for (int pos = threadIdx.x; pos < tr * 128; pos += blockDim.x) {
    float v = 0.f;
    const int src = off + pos;
    if (pos < TAILBITS && src < zbits)
      v = (float)((z[src >> 5] >> (src & 31)) & 1u);
    bt2c[pos] = v;
  }
}

}  // namespace

extern "C" int tt_fused_backhalf(const void* y, const void* bt,
                                 const void* rr, const void* rc,
                                 const void* sc, const void* bsel,
                                 const void* dsel, const void* scan_tab,
                                 void* corr, void* err, void* soft,
                                 void* bt2, void* last, void* misc, int p,
                                 int drop, int k_max, int tr, int z_rows,
                                 int n_carriers, void* stream) {
  const int n = 128 * p;
  const int smem = n * (int)sizeof(float2) + 4 * z_rows * 4 + 32 * p;
  cudaError_t e = cudaFuncSetAttribute(
      fused_backhalf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  fused_backhalf_kernel<<<n_carriers, 512, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)bt, (const float*)rr,
      (const float*)rc, (const float*)sc, (const int*)bsel,
      (const int*)dsel, (const unsigned*)scan_tab, (float*)corr,
      (int*)err, (float*)soft, (float*)bt2, (float*)last, (float*)misc, p,
      drop, k_max, tr, z_rows);
  return (int)cudaGetLastError();
}
