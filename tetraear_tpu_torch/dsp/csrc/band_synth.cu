// Per-carrier band synthesis with the Oerder-Meyr timing phasor.
//
// Replaces band_synth (tetraear_tpu/dsp/pallas_kernels.py) in its three
// forms, as compile-time variants of one kernel: with the phasor
// (phasor_drop=drop, _band_synth_ph_kernel), y only (_band_synth_kernel:
// no phasor is computed or written) and phasor only (y_out=False,
// _band_synth_phonly_kernel: y never reaches device memory).
// One block per carrier c:
//   * gather the carrier's n_band = 128 P natural-order spectrum bins,
//     which are contiguous: planes[:, row_start[c]*128 + i];
//   * multiply by its rolled channel filter h1_planes[:, d_shift[c]];
//   * inverse n_band-point DFT in shared memory, scaled by 1/n_band
//     (the same transform the reference evaluates as the m1c / tw / m2
//     Cooley-Tukey matmuls), written as y[c, re/im, k];
//   * the phasor sum_{k >= drop} |y_k|^2 e^{-j pi k / 2} by a block
//     reduction, in lanes 0/1 of ph[c].
//
// Bound by device memory: it streams 64 KB of spectrum in and 64 KB of
// samples out per carrier (1.3 GB a block at C = 10240); the 8.4 MB
// rolled-filter table is read by every carrier and stays in the 50 MB
// L2.  Design: one carrier's band lives in 64 KB of shared memory
// through a float32 radix-2 FFT; no TPU-style DMA pipelining or
// carrier groups.
#include "common.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool WRITE_Y, bool WITH_PH>
__global__ void __launch_bounds__(1024)
band_synth_kernel(const float* __restrict__ planes, long long plane_len,
                  const float* __restrict__ h1, int n_rolls,
                  const int* __restrict__ row_start,
                  const int* __restrict__ d_shift, float* __restrict__ y,
                  float* __restrict__ ph, int log2n, int drop,
                  const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  __shared__ float red[2][32];
  const int n = 1 << log2n;
  const int c = blockIdx.x;
  const long long base = (long long)row_start[c] * 128;
  const long long hbase = (long long)d_shift[c] * n;
  const long long hplane = (long long)n_rolls * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float nre = planes[base + i];
    const float nim = planes[plane_len + base + i];
    const float hre = h1[hbase + i];
    const float him = h1[hplane + hbase + i];
    sm[i] = make_float2(nre * hre - nim * him, nre * him + nim * hre);
  }
  __syncthreads();
  tt::smem_fft(sm, log2n, n, 1, tw, true);
  const float scale = 1.0f / (float)n;          // a power of two: exact
  float pre = 0.f, pim = 0.f;
  float* yc = y + (long long)c * 2 * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 v = sm[k];
    const float yr = v.x * scale;
    const float yi = v.y * scale;
    if (WRITE_Y) {
      yc[k] = yr;
      yc[n + k] = yi;
    }
    if (WITH_PH && k >= drop) {
      const float pw = yr * yr + yi * yi;
      switch (k & 3) {
        case 0: pre += pw; break;
        case 1: pim -= pw; break;
        case 2: pre -= pw; break;
        default: pim += pw; break;
      }
    }
  }
  if (!WITH_PH) return;
  pre = warp_sum(pre);
  pim = warp_sum(pim);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = pre;
    red[1][warp] = pim;
  }
  __syncthreads();
  float* phc = ph + (long long)c * 128;
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    pre = warp_sum(lane < nw ? red[0][lane] : 0.f);
    pim = warp_sum(lane < nw ? red[1][lane] : 0.f);
    if (lane == 0) {
      phc[0] = pre;
      phc[1] = pim;
    }
  }
  for (int l = 2 + threadIdx.x; l < 128; l += blockDim.x) phc[l] = 0.f;
}

}  // namespace

template <bool WRITE_Y, bool WITH_PH>
static int launch(const void* planes, long long plane_len, const void* h1,
                  int n_rolls, const void* row_start, const void* d_shift,
                  void* y, void* ph, const void* tw, int log2n, int drop,
                  int n_carriers, void* stream) {
  const int smem = (1 << log2n) * (int)sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      band_synth_kernel<WRITE_Y, WITH_PH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  band_synth_kernel<WRITE_Y, WITH_PH>
      <<<n_carriers, 1024, smem, (cudaStream_t)stream>>>(
          (const float*)planes, plane_len, (const float*)h1, n_rolls,
          (const int*)row_start, (const int*)d_shift, (float*)y,
          (float*)ph, log2n, drop, (const float2*)tw);
  return (int)cudaGetLastError();
}

// mode 0: y and phasor; 1: y only (ph unused); 2: phasor only (y unused)
extern "C" int tt_band_synth(const void* planes, long long plane_len,
                             const void* h1, int n_rolls,
                             const void* row_start, const void* d_shift,
                             void* y, void* ph, const void* tw, int log2n,
                             int drop, int n_carriers, int mode,
                             void* stream) {
  if (mode == 1)
    return launch<true, false>(planes, plane_len, h1, n_rolls, row_start,
                               d_shift, y, ph, tw, log2n, drop, n_carriers,
                               stream);
  if (mode == 2)
    return launch<false, true>(planes, plane_len, h1, n_rolls, row_start,
                               d_shift, y, ph, tw, log2n, drop, n_carriers,
                               stream);
  return launch<true, true>(planes, plane_len, h1, n_rolls, row_start,
                            d_shift, y, ph, tw, log2n, drop, n_carriers,
                            stream);
}
