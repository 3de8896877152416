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
//   * inverse n_band-point DFT, scaled by 1/n_band (the same transform
//     the reference evaluates as the m1c / tw / m2 Cooley-Tukey matmuls),
//     written as y[c, re/im, k];
//   * the phasor sum_{k >= drop} |y_k|^2 e^{-j pi k / 2} by a block
//     reduction, in lanes 0/1 of ph[c].
//
// Bound by device memory: it streams 64 KB of spectrum in and 64 KB of
// samples out per carrier (0.95 GB a block at C = 10240); the 8.4 MB
// rolled-filter table is read by every carrier and stays in the 50 MB
// L2.  What stands between a kernel and that bound is the transform's
// own traffic: run a radix-2 stage at a time through shared memory, an
// 8192-point band costs 27 passes over its 64 KB tile, 14 barriers and a
// twiddle load a butterfly, 8.6 times the bound.  What this design does
// about it:
//   * butterflies in registers (radix.cuh, shared with fft2p.cu): 3 or 4
//     radix-8 / radix-16 stages (2 under 512 points), decimation in frequency, in place.  The
//     first stage loads bins and filter from device memory and multiplies
//     in registers, the last scales, accumulates the phasor and stores y
//     from registers; the padded tile carries only the 2 or 3 exchanges
//     between stages, each closed by one barrier;
//   * stage twiddles from the float32 table the stage needs (made from
//     float64 on the host): four loads a radix-16 butterfly, the other
//     powers by products;
//   * the inverse transform is the forward one on data with re and im
//     exchanged, which costs nothing: the first stage builds (im, re),
//     the last stores .y as re and .x as im;
//   * coalesced on both sides.  In the first stage neighbouring lanes
//     take neighbouring bins (a radix's points lie n / R apart), so a
//     warp's load is 128 contiguous bytes of each plane.  The digit
//     reversal is folded into the last stage's addresses the other way
//     round than in fft2p: item u of the last stage takes the butterfly
//     whose tile position is u digit-reversed, so that its outputs are
//     the bins u + j n / R_last and neighbouring lanes store neighbouring
//     k, again 128 contiguous bytes a warp and plane.  The choice is
//     4-byte accesses a lane on both sides, not 16: a 16-byte access
//     would put four butterflies (64 complex values) into one thread, or
//     take y once more through the tile; the lane-contiguous form moves
//     whole 128-byte lines either way, and the tile's padding keeps the
//     digit-reversed reads of the last stage off each other's banks;
//   * the transform length is a template parameter (128 to 16384), so
//     every index is a constant and each length has its own block: 256
//     threads and a 70 KB tile at 8192 points, three carriers in flight
//     an SM (one carrier's loads run under another's stages); 512 threads
//     and one block an SM at 16384 (139 KB); 64 to 256 threads at 4096
//     points and fewer, many blocks an SM;
//   * the phasor's weight e^{-j pi k / 2} depends on k & 3, which is the
//     item's own low bits for all of its outputs: a thread sums the powers
//     of its outputs with k >= drop and applies the sign once.
// Not the tensor cores: the reference's matmul form exists for a matrix
// unit, TF32 keeps three digits where y is held to 1e-5 of its RMS, and
// a split-float product is more work than the register transform.
// Fused multiply-add contraction is on for this source (_FMAD_SOURCES):
// y is held to a tolerance, not to bit identity with the plain version,
// and the three variants run the same instructions, so y and the phasor
// stay bit-equal between them.
#include "radix.cuh"

namespace {

using namespace tt;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int band_threads(int lgn) {
  return lgn >= 14 ? 512 : lgn >= 12 ? 256 : lgn >= 10 ? 1 << (lgn - 4) : 64;
}
// blocks an SM that the register allocation must allow
__host__ __device__ constexpr int band_blocks(int lgn) {
  return lgn >= 14 ? 1 : lgn == 13 ? 3 : lgn == 12 ? 2 : 4;
}
// padded tile: one element a last-stage butterfly, one a first-stage
// sub-block (radix.cuh, sidx)
__host__ __device__ constexpr int band_tile_points(int lgn) {
  const Plan pl = make_plan(lgn);
  return (1 << lgn) + ((1 << lgn) >> pl.lg[pl.ns - 1]) + (1 << pl.lg[0]);
}

struct Band {
  const float* nre;     // the carrier's bins, two planes
  const float* nim;
  const float* hre;     // its rolled filter
  const float* him;
  float* y;             // (2, n)
  const float2* tw;     // exp(-2 pi i t / n), t < n / 2
  int drop;
};

// Stage S of the 2^LGN-point transform of one carrier.  The first stage
// reads device memory, the last writes it and accumulates the phasor's
// two sums into (pre, pim).
template <int LGN, int S, bool WRITE_Y, bool WITH_PH>
__device__ __forceinline__ void band_stage(const Band& b, float2* sm,
                                           float& pre, float& pim) {
  constexpr Plan pl = make_plan(LGN);
  constexpr int LGR = pl.lg[S];
  constexpr int R = 1 << LGR;
  constexpr bool FIRST = S == 0;
  constexpr bool LAST = S == pl.ns - 1;
  constexpr int N = 1 << LGN;
  constexpr int ITEMS = N >> LGR;
  constexpr int2 pad = {pl.lg[pl.ns - 1], LGN - pl.lg[0]};
  int lgns_ = LGN;
#pragma unroll
  for (int s = 0; s < S; ++s) lgns_ -= pl.lg[s];
  const int lgns = lgns_;              // log2 of this stage's sub-transform
  const int lgs = lgns - LGR;
  for (int item = threadIdx.x; item < ITEMS; item += blockDim.x) {
    float2 v[R];
    if constexpr (LAST) {
      // the butterfly at the digit-reversed position: its bins' low
      // digits are the item's own bits
      int base = 0, cum = 0;
#pragma unroll
      for (int s = 0; s + 1 < pl.ns; ++s) {
        base += ((item >> cum) & ((1 << pl.lg[s]) - 1))
                << (LGN - cum - pl.lg[s]);
        cum += pl.lg[s];
      }
      const float2* mine = sm + sidx(base, 0, pad, 0);
#pragma unroll
      for (int q = 0; q < R; ++q) v[q] = mine[q];
      dft<R>(v);
      const float scale = 1.0f / (float)N;       // a power of two: exact
      float pw = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int k = item + (brev<R>(i) << (LGN - LGR));
        const float yr = v[i].y * scale;         // re and im exchanged
        const float yi = v[i].x * scale;
        if constexpr (WRITE_Y) {
          b.y[k] = yr;
          b.y[N + k] = yi;
        }
        if constexpr (WITH_PH) {
          if (k >= b.drop) pw += yr * yr + yi * yi;
        }
      }
      if constexpr (WITH_PH) {
        switch (item & 3) {                      // = k & 3 of every output
          case 0: pre += pw; break;
          case 1: pim -= pw; break;
          case 2: pre -= pw; break;
          default: pim += pw; break;
        }
      }
    } else {
      const int j = item & ((1 << lgs) - 1);
      const int base = ((item >> lgs) << lgns) + j;
      float2* mine = sm + sidx(base, 0, pad, 0);
      const int pitch = (1 << lgs) + (1 << (lgs - pad.x)) + (FIRST ? 1 : 0);
      if constexpr (FIRST) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int i = base + (q << lgs);
          const float nre = b.nre[i], nim = b.nim[i];
          const float hre = b.hre[i], him = b.him[i];
          v[q] = make_float2(nre * him + nim * hre, nre * hre - nim * him);
        }
      } else {
#pragma unroll
        for (int q = 0; q < R; ++q) v[q] = mine[q * pitch];
      }
      dft<R>(v);
      stage_twiddles<R>(v, b.tw, j << (LGN - lgns));
#pragma unroll
      for (int i = 0; i < R; ++i) mine[brev<R>(i) * pitch] = v[i];
    }
  }
}

template <int LGN, bool WRITE_Y, bool WITH_PH>
__global__ void __launch_bounds__(band_threads(LGN), band_blocks(LGN))
band_synth_kernel(const float* __restrict__ planes, long long plane_len,
                  const float* __restrict__ h1, int n_rolls,
                  const int* __restrict__ row_start,
                  const int* __restrict__ d_shift, float* __restrict__ y,
                  float* __restrict__ ph, int drop,
                  const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  __shared__ float red[2][32];
  constexpr int N = 1 << LGN;
  constexpr int NS = make_plan(LGN).ns;
  const int c = blockIdx.x;
  const long long base = (long long)row_start[c] * 128;
  const long long hbase = (long long)d_shift[c] * N;
  Band b;
  b.nre = planes + base;
  b.nim = planes + plane_len + base;
  b.hre = h1 + hbase;
  b.him = h1 + (long long)n_rolls * N + hbase;
  b.y = WRITE_Y ? y + (long long)c * 2 * N : nullptr;
  b.tw = tw;
  b.drop = drop;
  float pre = 0.f, pim = 0.f;
  band_stage<LGN, 0, WRITE_Y, WITH_PH>(b, sm, pre, pim);
  __syncthreads();
  band_stage<LGN, 1, WRITE_Y, WITH_PH>(b, sm, pre, pim);
  if constexpr (NS > 2) {
    __syncthreads();
    band_stage<LGN, 2, WRITE_Y, WITH_PH>(b, sm, pre, pim);
  }
  if constexpr (NS > 3) {
    __syncthreads();
    band_stage<LGN, 3, WRITE_Y, WITH_PH>(b, sm, pre, pim);
  }
  if constexpr (!WITH_PH) return;
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

template <int LGN, bool WRITE_Y, bool WITH_PH>
int launch(const void* planes, long long plane_len, const void* h1,
           int n_rolls, const void* row_start, const void* d_shift, void* y,
           void* ph, const void* tw, int drop, int n_carriers,
           void* stream) {
  const int smem = band_tile_points(LGN) * (int)sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      band_synth_kernel<LGN, WRITE_Y, WITH_PH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  band_synth_kernel<LGN, WRITE_Y, WITH_PH>
      <<<n_carriers, band_threads(LGN), smem, (cudaStream_t)stream>>>(
          (const float*)planes, plane_len, (const float*)h1, n_rolls,
          (const int*)row_start, (const int*)d_shift, (float*)y,
          (float*)ph, drop, (const float2*)tw);
  return (int)cudaGetLastError();
}

template <int LGN>
int launch_mode(int mode, const void* planes, long long plane_len,
                const void* h1, int n_rolls, const void* row_start,
                const void* d_shift, void* y, void* ph, const void* tw,
                int drop, int n_carriers, void* stream) {
  if (mode == 1)
    return launch<LGN, true, false>(planes, plane_len, h1, n_rolls,
                                    row_start, d_shift, y, ph, tw, drop,
                                    n_carriers, stream);
  if (mode == 2)
    return launch<LGN, false, true>(planes, plane_len, h1, n_rolls,
                                    row_start, d_shift, y, ph, tw, drop,
                                    n_carriers, stream);
  return launch<LGN, true, true>(planes, plane_len, h1, n_rolls, row_start,
                                 d_shift, y, ph, tw, drop, n_carriers,
                                 stream);
}

}  // namespace

// mode 0: y and phasor; 1: y only (ph unused); 2: phasor only (y unused).
// tw: the n / 2 stage twiddles exp(-2 pi i t / n), n = 2^log2n in
// [128, 16384].
extern "C" int tt_band_synth(const void* planes, long long plane_len,
                             const void* h1, int n_rolls,
                             const void* row_start, const void* d_shift,
                             void* y, void* ph, const void* tw, int log2n,
                             int drop, int n_carriers, int mode,
                             void* stream) {
  if (n_carriers <= 0) return 0;
#define TT_BAND_CASE(L)                                                     \
  case L:                                                                   \
    return launch_mode<L>(mode, planes, plane_len, h1, n_rolls, row_start,  \
                          d_shift, y, ph, tw, drop, n_carriers, stream);
  switch (log2n) {
    TT_BAND_CASE(7)
    TT_BAND_CASE(8)
    TT_BAND_CASE(9)
    TT_BAND_CASE(10)
    TT_BAND_CASE(11)
    TT_BAND_CASE(12)
    TT_BAND_CASE(13)
    TT_BAND_CASE(14)
  }
#undef TT_BAND_CASE
  return (int)cudaErrorInvalidValue;
}
