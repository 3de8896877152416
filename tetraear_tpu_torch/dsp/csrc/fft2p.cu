// Wideband overlap-save FFT, four-step, in two launches.
//
// Replaces fft2p_planes_spliced / fft2p_planes
// (tetraear_tpu/dsp/pallas_kernels.py).  The window of N = la * lb
// samples is the carried tail (the first tail_len samples) followed by
// the fresh block; tail_len = 0 is the unspliced transform.  Sample
// n = i1 + lb * i2 (i1 < lb, i2 < la), bin k = k2 + la * k1:
//
//   pass 1, one block per t1 adjacent columns i1: la-point FFTs over i2,
//     times the four-step twiddle w_N^{i1 k2}, stored into the scratch G;
//   pass 2, one block per t2 adjacent k2: lb-point FFTs over i1, stored
//     into the natural-order planes (2, N + wrap_len), bins k < wrap_len
//     a second time at N + k (the wrap extension that keeps every band
//     one contiguous slice).
//
// Bound by device memory: each pass reads and writes 8 N bytes once.
// What the design does about it:
//   * butterflies in registers, radix 16 or 8 (dft<R>): a thread loads a
//     radix's points, transforms them, applies the stage twiddles and
//     writes them back in place (decimation in frequency).  Shared memory
//     only carries the exchange between two radix stages: the first stage
//     reads device memory into registers, the last writes device memory
//     from registers, and the tile is touched by 1 to 3 barriers where a
//     radix-2 transform has 13 or 14.  The digit reversal is folded into
//     the last stage's addresses;
//   * stage twiddles w^j, w^2j, w^4j, w^8j from a float32 table made from
//     float64 on the host, the other powers by at most three products;
//   * the four-step twiddle from two small float32 tables (high and low
//     bits of m = (i1 k2) mod N, one complex product): no float64, no
//     division;
//   * G is interleaved complex in tiles [la / t2][lb][t2].  In pass 1's
//     last stage neighbouring lanes take neighbouring columns and then
//     neighbouring bins k2, so a warp stores runs of t1 * t2 * 8 bytes
//     from its registers; pass 2 loads whole contiguous tiles;
//   * pass 2's tile cannot be 32 bytes of output wide at 4096 points and
//     more, and short store runs are what it was bound by (its time
//     halved with each doubling of the run).  There a thread block
//     cluster of cl2 neighbouring tiles shares the last stage: each
//     block takes a slice of the butterflies of all the cluster's rows,
//     read through distributed shared memory, and stores runs of
//     4 * t2 * cl2 bytes from its registers;
//   * the tile is padded (sidx), which keeps every stage's shared-memory
//     accesses free of bank conflicts;
//   * fused multiply-add contraction is on for this source (tolerance
//     1e-4 of the spectrum RMS; the measured error is 2e-6 of it).
// Pass 1's loads move runs of 4 * t1 bytes of the planar input; the tile
// widths and the cluster size are chosen by the wrapper from measurements.
#include <cooperative_groups.h>

#include "radix.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tt;

struct Args {
  // pass 1 reads tail / x and writes g; pass 2 reads g and writes out
  const float* tail;
  const float* x;
  float2* g;
  float* out;
  const float2* tw;      // stage twiddles of this pass's length
  const float2* whi;     // w_N^{m >> hbits << hbits}
  const float2* wlo;     // w_N^{m & (2^hbits - 1)}
  long long tail_len, wrap_len;
  int lga, lgb;          // log2 of pass 1's and pass 2's lengths
  int lgt1, lgt2;        // log2 of the tile widths
  int lgcl2;             // log2 of pass 2's cluster size
  int hbits;
};

// bin k of pass 2's row k2, with its wrap copy
__device__ __forceinline__ void store_bin(const Args& a, int k1, int k2,
                                          float2 v) {
  const long long nfft = 1LL << (a.lga + a.lgb);
  const long long plane = nfft + a.wrap_len;
  const long long k = ((long long)k1 << a.lga) + k2;
  a.out[k] = v.x;
  a.out[plane + k] = v.y;
  if (k < a.wrap_len) {
    a.out[nfft + k] = v.x;
    a.out[plane + nfft + k] = v.y;
  }
}

// One radix-R stage of the tile's transforms.  FIRST reads device memory,
// LAST writes it; everything else is in place in shared memory.  In the
// LAST stage of a CLUSTER (pass 2) a block takes its share of the
// butterflies of every tile of the cluster, read through distributed
// shared memory, so that neighbouring lanes hold neighbouring rows k2.
template <int R, bool FIRST, bool LAST, bool PASS1, bool CLUSTER>
__device__ __forceinline__ void run_stage(const Args& a, const Plan& pl,
                                          float2* sm, int lgns, int2 padsh) {
  constexpr int LGR = R == 16 ? 4 : 3;
  const int lgl = pl.lgn;
  const int lgt = PASS1 ? a.lgt1 : a.lgt2;
  const int lgs = lgns - LGR;
  const int items = (1 << (lgl - LGR)) << lgt;
  const int tile0 = blockIdx.x << lgt;
  const long long nfft = 1LL << (a.lga + a.lgb);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    int r = item & ((1 << lgt) - 1);
    int u = item >> lgt;
    int row = tile0 + r;             // the column i1 or the row k2
    float2* tile = sm;
    if constexpr (LAST && PASS1) {
      // neighbouring lanes take neighbouring bins k2 (the first stage's
      // digit), so that a warp stores whole runs of G
      const int rest_bits = lgl - LGR - pl.lg[0];
      u = ((u & ((1 << pl.lg[0]) - 1)) << rest_bits) | (u >> pl.lg[0]);
    }
    if constexpr (LAST && CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      const int lgw = lgt + a.lgcl2;
      const int kk = item & ((1 << lgw) - 1);
      r = kk & ((1 << lgt) - 1);
      u = ((int)cluster.block_rank() << (lgl - LGR - a.lgcl2))
          + (item >> lgw);
      row = ((blockIdx.x >> a.lgcl2) << lgw) + kk;
      tile = cluster.map_shared_rank(sm, kk >> lgt);
    }
    const int j = u & ((1 << lgs) - 1);
    const int base = ((u >> lgs) << lgns) + j;
    // the butterfly's points lie `pitch` apart in the padded tile: the
    // stride is a multiple of the last stage's radix (or 1 in the last
    // stage), and only the first stage steps over its own sub-blocks
    float2* mine = tile + sidx(base, r, padsh, lgt);
    const int pitch =
        LAST ? 1 << lgt
             : ((1 << lgs) + (1 << (lgs - padsh.x)) + (FIRST ? 1 : 0)) << lgt;
    float2 v[R];
    if constexpr (FIRST && PASS1) {
      const int i1 = row;
      const float* tail_im = a.tail + a.tail_len;
      const float* x_im = a.x + (nfft - a.tail_len);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const long long n =
            ((long long)(base + (q << lgs)) << a.lgb) + i1;
        if (n < a.tail_len) {
          v[q] = make_float2(a.tail[n], tail_im[n]);
        } else {
          const long long m = n - a.tail_len;
          v[q] = make_float2(a.x[m], x_im[m]);
        }
      }
    } else if constexpr (FIRST) {
      const float2* gt = a.g + ((long long)blockIdx.x << (a.lgb + lgt));
#pragma unroll
      for (int q = 0; q < R; ++q)
        v[q] = gt[((base + (q << lgs)) << lgt) + r];
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) v[q] = mine[q * pitch];
    }
    dft<R>(v);
    if constexpr (!LAST) {
      stage_twiddles<R>(v, a.tw, j << (lgl - lgns));
#pragma unroll
      for (int i = 0; i < R; ++i) mine[brev<R>(i) * pitch] = v[i];
    } else {
      // the bins' low digits from the butterfly's place in the tile
      const int k_low = bin_of_pos(pl, base);
      if constexpr (PASS1) {
        const int i1 = row;
        const int mask = (int)(nfft - 1);
        const int lomask = (1 << a.hbits) - 1;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int k2 = k_low + (brev<R>(i) << (lgl - LGR));
          const int m = (i1 * k2) & mask;
          const float2 w = tt::cmul(__ldg(a.whi + (m >> a.hbits)),
                                    __ldg(a.wlo + (m & lomask)));
          a.g[((((long long)(k2 >> a.lgt2) << a.lgb) + i1) << a.lgt2)
              + (k2 & ((1 << a.lgt2) - 1))] = tt::cmul(v[i], w);
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i)
          store_bin(a, k_low + (brev<R>(i) << (lgl - LGR)), row, v[i]);
      }
    }
  }
}

template <bool FIRST, bool LAST, bool PASS1, bool CLUSTER>
__device__ __forceinline__ void run_radix(int lgr, const Args& a,
                                          const Plan& pl, float2* sm,
                                          int lgns, int2 padsh) {
  if (lgr == 4) run_stage<16, FIRST, LAST, PASS1, CLUSTER>(a, pl, sm, lgns,
                                                           padsh);
  else run_stage<8, FIRST, LAST, PASS1, CLUSTER>(a, pl, sm, lgns, padsh);
}

// CLUSTER: pass 2 launched as clusters of 2^lgcl2 blocks.
template <bool PASS1, bool CLUSTER>
__global__ void __launch_bounds__(512)
fft2p_pass(Args a) {
  extern __shared__ float2 sm[];
  const Plan pl = make_plan(PASS1 ? a.lga : a.lgb);
  const int2 padsh = make_int2(pl.lg[pl.ns - 1], pl.lgn - pl.lg[0]);
  int lgns = pl.lgn;
  for (int s = 0; s < pl.ns; ++s) {
    if (s == 0)
      run_radix<true, false, PASS1, CLUSTER>(pl.lg[s], a, pl, sm, lgns,
                                             padsh);
    else if (s + 1 < pl.ns)
      run_radix<false, false, PASS1, CLUSTER>(pl.lg[s], a, pl, sm, lgns,
                                              padsh);
    else
      run_radix<false, true, PASS1, CLUSTER>(pl.lg[s], a, pl, sm, lgns,
                                             padsh);
    lgns -= pl.lg[s];
    // the last stage of a cluster reads every tile of the cluster, and
    // no block may leave while its tile is being read
    if (CLUSTER && s + 2 >= pl.ns) cg::this_cluster().sync();
    else if (s + 1 < pl.ns) __syncthreads();
  }
}

int tile_bytes(int lgn, int lgt) {
  const Plan pl = make_plan(lgn);
  const int n = 1 << lgn;
  return ((n + (n >> pl.lg[pl.ns - 1]) + (1 << pl.lg[0])) << lgt)
         * (int)sizeof(float2);
}

int block_threads(int lgn, int lgt) {
  const int items = (1 << (lgn - 4)) << lgt;
  return items < 64 ? 64 : items > 512 ? 512 : items;
}

template <bool PASS1, bool CLUSTER>
cudaError_t launch_pass(const Args& a, cudaStream_t st) {
  const int lgn = PASS1 ? a.lga : a.lgb;
  const int lgt = PASS1 ? a.lgt1 : a.lgt2;
  const int smem = tile_bytes(lgn, lgt);
  cudaError_t e = cudaFuncSetAttribute(
      fft2p_pass<PASS1, CLUSTER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1 << ((PASS1 ? a.lgb : a.lga) - lgt));
  cfg.blockDim = dim3(block_threads(lgn, lgt));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER ? 1 << a.lgcl2 : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fft2p_pass<PASS1, CLUSTER>, a);
}

Args make_args(const void* tail, const void* x, void* g, void* out,
               const void* tw, const void* whi, const void* wlo,
               long long tail_len, long long wrap_len, int lga, int lgb,
               int lgt1, int lgt2, int lgcl2, int hbits) {
  Args a;
  a.tail = (const float*)tail;
  a.x = (const float*)x;
  a.g = (float2*)g;
  a.out = (float*)out;
  a.tw = (const float2*)tw;
  a.whi = (const float2*)whi;
  a.wlo = (const float2*)wlo;
  a.tail_len = tail_len;
  a.wrap_len = wrap_len;
  a.lga = lga;
  a.lgb = lgb;
  a.lgt1 = lgt1;
  a.lgt2 = lgt2;
  a.lgcl2 = lgcl2;
  a.hbits = hbits;
  return a;
}

}  // namespace

// Pass 1 alone: the window's column transforms times the four-step
// twiddle, into G (the probe entry; tt_fft2p runs the same launch).
extern "C" int tt_fft2p_pass1(const void* tail, const void* x, void* g,
                              const void* twa, const void* whi,
                              const void* wlo, long long tail_len, int lga,
                              int lgb, int lgt1, int lgt2, int hbits,
                              void* stream) {
  const Args a = make_args(tail, x, g, nullptr, twa, whi, wlo, tail_len, 0,
                           lga, lgb, lgt1, lgt2, 0, hbits);
  return (int)launch_pass<true, false>(a, (cudaStream_t)stream);
}

extern "C" int tt_fft2p(const void* tail, const void* x, void* g, void* out,
                        const void* twa, const void* twb, const void* whi,
                        const void* wlo, long long tail_len,
                        long long wrap_len, int lga, int lgb, int lgt1,
                        int lgt2, int lgcl2, int hbits, void* stream) {
  Args a = make_args(tail, x, g, out, twa, whi, wlo, tail_len, wrap_len,
                     lga, lgb, lgt1, lgt2, lgcl2, hbits);
  cudaError_t e = launch_pass<true, false>(a, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  a.tw = (const float2*)twb;
  if (lgcl2 == 0)
    return (int)launch_pass<false, false>(a, (cudaStream_t)stream);
  return (int)launch_pass<false, true>(a, (cudaStream_t)stream);
}
