// Wideband overlap-save FFT, four-step, in two launches.
//
// Replaces fft2p_planes_spliced / fft2p_planes
// (tetraear_tpu/dsp/pallas_kernels.py).  The window is the carried tail
// rows [0, o2) followed by the fresh block rows [o2, n2) of the
// (n2, n1) row-major sample matrix xm[i2, i1] = window[n1*i2 + i1];
// o2 = 0 is the unspliced transform.  With N = n1 * n2:
//
//   pass 1, one block per `cols` adjacent columns i1: load the column
//     (the splice: tail rows from one input, block rows from the other),
//     n2-point FFT in shared memory, multiply by w_N^{i1 k2}, store
//     G[k2, i1] as planar float32 (2, n2, n1);
//   pass 2, one block per `rows` adjacent k2 rows: load G[k2, :],
//     n1-point FFT, store X[k2 + n2 k1] into the natural-order spectrum
//     planes (2, (n1 + wrap) n2), and again at k1 + n1 for k1 < wrap
//     (the wrap extension that keeps every band one contiguous slice).
//
// Bound by device memory: each pass reads and writes the 8*N-byte
// planes once (268 MB each way at N = 2^25).  Design: float32 radix-2
// FFTs in up to 128 KB of dynamic shared memory; several columns or
// rows per block so the strided side of each pass moves runs of
// 4*cols or 4*rows bytes instead of single floats.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
fft2p_pass1(const float* __restrict__ tail, const float* __restrict__ x,
            float* __restrict__ g, int n1, int n2, int log2n2, int o2,
            int cols, const float2* __restrict__ tw2) {
  extern __shared__ float2 sm[];
  const int ld = n2 + 1;
  const int c0 = blockIdx.x * cols;
  const long long tail_plane = (long long)o2 * n1;
  const long long x_plane = (long long)(n2 - o2) * n1;
  const int total = n2 * cols;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int row = idx / cols;
    const int col = idx - row * cols;
    const int i1 = c0 + col;
    float re, im;
    if (row < o2) {
      const long long off = (long long)row * n1 + i1;
      re = tail[off];
      im = tail[tail_plane + off];
    } else {
      const long long off = (long long)(row - o2) * n1 + i1;
      re = x[off];
      im = x[x_plane + off];
    }
    sm[col * ld + row] = make_float2(re, im);
  }
  __syncthreads();
  tt::smem_fft(sm, log2n2, ld, cols, tw2, false);
  const long long nfft = (long long)n1 * n2;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k2 = idx / cols;
    const int col = idx - k2 * cols;
    const int i1 = c0 + col;
    // four-step twiddle w_N^{i1 k2} from the exact integer phase
    const long long m = ((long long)i1 * k2) % nfft;
    double s, c;
    sincospi(-2.0 * (double)m / (double)nfft, &s, &c);
    const float2 v = tt::cmul(sm[col * ld + k2],
                              make_float2((float)c, (float)s));
    const long long off = (long long)k2 * n1 + i1;
    g[off] = v.x;
    g[nfft + off] = v.y;
  }
}

__global__ void __launch_bounds__(1024)
fft2p_pass2(const float* __restrict__ g, float* __restrict__ out, int n1,
            int n2, int log2n1, int rows, int wrap,
            const float2* __restrict__ tw1) {
  extern __shared__ float2 sm[];
  const int ld = n1 + 1;
  const int k2_0 = blockIdx.x * rows;
  const long long nfft = (long long)n1 * n2;
  const int total = n1 * rows;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / n1;
    const int i1 = idx - r * n1;
    const long long off = (long long)(k2_0 + r) * n1 + i1;
    sm[r * ld + i1] = make_float2(g[off], g[nfft + off]);
  }
  __syncthreads();
  tt::smem_fft(sm, log2n1, ld, rows, tw1, false);
  const long long out_plane = (long long)(n1 + wrap) * n2;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k1 = idx / rows;
    const int r = idx - k1 * rows;
    const float2 v = sm[r * ld + k1];
    const long long off = (long long)k1 * n2 + k2_0 + r;
    out[off] = v.x;
    out[out_plane + off] = v.y;
    if (k1 < wrap) {
      const long long off2 = (long long)(n1 + k1) * n2 + k2_0 + r;
      out[off2] = v.x;
      out[out_plane + off2] = v.y;
    }
  }
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

extern "C" int tt_fft2p(const void* tail, const void* x, void* g, void* out,
                        const void* tw2, const void* tw1, int n1, int n2,
                        int o2, int wrap, int cols, int rows,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem1 = cols * (n2 + 1) * (int)sizeof(float2);
  const int smem2 = rows * (n1 + 1) * (int)sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      fft2p_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(
      fft2p_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return (int)e;
  fft2p_pass1<<<n1 / cols, 1024, smem1, st>>>(
      (const float*)tail, (const float*)x, (float*)g, n1, n2, ilog2(n2),
      o2, cols, (const float2*)tw2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fft2p_pass2<<<n2 / rows, 1024, smem2, st>>>(
      (const float*)g, (float*)out, n1, n2, ilog2(n1), rows, wrap,
      (const float2*)tw1);
  return (int)cudaGetLastError();
}
