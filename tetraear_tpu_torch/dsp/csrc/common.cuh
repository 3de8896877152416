// Shared device helpers for the receive-path kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place radix-2 decimation-in-time FFT of `batch` transforms of
// length n = 2^log2n held in shared memory; transform b occupies
// buf[b*ld, b*ld + n).  An ld of n + 1 staggers the transforms across
// the shared-memory banks.  tw[k] = exp(-2 pi i k / n) for k < n/2,
// float32 from a float64 host table.  inverse conjugates the twiddles
// and does not scale.  Every thread of the block must call it; it
// synchronises before it returns.
__device__ inline void smem_fft(float2* buf, int log2n, int ld, int batch,
                         const float2* __restrict__ tw, bool inverse) {
  const int n = 1 << log2n;
  const int total = n * batch;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int b = idx >> log2n;
    const int i = idx & (n - 1);
    const int r = (int)(__brev((unsigned)i) >> (32 - log2n));
    if (r > i) {
      const float2 t = buf[b * ld + i];
      buf[b * ld + i] = buf[b * ld + r];
      buf[b * ld + r] = t;
    }
  }
  __syncthreads();
  const int hn = n >> 1;
  const int half_total = hn * batch;
  for (int s = 0; s < log2n; ++s) {
    const int h = 1 << s;
    const int tstride = hn >> s;             // n / (2h)
    for (int j = threadIdx.x; j < half_total; j += blockDim.x) {
      const int b = j >> (log2n - 1);
      const int jj = j & (hn - 1);
      const int pos = jj & (h - 1);
      const int i0 = b * ld + ((jj >> s) << (s + 1)) + pos;
      const int i1 = i0 + h;
      float2 w = __ldg(tw + pos * tstride);
      if (inverse) w.y = -w.y;
      const float2 a = buf[i0];
      const float2 t = cmul(w, buf[i1]);
      buf[i0] = make_float2(a.x + t.x, a.y + t.y);
      buf[i1] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }
}

}  // namespace tt
