// Per-carrier band extraction: contiguous slices of the wideband
// spectrum copied into a (C, ...) batch.
//
// Replaces band_extract_rows and band_extract
// (tetraear_tpu/dsp/pallas_kernels.py: _rows_kernel, _extract_kernel),
// which issue one DMA per carrier.  Here a 2-D grid of blocks (carrier x
// chunk) copies each slice with 16-byte accesses.
//
//   * rows: planes (2, R, 128) float32 re/im planes, row_start (C,);
//     out[c, pl] = planes[pl, row_start[c] : row_start[c] + P].  A row is
//     512 bytes, so every source and destination address is 16-byte
//     aligned and the copy is float4 throughout.
//   * pairs: x (n_rows, 2) float32 [re, im] pairs, start (C,);
//     out[c] = x[start[c] : start[c] + n_band].  A pair is 8 bytes: an
//     odd start leaves the source 8 bytes off a 16-byte boundary while
//     the destination is on one (n_band even), so that case reads two
//     8-byte pairs and writes one 16-byte vector; an odd n_band copies
//     pair by pair.  No access is misaligned.
//
// Bound by device memory: every byte is read once and written once
// (128 KB per carrier at n_band = 8192).  Bulk asynchronous copies
// (cp.async.bulk) would take the threads out of the copy; later work.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
extract_rows_kernel(const float4* __restrict__ planes, long long plane_vecs,
                    const int* __restrict__ row_start,
                    float4* __restrict__ out, int band_vecs) {
  const int c = blockIdx.x;
  const int pl = blockIdx.y;
  const float4* src = planes + pl * plane_vecs + (long long)row_start[c] * 32;
  float4* dst = out + ((long long)c * 2 + pl) * band_vecs;
  for (int v = blockIdx.z * blockDim.x + threadIdx.x; v < band_vecs;
       v += gridDim.z * blockDim.x)
    dst[v] = __ldg(src + v);
}

__global__ void __launch_bounds__(256)
extract_pairs_kernel(const float2* __restrict__ x,
                     const int* __restrict__ start,
                     float2* __restrict__ out, int n_band) {
  const int c = blockIdx.x;
  const int s = start[c];
  const float2* src = x + s;
  float2* dst = out + (long long)c * n_band;
  const int first = blockIdx.y * blockDim.x + threadIdx.x;
  const int stride = gridDim.y * blockDim.x;
  if (n_band & 1) {
    for (int i = first; i < n_band; i += stride) dst[i] = __ldg(src + i);
    return;
  }
  const int n_vec = n_band >> 1;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  if ((s & 1) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int v = first; v < n_vec; v += stride) dst4[v] = __ldg(src4 + v);
  } else {
    for (int v = first; v < n_vec; v += stride) {
      const float2 a = __ldg(src + 2 * v);
      const float2 b = __ldg(src + 2 * v + 1);
      dst4[v] = make_float4(a.x, a.y, b.x, b.y);
    }
  }
}

int chunks_for(int n_vec) {
  int y = n_vec / 1024;                     // 4 vectors a thread
  return y < 1 ? 1 : (y > 16 ? 16 : y);
}

}  // namespace

extern "C" int tt_band_extract_rows(const void* planes, long long plane_len,
                                    const void* row_start, void* out,
                                    int rows_per_band, int n_carriers,
                                    void* stream) {
  const int band_vecs = rows_per_band * 32;
  dim3 grid(n_carriers, 2, chunks_for(band_vecs));
  extract_rows_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)planes, plane_len / 4, (const int*)row_start,
      (float4*)out, band_vecs);
  return (int)cudaGetLastError();
}

extern "C" int tt_band_extract(const void* x, const void* start, void* out,
                               int n_band, int n_carriers, void* stream) {
  dim3 grid(n_carriers, chunks_for(n_band / 2));
  extract_pairs_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const int*)start, (float2*)out, n_band);
  return (int)cudaGetLastError();
}
