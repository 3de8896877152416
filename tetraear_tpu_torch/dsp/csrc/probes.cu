// Three measurement instruments: small kernels that answer one question
// each about the card, counterparts of the TPU package's probes.
//
//   bit_place       (perf/place_probe.py) the fused back half's bit
//                   placement alone: carried tail bits and symbol
//                   decisions into the packed scan row z and the next
//                   carried tail, the device functions of place.cuh as
//                   backhalf.cu runs them, one block a carrier.  Bound by
//                   device memory (about 13 KB a carrier at 2048 symbols).
//   ops_probe       (perf/mosaic_ops_probe.py) one elementwise operation
//                   or layout idiom a launch, to hold the device's math
//                   functions (as this build's flags compile them) against
//                   the PyTorch operation: cos, sin, floor, mod, arctan2,
//                   exp, rsqrt, round, select; a column broadcast, a
//                   selector product and a full reduction into one row.
//                   A launch of 1024 elements: bound by launch latency.
//   iir_recursion   (perf/scan_overhead_probe.py) a serial sample
//                   recursion inside one kernel: the speech decoder's
//                   10-tap saturating synthesis filter over n samples,
//                   one thread a batch row, against the same recursion
//                   driven from the host one step at a time.  Bound by its
//                   integer operations (about 75 a sample and row).
#include "place.cuh"

namespace {

__global__ void __launch_bounds__(256)
bit_place_kernel(const unsigned char* __restrict__ hard,
                 const float* __restrict__ bt, const int* __restrict__ dsel,
                 int* __restrict__ z_out, float* __restrict__ bt2, int ns,
                 int nw, int k_max, int tr) {
  extern __shared__ unsigned z[];
  const int c = blockIdx.x;
  tt::place_tail(bt + (long long)c * tr * 128, z);
  __syncthreads();
  tt::place_symbols(hard + (long long)c * ns, ns, nw, z);
  __syncthreads();
  int* zc = z_out + (long long)c * nw;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) zc[w] = (int)z[w];
  tt::place_next_tail(z, nw, 2 * k_max - 4 + 2 * dsel[c], tr,
                      bt2 + (long long)c * tr * 128);
}

enum Op {
  OP_COS, OP_SIN, OP_FLOOR, OP_MOD, OP_ARCTAN2, OP_EXP, OP_RSQRT, OP_ROUND,
  OP_SELECT, OP_BCAST_COL, OP_SEL_MM, OP_RED_ROW
};

// jnp.mod / torch.remainder: the result takes the divisor's sign.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

// a, b (rows, cols) for the elementwise operations; OP_BCAST_COL reads b
// as a column (rows,), OP_SEL_MM writes (rows, cols / 4), OP_RED_ROW one
// block's (128,) row with the sum in lane 0 and the sum of squares in
// lane 1.
__global__ void __launch_bounds__(256)
ops_probe_kernel(int op, const float* __restrict__ a,
                 const float* __restrict__ b, float* __restrict__ out,
                 int rows, int cols) {
  const int n = rows * cols;
  if (op == OP_RED_ROW) {
    __shared__ float part[2][8];
    float s0 = 0.f, s1 = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = a[i];
      s0 += v;
      s1 += v * v;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, d);
      s1 += __shfl_down_sync(0xffffffffu, s1, d);
    }
    if ((threadIdx.x & 31) == 0) {
      part[0][threadIdx.x >> 5] = s0;
      part[1][threadIdx.x >> 5] = s1;
    }
    __syncthreads();
    if (threadIdx.x < 128) {
      float v = 0.f;
      if (threadIdx.x < 2)
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
          v += part[threadIdx.x][w];
      out[threadIdx.x] = v;
    }
    return;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (op == OP_SEL_MM) {
    const int oc = cols / 4;
    if (i < rows * oc) {
      const int r = i / oc;
      const int u = i - r * oc;
      out[i] = a[r * cols + 4 * u + 3] * 2.0f;
    }
    return;
  }
  if (i >= n) return;
  const float x = a[i];
  float v;
  switch (op) {
    case OP_COS: v = cosf(x); break;
    case OP_SIN: v = sinf(x); break;
    case OP_FLOOR: v = floorf(x); break;
    case OP_MOD: v = floor_mod(x, b[i]); break;
    case OP_ARCTAN2: v = atan2f(x, b[i]); break;
    case OP_EXP: v = expf(x); break;
    case OP_RSQRT: v = rsqrtf(x); break;
    case OP_ROUND: v = rintf(x); break;
    case OP_SELECT: v = x < 3.0f ? x : -x; break;
    default: v = x * b[i / cols]; break;          // OP_BCAST_COL
  }
  out[i] = v;
}

__device__ __forceinline__ int sat_sub(int l, int p) {
  const long long d = (long long)l - (long long)p;
  return d > 2147483647LL ? 2147483647
                          : d < -2147483648LL ? (int)(-2147483647 - 1)
                                              : (int)d;
}

// y[i, r] = store_hi(L_shr(L_deposit_h(x[i, r]), 4) - sum_k a[r, k] m_k, 4)
// with every subtraction saturating and m the last ten outputs, newest
// first (zero before the first sample); m_out is the memory after sample
// n - 1.
__global__ void __launch_bounds__(128)
iir_recursion_kernel(const int* __restrict__ a, const int* __restrict__ x,
                     int* __restrict__ y, int* __restrict__ m_out, int n,
                     int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int coef[10], m[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    coef[k] = a[r * 10 + k];
    m[k] = 0;
  }
  for (int i = 0; i < n; ++i) {
    int l = (int)((unsigned)x[(long long)i * n_rows + r] << 16) >> 4;
#pragma unroll
    for (int k = 0; k < 10; ++k) l = sat_sub(l, coef[k] * m[k]);
    const int out = (int)(short)(l >> 12);
#pragma unroll
    for (int k = 9; k > 0; --k) m[k] = m[k - 1];
    m[0] = out;
    y[(long long)i * n_rows + r] = out;
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) m_out[r * 10 + k] = m[k];
}

// The card's integer instruction rates, for the yardstick that prices the
// scan: each thread runs iters rounds over eight registers, a round
// being eight three-input logic operations (kind 0: r = (r & mask) ^
// next), eight population counts each followed by one exclusive-or
// (kind 1) or eight three-input additions (kind 2: r = r + mask + next);
// no memory is touched until the last store.
__global__ void __launch_bounds__(256)
int_rate_kernel(int kind, int iters, unsigned mask,
                unsigned* __restrict__ out) {
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = (tid + 1u) * 2654435761u + 40503u * i;
  if (kind == 0) {
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = (r[i] & mask) ^ r[(i + 1) & 7];
    }
  } else if (kind == 1) {
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        r[i] = (unsigned)__popc(r[i]) ^ r[(i + 1) & 7];
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = r[i] + mask + r[(i + 1) & 7];
    }
  }
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc ^= r[i];
  out[tid] = acc;
}

}  // namespace

extern "C" int tt_bit_place(const void* hard, const void* bt,
                            const void* dsel, void* z_out, void* bt2, int ns,
                            int nw, int k_max, int tr, int n_carriers,
                            void* stream) {
  bit_place_kernel<<<n_carriers, 256, nw * (int)sizeof(unsigned),
                     (cudaStream_t)stream>>>(
      (const unsigned char*)hard, (const float*)bt, (const int*)dsel,
      (int*)z_out, (float*)bt2, ns, nw, k_max, tr);
  return (int)cudaGetLastError();
}

extern "C" int tt_ops_probe(int op, const void* a, const void* b, void* out,
                            int rows, int cols, void* stream) {
  const int blocks = op == OP_RED_ROW ? 1 : (rows * cols + 255) / 256;
  ops_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      op, (const float*)a, (const float*)b, (float*)out, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int tt_iir_recursion(const void* a, const void* x, void* y,
                                void* m_out, int n, int n_rows,
                                void* stream) {
  iir_recursion_kernel<<<(n_rows + 127) / 128, 128, 0,
                         (cudaStream_t)stream>>>(
      (const int*)a, (const int*)x, (int*)y, (int*)m_out, n, n_rows);
  return (int)cudaGetLastError();
}

// n_threads a multiple of 256
extern "C" int tt_int_rate(int kind, int iters, unsigned mask, void* out,
                           int n_threads, void* stream) {
  int_rate_kernel<<<n_threads / 256, 256, 0, (cudaStream_t)stream>>>(
      kind, iters, mask, (unsigned*)out);
  return (int)cudaGetLastError();
}
