// Shared device helpers for the receive-path kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

}  // namespace tt
