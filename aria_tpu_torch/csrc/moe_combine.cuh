// The bf16-activation and float decode MoE kernels' combine
// (moe_decode_fp.cu, moe_decode_q4.cu): out = the sum of the valid experts'
// parts [U, T*D] in u order, in f32, cast to bf16. A fixed order, so the
// result does not depend on scheduling.
#pragma once

#include "common.cuh"

namespace {

__global__ void moe_combine_kernel(const float* __restrict__ part, const int* __restrict__ valid,
                                   __nv_bfloat16* __restrict__ out, int TD, int U) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= TD) return;
  float acc = 0.f;
  for (int u = 0; u < U; ++u)
    if (valid[u]) acc += part[(size_t)u * TD + idx];
  out[idx] = __float2bfloat16(acc);
}

}  // namespace
