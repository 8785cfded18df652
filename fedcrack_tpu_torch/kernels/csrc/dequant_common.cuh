// Device helpers shared by the dequant kernels (dequant.cu, dequant_conv.cu):
// the exact code-to-float conversion and the three-term bf16 split of an f32
// activation, whose arithmetic both kernels' contracts rest on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include <cstdint>
#include <cstring>

namespace fc {

__device__ __forceinline__ float code_to_float(int8_t c) {
  return static_cast<float>(c);
}

__device__ __forceinline__ float code_to_float(__nv_fp8_e4m3 c) {
  return static_cast<float>(c);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t bits;
  memcpy(&bits, &v, sizeof(bits));
  return bits;
}

// Two neighbouring-k activations into their hi/mid/lo bf16 pairs (the lower
// k in the low half, as the MMA fragment wants).
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v.x - hf.x;  // exact: x minus its nearest bf16
  const float r1 = v.y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(l);
}

}  // namespace fc
