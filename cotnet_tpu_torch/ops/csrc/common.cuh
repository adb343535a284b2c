// What every kernel source of the local aggregation shares: widening to
// f32 and rounding back once, the op's geometry, and the 1-D launch grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x [N, C, Hi, Wi]; w [N, heads, Cw, Kh*Kw, Ho, Wo]; stride 1, zero padding
// (ph, pw) as a bounds check, dilation (dh, dw).
struct Geometry {
  int n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw;
};

constexpr int kThreads = 256;

// Blocks of kThreads threads for one thread per element; false when the
// grid would not fit.
inline bool grid_for(int64_t total, unsigned* blocks) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  if (b > 0x7fffffff) return false;
  *blocks = unsigned(b);
  return true;
}

// Sum over the warp's 32 lanes; every lane gets the same bits (a + b is
// commutative, and each butterfly step pairs lane i with lane i ^ m).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

}  // namespace
