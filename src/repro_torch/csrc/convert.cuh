// float32 <-> storage type conversions shared by the Table-I kernels
// (gemm_os.cu, conv2d_os.cu, qgemm_int8.cu): inputs widen to float32 as
// they are staged, and each output rounds once, to nearest even.  store2
// writes two neighbouring outputs of a tensor-core fragment at once.
#pragma once

#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// (x, y) to p[0], p[1]; p is aligned to the pair (8 bytes for float32,
// 4 for bfloat16).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace repro
