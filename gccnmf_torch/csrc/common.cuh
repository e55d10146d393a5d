// Helpers every source of the port's hand-written Hopper kernels shares:
// bf16 conversions and rounding, the guarded divide of the JAX kernels,
// elementwise launch sizes. The products live in their cores: exact fp32
// FMAs on the SIMT cores in simt_gemm.cuh, bf16 on the tensor cores in
// tc_gemm.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gccnmf {

constexpr float TINY = 1e-30f; // the JAX kernels' double-where threshold

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// a / b, or 0 where b <= 1e-30 (the double-where guard; IEEE divide).
__device__ __forceinline__ float safe_div(float a, float b) {
  return b > TINY ? a / b : 0.0f;
}

// Blocks of 256 threads for a grid-stride loop over total items: one item
// a thread, capped at 16 blocks an SM.
inline int elementwise_blocks(long total) {
  const long blocks = (total + 255) / 256, cap = 132L * 16;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace gccnmf
