// What the FP32-pipe kernel of the port still shares: the sphere conv's
// weight gradient (sphere_conv_bwd.cu: bwd_weight_kernel) runs its own tile
// loop on the FP32 pipes with these constants and helpers. Every other
// convolution kernel runs on the tensor cores (igemm_tc.cuh).
//
// A block of NT = 256 threads computes a tile of f32 sums, K steps of BK =
// 16 channels staged in shared memory; bf16 inputs are widened to f32 on
// load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace igemm {

constexpr int NT = 256;  // threads per block
constexpr int BK = 16;   // input channels per K step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// N consecutive floats from shared memory, 16 bytes at a time where N allows
// (the tiles keep every such row 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

}  // namespace igemm
