// The A operand of the sphere conv's tensor-core kernels (sphere_conv.cu:
// the forward, K3/K10; sphere_conv_bwd.cu: the grad-input, K3b/K10b dx),
// for sm_90a, on the machinery of igemm_tc.cuh.
//
// Neither kernel's A row is a copy of one input row: it is a weighted sum
// of a few rows that the stage copied into swizzled tiles in shared memory
// (the forward: the four bilinear corners of the row's sample; the
// grad-input: the output samples that read the row's pixel). So each
// thread reads its own fragment's values from those tiles, sums them with
// its rows' weights on the FP32 pipes (Blend::add, one source row at a
// time, fmaf in call order), and issues wgmma with A from registers
// (Blend::mma):
//   f32   3xTF32 on the sum, exactly as igemm_tc.cuh's conv_body after its
//         fragment load, the stage's products into a fresh fragment added
//         on the FP32 pipes (mma_stage_f32);
//   bf16  the sum kept in f32 and rounded to bf16 once, before the product.
// B, the K-major weight of ops/kmajor.py, is read through its descriptor
// as in conv_body.

#pragma once

#include "igemm_tc.cuh"

namespace sph {
// Internal linkage, as igemm_tc.cuh: each library keeps its own copy.
namespace {

using tc::Cfg;

// The thread's A values over one K stage of BK = 32 channels, for its two
// fragment rows r0 and r0 + 8 (hh = 0, 1), in f32.
template <typename T>
struct Blend;

// f32: the weight holds, at K position p of a stage, channel
// 8 (p % 4) + p / 4 (ops/kmajor.py:pack), so the thread's fragment values
// are channels 8q .. 8q + 7 of each of its rows (q = lane % 4): chunks 2q
// and 2q + 1 of a tile row, two 16-byte reads.
template <>
struct Blend<float> {
  float v[2][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[hh][j] = 0.f;
  }

  // v[hh] += w * row `row` of `tile` at the thread's channels.
  __device__ __forceinline__ void add(int hh, const uint8_t* tile, int row,
                                      int q, float w) {
    const float4 lo = *reinterpret_cast<const float4*>(
        tile + tc::swizzle<float>(row, 2 * q));
    const float4 hi = *reinterpret_cast<const float4*>(
        tile + tc::swizzle<float>(row, 2 * q + 1));
    v[hh][0] = fmaf(w, lo.x, v[hh][0]);
    v[hh][1] = fmaf(w, lo.y, v[hh][1]);
    v[hh][2] = fmaf(w, lo.z, v[hh][2]);
    v[hh][3] = fmaf(w, lo.w, v[hh][3]);
    v[hh][4] = fmaf(w, hi.x, v[hh][4]);
    v[hh][5] = fmaf(w, hi.y, v[hh][5]);
    v[hh][6] = fmaf(w, hi.z, v[hh][6]);
    v[hh][7] = fmaf(w, hi.w, v[hh][7]);
  }

  // acc += A B over the stage; sb: the stage's B tiles (big, then small).
  template <int BN>
  __device__ __forceinline__ void mma(float (&acc)[BN / 2], uint32_t sb) {
    tc::mma_stage_f32<BN>(acc, v, tc::make_desc<float>(sb),
                          tc::make_desc<float>(sb + BN * Cfg<float>::RB));
  }
};

// bf16: the m64k16 A fragment of K step kk, register e, holds row
// r0 + 8 (e & 1) at channels 16 kk + 8 (e >> 1) + 2q and the next: bytes
// 4q of chunk 2 kk + (e >> 1) of a tile row.
template <>
struct Blend<__nv_bfloat16> {
  static constexpr int KSTEPS = Cfg<__nv_bfloat16>::KSTEPS;
  float f[KSTEPS][4][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[kk][e][0] = f[kk][e][1] = 0.f;
  }

  __device__ __forceinline__ void add(int hh, const uint8_t* tile, int row,
                                      int q, float w) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(
            tile + tc::swizzle<__nv_bfloat16>(row, 2 * kk + half) + 4 * q);
        const float2 g = __bfloat1622float2(pair);
        const int e = 2 * half + hh;
        f[kk][e][0] = fmaf(w, g.x, f[kk][e][0]);
        f[kk][e][1] = fmaf(w, g.y, f[kk][e][1]);
      }
    }
  }

  template <int BN>
  __device__ __forceinline__ void mma(float (&acc)[BN / 2], uint32_t sb) {
    uint32_t a[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 rounded =
            __floats2bfloat162_rn(f[kk][e][0], f[kk][e][1]);
        a[kk][e] = *reinterpret_cast<const uint32_t*>(&rounded);
      }
    }
    const uint64_t db = tc::make_desc<__nv_bfloat16>(sb);
    tc::pin(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      tc::mma_bf16_ra<BN>(acc, a[kk], db + 2 * kk);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::pin(acc);
    tc::pin(a);
  }
};

}  // namespace
}  // namespace sph
