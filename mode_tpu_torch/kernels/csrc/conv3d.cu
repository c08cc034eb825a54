// Transposed cost-volume 3-D convolution of MODE stage 1 on NDHWC volumes,
// ConvTranspose3d k3 s2 p1 output_padding 1 with the torch (I, O, k)
// weight, with the folded eval-BatchNorm affine, an optional residual and
// an optional ReLU in the epilogue:
//   out = act(deconv(x, w) * scale + bias (+ residual)).
//
// Replaces the TPU kernels conv3d_band_deconv_pallas (K5,
// mode_tpu/ops/pallas/conv3d_kernel.py:677) and conv3d_fold_deconv_pallas
// (K7, :1042). (The stride-1 conv, K1 and K6, and the stride-2 conv, K4,
// have their own tensor-core kernels in conv3d_s1.cu and conv3d_s2.cu.) The
// lane-major layouts, lane rolls and the M*L lane fold of those kernels
// answered the TPU's 128-lane tiles. Here every volume stays NDHWC with the
// channels innermost, and one kernel serves every level of the hourglass.
//
// What bounds it on the card: at the stage-1 shapes (Cin, Cout <= 64) each
// input voxel costs 2*8*Cin*Cout flops against (Cin + 8 Cout) values of
// compulsory traffic, above the H100's ridge point, so the kernel is bound
// by arithmetic. The design is an implicit GEMM with M = input-sized grid
// points of one output parity phase, N = Cout, K = taps x Cin, on the tile
// machinery of igemm.cuh (the FP32 pipes): each K step gathers a BM x 16
// slice of the input at one tap's offset, zero outside the volume. There is
// no zero-stuffing: blockIdx.z picks one of the eight output parity
// phases, and a phase visits only the 1, 2, 4 or 8 taps that land on it.
// Tensor cores (wgmma) are later work.

#include "igemm.cuh"

namespace {

using igemm::BK;
using igemm::NT;

// Tap j of one spatial axis of output parity phase: kernel index k and
// input offset off, so that the input index is z + off for grid coordinate
// z. Output o = 2i - 1 + k: an even output 2z reads tap 1 at input z; an
// odd output 2z+1 reads tap 0 at input z+1 and tap 2 at z.
__device__ __forceinline__ void tap(int phase, int j, int& k, int& off) {
  k = phase ? 2 * j : 1;
  off = phase ? 1 - j : 0;
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT)
deconv3d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias,
                const T* __restrict__ res, T* __restrict__ out, int nb,
                int di, int hi, int wi, int cin, int cout, int relu) {
  constexpr int RA = BM * BK / NT;  // A rows gathered per thread
  // M walks the input-sized grid of one parity phase in NDHW order.
  const long long mtot = (long long)nb * di * hi * wi;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int pd = (blockIdx.z >> 2) & 1;
  const int ph = (blockIdx.z >> 1) & 1;
  const int pw = blockIdx.z & 1;

  // The A rows this thread gathers stay the same for every K step.
  int rb[RA], rz0[RA], rz1[RA], rz2[RA];
  bool rv[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const long long m = m0 + igemm::a_row() + r * (NT / BK);
    rv[r] = m < mtot;
    long long t = rv[r] ? m : 0;
    rz2[r] = (int)(t % wi);
    t /= wi;
    rz1[r] = (int)(t % hi);
    t /= hi;
    rz0[r] = (int)(t % di);
    rb[r] = (int)(t / di);
  }

  float acc[TM][TN];
  igemm::mainloop<T, BM, BN, TM, TN>(
      acc, w, cin, cout, n0, (1 + pd) * (1 + ph) * (1 + pw),
      [&](int t, int ci, float(&ra)[RA]) {
        const int j2 = t % (1 + pw);
        t /= 1 + pw;
        const int j1 = t % (1 + ph);
        const int j0 = t / (1 + ph);
        int k0, o0, k1, o1, k2, o2;
        tap(pd, j0, k0, o0);
        tap(ph, j1, k1, o1);
        tap(pw, j2, k2, o2);
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          const int id = rz0[r] + o0;
          const int ih = rz1[r] + o1;
          const int iw = rz2[r] + o2;
          float v = 0.f;
          if (rv[r] && ci < cin && (unsigned)id < (unsigned)di &&
              (unsigned)ih < (unsigned)hi && (unsigned)iw < (unsigned)wi) {
            v = igemm::to_f32(
                x[((((long long)rb[r] * di + id) * hi + ih) * wi + iw) * cin +
                  ci]);
          }
          ra[r] = v;
        }
        return (k0 * 3 + k1) * 3 + k2;
      });

  igemm::epilogue<T, BN, TM, TN>(
      acc, m0, mtot, n0, cout, scale, bias, res, out, relu,
      [&](long long m) {
        long long t = m;
        const int z2 = (int)(t % wi);
        t /= wi;
        const int z1 = (int)(t % hi);
        t /= hi;
        const int z0 = (int)(t % di);
        const long long b = t / di;
        return (((b * 2 * di + 2 * z0 + pd) * 2 * hi + 2 * z1 + ph) * 2 * wi +
                2 * z2 + pw) *
               cout;
      });
}

template <typename T, int BM, int BN, int TM, int TN>
void launch_tile(const void* x, const void* w, const float* scale,
                 const float* bias, const void* res, void* out, int nb,
                 int di, int hi, int wi, int cin, int cout, int relu,
                 cudaStream_t stream) {
  dim3 grid((unsigned)(((long long)nb * di * hi * wi + BM - 1) / BM),
            (cout + BN - 1) / BN, 8);
  deconv3d_kernel<T, BM, BN, TM, TN><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<const T*>(res), static_cast<T*>(out), nb, di, hi, wi, cin,
      cout, relu);
}

// The output-channel tile follows Cout, so a narrow output does not pay for
// idle columns.
template <typename T>
void launch(const void* x, const void* w, const float* scale,
            const float* bias, const void* res, void* out, int nb, int di,
            int hi, int wi, int cin, int cout, int relu,
            cudaStream_t stream) {
  if (cout > 32) {
    launch_tile<T, 64, 64, 4, 4>(x, w, scale, bias, res, out, nb, di, hi, wi,
                                 cin, cout, relu, stream);
  } else if (cout > 8) {
    launch_tile<T, 128, 32, 4, 4>(x, w, scale, bias, res, out, nb, di, hi,
                                  wi, cin, cout, relu, stream);
  } else {
    launch_tile<T, 128, 8, 4, 1>(x, w, scale, bias, res, out, nb, di, hi, wi,
                                 cin, cout, relu, stream);
  }
}

}  // namespace

// x: (nb, di, hi, wi, cin); w: (27, cin, cout) with tap (kd*3 + kh)*3 + kw
// of the torch (I, O, 3, 3, 3) weight; scale, bias: (cout,) f32; res (may
// be null) and out: (nb, 2 di, 2 hi, 2 wi, cout). x, w, res and out are f32
// (bf16 == 0) or bf16 (bf16 == 1). Returns cudaGetLastError() after the
// launch.
extern "C" int deconv3d_bn_act(int bf16, const void* x, const void* w,
                               const void* scale, const void* bias,
                               const void* res, void* out, int nb, int di,
                               int hi, int wi, int cin, int cout, int relu,
                               void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(x, w, s, b, res, out, nb, di, hi, wi, cin, cout,
                          relu, st);
  } else {
    launch<float>(x, w, s, b, res, out, nb, di, hi, wi, cin, cout, relu, st);
  }
  return (int)cudaGetLastError();
}
