// Stride-1 3x3 2-D convolution of the MODE feature extractors on NHWC maps,
// padding = dilation (1 or 2), with the folded eval-BatchNorm affine, an
// optional residual and an optional ReLU in the epilogue:
//   out = act(conv2d(x, w) * scale + bias (+ residual)).
//
// Replaces the TPU kernels of mode_tpu/ops/pallas/conv2d_kernel.py:
//   conv2d_band_pallas (K8)  one image per grid step: the Sphere stem's
//                            firstconv.2 and .4 at batch 1;
//   conv2d_band_bpack  (K9)  g images packed side by side on the lanes,
//                            dilation 1 or 2: every stride-1 3x3 conv of the
//                            feature extractors at batch >= 2.
// Both answered the TPU's 128-lane tiles: a lane-major (B, M, C, L) layout,
// the kh taps folded into the contraction, the kw taps into the output rows
// as a (3 Cout, 3 Cin) weight recombined by lane rolls, and batch packing
// to fill the lanes. On this card the batch is only part of the GEMM's M,
// so one kernel serves both: an implicit GEMM with M = N*H*W output pixels
// in NHW order, N = Cout, K = 9 taps x Cin, the map NHWC with the channels
// innermost.
//
// What bounds it on the card: each output pixel costs 2*9*Cin*Cout flops
// (73.7 kflop at 64 -> 64) against (Cin + Cout) values of compulsory
// traffic, far above the H100's ridge point, so it is bound by arithmetic.
// It runs on the tile machinery of igemm.cuh, as the cost-volume kernel
// (conv3d.cu) does: each K step gathers a BM x 16 slice of the input at one
// tap's (dilated) offset, zero outside the map. The output-channel tile
// follows Cout (32, 64 or 128 wide). This first version runs on the FP32
// pipes; tensor cores (wgmma) and TMA loads are later work.

#include "igemm.cuh"

namespace {

using igemm::BK;
using igemm::NT;

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const T* __restrict__ res, T* __restrict__ out, int nb, int h,
              int wd, int cin, int cout, int dil, int relu) {
  constexpr int RA = BM * BK / NT;  // A rows gathered per thread
  const long long mtot = (long long)nb * h * wd;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // The A rows this thread gathers stay the same for every K step.
  int rn[RA], ri[RA], rj[RA];
  bool rv[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const long long m = m0 + igemm::a_row() + r * (NT / BK);
    rv[r] = m < mtot;
    long long t = rv[r] ? m : 0;
    rj[r] = (int)(t % wd);
    t /= wd;
    ri[r] = (int)(t % h);
    rn[r] = (int)(t / h);
  }

  float acc[TM][TN];
  igemm::mainloop<T, BM, BN, TM, TN>(
      acc, w, cin, cout, n0, 9, [&](int tap, int ci, float(&ra)[RA]) {
        const int oi = (tap / 3 - 1) * dil;
        const int oj = (tap % 3 - 1) * dil;
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          const int ih = ri[r] + oi;
          const int iw = rj[r] + oj;
          float v = 0.f;
          if (rv[r] && ci < cin && (unsigned)ih < (unsigned)h &&
              (unsigned)iw < (unsigned)wd) {
            v = igemm::to_f32(
                x[(((long long)rn[r] * h + ih) * wd + iw) * cin + ci]);
          }
          ra[r] = v;
        }
        return tap;
      });
  igemm::epilogue<T, BN, TM, TN>(acc, m0, mtot, n0, cout, scale, bias, res,
                                 out, relu,
                                 [&](long long m) { return m * cout; });
}

template <typename T, int BM, int BN, int TM, int TN>
void launch_tile(const void* x, const void* w, const float* scale,
                 const float* bias, const void* res, void* out, int nb, int h,
                 int wd, int cin, int cout, int dil, int relu,
                 cudaStream_t stream) {
  const long long mtot = (long long)nb * h * wd;
  dim3 grid((unsigned)((mtot + BM - 1) / BM), (cout + BN - 1) / BN);
  conv2d_kernel<T, BM, BN, TM, TN><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<const T*>(res), static_cast<T*>(out), nb, h, wd, cin, cout,
      dil, relu);
}

template <typename T>
void launch_dtype(const void* x, const void* w, const float* scale,
                  const float* bias, const void* res, void* out, int nb,
                  int h, int wd, int cin, int cout, int dil, int relu,
                  cudaStream_t stream) {
  if (cout > 64) {
    launch_tile<T, 64, 128, 4, 8>(x, w, scale, bias, res, out, nb, h, wd,
                                  cin, cout, dil, relu, stream);
  } else if (cout > 32) {
    launch_tile<T, 64, 64, 4, 4>(x, w, scale, bias, res, out, nb, h, wd, cin,
                                 cout, dil, relu, stream);
  } else {
    launch_tile<T, 128, 32, 4, 4>(x, w, scale, bias, res, out, nb, h, wd,
                                  cin, cout, dil, relu, stream);
  }
}

}  // namespace

// x: (nb, h, wd, cin); w: (9, cin, cout) with tap kh*3 + kw; scale, bias:
// (cout,) f32; res (may be null) and out: (nb, h, wd, cout); dil: the
// dilation, which is also the padding. x, w, res and out are f32 (bf16 == 0)
// or bf16 (bf16 == 1). Returns cudaGetLastError() after the launch.
extern "C" int conv2d_s1_bn_act(int bf16, const void* x, const void* w,
                                const void* scale, const void* bias,
                                const void* res, void* out, int nb, int h,
                                int wd, int cin, int cout, int dil, int relu,
                                void* stream) {
  if (dil < 1) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_dtype<__nv_bfloat16>(x, w, s, b, res, out, nb, h, wd, cin, cout,
                                dil, relu, st);
  } else {
    launch_dtype<float>(x, w, s, b, res, out, nb, h, wd, cin, cout, dil, relu,
                        st);
  }
  return (int)cudaGetLastError();
}
