// Stride-1 3x3 2-D convolution of the MODE feature extractors on NHWC maps,
// padding = dilation (1 or 2), with the folded eval-BatchNorm affine, an
// optional residual and an optional ReLU in the epilogue:
//   out = act(conv2d(x, w) * scale + bias (+ residual)).
//
// Replaces the TPU kernels of mode_tpu/ops/pallas/conv2d_kernel.py:
//   conv2d_band_pallas (K8, :162)  one image per grid step: the Sphere
//                                  stem's firstconv.2 and .4 at batch 1;
//   conv2d_band_bpack  (K9, :346)  g images packed side by side on the
//                                  lanes, dilation 1 or 2: every stride-1
//                                  3x3 conv of the feature extractors at
//                                  batch >= 2.
// Both answered the TPU's 128-lane tiles: a lane-major (B, M, C, L) layout,
// the kh taps folded into the contraction, the kw taps into the output rows
// recombined by lane rolls, and batch packing to fill the lanes. On this
// card the batch is only part of the GEMM's M, so one kernel serves both:
// an implicit GEMM with M = N*H*W output pixels in NHW order, N = Cout,
// K = 9 taps x Cin, taps at ((kh - 1) * dil, (kw - 1) * dil), the map NHWC
// with the channels innermost.
//
// What bounds it: each output pixel costs 2*9*Cin*Cout flops (73.7 kflop at
// 64 -> 64) against (Cin + Cout) values of compulsory traffic, far above the
// ridge point even at the 3xTF32 rate (495/3 = 165 TFLOP/s), so operations.
// It runs on the tensor cores through igemm_tc.cuh (wgmma; f32 as 3xTF32,
// bf16 directly), the map being a volume of depth 1: each K stage copies a
// tap's 32 channels of 128 (or 64) pixels with zero-filling cp.async into
// wgmma's swizzled layout, B = Cout wide (32, 64 or 128).
//
// Under the spatial axis (mode_tpu_torch/parallel/shard_ops.py; the m_halo
// form of K8, conv2d_kernel.py:168-211) x holds a shard's rows with one halo
// row above and below, dilation 1: the walk reads it from an H origin of
// one row (tc::Shape's h0, the HALOED instantiations), W alone is padded,
// and hi - 2 output rows come out.

#include "igemm_tc.cuh"

namespace {

template <typename T, int BM, int BN, bool HALOED>
__global__ void __launch_bounds__(2 * BM)
conv2d_tc_kernel(const T* __restrict__ x, const T* __restrict__ wbig,
                 const T* __restrict__ wsmall, const float* __restrict__ scale,
                 const float* __restrict__ bias, const T* __restrict__ res,
                 T* __restrict__ out, const tc::Shape s, int relu) {
  tc::conv_body<T, BM, BN, 1, HALOED>(x, wbig, wsmall, scale, bias, res, out,
                                      s, relu);
}

struct Kernels {
  template <typename T, int BM, int BN, bool HALOED>
  static auto get() {
    return &conv2d_tc_kernel<T, BM, BN, HALOED>;
  }
};

}  // namespace

// x: (nb, hi, wd, cin), cin a multiple of 8; wbig: the K-major weight
// (9, cout, cin), tap kh*3 + kw; wsmall: for f32 its tf32 remainder (wbig +
// wsmall = w), unused for bf16; scale, bias: (cout,) f32; res (may be null)
// and out: (nb, h, wd, cout), h = hi, or with h_halo 1 (x's first and last
// rows halo rows, dilation 1) hi - 2; dil: the dilation, which is also the
// padding (of W alone with a halo). x, w*, res and out are f32 (bf16 == 0)
// or bf16 (bf16 == 1), 16-byte aligned. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue without launching on a shape it does
// not take.
extern "C" int conv2d_s1_bn_act(int bf16, const void* x, const void* wbig,
                                const void* wsmall, const void* scale,
                                const void* bias, const void* res, void* out,
                                int nb, int hi, int wd, int cin, int cout,
                                int dil, int relu, int h_halo, void* stream) {
  if (dil < 1 || cin % 8 != 0 || cout < 1 || (h_halo != 0 && h_halo != 1) ||
      (h_halo && (dil != 1 || hi < 3))) {
    return (int)cudaErrorInvalidValue;
  }
  const int h = hi - 2 * h_halo;
  const tc::Shape s{nb, 1, h, wd, cin, cout, 1, dil, 1, hi, wd, h_halo};
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? tc::dispatch<Kernels, __nv_bfloat16>(x, wbig, wsmall, sc, b, res,
                                                  out, s, relu, st)
           : tc::dispatch<Kernels, float>(x, wbig, wsmall, sc, b, res, out, s,
                                          relu, st);
  return (int)e;
}
