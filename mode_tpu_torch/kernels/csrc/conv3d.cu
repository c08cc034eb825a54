// Transposed cost-volume 3-D convolution of MODE stage 1 on NDHWC volumes,
// ConvTranspose3d k3 s2 p1 output_padding 1 with the torch (I, O, k)
// weight, with the folded eval-BatchNorm affine, an optional residual and
// an optional ReLU in the epilogue:
//   out = act(deconv(x, w) * scale + bias (+ residual)).
// In training it is also the grad-input of the stride-2 conv (K4), whose
// torch (Cout, Cin, k) weight it reads as (I, O, k).
//
// Replaces the TPU kernels conv3d_band_deconv_pallas (K5,
// mode_tpu/ops/pallas/conv3d_kernel.py:677) and conv3d_fold_deconv_pallas
// (K7, :1042). (The stride-1 conv, K1 and K6, and the stride-2 conv, K4,
// have their own kernels in conv3d_s1.cu and conv3d_s2.cu.) The lane-major
// layouts, lane rolls and the M*L lane fold of those kernels answered the
// TPU's 128-lane tiles. Here every volume stays NDHWC with the channels
// innermost, and one kernel serves every level of the hourglass.
//
// What bounds it on the card: each input voxel costs 2*27*Cin*Cout flops
// (110 kflop at 64 -> 32) against Cin values read and 8 Cout written,
// 86 flop per byte in f32 at 64 -> 32, above the ridge point at the
// 3xTF32 rate (165 TFLOP/s over 3.35 TB/s), so operations.
//
// The design: the tensor-core implicit GEMM of igemm_tc.cuh (zero-fill
// cp.async copies into wgmma's swizzled tiles; f32 as 3xTF32 with a fresh
// fragment per K stage, bf16 directly), conv_body with S = DECONV. There
// is no zero-stuffing: by the sub-pixel decomposition, output parity phase
// (pd, ph, pw) reads only its own 1, 2, 4 or 8 taps, at input offsets 0 or
// +1 on each axis. M is the input-sized grid, N is Cout and K is (phase
// tap, 32-channel chunk), so each A row is one contiguous run of Cin
// channels of input voxel z + offset. Every block walks all 27 (phase,
// tap) pairs of its M x N tile in one pipeline; after a phase's last stage
// it stores that phase's output voxels (2z + pd, 2y + ph, 2x + pw) and
// clears the sums, while the next phase's copies are already in flight.
// So every block does the same work and the pipeline fills once.
//
// Under the spatial axis (mode_tpu_torch/parallel/shard_ops.py; the m_halo
// form of K5, conv3d_kernel.py:681-737) x holds a shard's rows with one
// halo row above and below: the M grid is the shard's own rows, read from
// an H origin of one row (tc::Shape's h0), so a tap at offset +1 on the
// last row reads the lower halo row and the upper one is never read.

#include "igemm_tc.cuh"

namespace {

template <typename T, int BM, int BN, bool HALOED>
__global__ void __launch_bounds__(2 * BM)
deconv3d_tc_kernel(const T* __restrict__ x, const T* __restrict__ wbig,
                   const T* __restrict__ wsmall,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const T* __restrict__ res, T* __restrict__ out,
                   const tc::Shape s, int relu) {
  tc::conv_body<T, BM, BN, tc::DECONV, HALOED>(x, wbig, wsmall, scale,
                                               bias, res, out, s, relu);
}

struct Kernels {
  template <typename T, int BM, int BN, bool HALOED>
  static auto get() {
    return &deconv3d_tc_kernel<T, BM, BN, HALOED>;
  }
};

}  // namespace

// x: (nb, di, hi, wi, cin), cin a multiple of 8; wbig: the K-major weight
// (27, cout, cin), tap (kd*3 + kh)*3 + kw of the torch (I, O, 3, 3, 3)
// weight; wsmall: for f32 its tf32 remainder (wbig + wsmall = w), unused
// for bf16; scale, bias: (cout,) f32; res (may be null) and out: (nb,
// 2 di, 2 (hi - 2 h_halo), 2 wi, cout); h_halo 1: x's first and last rows
// are halo rows (see the top). x, w*, res and out are f32 (bf16 == 0) or
// bf16 (bf16 == 1), x and w* 16-byte aligned. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue without launching on a cin
// the 16-byte copies cannot take or a halo that leaves no row.
extern "C" int deconv3d_bn_act(int bf16, const void* x, const void* wbig,
                               const void* wsmall, const void* scale,
                               const void* bias, const void* res, void* out,
                               int nb, int di, int hi, int wi, int cin,
                               int cout, int relu, int h_halo, void* stream) {
  if (cin % 8 != 0 || cout < 1 || (h_halo != 0 && h_halo != 1) ||
      hi - 2 * h_halo < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // M is the input-sized grid, so the "output" extents of the walk are the
  // input's own rows.
  const tc::Shape s{nb, di, hi - 2 * h_halo, wi, cin, cout, 3, 1, di, hi,
                    wi, h_halo};
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? tc::dispatch<Kernels, __nv_bfloat16>(x, wbig, wsmall, sc, b, res,
                                                  out, s, relu, st)
           : tc::dispatch<Kernels, float>(x, wbig, wsmall, sc, b, res, out,
                                          s, relu, st);
  return (int)e;
}
