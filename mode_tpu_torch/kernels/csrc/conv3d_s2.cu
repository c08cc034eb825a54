// Stride-2 pad-1 3x3x3 convolution of MODE stage 1 (the hourglasses' conv1
// and conv3) on NDHWC volumes, with the folded eval-BatchNorm affine and an
// optional ReLU in the epilogue: out = act(conv_s2(x, w) * scale + bias).
// In training it is also the grad-input of the transposed conv (K5/K7),
// whose torch (I, O, 3, 3, 3) weight it reads as (Cout, Cin).
//
// Replaces the TPU kernel conv3d_band_s2_pallas (K4,
// mode_tpu/ops/pallas/conv3d_kernel.py:480), whose lane decimation by 0/1
// selection matmuls answered the TPU's 128-lane tiles. Here the volume
// stays NDHWC and output voxel (z, y, x) reads input voxel (2z + kd - 1,
// 2y + kh - 1, 2x + kw - 1): each A row of the implicit GEMM is still one
// contiguous run of Cin channels, so the stride-1 tensor-core machinery of
// igemm_tc.cuh (zero-fill cp.async copies into wgmma's swizzled tiles; f32
// as 3xTF32 with a fresh fragment per K stage, bf16 directly) takes it
// with the stride as a template parameter.
//
// What bounds it: each output voxel costs 2*27*Cin*Cout flops (221 kflop
// at 64 -> 64) against its Cout values written and the 8 Cin input values
// of its 2x2x2 cell read once, 96 flop per byte in f32, twice the ridge
// point at the 3xTF32 rate (495/3 = 165 TFLOP/s over 3.35 TB/s), so
// operations. Each 16-byte copy still moves a whole channel chunk;
// neighbouring output rows read input voxels two apart, which L2 serves.
//
// Under the spatial axis (mode_tpu_torch/parallel/shard_ops.py; the m_halo
// form of K4, conv3d_kernel.py:484-520) x holds a shard's rows with one halo
// row above and below, the shard starting on an even global row: the walk
// reads it from an H origin of one row (tc::Shape's h0), and (hi - 2) / 2
// output rows come out.

#include "igemm_tc.cuh"

namespace {

template <typename T, int BM, int BN, bool HALOED>
__global__ void __launch_bounds__(2 * BM)
conv3d_s2_tc_kernel(const T* __restrict__ x, const T* __restrict__ wbig,
                    const T* __restrict__ wsmall,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const T* __restrict__ res, T* __restrict__ out,
                    const tc::Shape s, int relu) {
  tc::conv_body<T, BM, BN, 2, HALOED>(x, wbig, wsmall, scale, bias, res,
                                      out, s, relu);
}

struct Kernels {
  template <typename T, int BM, int BN, bool HALOED>
  static auto get() {
    return &conv3d_s2_tc_kernel<T, BM, BN, HALOED>;
  }
};

}  // namespace

// x: (nb, di, hi, wi, cin), cin a multiple of 8; wbig: the K-major weight
// (27, cout, cin), tap (kd*3 + kh)*3 + kw; wsmall: for f32 its tf32
// remainder (wbig + wsmall = w), unused for bf16; scale, bias: (cout,)
// f32; out: (nb, (di + 1) / 2, ho, (wi + 1) / 2, cout), ho = (hi + 1) / 2,
// or with h_halo 1 (x's first and last rows halo rows, hi even) (hi - 2) /
// 2. x, w* and out are f32 (bf16 == 0) or bf16 (bf16 == 1), 16-byte
// aligned. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without launching on a shape it does not take.
extern "C" int conv3d_s2_bn_act(int bf16, const void* x, const void* wbig,
                                const void* wsmall, const void* scale,
                                const void* bias, void* out, int nb, int di,
                                int hi, int wi, int cin, int cout, int relu,
                                int h_halo, void* stream) {
  if (cin % 8 != 0 || cout < 1 || (h_halo != 0 && h_halo != 1) ||
      (h_halo && (hi % 2 != 0 || hi < 4))) {
    return (int)cudaErrorInvalidValue;
  }
  const int ho = h_halo ? (hi - 2) / 2 : (hi + 1) / 2;
  const tc::Shape s{nb, (di + 1) / 2, ho, (wi + 1) / 2, cin, cout, 3, 1,
                    di, hi, wi, h_halo};
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? tc::dispatch<Kernels, __nv_bfloat16>(x, wbig, wsmall, sc, b,
                                                  nullptr, out, s, relu, st)
           : tc::dispatch<Kernels, float>(x, wbig, wsmall, sc, b, nullptr,
                                          out, s, relu, st);
  return (int)e;
}
