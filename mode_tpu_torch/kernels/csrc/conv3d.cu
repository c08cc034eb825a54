// Strided and transposed cost-volume 3-D convolutions of MODE stage 1 on
// NDHWC volumes, with the folded eval-BatchNorm affine, an optional residual
// and an optional ReLU in the epilogue:
//   out = act(conv(x, w) * scale + bias (+ residual)).
//
// Replaces the TPU kernels of mode_tpu/ops/pallas/conv3d_kernel.py:
//   MODE_S2      stride-2 pad-1 3x3x3 conv
//                  <- conv3d_band_s2_pallas (K4)
//   MODE_DECONV  ConvTranspose3d k3 s2 p1 output_padding 1, torch (I, O, k)
//                weight  <- conv3d_band_deconv_pallas (K5) and
//                conv3d_fold_deconv_pallas (K7)
// (the stride-1 conv, K1 and K6, has its own tensor-core kernel in
// conv3d_s1.cu). The lane-major layouts, lane rolls, 0/1 selection matmuls
// and the M*L lane fold of those kernels answered the TPU's 128-lane tiles.
// Here every volume stays NDHWC with the channels innermost, and one kernel
// serves every level of the hourglass.
//
// What bounds it on the card: at the stage-1 shapes (Cin, Cout <= 64) each
// output voxel costs 2*27*Cin*Cout flops (2*8*Cin*Cout per input voxel for
// the deconv) against (Cin + Cout) values of compulsory traffic, far above
// the H100's ridge point, so the kernel is bound by arithmetic. The design
// is an implicit GEMM with M = output voxels, N = Cout, K = taps x Cin, on
// the tile machinery of igemm.cuh: each K step gathers a BM x 16 slice of
// the input at one tap's offset, zero outside the volume. The transposed
// conv does no zero-stuffing: blockIdx.z picks one of the eight output
// parity phases, and a phase visits only the 1, 2, 4 or 8 taps that land on
// it. This first version runs on the FP32 pipes; tensor cores (wgmma) and
// TMA loads are later work.

#include "igemm.cuh"

namespace {

constexpr int MODE_S2 = 1;
constexpr int MODE_DECONV = 2;
using igemm::BK;
using igemm::NT;

// Tap j of one spatial axis: kernel index k and input offset off, so that
// the input index is stride * z + off for grid coordinate z.
//   stride 1 and 2: k = j, input 2z-1+k (s2) or z-1+k (s1)
//   transposed conv, output o = 2i - 1 + k: an even output 2z reads tap 1 at
//   input z; an odd output 2z+1 reads tap 0 at input z+1 and tap 2 at z.
template <int MODE>
__device__ __forceinline__ void tap(int phase, int j, int& k, int& off) {
  if (MODE == MODE_DECONV) {
    k = phase ? 2 * j : 1;
    off = phase ? 1 - j : 0;
  } else {
    k = j;
    off = j - 1;
  }
}

template <typename T, int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT)
conv3d_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const T* __restrict__ res, T* __restrict__ out, int nb,
                     int di, int hi, int wi, int cin, int dout, int hout,
                     int wout, int cout, int relu) {
  constexpr int RA = BM * BK / NT;  // A rows gathered per thread
  // M walks the output voxels in NDHW order; for the transposed conv it
  // walks the input-sized grid of one parity phase.
  const int gd = MODE == MODE_DECONV ? di : dout;
  const int gh = MODE == MODE_DECONV ? hi : hout;
  const int gw = MODE == MODE_DECONV ? wi : wout;
  const long long mtot = (long long)nb * gd * gh * gw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int pd = (blockIdx.z >> 2) & 1;
  const int ph = (blockIdx.z >> 1) & 1;
  const int pw = blockIdx.z & 1;
  const int nt_d = MODE == MODE_DECONV ? 1 + pd : 3;
  const int nt_h = MODE == MODE_DECONV ? 1 + ph : 3;
  const int nt_w = MODE == MODE_DECONV ? 1 + pw : 3;
  const int stride = MODE == MODE_S2 ? 2 : 1;

  // The A rows this thread gathers stay the same for every K step.
  int rb[RA], rz0[RA], rz1[RA], rz2[RA];
  bool rv[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const long long m = m0 + igemm::a_row() + r * (NT / BK);
    rv[r] = m < mtot;
    long long t = rv[r] ? m : 0;
    rz2[r] = (int)(t % gw);
    t /= gw;
    rz1[r] = (int)(t % gh);
    t /= gh;
    rz0[r] = (int)(t % gd);
    rb[r] = (int)(t / gd);
  }

  float acc[TM][TN];
  igemm::mainloop<T, BM, BN, TM, TN>(
      acc, w, cin, cout, n0, nt_d * nt_h * nt_w,
      [&](int t, int ci, float(&ra)[RA]) {
        const int j2 = t % nt_w;
        t /= nt_w;
        const int j1 = t % nt_h;
        const int j0 = t / nt_h;
        int k0, o0, k1, o1, k2, o2;
        tap<MODE>(pd, j0, k0, o0);
        tap<MODE>(ph, j1, k1, o1);
        tap<MODE>(pw, j2, k2, o2);
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          const int id = stride * rz0[r] + o0;
          const int ih = stride * rz1[r] + o1;
          const int iw = stride * rz2[r] + o2;
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
        if (MODE != MODE_DECONV) return m * cout;
        long long t = m;
        const int z2 = (int)(t % gw);
        t /= gw;
        const int z1 = (int)(t % gh);
        t /= gh;
        const int z0 = (int)(t % gd);
        const long long b = t / gd;
        return (((b * dout + 2 * z0 + pd) * hout + 2 * z1 + ph) * wout +
                2 * z2 + pw) *
               cout;
      });
}

template <typename T, int MODE, int BM, int BN, int TM, int TN>
void launch_tile(const void* x, const void* w, const float* scale,
                 const float* bias, const void* res, void* out, int nb,
                 int di, int hi, int wi, int cin, int dout, int hout,
                 int wout, int cout, int relu, cudaStream_t stream) {
  const long long grid_m = MODE == MODE_DECONV
                               ? (long long)nb * di * hi * wi
                               : (long long)nb * dout * hout * wout;
  dim3 grid((unsigned)((grid_m + BM - 1) / BM), (cout + BN - 1) / BN,
            MODE == MODE_DECONV ? 8 : 1);
  conv3d_bn_act_kernel<T, MODE, BM, BN, TM, TN><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<const T*>(res), static_cast<T*>(out), nb, di, hi, wi, cin,
      dout, hout, wout, cout, relu);
}

// The output-channel tile follows Cout, so a narrow output does not pay for
// idle columns.
template <typename T, int MODE>
void launch_mode(const void* x, const void* w, const float* scale,
                 const float* bias, const void* res, void* out, int nb,
                 int di, int hi, int wi, int cin, int dout, int hout,
                 int wout, int cout, int relu, cudaStream_t stream) {
  if (cout > 32) {
    launch_tile<T, MODE, 64, 64, 4, 4>(x, w, scale, bias, res, out, nb, di,
                                       hi, wi, cin, dout, hout, wout, cout,
                                       relu, stream);
  } else if (cout > 8) {
    launch_tile<T, MODE, 128, 32, 4, 4>(x, w, scale, bias, res, out, nb, di,
                                        hi, wi, cin, dout, hout, wout, cout,
                                        relu, stream);
  } else {
    launch_tile<T, MODE, 128, 8, 4, 1>(x, w, scale, bias, res, out, nb, di,
                                       hi, wi, cin, dout, hout, wout, cout,
                                       relu, stream);
  }
}

template <typename T>
void launch_dtype(int mode, const void* x, const void* w, const float* scale,
                  const float* bias, const void* res, void* out, int nb,
                  int di, int hi, int wi, int cin, int dout, int hout,
                  int wout, int cout, int relu, cudaStream_t stream) {
  if (mode == MODE_S2) {
    launch_mode<T, MODE_S2>(x, w, scale, bias, res, out, nb, di, hi, wi, cin,
                            dout, hout, wout, cout, relu, stream);
  } else {
    launch_mode<T, MODE_DECONV>(x, w, scale, bias, res, out, nb, di, hi, wi,
                                cin, dout, hout, wout, cout, relu, stream);
  }
}

}  // namespace

// mode: MODE_S2 or MODE_DECONV; x: (nb, di, hi, wi, cin); w: (27, cin,
// cout) with tap (kd*3 + kh)*3 + kw; scale, bias: (cout,) f32; res (may be
// null) and out: (nb, dout, hout, wout, cout). x, w, res and out are f32 (bf16 == 0) or bf16 (bf16 == 1).
// Returns cudaGetLastError() after the launch.
extern "C" int conv3d_bn_act(int mode, int bf16, const void* x, const void* w,
                             const void* scale, const void* bias,
                             const void* res, void* out, int nb, int di,
                             int hi, int wi, int cin, int dout, int hout,
                             int wout, int cout, int relu, void* stream) {
  if (mode != MODE_S2 && mode != MODE_DECONV) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_dtype<__nv_bfloat16>(mode, x, w, s, b, res, out, nb, di, hi, wi,
                                cin, dout, hout, wout, cout, relu, st);
  } else {
    launch_dtype<float>(mode, x, w, s, b, res, out, nb, di, hi, wi, cin, dout,
                        hout, wout, cout, relu, st);
  }
  return (int)cudaGetLastError();
}
