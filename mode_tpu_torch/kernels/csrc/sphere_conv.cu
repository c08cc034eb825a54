// Stride-1 3x3 Cassini sphere convolution of the MODE stage-1 feature
// extractor (layer 4), on NHWC maps with H = 2W, with the folded eval
// BatchNorm affine, an optional residual (the block's shortcut) and an
// optional ReLU in the epilogue:
//   out = act(sphere_conv(x, w) * scale + bias (+ residual)).
//
// Replaces mode_tpu/ops/pallas/sphere_conv_kernel.py:
// sphere_conv_cassini_pallas (K3). That kernel keeps the image lane-major
// (N, W, C, H) so that the row shifts are lane rotates, and feeds the MXU
// one (Cout, Cin) @ (Cin, H) product per tap and output column. None of that
// answers a limit of this card. Here the map stays NHWC with the channels
// innermost, and the conv is an implicit GEMM: M = N*H*W output pixels,
// N = Cout, K = 9 taps x Cin.
//
// The sampling structure (proved by the Pallas kernel and kept): the row of
// tap k at output pixel (i, j) is (i + sigma[j,k] + frac) mod H, and its
// two columns c0, c1 depend on j and k only. M walks the output pixels
// column by column, m = (n*W + j)*H + i, so the rows of a block share one
// output column and with it the nine taps' table entries, which every thread
// of a row reads once per tap: int4 (sigma, c0, c1, drop_row) and float4
// (the four corner weights), W x 9 of each. The full per-pixel gather
// tables (4 x 9 x H x W indices and weights) would be about half the bytes
// of the 128-channel activation the conv reads.
//
// The edge rules (sphere_conv_kernel.py:23-30): a column outside the image
// has weight zero in the table; the successor of source row H-1 is not
// wrapped (its two corners get weight zero here); at drop_row, where the f32
// position rounds to exactly H, the whole sample is zero.
//
// What bounds it on the card: each output pixel costs 2*9*Cin*Cout flops
// (295 kflop at 128 -> 128) against (Cin + Cout) values of compulsory
// traffic, so it is bound by arithmetic, 14x above its bytes bound at the
// production shapes. It runs on the tile machinery of igemm.cuh: each K
// step forms a BM x 16 slice of the A tile, each value the bilinear blend
// of four channel-contiguous corners. With BN = Cout = 128 each A value is
// blended once and used by 128 output channels, so its 4 FMAs add 1/32 to
// the GEMM's. This first version runs on the FP32 pipes; tensor cores
// (wgmma) and TMA loads are later work.

#include "igemm.cuh"

namespace {

using igemm::BK;
using igemm::NT;
constexpr int TAPS = 9;

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT)
sphere_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int4* __restrict__ itab,
                   const float4* __restrict__ ftab,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ out, int nb, int h, int wd, int cin,
                   int cout, int relu) {
  constexpr int RA = BM * BK / NT;  // A rows gathered per thread
  const long long mtot = (long long)nb * wd * h;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long row_stride = (long long)wd * cin;

  // The A rows this thread gathers stay the same for every K step.
  int ri[RA], rj[RA];
  long long rimg[RA];  // offset of the row's image in x
  bool rv[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const long long m = m0 + igemm::a_row() + r * (NT / BK);
    rv[r] = m < mtot;
    long long t = rv[r] ? m : 0;
    ri[r] = (int)(t % h);
    t /= h;
    rj[r] = (int)(t % wd);
    rimg[r] = (t / wd) * h * row_stride;
  }

  // The current tap's two source pixels (row s; columns c0 and c1), the
  // step to row s + 1 (0 at the seam, where those corners weigh zero) and
  // the four corner weights, for each gathered row; loaded when the tap
  // changes, once every ceil(cin / BK) K steps.
  int cur = -1;
  long long p0[RA], p1[RA];
  int nxt[RA];
  float q0[RA], q1[RA], q2[RA], q3[RA];
  auto load_tap = [&](int k) {
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int4 it = itab[rj[r] * TAPS + k];
      const float4 f = ftab[rj[r] * TAPS + k];
      int s = ri[r] + it.x;
      if (s >= h) s -= h;
      const bool drop = ri[r] == it.w;
      const bool seam = s == h - 1;
      const long long row = rimg[r] + s * row_stride;
      p0[r] = row + (long long)it.y * cin;
      p1[r] = row + (long long)it.z * cin;
      nxt[r] = seam ? 0 : wd * cin;
      q0[r] = drop ? 0.f : f.x;
      q1[r] = (drop || seam) ? 0.f : f.y;
      q2[r] = drop ? 0.f : f.z;
      q3[r] = (drop || seam) ? 0.f : f.w;
    }
  };

  float acc[TM][TN];
  igemm::mainloop<T, BM, BN, TM, TN>(
      acc, w, cin, cout, n0, TAPS, [&](int k, int ci, float(&ra)[RA]) {
        if (k != cur) {
          load_tap(k);
          cur = k;
        }
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          float v = 0.f;
          if (rv[r] && ci < cin) {
            const T* a = x + ci;
            v = q0[r] * igemm::to_f32(a[p0[r]]) +
                q1[r] * igemm::to_f32(a[p0[r] + nxt[r]]) +
                q2[r] * igemm::to_f32(a[p1[r]]) +
                q3[r] * igemm::to_f32(a[p1[r] + nxt[r]]);
          }
          ra[r] = v;
        }
        return k;
      });
  igemm::epilogue<T, BN, TM, TN>(
      acc, m0, mtot, n0, cout, scale, bias, res, out, relu,
      [&](long long m) {
        const int i = (int)(m % h);
        const long long t = m / h;
        return (((t / wd) * h + i) * wd + t % wd) * cout;
      });
}

template <typename T, int BM, int BN, int TM, int TN>
void launch_tile(const void* x, const void* w, const int4* itab,
                 const float4* ftab, const float* scale, const float* bias,
                 const void* res, void* out, int nb, int h, int wd, int cin,
                 int cout, int relu, cudaStream_t stream) {
  const long long mtot = (long long)nb * h * wd;
  dim3 grid((unsigned)((mtot + BM - 1) / BM), (cout + BN - 1) / BN);
  sphere_conv_kernel<T, BM, BN, TM, TN><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), itab, ftab, scale,
      bias, static_cast<const T*>(res), static_cast<T*>(out), nb, h, wd, cin,
      cout, relu);
}

// The output-channel tile covers the feature extractor's Cout of 128 in one
// block, so each blended A value feeds every output channel.
template <typename T>
void launch_dtype(const void* x, const void* w, const int4* itab,
                  const float4* ftab, const float* scale, const float* bias,
                  const void* res, void* out, int nb, int h, int wd, int cin,
                  int cout, int relu, cudaStream_t stream) {
  if (cout > 64) {
    launch_tile<T, 64, 128, 4, 8>(x, w, itab, ftab, scale, bias, res, out,
                                  nb, h, wd, cin, cout, relu, stream);
  } else {
    launch_tile<T, 64, 64, 4, 4>(x, w, itab, ftab, scale, bias, res, out, nb,
                                 h, wd, cin, cout, relu, stream);
  }
}

}  // namespace

// x: (nb, h, wd, cin) with h = 2*wd; w: (9, cin, cout), tap kh*3 + kw;
// itab: (wd, 9) int4 (sigma, c0, c1, drop_row); ftab: (wd, 9) float4, the
// corner weights of (s, c0), (s+1, c0), (s, c1), (s+1, c1); scale, bias:
// (cout,) f32; res (may be null) and out: (nb, h, wd, cout). x, w, res and
// out are f32 (bf16 == 0) or bf16 (bf16 == 1). Returns cudaGetLastError()
// after the launch.
extern "C" int sphere_conv_bn_act(int bf16, const void* x, const void* w,
                                  const void* itab, const void* ftab,
                                  const void* scale, const void* bias,
                                  const void* res, void* out, int nb, int h,
                                  int wd, int cin, int cout, int relu,
                                  void* stream) {
  const int4* it = static_cast<const int4*>(itab);
  const float4* ft = static_cast<const float4*>(ftab);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_dtype<__nv_bfloat16>(x, w, it, ft, s, b, res, out, nb, h, wd, cin,
                                cout, relu, st);
  } else {
    launch_dtype<float>(x, w, it, ft, s, b, res, out, nb, h, wd, cin, cout,
                        relu, st);
  }
  return (int)cudaGetLastError();
}
