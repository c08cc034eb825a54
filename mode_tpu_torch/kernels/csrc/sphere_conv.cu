// Stride-1 3x3 sphere convolution of the MODE stage-1 feature extractor
// (layer 4), on NHWC Cassini maps (H = 2W) or ERP maps (W = 2H), with the
// folded eval BatchNorm affine, an optional residual (the block's shortcut)
// and an optional ReLU in the epilogue:
//   out = act(sphere_conv(x, w) * scale + bias (+ residual)).
//
// Replaces mode_tpu/ops/pallas/sphere_conv_kernel.py:
// sphere_conv_cassini_pallas (K3) and sphere_conv_erp_pallas (K10). Those
// run one layout-blind body on a lane-major image (N, band, C, lanes) so
// that the circular shifts are lane rotates, and feed the MXU one
// (Cout, Cin) @ (Cin, lanes) product per tap and band index. None of that
// answers a limit of this card. Here the map stays NHWC with the channels
// innermost, and the conv is an implicit GEMM: M = N*H*W output pixels,
// N = Cout, K = 9 taps x Cin.
//
// The sampling structure (proved by the Pallas kernel and kept): one image
// axis is the band, the other the circular lane axis. Tap k at the output
// pixel with band index b and lane index l samples the two source band
// indices b0, b1 (within +-2 of b; they depend on b and k only) at lane
// (l + sigma[b,k] + frac) mod L. A Cassini map has (band, lane) =
// (column, row), an ERP map (row, column); the layout is a compile-time
// parameter (ERP), so each instantiation's inner loop has no layout
// branch. M walks the output pixels band index by band index,
// m = (n*B + b)*L + l: column by column for Cassini, row by row (NHWC's own
// order) for ERP. So the rows of a block share one band index and with it
// the nine taps' table entries, which every thread of a row reads once per
// tap: int4 (sigma, b0, b1, drop) and float4 (the four corner weights),
// B x 9 of each. The full per-pixel gather tables (4 x 9 x H x W indices
// and weights) would be about half the bytes of the 128-channel activation
// the conv reads.
//
// The edge rules (sphere_conv_kernel.py:23-30, 173-179): a band index
// outside the image has weight zero in the table (Cassini's columns past
// the edge, ERP's rows past a pole); the lane successor of lane L-1 is not
// wrapped (its two corners get weight zero here); at the lane index `drop`,
// where the f32 position rounds to exactly L, the whole sample is zero.
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

template <typename T, int BM, int BN, int TM, int TN, bool ERP>
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
  // band and lane extents, and the element steps of one band and one lane
  const int nband = ERP ? h : wd, nlane = ERP ? wd : h;
  const long long band_step = ERP ? row_stride : cin;
  const long long lane_step = ERP ? cin : row_stride;

  // The A rows this thread gathers stay the same for every K step.
  int rb[RA], rl[RA];  // band and lane index
  long long rimg[RA];  // offset of the row's image in x
  bool rv[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const long long m = m0 + igemm::a_row() + r * (NT / BK);
    rv[r] = m < mtot;
    long long t = rv[r] ? m : 0;
    rl[r] = (int)(t % nlane);
    t /= nlane;
    rb[r] = (int)(t % nband);
    rimg[r] = (t / nband) * h * row_stride;
  }

  // The current tap's two source pixels (lane s; band indices b0 and b1),
  // the step to lane s + 1 (0 at the seam, where those corners weigh zero)
  // and the four corner weights, for each gathered row; loaded when the tap
  // changes, once every ceil(cin / BK) K steps.
  int cur = -1;
  long long p0[RA], p1[RA];
  int nxt[RA];
  float q0[RA], q1[RA], q2[RA], q3[RA];
  auto load_tap = [&](int k) {
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int4 it = itab[rb[r] * TAPS + k];
      const float4 f = ftab[rb[r] * TAPS + k];
      int s = rl[r] + it.x;
      if (s >= nlane) s -= nlane;
      const bool drop = rl[r] == it.w;
      const bool seam = s == nlane - 1;
      const long long lane = rimg[r] + s * lane_step;
      p0[r] = lane + it.y * band_step;
      p1[r] = lane + it.z * band_step;
      nxt[r] = seam ? 0 : (int)lane_step;
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
        if (ERP) return m * cout;  // M is NHWC's own order
        const int i = (int)(m % h);
        const long long t = m / h;
        return (((t / wd) * h + i) * wd + t % wd) * cout;
      });
}

template <typename T, int BM, int BN, int TM, int TN, bool ERP>
void launch_tile(const void* x, const void* w, const int4* itab,
                 const float4* ftab, const float* scale, const float* bias,
                 const void* res, void* out, int nb, int h, int wd, int cin,
                 int cout, int relu, cudaStream_t stream) {
  const long long mtot = (long long)nb * h * wd;
  dim3 grid((unsigned)((mtot + BM - 1) / BM), (cout + BN - 1) / BN);
  sphere_conv_kernel<T, BM, BN, TM, TN, ERP><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), itab, ftab, scale,
      bias, static_cast<const T*>(res), static_cast<T*>(out), nb, h, wd, cin,
      cout, relu);
}

// The output-channel tile covers the feature extractor's Cout of 128 in one
// block, so each blended A value feeds every output channel.
template <typename T, bool ERP>
void launch_dtype(const void* x, const void* w, const int4* itab,
                  const float4* ftab, const float* scale, const float* bias,
                  const void* res, void* out, int nb, int h, int wd, int cin,
                  int cout, int relu, cudaStream_t stream) {
  if (cout > 64) {
    launch_tile<T, 64, 128, 4, 8, ERP>(x, w, itab, ftab, scale, bias, res,
                                       out, nb, h, wd, cin, cout, relu,
                                       stream);
  } else {
    launch_tile<T, 64, 64, 4, 4, ERP>(x, w, itab, ftab, scale, bias, res,
                                      out, nb, h, wd, cin, cout, relu,
                                      stream);
  }
}

template <bool ERP>
int run(int bf16, const void* x, const void* w, const void* itab,
        const void* ftab, const void* scale, const void* bias,
        const void* res, void* out, int nb, int h, int wd, int cin, int cout,
        int relu, void* stream) {
  const int4* it = static_cast<const int4*>(itab);
  const float4* ft = static_cast<const float4*>(ftab);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_dtype<__nv_bfloat16, ERP>(x, w, it, ft, s, b, res, out, nb, h, wd,
                                     cin, cout, relu, st);
  } else {
    launch_dtype<float, ERP>(x, w, it, ft, s, b, res, out, nb, h, wd, cin,
                             cout, relu, st);
  }
  return (int)cudaGetLastError();
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
  return run<false>(bf16, x, w, itab, ftab, scale, bias, res, out, nb, h, wd,
                    cin, cout, relu, stream);
}

// The same on an ERP map, x: (nb, h, wd, cin) with wd = 2*h; itab: (h, 9)
// int4 (sigma, r0, r1, drop_col); ftab: (h, 9) float4, the corner weights
// of (r0, s), (r0, s+1), (r1, s), (r1, s+1).
extern "C" int sphere_conv_erp_bn_act(int bf16, const void* x, const void* w,
                                      const void* itab, const void* ftab,
                                      const void* scale, const void* bias,
                                      const void* res, void* out, int nb,
                                      int h, int wd, int cin, int cout,
                                      int relu, void* stream) {
  return run<true>(bf16, x, w, itab, ftab, scale, bias, res, out, nb, h, wd,
                   cin, cout, relu, stream);
}
