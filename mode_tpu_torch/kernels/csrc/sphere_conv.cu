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
// innermost, and the conv is an implicit GEMM on the tensor cores: M =
// N*H*W output pixels, N = Cout, K = 9 taps x Cin.
//
// The sampling structure (proved by the Pallas kernel and kept): one image
// axis is the band, the other the circular lane axis. Tap k at the output
// pixel with band index b and lane index l samples the two source band
// indices b0, b1 (within +-2 of b; they depend on b and k only) at lane
// s = (l + sigma[b,k]) mod L and its successor s + 1, blended with four
// corner weights that also depend on b and k only:
//   q0 X[b0][s] + q1 X[b0][s+1] + q2 X[b1][s] + q3 X[b1][s+1].
// A Cassini map has (band, lane) = (column, row), an ERP map (row, column);
// the layout is a compile-time parameter (ERP), so each instantiation's
// inner loop has no layout branch. M walks the output pixels band index by
// band index, m = (n*B + b)*L + l: column by column for Cassini, row by row
// (NHWC's own order) for ERP. A tile of BM rows may span two band indices
// (at small maps, where L < BM or L is no multiple of BM), so every row
// reads its own table entries: int4 (sigma, b0, b1, drop) and float4 (the
// four corner weights), B x 9 of each.
//
// The edge rules (sphere_conv_kernel.py:23-30, 173-179): a band index
// outside the image has weight zero in the table (Cassini's columns past
// the edge, ERP's rows past a pole); the lane successor of lane L-1 is not
// wrapped (its two corners are zero); at the lane index `drop`, where the
// f32 position rounds to exactly L, the whole sample is zero.
//
// What bounds it on the card: each output pixel costs 2*9*Cin*Cout flops
// (295 kflop at 128 -> 128) on the tensor cores plus 7*9*Cin for the blend
// on the FP32 pipes, against (Cin + Cout) values of compulsory traffic, so
// arithmetic. The design: a K stage is one tap x 32 channels. For each A
// row the stage copies the four corners' 32-channel runs (128 bytes in f32,
// 64 in bf16) with zero-fill cp.async into four swizzled BM-row corner
// tiles, and the row's four corner weights (its float4 table entry) beside
// them. Every copy is issued; a corner at the seam, on the drop lane, past
// Cin or of a row past M is zero-filled, so no stale shared memory meets a
// zero weight. Each thread then reads its A fragment's values from the four
// tiles (conflict-free through the swizzle), blends them with its rows'
// weights on the FP32 pipes, and issues wgmma with A from registers
// (sphere_tc.cuh, shared with the grad-input of sphere_conv_bwd.cu): f32 as
// 3xTF32 exactly as igemm_tc.cuh's conv_body does after its fragment load
// (a fresh fragment per stage), bf16 blended in f32 and rounded to bf16, as
// the Pallas kernel rounds its premixed sample. B, the K-major weight (9,
// Cout, Cin) of ops/kmajor.py, is copied as in conv_body. With BN = Cout =
// 128 each blended value feeds every output channel.

#include "sphere_tc.cuh"

namespace {

using tc::BK;
using tc::Cfg;
using tc::SMEM_MAX;
constexpr int TAPS = 9;

// Bytes of one stage: four corner tiles, the weight parts, and the rows'
// corner weights (a float4 each).
template <typename T, int BM, int BN>
__host__ __device__ constexpr int stage_bytes() {
  return 4 * BM * Cfg<T>::RB + Cfg<T>::PARTS * BN * Cfg<T>::RB + BM * 16;
}
// Stages in flight: as many as fit, at most four.
template <typename T, int BM, int BN>
__host__ __device__ constexpr int stages() {
  return (SMEM_MAX - 1024) / stage_bytes<T, BM, BN>() < 4
             ? (SMEM_MAX - 1024) / stage_bytes<T, BM, BN>()
             : 4;
}
template <typename T, int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return stages<T, BM, BN>() * stage_bytes<T, BM, BN>() + 1024;
}

// x: (nb, h, wd, cin); wbig, wsmall: the K-major weight as conv_body takes
// it; itab, ftab: the shift tables by (band index, tap); res may be null.
template <typename T, int BM, int BN, bool ERP>
__global__ void __launch_bounds__(2 * BM)
sphere_conv_tc_kernel(const T* __restrict__ x, const T* __restrict__ wbig,
                      const T* __restrict__ wsmall,
                      const int4* __restrict__ itab,
                      const float4* __restrict__ ftab,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const T* __restrict__ res, T* __restrict__ out, int nb,
                      int h, int wd, int cin, int cout, int relu) {
  using C = Cfg<T>;
  constexpr int NT = 2 * BM;            // one warpgroup per 64 rows
  constexpr int CH = 16 / sizeof(T);    // channels per 16-byte chunk
  constexpr int CPR = C::RB / 16;       // chunks per stage row
  constexpr int NA = BM * CPR / NT;     // rows each thread copies per tile
  constexpr int A_BYTES = BM * C::RB;   // one corner tile
  constexpr int B_BYTES = BN * C::RB;
  constexpr int Q_OFF = 4 * A_BYTES + C::PARTS * B_BYTES;
  constexpr int STAGE = stage_bytes<T, BM, BN>();
  constexpr int STAGES = stages<T, BM, BN>();
  static_assert(BM % 64 == 0 && NA * NT == BM * CPR, "whole rows per stage");
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0 &&
                    B_BYTES % 1024 == 0,
                "1024-byte aligned tiles");
  static_assert(STAGES >= 2, "two stages in flight");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const long long mtot = (long long)nb * h * wd;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nkc = (cin + BK - 1) / BK;
  const int nsteps = TAPS * nkc;
  // band and lane extents; a pixel's index steps by band_step from one
  // band index to the next and by lane_step along the lane axis
  const int nband = ERP ? h : wd, nlane = ERP ? wd : h;
  const int band_step = ERP ? wd : 1;
  const int lane_step = ERP ? 1 : wd;

  // The A rows this thread copies (rows tid / CPR + i * NT / CPR, chunk ac
  // of each corner tile): band and lane index, the pixel index of the
  // row's image, whether the row is inside M.
  const int ac = tid % CPR;
  int rb[NA], rl[NA];
  long long rimg[NA];
  bool rv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const long long m = m0 + tid / CPR + i * (NT / CPR);
    rv[i] = m < mtot;
    long long t = rv[i] ? m : 0;
    rl[i] = (int)(t % nlane);
    t /= nlane;
    rb[i] = (int)(t % nband);
    rimg[i] = t / nband * h * wd;
  }
  // The f32 weight's Cin is padded to whole stages (host-side pack).
  const int wcin = C::PARTS == 2 ? nkc * BK : cin;

  auto load = [&](int step, int slot) {
    const int tap = step / nkc, kc = step - tap * nkc;
    const uint32_t sa = base + slot * STAGE;
    const int ch = kc * BK + ac * CH;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = tid / CPR + i * (NT / CPR);
      const int4 it = itab[rb[i] * TAPS + tap];
      int sl = rl[i] + it.x;
      if (sl >= nlane) sl -= nlane;
      // corners (b0, s), (b0, s+1), (b1, s), (b1, s+1); the successor of
      // lane L-1 and the whole sample at the drop lane are zero
      const bool ok = rv[i] && ch < cin && rl[i] != it.w;
      const bool okn = ok && sl != nlane - 1;
      const long long p = rimg[i] + (long long)sl * lane_step;
      const long long p0 = (p + (long long)it.y * band_step) * cin + ch;
      const long long p1 = (p + (long long)it.z * band_step) * cin + ch;
      const long long nx = (long long)lane_step * cin;
      const uint32_t dst = sa + tc::swizzle<T>(r, ac);
      tc::cp_async16(dst, ok ? x + p0 : x, ok);
      tc::cp_async16(dst + A_BYTES, okn ? x + p0 + nx : x, okn);
      tc::cp_async16(dst + 2 * A_BYTES, ok ? x + p1 : x, ok);
      tc::cp_async16(dst + 3 * A_BYTES, okn ? x + p1 + nx : x, okn);
      if (ac == 0) {
        tc::cp_async16(sa + Q_OFF + r * 16,
                       rv[i] ? ftab + rb[i] * TAPS + tap : ftab, rv[i]);
      }
    }
#pragma unroll
    for (int idx = tid; idx < BN * CPR; idx += NT) {
      const int n = idx / CPR, c = idx % CPR;
      const int co = n0 + n, chb = kc * BK + c * CH;
      const bool ok = co < cout && chb < wcin;
      const long long off = ((long long)tap * cout + co) * wcin + chb;
      const uint32_t dst = sa + 4 * A_BYTES + tc::swizzle<T>(n, c);
      tc::cp_async16(dst, ok ? wbig + off : wbig, ok);
      if constexpr (C::PARTS == 2) {
        tc::cp_async16(dst + B_BYTES, ok ? wsmall + off : wsmall, ok);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid / 128;
  const int warp = tid % 128 / 32;
  const int lane = tid % 32;
  // this thread's A fragment rows r0 and r0 + 8, and its quad index
  const int r0 = wg * 64 + warp * 16 + lane / 4, q = lane % 4;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    tc::cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    tc::cp_async_wait<STAGES - 2>();
    tc::fence_proxy_async();
    // Stage `step` has landed for every thread, and every warpgroup has
    // waited out its products of stage step - 1, whose slot is refilled.
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < nsteps) load(next, next % STAGES);
    tc::cp_async_commit();

    const int slot = step % STAGES;
    const uint8_t* ta = smem + slot * STAGE;
    const uint32_t sb = base + slot * STAGE + 4 * A_BYTES;
    float wq[2][4];  // the corner weights of rows r0 and r0 + 8
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float4 f =
          *reinterpret_cast<const float4*>(ta + Q_OFF + (r0 + 8 * hh) * 16);
      wq[hh][0] = f.x, wq[hh][1] = f.y, wq[hh][2] = f.z, wq[hh][3] = f.w;
    }
    // the blend of the four corner tiles (sphere_tc.cuh)
    sph::Blend<T> a;
    a.zero();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a.add(hh, ta + c * A_BYTES, r0 + 8 * hh, q, wq[hh][c]);
      }
    }
    a.template mma<BN>(acc, sb);
  }
  tc::cp_async_wait<0>();
  tc::epilogue<T, BN>(acc, m0, mtot, n0, cout, scale, bias, res, out, relu,
                      [&](long long m) {
                        if (ERP) return m * cout;  // NHWC's own order
                        const int i = (int)(m % h);
                        const long long t = m / h;
                        return (((t / wd) * h + i) * wd + t % wd) * cout;
                      });
}

template <typename T, int BM, int BN, bool ERP>
cudaError_t launch_tile(const void* x, const void* wbig, const void* wsmall,
                        const int4* itab, const float4* ftab,
                        const float* scale, const float* bias,
                        const void* res, void* out, int nb, int h, int wd,
                        int cin, int cout, int relu, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, BM, BN>();
  const auto kernel = sphere_conv_tc_kernel<T, BM, BN, ERP>;
  static bool sized[tc::MAX_DEVICES] = {};
  const cudaError_t e = tc::size_smem(kernel, smem, sized);
  if (e != cudaSuccess) return e;
  const long long mtot = (long long)nb * h * wd;
  const dim3 grid((unsigned)((mtot + BM - 1) / BM), (cout + BN - 1) / BN);
  kernel<<<grid, 2 * BM, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wbig),
      static_cast<const T*>(wsmall), itab, ftab, scale, bias,
      static_cast<const T*>(res), static_cast<T*>(out), nb, h, wd, cin, cout,
      relu);
  return cudaGetLastError();
}

// The tile: BN = 128 covers the feature extractor's Cout of 128, so each
// blended A value feeds every output channel (64 below 65); BM = 128 where
// that still gives every SM a block, else 64. One block fills an SM's
// shared memory either way (f32: two or three stages in flight).
template <typename T, bool ERP>
cudaError_t launch(const void* x, const void* wbig, const void* wsmall,
                   const int4* itab, const float4* ftab, const float* scale,
                   const float* bias, const void* res, void* out, int nb,
                   int h, int wd, int cin, int cout, int relu,
                   cudaStream_t stream) {
  const bool tall = ((long long)nb * h * wd + 127) / 128 >= 132;
#define SPHERE_LAUNCH(BM_, BN_)                                              \
  return launch_tile<T, BM_, BN_, ERP>(x, wbig, wsmall, itab, ftab, scale,  \
                                       bias, res, out, nb, h, wd, cin, cout, \
                                       relu, stream)
  if (cout > 64) {
    if (tall) SPHERE_LAUNCH(128, 128);
    SPHERE_LAUNCH(64, 128);
  }
  if (tall) SPHERE_LAUNCH(128, 64);
  SPHERE_LAUNCH(64, 64);
#undef SPHERE_LAUNCH
}

template <bool ERP>
int run(int bf16, const void* x, const void* wbig, const void* wsmall,
        const void* itab, const void* ftab, const void* scale,
        const void* bias, const void* res, void* out, int nb, int h, int wd,
        int cin, int cout, int relu, void* stream) {
  if (cin % 8 != 0 || cout < 1) return (int)cudaErrorInvalidValue;
  const int4* it = static_cast<const int4*>(itab);
  const float4* ft = static_cast<const float4*>(ftab);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16, ERP>(x, wbig, wsmall, it, ft, s, b, res,
                                        out, nb, h, wd, cin, cout, relu, st)
           : launch<float, ERP>(x, wbig, wsmall, it, ft, s, b, res, out, nb,
                                h, wd, cin, cout, relu, st);
  return (int)e;
}

}  // namespace

// x: (nb, h, wd, cin) with h = 2*wd, cin a multiple of 8; wbig, wsmall:
// the K-major weight (9, cout, cin), tap kh*3 + kw, f32 split into its
// tf32 parts (wbig + wsmall = w, Cin padded to whole stages and permuted
// as ops/kmajor.py packs it), bf16 whole (wsmall unused); itab: (wd, 9)
// int4 (sigma, c0, c1, drop_row); ftab: (wd, 9) float4, the corner weights
// of (s, c0), (s+1, c0), (s, c1), (s+1, c1); scale, bias: (cout,) f32; res
// (may be null) and out: (nb, h, wd, cout). x, w*, res and out are f32
// (bf16 == 0) or bf16 (bf16 == 1), 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int sphere_conv_bn_act(int bf16, const void* x, const void* wbig,
                                  const void* wsmall, const void* itab,
                                  const void* ftab, const void* scale,
                                  const void* bias, const void* res,
                                  void* out, int nb, int h, int wd, int cin,
                                  int cout, int relu, void* stream) {
  return run<false>(bf16, x, wbig, wsmall, itab, ftab, scale, bias, res, out,
                    nb, h, wd, cin, cout, relu, stream);
}

// The same on an ERP map, x: (nb, h, wd, cin) with wd = 2*h; itab: (h, 9)
// int4 (sigma, r0, r1, drop_col); ftab: (h, 9) float4, the corner weights
// of (r0, s), (r0, s+1), (r1, s), (r1, s+1).
extern "C" int sphere_conv_erp_bn_act(int bf16, const void* x,
                                      const void* wbig, const void* wsmall,
                                      const void* itab, const void* ftab,
                                      const void* scale, const void* bias,
                                      const void* res, void* out, int nb,
                                      int h, int wd, int cin, int cout,
                                      int relu, void* stream) {
  return run<true>(bf16, x, wbig, wsmall, itab, ftab, scale, bias, res, out,
                   nb, h, wd, cin, cout, relu, stream);
}
