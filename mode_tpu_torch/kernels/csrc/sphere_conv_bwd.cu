// Backward of the stride-1 3x3 sphere convolution (sphere_conv.cu) on NHWC
// Cassini maps (H = 2W) or ERP maps (W = 2H): the gradient of the input, dx
// (N, H, W, Cin), and of the weight, dw (9, Cin, Cout) in f32, for a
// cotangent g (N, H, W, Cout) of the bare conv's output.
//
// Replaces mode_tpu/ops/pallas/sphere_conv_kernel.py:
// sphere_conv_cassini_pallas_bwd (K3b) and sphere_conv_erp_pallas_bwd
// (K10b): their dx pallas_call (_bwd_input_kernel) and their dw pallas_call
// (_bwd_weight_kernel). As there, one body serves both layouts, with
// (band, lane) = (column, row) for Cassini and (row, column) for ERP
// (sphere_conv.cu says what the two axes are); here the layout is a
// compile-time parameter (ERP), so each instantiation's inner loop has no
// layout branch. Both kernels read the forward's B x 9 shift tables (B the
// band extent): int4 (sigma, b0, b1, drop) and float4 (the corner weights
// of (b0, s), (b0, s+1), (b1, s), (b1, s+1) in (band, lane) terms), where
// the output pixel with band index b and lane index l samples at tap k the
// lane s = (l + sigma[b,k]) mod L and its successor.
//
// sphere_conv_bwd_input. dx[p] = sum over the samples that read input
// pixel p of their corner weight times dcol = g . W^T at that sample. The
// Pallas kernels and the reference's col2im (sphere_conv_cuda_kernel.cu)
// scatter those contributions; here each dx pixel gathers its own, so the
// result is deterministic with no atomics. Tap k's corners land on band
// index c from the output band indices j with b0[j,k] == c or
// b1[j,k] == c, all within `reach` (2 on the Cassini and ERP grids) of c;
// from output lane (l - sigma) mod L for the (., s) corners and
// (l - 1 - sigma) mod L for the successor corners. The forward's edge
// rules, transposed: a successor corner never lands on lane 0 (the forward
// does not wrap the successor of lane L-1); a corner read by the output
// lane drop[j,k] carries nothing; the clamped band indices have weight zero
// and so never match. Since W^T does not depend on the pixel, the blend and
// the GEMM fuse into one implicit GEMM: M = dx pixels, N = Cin,
// K = 9 taps x Cout, whose A value at (pixel, tap k, channel co) blends
// g[., co] over the at most MAXE contributing samples (4 on both grids; the
// wrapper checks both bounds on the tables), and whose B slice for tap k is
// W[k]^T.
//
// sphere_conv_bwd_weight. dw[k, ci, co] = sum over the N*H*W pixels of
// col[p, k, ci] * g[p, co], col being the forward's blended sample, rebuilt
// from the shift tables as sphere_conv.cu's A gather builds it. A GEMM of
// M = 9*Cin, N = Cout and K = pixels: blockIdx.z splits the pixels into
// `nsplit` ranges, each block writes its f32 partial sums, and a second
// kernel adds the partials in split order. On the TPU the sequential grid
// carried the sum across blocks; here blocks run in no order, and the fixed
// order of the second pass keeps dw deterministic. Both accumulate in f32,
// for bf16 inputs too.
//
// What bounds them on the card: each costs the forward's 2*9*Cin*Cout flops
// per pixel (295 kflop at 128 -> 128) against (Cin + Cout) values of
// traffic, so both are bound by arithmetic. This first version runs on the
// FP32 pipes, dx on the tile machinery of igemm.cuh, dw on its own tile loop
// of the same shape; tensor cores (wgmma) and TMA loads are later work.

#include "igemm.cuh"

namespace {

using igemm::BK;
using igemm::NT;
constexpr int TAPS = 9;
constexpr int MAXE = 4;  // contributing samples per (input band index, tap)

template <typename T, int BM, int BN, int TM, int TN, bool ERP>
__global__ void __launch_bounds__(NT)
bwd_input_kernel(const T* __restrict__ g, const T* __restrict__ wt,
                 const int4* __restrict__ itab,
                 const float4* __restrict__ ftab,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ dx, int nb,
                 int h, int wd, int cin, int cout, int reach) {
  constexpr int RA = BM * BK / NT;  // A rows gathered per thread
  const long long mtot = (long long)nb * wd * h;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nband = ERP ? h : wd, nlane = ERP ? wd : h;

  // M walks the dx pixels band index by band index, m = (n*B + c)*L + l
  // (Cassini: column by column; ERP: row by row), so the rows of a block
  // share their band index and its table entries.
  int rl[RA], rc[RA];  // lane and band index
  long long rimg[RA];  // offset of the row's image in g
  bool rv[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const long long m = m0 + igemm::a_row() + r * (NT / BK);
    rv[r] = m < mtot;
    long long t = rv[r] ? m : 0;
    rl[r] = (int)(t % nlane);
    t /= nlane;
    rc[r] = (int)(t % nband);
    rimg[r] = (t / nband) * h * wd * (long long)cout;
  }

  // The current tap's contributions to each gathered row: the offsets in g
  // of the sample that reads the pixel through an (s, .) corner and through
  // a successor corner, and their weights; loaded when the tap changes.
  int cur = -1;
  int ne[RA];
  int ps[RA][MAXE], pn[RA][MAXE];
  float ws[RA][MAXE], wn[RA][MAXE];
  auto load_tap = [&](int k) {
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      ne[r] = 0;
      const int c = rc[r];
      const int jlo = max(c - reach, 0), jhi = min(c + reach, nband - 1);
      for (int j = jlo; j <= jhi; ++j) {
        const int4 it = itab[j * TAPS + k];
        const float4 f = ftab[j * TAPS + k];
        float a_s = (it.y == c ? f.x : 0.f) + (it.z == c ? f.z : 0.f);
        float a_n = (it.y == c ? f.y : 0.f) + (it.z == c ? f.w : 0.f);
        if (a_s == 0.f && a_n == 0.f) continue;
        int is = rl[r] - it.x;  // the output lane reading (c, l) as lane s
        if (is < 0) is += nlane;
        const int in = is == 0 ? nlane - 1 : is - 1;  // ... as lane s + 1
        if (is == it.w) a_s = 0.f;
        if (rl[r] == 0 || in == it.w) a_n = 0.f;
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
          if (e == ne[r]) {
            // the offsets in g of output pixels (band j, lane is / in)
            ps[r][e] = (ERP ? j * wd + is : is * wd + j) * cout;
            pn[r][e] = (ERP ? j * wd + in : in * wd + j) * cout;
            ws[r][e] = a_s;
            wn[r][e] = a_n;
          }
        }
        ++ne[r];
      }
    }
  };

  float acc[TM][TN];
  igemm::mainloop<T, BM, BN, TM, TN>(
      acc, wt, cout, cin, n0, TAPS, [&](int k, int co, float(&ra)[RA]) {
        if (k != cur) {
          load_tap(k);
          cur = k;
        }
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          float v = 0.f;
          if (rv[r] && co < cout) {
            const T* a = g + rimg[r] + co;
#pragma unroll
            for (int e = 0; e < MAXE; ++e) {
              if (e < ne[r]) {
                v += ws[r][e] * igemm::to_f32(a[ps[r][e]]) +
                     wn[r][e] * igemm::to_f32(a[pn[r][e]]);
              }
            }
          }
          ra[r] = v;
        }
        return k;
      });
  igemm::epilogue<T, BN, TM, TN>(
      acc, m0, mtot, n0, cin, scale, bias, static_cast<const T*>(nullptr),
      dx, 0, [&](long long m) {
        if (ERP) return m * cin;  // M is NHWC's own order
        const int i = (int)(m % h);
        const long long t = m / h;
        return (((t / wd) * h + i) * wd + t % wd) * cin;
      });
}

// dw partial sums: block (x, y, z) sums rows m = k*Cin + ci in
// [x*BM, x*BM + BM) and channels co in [y*BN, y*BN + BN) over the pixels
// p = (n*H + i)*W + j in [z*chunk, z*chunk + chunk) into
// part[z][m][co]. Each thread stages, per step of BK pixels, the A values
// of one row (fixed tap and channel, so the warp's loads are channel-
// contiguous) at BK*BM/NT pixels, and BK*BN/NT values of g.
template <typename T, int BM, int BN, int TM, int TN, bool ERP>
__global__ void __launch_bounds__(NT)
bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const int4* __restrict__ itab,
                  const float4* __restrict__ ftab, float* __restrict__ part,
                  int nb, int h, int wd, int cin, int cout, int chunk) {
  static_assert((BM / TM) * (BN / TN) == NT, "one thread per TM x TN tile");
  static_assert(NT % BM == 0 && (BK * BM) % NT == 0, "whole A columns");
  constexpr int RA = BK * BM / NT;             // A values staged per thread
  constexpr int PS = NT / BM;                  // pixel stride of those
  constexpr int RB = (BK * BN + NT - 1) / NT;  // g values staged per thread
  constexpr int AP = BM + 4;
  __shared__ __align__(16) float As[2][BK][AP];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int mrows = TAPS * cin;
  const long long ptot = (long long)nb * h * wd;
  const long long p_lo = (long long)blockIdx.z * chunk;
  const long long p_hi = min(p_lo + chunk, ptot);
  const int n0 = blockIdx.y * BN;

  // this thread's A row: tap k, channel ci
  const int am = blockIdx.x * BM + tid % BM;
  const bool arow = am < mrows;
  const int ak = arow ? am / cin : 0;
  const int aci = arow ? am % cin : 0;
  const int apix = tid / BM;
  const long long img = (long long)h * wd;
  // the lane extent, and the element steps of one band and one lane
  const int nlane = ERP ? wd : h;
  const long long band_step = ERP ? (long long)wd * cin : cin;
  const long long lane_step = ERP ? cin : (long long)wd * cin;

  float ra[RA], rb[RB];
  auto fetch = [&](long long p0) {
#pragma unroll
    for (int q = 0; q < RA; ++q) {
      const long long p = p0 + apix + q * PS;
      float v = 0.f;
      if (arow && p < p_hi) {
        const int j = (int)(p % wd);
        const long long t = p / wd;
        const int i = (int)(t % h);
        const long long base = (t / h) * img * cin + aci;
        const int b = ERP ? i : j, l = ERP ? j : i;  // band and lane index
        const int4 it = itab[b * TAPS + ak];
        const float4 f = ftab[b * TAPS + ak];
        int s = l + it.x;
        if (s >= nlane) s -= nlane;
        if (l != it.w) {
          const bool seam = s == nlane - 1;
          const long long lane = base + s * lane_step;
          const long long nxt = seam ? 0 : lane_step;
          const T* p0c = x + lane + it.y * band_step;
          const T* p1c = x + lane + it.z * band_step;
          v = f.x * igemm::to_f32(p0c[0]) + f.z * igemm::to_f32(p1c[0]);
          if (!seam) {
            v += f.y * igemm::to_f32(p0c[nxt]) + f.w * igemm::to_f32(p1c[nxt]);
          }
        }
      }
      ra[q] = v;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int idx = tid + r * NT;
      const long long p = p0 + idx / BN;
      const int co = n0 + idx % BN;
      float v = 0.f;
      if (idx < BK * BN && p < p_hi && co < cout) {
        v = igemm::to_f32(g[p * cout + co]);
      }
      rb[r] = v;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < RA; ++q) As[buf][apix + q * PS][tid % BM] = ra[q];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int idx = tid + r * NT;
      if (idx < BK * BN) Bs[buf][idx / BN][idx % BN] = rb[r];
    }
  };

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nsteps = p_hi > p_lo ? (int)((p_hi - p_lo + BK - 1) / BK) : 0;
  if (nsteps > 0) {
    fetch(p_lo);
    stash(0);
  }
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s & 1;
    if (s + 1 < nsteps) fetch(p_lo + (long long)(s + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      igemm::load_row(a, &As[buf][kk][ty * TM]);
      igemm::load_row(b, &Bs[buf][kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < nsteps) stash(buf ^ 1);
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.z * mrows * cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = blockIdx.x * BM + ty * TM + i;
    if (m >= mrows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < cout) out[(long long)m * cout + co] = acc[i][j];
    }
  }
}

// dw[e] = sum over z of part[z][e], z in order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ dw, long long n,
                                     int nsplit) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < nsplit; ++z) s += part[z * n + e];
    dw[e] = s;
  }
}

template <typename T, bool ERP>
void launch_input(const void* g, const void* wt, const int4* itab,
                  const float4* ftab, const float* scale, const float* bias,
                  void* dx, int nb, int h, int wd, int cin, int cout,
                  int reach, cudaStream_t stream) {
  const long long mtot = (long long)nb * h * wd;
  // the output-channel tile covers Cin = 128 in one block, as the forward's
  // covers Cout
  if (cin > 64) {
    dim3 grid((unsigned)((mtot + 63) / 64), (cin + 127) / 128);
    bwd_input_kernel<T, 64, 128, 4, 8, ERP><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(wt), itab, ftab,
        scale, bias, static_cast<T*>(dx), nb, h, wd, cin, cout, reach);
  } else {
    dim3 grid((unsigned)((mtot + 63) / 64), (cin + 63) / 64);
    bwd_input_kernel<T, 64, 64, 4, 4, ERP><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(wt), itab, ftab,
        scale, bias, static_cast<T*>(dx), nb, h, wd, cin, cout, reach);
  }
}

template <typename T, bool ERP>
void launch_weight(const void* x, const void* g, const int4* itab,
                   const float4* ftab, float* part, int nb, int h, int wd,
                   int cin, int cout, int nsplit, int chunk,
                   cudaStream_t stream) {
  const int mrows = TAPS * cin;
  if (cout > 64) {
    dim3 grid((mrows + 63) / 64, (cout + 127) / 128, nsplit);
    bwd_weight_kernel<T, 64, 128, 4, 8, ERP><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), itab, ftab, part,
        nb, h, wd, cin, cout, chunk);
  } else {
    dim3 grid((mrows + 63) / 64, (cout + 63) / 64, nsplit);
    bwd_weight_kernel<T, 64, 64, 4, 4, ERP><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), itab, ftab, part,
        nb, h, wd, cin, cout, chunk);
  }
}

template <bool ERP>
int run_input(int bf16, const void* g, const void* wt, const void* itab,
              const void* ftab, const void* scale, const void* bias, void* dx,
              int nb, int h, int wd, int cin, int cout, int reach,
              void* stream) {
  const int4* it = static_cast<const int4*>(itab);
  const float4* ft = static_cast<const float4*>(ftab);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_input<__nv_bfloat16, ERP>(g, wt, it, ft, s, b, dx, nb, h, wd, cin,
                                     cout, reach, st);
  } else {
    launch_input<float, ERP>(g, wt, it, ft, s, b, dx, nb, h, wd, cin, cout,
                             reach, st);
  }
  return (int)cudaGetLastError();
}

template <bool ERP>
int run_weight(int bf16, const void* x, const void* g, const void* itab,
               const void* ftab, void* part, void* dw, int nb, int h, int wd,
               int cin, int cout, int nsplit, int chunk, void* stream) {
  const int4* it = static_cast<const int4*>(itab);
  const float4* ft = static_cast<const float4*>(ftab);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_weight<__nv_bfloat16, ERP>(x, g, it, ft, pt, nb, h, wd, cin, cout,
                                      nsplit, chunk, st);
  } else {
    launch_weight<float, ERP>(x, g, it, ft, pt, nb, h, wd, cin, cout, nsplit,
                              chunk, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)TAPS * cin * cout;
  const int blocks = (int)min((n + 255) / 256, 4096LL);
  reduce_splits_kernel<<<blocks, 256, 0, st>>>(pt, static_cast<float*>(dw), n,
                                               nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// g: (nb, h, wd, cout) with h = 2*wd; wt: (9, cout, cin), the forward's
// (9, cin, cout) weight with its channel axes swapped; itab, ftab: the
// forward's shift tables, (wd, 9) int4 and float4; scale, bias: (cin,) f32
// ones and zeros (the shared epilogue's affine); dx: (nb, h, wd, cin).
// reach: the largest |c - j| between an input column c and an output column
// j that samples it. g, wt and dx are f32 (bf16 == 0) or bf16 (bf16 == 1).
// Returns cudaGetLastError() after the launch.
extern "C" int sphere_conv_bwd_input(int bf16, const void* g, const void* wt,
                                     const void* itab, const void* ftab,
                                     const void* scale, const void* bias,
                                     void* dx, int nb, int h, int wd, int cin,
                                     int cout, int reach, void* stream) {
  return run_input<false>(bf16, g, wt, itab, ftab, scale, bias, dx, nb, h, wd,
                          cin, cout, reach, stream);
}

// The same on an ERP map (wd = 2*h) with the ERP shift tables, (h, 9) int4
// (sigma, r0, r1, drop_col) and float4; reach: the largest |c - i| between
// an input row c and an output row i that samples it.
extern "C" int sphere_conv_erp_bwd_input(int bf16, const void* g,
                                         const void* wt, const void* itab,
                                         const void* ftab, const void* scale,
                                         const void* bias, void* dx, int nb,
                                         int h, int wd, int cin, int cout,
                                         int reach, void* stream) {
  return run_input<true>(bf16, g, wt, itab, ftab, scale, bias, dx, nb, h, wd,
                         cin, cout, reach, stream);
}

// x: (nb, h, wd, cin) with h = 2*wd; g: (nb, h, wd, cout); itab, ftab: the
// forward's shift tables; part: (nsplit, 9 * cin, cout) f32 scratch; dw:
// (9, cin, cout) f32. The pixels are split into nsplit ranges of chunk
// pixels (nsplit * chunk >= nb * h * wd). x and g are f32 (bf16 == 0) or
// bf16 (bf16 == 1). Returns cudaGetLastError() after the two launches.
extern "C" int sphere_conv_bwd_weight(int bf16, const void* x, const void* g,
                                      const void* itab, const void* ftab,
                                      void* part, void* dw, int nb, int h,
                                      int wd, int cin, int cout, int nsplit,
                                      int chunk, void* stream) {
  return run_weight<false>(bf16, x, g, itab, ftab, part, dw, nb, h, wd, cin,
                           cout, nsplit, chunk, stream);
}

// The same on an ERP map (wd = 2*h) with the ERP shift tables.
extern "C" int sphere_conv_erp_bwd_weight(int bf16, const void* x,
                                          const void* g, const void* itab,
                                          const void* ftab, void* part,
                                          void* dw, int nb, int h, int wd,
                                          int cin, int cout, int nsplit,
                                          int chunk, void* stream) {
  return run_weight<true>(bf16, x, g, itab, ftab, part, dw, nb, h, wd, cin,
                          cout, nsplit, chunk, stream);
}
