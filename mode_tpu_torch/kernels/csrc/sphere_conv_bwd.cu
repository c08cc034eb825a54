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
// layout branch. The forward's output pixel with band index j and lane
// index l samples at tap k the lane s = (l + sigma[j,k]) mod L and its
// successor, in the source band indices b0[j,k] and b1[j,k], with four
// corner weights; the successor of lane L-1 is not wrapped, and the whole
// sample of the lane drop[j,k] is zero.
//
// sphere_conv_bwd_input (dx), on the tensor cores. The exact transpose of
// the forward's gather + GEMM: an implicit GEMM with M = dx pixels, N = Cin,
// K = 9 taps x Cout, whose A value at (input pixel (c, l), tap k, channel
// co) sums g[., co] over the output samples that read the pixel, and whose
// B for tap k is W[k]^T: the forward's (9, Cin, Cout) weight read K-major,
// packed by ops/kmajor.py (f32: Cout padded to whole stages, permuted, split
// for 3xTF32). Where the Pallas kernel forms dcol = W g per block of bands
// and overlap-adds it back with lane rolls and a +-2-band halo, here each dx
// row gathers its own sum, so dx is deterministic with no atomics.
//   The transposed table (ops/sphere_conv.py:transpose_table, built once
// per map): for each input band index c and tap k, the at most MAXE = 4
// output band indices j that read c with a nonzero corner weight, each as
// int4 (j, sigma[j,k], drop[j,k], count) and float2 (a_s, a_n), the summed
// weights of its (., s) corners and of its successor corners; count is the
// number of such j (1.88 on average at the layer-4 maps, 0 to 4). Output
// lane (l - sigma) mod L reads (c, l) through an (., s) corner and
// (l - 1 - sigma) mod L through a successor corner. The edge rules,
// transposed: lane 0 takes nothing through a successor corner; a corner read
// by the output lane drop[j,k] carries nothing; clamped band indices have
// weight zero and are not in the table.
//   A block owns one image, one band index c and BM consecutive lanes l0 ..
// l0 + BM - 1 (rows past L, where L < BM or L is no multiple of BM, are
// masked: copied as zeros, never stored), so everything that depends on
// (c, k) is the same for the whole block; it copies band c's 9 x MAXE table
// entries into shared memory first. A K stage is one pass over a live tap
// x 32 channels of g: a tap of c with no entry has A = 0 and is skipped,
// for the whole block, and a tap's entries go through in passes of MAXT =
// 2 (the rare taps with 3 or 4 entries take two passes with the same B,
// whose products add up in the accumulator: A is linear in the entries).
// For each entry e of the pass the stage copies one halo tile of BM + 1
// rows of g from band j_e, output lanes (l0 - sigma - 1 .. l0 + BM - 1 -
// sigma) mod L, each row's index wrapped, by zero-fill cp.async into
// igemm_tc.cuh's swizzled layout: tile row r + 1 is row r's (., s) corner
// and tile row r its successor corner. Every copy of a live entry is
// issued, zero-filled past Cout and on masked rows, so no stale shared
// memory meets a weight. Each thread then blends its fragment's values
// from the pass's tiles on the FP32 pipes, with per-row weights a_s (0 where
// the s-lane is the drop lane) and a_n (0 where l = 0 or the successor
// lane is the drop lane), and issues wgmma with A from registers
// (sphere_tc.cuh, as sphere_conv.cu does after its blend): f32 as 3xTF32,
// each stage's products into a fresh fragment added on the FP32 pipes;
// bf16 blended in f32 and rounded once. The epilogue writes dx in g's type
// at (n, band c, lane l): Cassini (row l, column c), ERP (row c, column l).
//
// sphere_conv_bwd_weight (dw), on the FP32 pipes. dw[k, ci, co] = sum over
// the N*H*W pixels of col[p, k, ci] * g[p, co], col being the forward's
// blended sample, rebuilt from the forward's B x 9 shift tables (int4
// (sigma, b0, b1, drop), float4 the corner weights) as sphere_conv.cu's A
// gather builds it. A GEMM of M = 9*Cin, N = Cout and K = pixels:
// blockIdx.z splits the pixels into `nsplit` ranges, each block writes its
// f32 partial sums, and a second kernel adds the partials in split order.
// On the TPU the sequential grid carried the sum across blocks; here blocks
// run in no order, and the fixed order of the second pass keeps dw
// deterministic. It accumulates in f32, for bf16 inputs too.
//
// What bounds them on the card: each costs the forward's 2*9*Cin*Cout flops
// per pixel (295 kflop at 128 -> 128) against (Cin + Cout) values of
// traffic, so both are bound by arithmetic. dx runs it on the tensor cores;
// per stage a 128-row block moves ~1.9 halo tiles of 129 rows (the
// forward: four corner tiles of 128) plus the stage's B. Two tiles a stage
// rather than four leave room for three f32 stages in flight (66 KB each
// at BM = BN = 128) and for two bf16 blocks on an SM. dw still runs on
// igemm.cuh's FP32-pipe tile machinery, its own tile loop of the same shape.

#include "igemm.cuh"
#include "sphere_tc.cuh"

namespace {

using igemm::BK;  // the dw kernel's channels per K step (dx: tc::BK)
using igemm::NT;  // the dw kernel's threads per block
constexpr int TAPS = 9;
constexpr int MAXE = 4;  // output band indices per (input band index, tap)
// Halo tiles per dx stage: a tap's entries go through in passes of MAXT.
// 2 leaves room for three f32 stages, or two bf16 blocks an SM
// (scripts/sphere_dx_tiles.py times 1, 2 and 4).
constexpr int MAXT = 2;
// static shared memory of the dx kernel: its band's table rows and the
// block's list of (tap, pass)
constexpr int DX_TABLE_BYTES = TAPS * MAXE * (16 + 8) + MAXE * TAPS + 4;

// ---- dx --------------------------------------------------------------------

// Bytes of one halo tile (BM + 1 stage rows, whole 128-byte lines), of a
// stage (the weight parts, 1024-byte aligned for their descriptors, then
// MAXT halo tiles), the stages in flight (as many as fit beside the
// table's static shared memory, at most four) and the dynamic shared
// memory of a block.
template <typename T, int BM>
__host__ __device__ constexpr int dx_tile_bytes() {
  return ((BM + 1) * tc::Cfg<T>::RB + 127) / 128 * 128;
}
template <typename T, int BM, int BN>
__host__ __device__ constexpr int dx_stage_bytes() {
  return (tc::Cfg<T>::PARTS * BN * tc::Cfg<T>::RB +
          MAXT * dx_tile_bytes<T, BM>() + 1023) /
         1024 * 1024;
}
template <typename T, int BM, int BN>
__host__ __device__ constexpr int dx_stages() {
  const int fit =
      (tc::SMEM_MAX - 1024 - DX_TABLE_BYTES) / dx_stage_bytes<T, BM, BN>();
  return fit < 4 ? fit : 4;
}
template <typename T, int BM, int BN>
__host__ __device__ constexpr int dx_smem_bytes() {
  return dx_stages<T, BM, BN>() * dx_stage_bytes<T, BM, BN>() + 1024;
}

// g: (nb, h, wd, cout); wbig, wsmall: the weight (9, Cin, Cout) K-major as
// ops/kmajor.py packs it (f32: Cout padded to whole stages, two parts;
// bf16: whole, wsmall unused); etab, wtab: the transposed table, (B, 9,
// MAXE) int4 (j, sigma, drop, count) and float2 (a_s, a_n); dx: (nb, h, wd,
// cin).
template <typename T, int BM, int BN, bool ERP>
__global__ void __launch_bounds__(2 * BM)
bwd_input_tc_kernel(const T* __restrict__ g, const T* __restrict__ wbig,
                    const T* __restrict__ wsmall,
                    const int4* __restrict__ etab,
                    const float2* __restrict__ wtab, T* __restrict__ dx,
                    int nb, int h, int wd, int cin, int cout) {
  using C = tc::Cfg<T>;
  constexpr int THREADS = 2 * BM;        // one warpgroup per 64 rows
  constexpr int CH = 16 / sizeof(T);     // channels per 16-byte chunk
  constexpr int CPR = C::RB / 16;        // chunks per stage row
  constexpr int B_BYTES = BN * C::RB;
  constexpr int A_OFF = C::PARTS * B_BYTES;  // the first halo tile
  constexpr int TILE = dx_tile_bytes<T, BM>();
  constexpr int STAGE = dx_stage_bytes<T, BM, BN>();
  constexpr int STAGES = dx_stages<T, BM, BN>();
  static_assert(BM % 64 == 0, "whole warpgroups");
  static_assert(STAGE % 1024 == 0 && B_BYTES % 1024 == 0 && TILE % 128 == 0,
                "1024-byte aligned weight tiles, 128-byte aligned halo tiles");
  static_assert(STAGES >= 2, "two stages in flight");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int nband = ERP ? h : wd, nlane = ERP ? wd : h;
  // the block's image, band index c and lanes l0 .. l0 + rows - 1
  const int tiles = (nlane + BM - 1) / BM;
  long long blk = blockIdx.x;
  const int l0 = (int)(blk % tiles) * BM;
  blk /= tiles;
  const int c = (int)(blk % nband);
  const long long img = blk / nband * h * wd;
  const int rows = min(BM, nlane - l0);
  const int n0 = blockIdx.y * BN;
  const int nkc = (cout + tc::BK - 1) / tc::BK;
  // The f32 weight's Cout is padded to whole stages (host-side pack).
  const int wcout = C::PARTS == 2 ? nkc * tc::BK : cout;
  // the pixel index of (band index b, lane index l) in the block's image
  auto pixel = [&](int b, int l) {
    return img + (ERP ? (long long)b * wd + l : (long long)l * wd + b);
  };

  // Band c's rows of the transposed table, in shared memory: every stage
  // reads its tap's entries before its copies and before its blend. The
  // block's work: each tap of c with an entry (a tap without one has A = 0
  // and is skipped), in passes of MAXT entries, 4 bits of tap and the pass
  // above them, in K order.
  __shared__ int4 ent[TAPS * MAXE];
  __shared__ float2 ewt[TAPS * MAXE];
  __shared__ uint8_t work[MAXE * TAPS];
  __shared__ int nwork;
  static_assert(sizeof(ent) + sizeof(ewt) + sizeof(work) + sizeof(nwork) ==
                    DX_TABLE_BYTES,
                "static shared memory");
  if (tid < TAPS * MAXE) {
    ent[tid] = etab[(long long)c * TAPS * MAXE + tid];
    ewt[tid] = wtab[(long long)c * TAPS * MAXE + tid];
  }
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < TAPS; ++k) {
      const int cnt = etab[((long long)c * TAPS + k) * MAXE].w;
      for (int p = 0; p * MAXT < cnt; ++p) work[n++] = (uint8_t)(k | p << 4);
    }
    nwork = n;
  }
  __syncthreads();
  const int nsteps = nwork * nkc;

  auto load = [&](int step, int slot) {
    const int item = work[step / nkc];
    const int tap = item & 15, e0 = (item >> 4) * MAXT;
    const int kc = step % nkc;
    const uint32_t sa = base + slot * STAGE;
    // B: row n is dx channel n0 + n, its stage of the tap's Cout channels
#pragma unroll
    for (int idx = tid; idx < BN * CPR; idx += THREADS) {
      const int n = idx / CPR, cc = idx % CPR;
      const int ci = n0 + n, chb = kc * tc::BK + cc * CH;
      const bool ok = ci < cin && chb < wcout;
      const long long off = ((long long)tap * cin + ci) * wcout + chb;
      const uint32_t dst = sa + tc::swizzle<T>(n, cc);
      tc::cp_async16(dst, ok ? wbig + off : wbig, ok);
      if constexpr (C::PARTS == 2) {
        tc::cp_async16(dst + B_BYTES, ok ? wsmall + off : wsmall, ok);
      }
    }
    // A: the halo tile of each entry of the pass; tile row t is output
    // lane (l0 - sigma - 1 + t) mod L of band j, live for t <= rows (the
    // lanes of the rows inside the band and one before them, never past
    // L - 1)
    const int4* te = ent + tap * MAXE + e0;
    const int cnt = te[0].w - e0;
#pragma unroll
    for (int e = 0; e < MAXT; ++e) {
      if (e < cnt) {
        const int4 it = te[e];
        const uint32_t st = sa + A_OFF + e * TILE;
        for (int idx = tid; idx < (BM + 1) * CPR; idx += THREADS) {
          const int t = idx / CPR, cc = idx % CPR;
          const int ch = kc * tc::BK + cc * CH;
          int l = l0 - it.y - 1 + t;
          if (l < 0) l += nlane;
          const bool ok = t <= rows && ch < cout;
          tc::cp_async16(st + tc::swizzle<T>(t, cc),
                         ok ? g + pixel(it.x, l) * cout + ch : g, ok);
        }
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
    const uint8_t* ta = smem + slot * STAGE + A_OFF;
    const int item = work[step / nkc];
    const int tap = item & 15, e0 = (item >> 4) * MAXT;
    const int4* te = ent + tap * MAXE + e0;
    const float2* tw = ewt + tap * MAXE + e0;
    const int cnt = te[0].w - e0;
    sph::Blend<T> a;
    a.zero();
#pragma unroll
    for (int e = 0; e < MAXT; ++e) {
      if (e < cnt) {
        const int4 it = te[e];
        const float2 f = tw[e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 8 * hh, l = l0 + r;
          // the output lanes that read (c, l) through an (., s) corner and
          // through a successor corner
          int ls = l - it.y;
          if (ls < 0) ls += nlane;
          const int ln = ls == 0 ? nlane - 1 : ls - 1;
          const float ws = ls == it.z ? 0.f : f.x;
          const float wn = l == 0 || ln == it.z ? 0.f : f.y;
          a.add(hh, ta + e * TILE, r + 1, q, ws);
          a.add(hh, ta + e * TILE, r, q, wn);
        }
      }
    }
    a.template mma<BN>(acc, base + slot * STAGE);
  }
  tc::cp_async_wait<0>();
  tc::epilogue<T, BN>(acc, 0, rows, n0, cin, nullptr, nullptr, nullptr, dx, 0,
                      [&](long long r) {
                        return pixel(c, l0 + (int)r) * cin;
                      });
}

template <typename T, int BM, int BN, bool ERP>
cudaError_t launch_dx_tile(const void* g, const void* wbig,
                           const void* wsmall, const int4* etab,
                           const float2* wtab, void* dx, int nb, int h,
                           int wd, int cin, int cout, cudaStream_t stream) {
  constexpr int smem = dx_smem_bytes<T, BM, BN>();
  const auto kernel = bwd_input_tc_kernel<T, BM, BN, ERP>;
  static bool sized[tc::MAX_DEVICES] = {};
  const cudaError_t e = tc::size_smem(kernel, smem, sized);
  if (e != cudaSuccess) return e;
  const int nband = ERP ? h : wd, nlane = ERP ? wd : h;
  const long long blocks = (long long)nb * nband * ((nlane + BM - 1) / BM);
  const dim3 grid((unsigned)blocks, (cin + BN - 1) / BN);
  kernel<<<grid, 2 * BM, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wbig),
      static_cast<const T*>(wsmall), etab, wtab, static_cast<T*>(dx), nb, h,
      wd, cin, cout);
  return cudaGetLastError();
}

// The tile, as sphere_conv.cu's: BN = 128 covers Cin 128 in one block (64
// up to 64); BM = 128 where that still gives every SM a block, else 64.
template <typename T, bool ERP>
cudaError_t launch_dx(const void* g, const void* wbig, const void* wsmall,
                      const int4* etab, const float2* wtab, void* dx, int nb,
                      int h, int wd, int cin, int cout, cudaStream_t stream) {
  const int nband = ERP ? h : wd, nlane = ERP ? wd : h;
  const bool tall = (long long)nb * nband * ((nlane + 127) / 128) >= 132;
#define DX_LAUNCH(BM_, BN_)                                                  \
  return launch_dx_tile<T, BM_, BN_, ERP>(g, wbig, wsmall, etab, wtab, dx,  \
                                          nb, h, wd, cin, cout, stream)
  if (cin > 64) {
    if (tall) DX_LAUNCH(128, 128);
    DX_LAUNCH(64, 128);
  }
  if (tall) DX_LAUNCH(128, 64);
  DX_LAUNCH(64, 64);
#undef DX_LAUNCH
}

template <bool ERP>
int run_input(int bf16, const void* g, const void* wbig, const void* wsmall,
              const void* etab, const void* wtab, void* dx, int nb, int h,
              int wd, int cin, int cout, void* stream) {
  if (cout % 8 != 0 || cin < 1) return (int)cudaErrorInvalidValue;
  const int4* et = static_cast<const int4*>(etab);
  const float2* wt = static_cast<const float2*>(wtab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_dx<__nv_bfloat16, ERP>(g, wbig, wsmall, et, wt, dx, nb,
                                           h, wd, cin, cout, st)
           : launch_dx<float, ERP>(g, wbig, wsmall, et, wt, dx, nb, h, wd,
                                   cin, cout, st);
  return (int)e;
}

// ---- dw --------------------------------------------------------------------

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

// g: (nb, h, wd, cout) with h = 2*wd, cout a multiple of 8, 16-byte
// aligned; wbig, wsmall: the forward's (9, cin, cout) weight, tap kh*3 + kw,
// K-major over cout as ops/kmajor.py packs it: f32 split into its tf32
// parts (wbig + wsmall = w, cout padded to whole stages of 32 and permuted
// within each), bf16 whole (wsmall unused); etab, wtab: the transposed
// table of the Cassini shift tables, (wd, 9, 4) int4 (j, sigma, drop_row,
// count) and float2 (a_s, a_n); dx: (nb, h, wd, cin). g, w* and dx are f32
// (bf16 == 0) or bf16 (bf16 == 1). Returns cudaErrorInvalidValue for a cout
// that is no multiple of 8, else cudaGetLastError() after the launch.
extern "C" int sphere_conv_bwd_input(int bf16, const void* g,
                                     const void* wbig, const void* wsmall,
                                     const void* etab, const void* wtab,
                                     void* dx, int nb, int h, int wd, int cin,
                                     int cout, void* stream) {
  return run_input<false>(bf16, g, wbig, wsmall, etab, wtab, dx, nb, h, wd,
                          cin, cout, stream);
}

// The same on an ERP map (wd = 2*h), with the transposed table of the ERP
// shift tables, (h, 9, 4): int4 (i, sigma, drop_col, count), float2.
extern "C" int sphere_conv_erp_bwd_input(int bf16, const void* g,
                                         const void* wbig, const void* wsmall,
                                         const void* etab, const void* wtab,
                                         void* dx, int nb, int h, int wd,
                                         int cin, int cout, void* stream) {
  return run_input<true>(bf16, g, wbig, wsmall, etab, wtab, dx, nb, h, wd,
                         cin, cout, stream);
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
