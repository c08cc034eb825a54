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
// sphere_conv_bwd_weight (dw), on the tensor cores. dw[k, ci, co] = sum
// over the N*H*W pixels p of col[p, k, ci] * g[p, co], col being the
// forward's blended sample, rebuilt from the forward's B x 9 shift tables
// (int4 (sigma, b0, b1, drop), float4 the corner weights) with the
// forward's edge rules. As the Pallas kernel forms g @ col^T, the kernel
// (bwd_weight_tc_kernel) computes dw^T: a GEMM of M = Cout (128 rows, two
// warpgroups), N = one tap x up to 128 input channels, K = pixels. A K
// stage is one run of 32 consecutive lanes of one band index, so the
// stage's shift-table entry is the same for the whole block: its two
// source band indices b0, b1 and its lane shift sigma.
//   wgmma reads a tf32 operand from shared memory only K-major, and K is
// the pixel axis while x and g are contiguous along channels, so one
// operand is transposed on chip. The layout taken (the recommended one):
//   A = g^T from registers. The block copies the run's 32 rows of g (128
//     channels each) by zero-fill cp.async into a tile whose 16-byte chunks
//     are XOR-swizzled by row / 8, and each thread reads its fragment's 16
//     values (output channels r0 and r0 + 8, pixels 8q .. 8q + 7) with no
//     bank conflict and splits them for 3xTF32, as conv_body splits its A.
//   B = col, K-major in shared memory, written by the threads. The block
//     copies the two corner tiles of the stage, 33 rows each (lanes (l0 +
//     sigma + t) mod L, t = 0 .. 32, of bands b0 and b1: a sample reads its
//     lane s and s + 1), zero-filled past the run's rows and past Cin. Each
//     thread blends 4 channels x 4 pixels on the FP32 pipes (four float4
//     reads a pixel, chunks XOR row & 7: conflict-free) and stores each
//     channel's four values, split into their TF32 parts, as one 16-byte
//     chunk of the 128-byte-swizzled B tile: the permutation of
//     ops/kmajor.py:pack applied to pixels (K position q + 4j holds pixel
//     8q + j) makes a thread's four pixels one chunk of B and its A
//     fragment two runs of 8 pixels, and keeps the stores conflict-free.
// The other orientation (col as A from registers, g^T written K-major)
// would gather 64 scalar corner values a thread per stage instead of 16
// float4s. B is double-buffered: the wgmma of stage s is issued, then the
// threads blend stage s + 1 into the other buffer, then they wait for the
// products, which go to a fresh fragment added on the FP32 pipes (the f32
// rule of igemm_tc.cuh; never one TF32 pass). Copies run three stages
// ahead in f32 (50 KB a stage at BN = 128, beside the two 32 KB B
// buffers), four in bf16. bf16 inputs are widened to f32 on read and take
// the same 3xTF32 route, so dw is the f32 sum for both types.
//   Split-K: blockIdx.z takes a range of `chunk` stages of the walk over
// (image, band index, run); each block writes its f32 partial sums to
// `part`, and a second kernel adds them in split order. On the TPU the
// sequential grid carried the sum across blocks; here blocks run in no
// order, and the fixed order of the second pass keeps dw deterministic,
// with no atomics. ops/sphere_conv.py:_weight_splits sizes the splits so
// the grid fills whole waves of the card's SMs.
//
// What bounds them on the card: each costs the forward's 2*9*Cin*Cout flops
// per pixel (295 kflop at 128 -> 128) against (Cin + Cout) values of
// traffic, so both are bound by arithmetic, on the tensor cores. dx: per
// stage a 128-row block moves ~1.9 halo tiles of 129 rows (the forward:
// four corner tiles of 128) plus the stage's B. Two tiles a stage rather
// than four leave room for three f32 stages in flight (66 KB each at BM =
// BN = 128) and for two bf16 blocks on an SM. dw: per stage of 32 pixels
// and 128 x 128 products a block copies 66 rows of x and 32 of g, blends
// 4096 samples and writes them twice (big and small), and both
// warpgroups read the B tile through wgmma: shared memory traffic about
// as long as the 3xTF32 products, which the double-buffered B overlaps.

#include "sphere_tc.cuh"

namespace {

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

// The dw tile: DW_BM = 128 output channels (two warpgroups of 64 rows), a
// K stage one run of DW_BK = 32 consecutive lanes of one band index, and
// its corner tiles DW_BK + 1 rows (a sample reads its lane s and s + 1).
constexpr int DW_BM = 128;
constexpr int DW_THREADS = 2 * DW_BM;
constexpr int DW_BK = 32;
constexpr int DW_HALO = DW_BK + 1;

// Bytes of one part of a B buffer (BN rows of the 32 K positions, f32), of
// a corner tile (DW_HALO rows of BN channels of x, whole 128-byte lines),
// of the g tile (DW_BK pixels of DW_BM channels), of a copy stage (two
// corner tiles and the g tile), the copy stages in flight (as many as fit
// beside the four B parts, at most four) and the block's dynamic shared
// memory.
template <int BN>
__host__ __device__ constexpr int dw_b_bytes() {
  return BN * tc::Cfg<float>::RB;
}
template <typename T, int BN>
__host__ __device__ constexpr int dw_corner_bytes() {
  return (DW_HALO * BN * (int)sizeof(T) + 127) / 128 * 128;
}
template <typename T>
__host__ __device__ constexpr int dw_g_bytes() {
  return DW_BK * DW_BM * (int)sizeof(T);
}
template <typename T, int BN>
__host__ __device__ constexpr int dw_stage_bytes() {
  return 2 * dw_corner_bytes<T, BN>() + dw_g_bytes<T>();
}
template <typename T, int BN>
__host__ __device__ constexpr int dw_stages() {
  const int fit =
      (tc::SMEM_MAX - 1024 - 4 * dw_b_bytes<BN>()) / dw_stage_bytes<T, BN>();
  return fit < 4 ? fit : 4;
}
template <typename T, int BN>
__host__ __device__ constexpr int dw_smem_bytes() {
  return 4 * dw_b_bytes<BN>() + dw_stages<T, BN>() * dw_stage_bytes<T, BN>() +
         1024;
}

// The byte offset of 16-byte chunk c of row t of a corner tile (rows of
// BN * sizeof(T) bytes, at least 128): the chunk XOR t & 7, so the eight
// threads that read one chunk column of eight consecutive rows hit eight
// different bank groups.
template <typename T, int BN>
__device__ __forceinline__ uint32_t dw_corner_at(int t, int c) {
  return t * BN * (int)sizeof(T) + ((c ^ (t & 7)) << 4);
}
// The byte offset of 16-byte chunk c of pixel row i of the g tile: the
// chunk XOR a function of i >> 3, so the four rows 8q + j (q = 0..3) that
// one A fragment load reads at once land in different bank groups.
template <typename T>
__device__ __forceinline__ uint32_t dw_g_at(int i, int c) {
  const int sw = sizeof(T) == 4 ? ((i >> 3) & 3) << 1 : (i >> 3) & 3;
  return i * DW_BM * (int)sizeof(T) + ((c ^ sw) << 4);
}
// Channels 4 cg .. 4 cg + 3 of row t of a corner tile, in f32.
template <typename T, int BN>
__device__ __forceinline__ float4 dw_corner4(const uint8_t* tile, int t,
                                             int cg) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(tile +
                                            dw_corner_at<T, BN>(t, cg));
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(
        tile + dw_corner_at<T, BN>(t, cg >> 1) + 8 * (cg & 1));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// dw partial sums, dw^T = g^T col per block: the GEMM M = Cout, N = one
// tap x BN input channels, K = the pixels of the block's split, one K
// stage per run of 32 lanes of one band index. Block (x, y, z): tap
// x / ntile and channels (x % ntile) * BN .., output channels y * DW_BM ..,
// stages [z * chunk, z * chunk + chunk) of the walk over (image, band
// index, run); it writes part[z][tap * Cin + ci][co].
template <typename T, int BN, bool ERP>
__global__ void __launch_bounds__(DW_THREADS, 1)
bwd_weight_tc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const int4* __restrict__ itab,
                     const float4* __restrict__ ftab,
                     float* __restrict__ part, int nb, int h, int wd,
                     int cin, int cout, int chunk) {
  constexpr int CH = 16 / sizeof(T);             // channels per chunk
  constexpr int XCPR = BN / CH;                  // chunks per corner row
  constexpr int GCPR = DW_BM / CH;               // chunks per g row
  constexpr int B_BYTES = dw_b_bytes<BN>();
  constexpr int CORNER = dw_corner_bytes<T, BN>();
  constexpr int STAGE = dw_stage_bytes<T, BN>();
  constexpr int STAGES = dw_stages<T, BN>();
  static_assert(BN * sizeof(T) >= 128, "corner rows of eight chunks or more");
  static_assert(B_BYTES % 1024 == 0 && STAGE % 128 == 0,
                "1024-byte aligned B parts, 128-byte aligned copy stages");
  static_assert(STAGES >= 3, "three copy stages in flight");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // B buffer b, part p (big, small) at (2 b + p) * B_BYTES; the copy
  // stages after them
  uint8_t* const stages = smem + 4 * B_BYTES;
  const uint32_t stages_u32 = base + 4 * B_BYTES;

  const int tid = threadIdx.x;
  const int ntile = (cin + BN - 1) / BN;
  const int tap = blockIdx.x / ntile;
  const int c0 = blockIdx.x % ntile * BN;
  const int m0 = blockIdx.y * DW_BM;
  const int nband = ERP ? h : wd, nlane = ERP ? wd : h;
  const int runs = (nlane + DW_BK - 1) / DW_BK;
  const long long total = (long long)nb * nband * runs;
  const long long s_lo = (long long)blockIdx.z * chunk;
  const int nsteps = (int)max(0LL, min((long long)chunk, total - s_lo));

  // the stage's image, band index, first lane and lanes (at most DW_BK)
  struct Run {
    long long img;
    int band, l0, rows;
  };
  auto run_of = [&](int step) {
    long long s = s_lo + step;
    Run r;
    r.l0 = (int)(s % runs) * DW_BK;
    s /= runs;
    r.band = (int)(s % nband);
    r.img = s / nband * h * wd;
    r.rows = min(DW_BK, nlane - r.l0);
    return r;
  };
  auto pixel = [&](long long img, int b, int l) {
    return img + (ERP ? (long long)b * wd + l : (long long)l * wd + b);
  };

  // The copies of a stage: the two corner tiles, row t the lane (l0 +
  // sigma + t) mod L of source band index b0 (tile 0) or b1 (tile 1), live
  // for t <= rows (the rows a sample of the run reads); the g tile, row i
  // output lane l0 + i, live for i < rows. Every copy is issued, zero-
  // filled where it is not live and past Cin or Cout.
  auto load = [&](int step, int slot) {
    const Run r = run_of(step);
    const int4 it = __ldg(itab + r.band * TAPS + tap);
    int sl = r.l0 + it.x;
    if (sl >= nlane) sl -= nlane;
    const uint32_t su = stages_u32 + slot * STAGE;
    for (int idx = tid; idx < 2 * DW_HALO * XCPR; idx += DW_THREADS) {
      const int e = idx / (DW_HALO * XCPR);
      const int t = idx / XCPR % DW_HALO, cc = idx % XCPR;
      const int ci = c0 + cc * CH;
      int l = sl + t;
      if (l >= nlane) l -= nlane;
      const bool ok = t <= r.rows && ci < cin;
      tc::cp_async16(
          su + e * CORNER + dw_corner_at<T, BN>(t, cc),
          ok ? x + pixel(r.img, e ? it.z : it.y, l) * cin + ci : x, ok);
    }
    for (int idx = tid; idx < DW_BK * GCPR; idx += DW_THREADS) {
      const int i = idx / GCPR, cc = idx % GCPR;
      const int co = m0 + cc * CH;
      const bool ok = i < r.rows && co < cout;
      tc::cp_async16(su + 2 * CORNER + dw_g_at<T>(i, cc),
                     ok ? g + pixel(r.img, r.band, r.l0 + i) * cout + co : g,
                     ok);
    }
  };

  // The blend of a stage into B buffer `buf`: thread (j = tid % 8, cg =
  // tid / 8) forms channels 4 cg .. 4 cg + 3 of the stage's pixels j,
  // j + 8, j + 16 and j + 24, in f32, and stores each channel's four
  // values, split into their TF32 parts, as chunk j of B row 4 cg + c: K
  // position q + 4 j holds pixel 8 q + j (ops/kmajor.py:pack's permutation,
  // on the pixels), so that the A fragment's values are 8 consecutive
  // pixels. A pixel past the run, or on the drop lane, is zero; the
  // successor of lane L - 1 weighs zero.
  const int bj = tid & 7, cg = tid >> 3;
  auto blend = [&](int step, int slot, int buf) {
    if (cg >= BN / 4) return;
    const Run r = run_of(step);
    const int4 it = __ldg(itab + r.band * TAPS + tap);
    const float4 f = __ldg(ftab + r.band * TAPS + tap);
    int sl = r.l0 + it.x;
    if (sl >= nlane) sl -= nlane;
    const uint8_t* t0 = stages + slot * STAGE;
    const uint8_t* t1 = t0 + CORNER;
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = bj + 8 * u;
      if (i < r.rows && r.l0 + i != it.w) {
        int s = sl + i;
        if (s >= nlane) s -= nlane;
        const bool seam = s == nlane - 1;
        const float fy = seam ? 0.f : f.y, fw = seam ? 0.f : f.w;
        const float4 a0 = dw_corner4<T, BN>(t0, i, cg);
        const float4 a1 = dw_corner4<T, BN>(t0, i + 1, cg);
        const float4 b0 = dw_corner4<T, BN>(t1, i, cg);
        const float4 b1 = dw_corner4<T, BN>(t1, i + 1, cg);
        const float p0[4] = {a0.x, a0.y, a0.z, a0.w};
        const float p1[4] = {a1.x, a1.y, a1.z, a1.w};
        const float q0[4] = {b0.x, b0.y, b0.z, b0.w};
        const float q1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s4 = f.x * p0[c];
          s4 = fmaf(fy, p1[c], s4);
          s4 = fmaf(f.z, q0[c], s4);
          v[u][c] = fmaf(fw, q1[c], s4);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[u][c] = 0.f;
      }
    }
    uint8_t* bb = smem + 2 * buf * B_BYTES;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 4 * cg + c;
      uint32_t big[4], small[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        big[u] = tc::tf32_rna(v[u][c]);
        small[u] = tc::tf32_rna(v[u][c] - __uint_as_float(big[u]));
      }
      const uint32_t off = tc::swizzle<float>(n, bj);
      *reinterpret_cast<uint4*>(bb + off) =
          make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(bb + B_BYTES + off) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  // this thread's A fragment rows (output channels) r0 and r0 + 8 of the
  // tile, and its quad index: its values are pixels 8q .. 8q + 7
  const int r0 = wg * 64 + warp * 16 + lane / 4, q = lane % 4;

  if (nsteps > 0) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nsteps) load(st, st);
      tc::cp_async_commit();
    }
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    blend(0, 0, 0);
    tc::fence_proxy_async();
  }
  for (int step = 0; step < nsteps; ++step) {
    // Stage step + 1 has landed for every thread; every thread has stored
    // and fenced its blend of stage `step`; every warpgroup has waited out
    // its products of stage step - 1, so the B buffer and the copy slot
    // that those read are free.
    tc::cp_async_wait<STAGES - 3>();
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < nsteps) load(next, next % STAGES);
    tc::cp_async_commit();

    // A: g^T at output channels r0 (+ 8), pixels 8q .. 8q + 7
    const uint8_t* gt = stages + step % STAGES * STAGE + 2 * CORNER;
    uint32_t big[4][4], small[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * q + 2 * kk + (e >> 1);
        const int col = r0 + 8 * (e & 1);
        const T* p = reinterpret_cast<const T*>(gt + dw_g_at<T>(i, col / CH)) +
                     col % CH;
        const float a = tc::to_f32(*p);
        big[kk][e] = tc::tf32_rna(a);
        small[kk][e] = tc::tf32_rna(a - __uint_as_float(big[kk][e]));
      }
    }
    const uint32_t sb = base + 2 * (step & 1) * B_BYTES;
    const uint64_t db = tc::make_desc<float>(sb);
    const uint64_t ds = tc::make_desc<float>(sb + B_BYTES);
    // The stage's products go to a fresh fragment, added on the FP32 pipes
    // (igemm_tc.cuh:mma_stage_f32), issued before the blend of the next
    // stage and waited after it.
    float prod[BN / 2];
    tc::pin(prod);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::mma_tf32<BN>(prod, small[kk], db + 2 * kk, kk > 0);
      tc::mma_tf32<BN>(prod, big[kk], ds + 2 * kk, 1);
      tc::mma_tf32<BN>(prod, big[kk], db + 2 * kk, 1);
    }
    tc::wgmma_commit();
    if (step + 1 < nsteps) {
      blend(step + 1, (step + 1) % STAGES, (step + 1) & 1);
      tc::fence_proxy_async();
    }
    tc::wgmma_wait_all();
    tc::pin(prod);
    tc::pin(big);
    tc::pin(small);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += prod[i];
  }
  tc::cp_async_wait<0>();

  // fragment element 4j + 2hh + e: output channel m0 + r0 + 8hh, input
  // channel c0 + 8j + 2q + e
  float* out = part + (long long)blockIdx.z * TAPS * cin * cout;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = m0 + r0 + 8 * hh, ci = c0 + 8 * j + 2 * q + e;
        if (co < cout && ci < cin) {
          out[((long long)tap * cin + ci) * cout + co] =
              acc[4 * j + 2 * hh + e];
        }
      }
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

template <typename T, int BN, bool ERP>
cudaError_t launch_dw_tile(const void* x, const void* g, const int4* itab,
                           const float4* ftab, float* part, int nb, int h,
                           int wd, int cin, int cout, int nsplit, int chunk,
                           cudaStream_t stream) {
  constexpr int smem = dw_smem_bytes<T, BN>();
  const auto kernel = bwd_weight_tc_kernel<T, BN, ERP>;
  static bool sized[tc::MAX_DEVICES] = {};
  const cudaError_t e = tc::size_smem(kernel, smem, sized);
  if (e != cudaSuccess) return e;
  const dim3 grid(TAPS * ((cin + BN - 1) / BN), (cout + DW_BM - 1) / DW_BM,
                  nsplit);
  kernel<<<grid, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), itab, ftab, part,
      nb, h, wd, cin, cout, chunk);
  return cudaGetLastError();
}

// BN = 128 input channels a block past Cin 64, else 64.
template <typename T, bool ERP>
cudaError_t launch_dw(const void* x, const void* g, const int4* itab,
                      const float4* ftab, float* part, int nb, int h, int wd,
                      int cin, int cout, int nsplit, int chunk,
                      cudaStream_t stream) {
  if (cin > 64) {
    return launch_dw_tile<T, 128, ERP>(x, g, itab, ftab, part, nb, h, wd, cin,
                                       cout, nsplit, chunk, stream);
  }
  return launch_dw_tile<T, 64, ERP>(x, g, itab, ftab, part, nb, h, wd, cin,
                                    cout, nsplit, chunk, stream);
}

template <bool ERP>
int run_weight(int bf16, const void* x, const void* g, const void* itab,
               const void* ftab, void* part, void* dw, int nb, int h, int wd,
               int cin, int cout, int nsplit, int chunk, void* stream) {
  if (cin % 8 != 0 || cout % 8 != 0 || cin < 1 || cout < 1 || nsplit < 1 ||
      chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int4* it = static_cast<const int4*>(itab);
  const float4* ft = static_cast<const float4*>(ftab);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_dw<__nv_bfloat16, ERP>(x, g, it, ft, pt, nb, h, wd, cin,
                                           cout, nsplit, chunk, st)
           : launch_dw<float, ERP>(x, g, it, ft, pt, nb, h, wd, cin, cout,
                                   nsplit, chunk, st);
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

// x: (nb, h, wd, cin) with h = 2*wd; g: (nb, h, wd, cout); cin and cout
// multiples of 8, x and g 16-byte aligned; itab, ftab: the forward's shift
// tables; part: (nsplit, 9 * cin, cout) f32 scratch; dw: (9, cin, cout)
// f32. The K stages, one per run of 32 lanes of a band index of an image
// (nb * wd * ceil(h / 32) of them), are split into nsplit ranges of chunk
// stages (nsplit * chunk >= their count). x and g are f32 (bf16 == 0) or
// bf16 (bf16 == 1). Returns cudaErrorInvalidValue for a cin or cout off 8,
// else cudaGetLastError() after the two launches.
extern "C" int sphere_conv_bwd_weight(int bf16, const void* x, const void* g,
                                      const void* itab, const void* ftab,
                                      void* part, void* dw, int nb, int h,
                                      int wd, int cin, int cout, int nsplit,
                                      int chunk, void* stream) {
  return run_weight<false>(bf16, x, g, itab, ftab, part, dw, nb, h, wd, cin,
                           cout, nsplit, chunk, stream);
}

// The same on an ERP map (wd = 2*h) with the ERP shift tables; its K
// stages are runs of 32 lanes of a row: nb * h * ceil(wd / 32) of them.
extern "C" int sphere_conv_erp_bwd_weight(int bf16, const void* x,
                                          const void* g, const void* itab,
                                          const void* ftab, void* part,
                                          void* dw, int nb, int h, int wd,
                                          int cin, int cout, int nsplit,
                                          int chunk, void* stream) {
  return run_weight<true>(bf16, x, g, itab, ftab, part, dw, nb, h, wd, cin,
                          cout, nsplit, chunk, stream);
}
