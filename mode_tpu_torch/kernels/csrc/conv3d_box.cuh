// The box-tiled implicit GEMM of the bf16 stride-1 3x3x3 conv (K1/K6's
// tensor-core path at Cout 32 and 64, Cin 32 and 64; conv3d_s1.cu chooses
// it), for sm_90a.
//
// What it answers: igemm_tc.cuh:conv_body copies, for every K stage (one
// tap x 32 channels), each output row's input row from L2 into shared
// memory, so every input voxel crosses into shared memory 27 times and the
// weight slice once per tile: at Cout 32 a stage moves 10 KB for 64 x 32 x
// 32 MACs a warpgroup, several times the bytes a clock the L2 gives an SM,
// and the conv runs at the L2's pace, not the tensor cores'. Here a block
// copies the input box of its output box once per 32 input channels and
// every tap reads a shifted window of it in place; the block's 32-column
// slice of the weight stays in shared memory for the life of the block.
//
// The output box: TZ x TY x TX voxels (D, H, W) of one batch index, times
// BN = 32 output channels (blockIdx.y picks them: Cout 64 takes two). Its
// m64 tiles are 8 rows of H x 8 voxels of W at one D plane: a consumer
// warpgroup owns TZ / NWG planes x TX / 8 of them. The input box, (TZ + 2)
// x (TY + 2) x (TX + 2) voxels from (z0 - 1, y0 - 1, x0 - 1), is held as
// four planes of 8 channels, 16 bytes a voxel, voxels in (z, y, x) order:
// each plane one TMA box of a 5-D tensor map over x (C, W, H, D, N), whose
// zero fill outside the tensor, negative coordinates included, is the
// conv's padding. A tap (kd, kh, kw) of a tile is the window that starts
// at box voxel (z + kd, y + kh, x + kw): wgmma reads its A through a
// descriptor without swizzle (INTERLEAVE), whose 8 x 16-byte core matrices
// are 8 neighbouring voxels of one box row, the 8 rows of the tile SBO =
// one box row (TX + 2 voxels) apart and the two 8-channel halves of a k16
// step LBO = one channel plane apart; any voxel is a valid start, so the
// shifted windows need no copy. B is the weight's (tap, 32-channel chunk)
// tile, K-major with the 64-byte swizzle as in conv_body. The products
// accumulate in f32 over the whole K (27 taps x Cin); the epilogue writes
// act(acc * scale + bias (+ residual)) in bf16, the residual read while a
// tile's last products run.
//
// The block is persistent (one a streaming multiprocessor, over the
// tiles of its column slice, in W, H, D, batch order so that neighbouring
// boxes, which share their halo, run together) and split by role. All its
// threads copy the weight slice once (cp.async); then one thread of a
// producer warpgroup issues each step's box (a tile's next 32 input
// channels: four TMA boxes) into one of two buffers, and NWG consumer
// warpgroups run the step's 54 k16 products a tile. An mbarrier a buffer
// tells the consumers that its bytes landed; a named barrier a buffer
// (EMPTY) tells the producer that their products over it are done. So the
// next box's copy runs under this box's products. The producer gives up
// its registers to the consumers (setmaxnreg), which hold TZ / 2 x 2 m64
// tiles of f32 sums: 64 at depth 4.
//
// Measured on an H100: with the copies taken away the kernel runs as
// fast, so the products and their drain at each step's end bound it. A
// tile's sums start with a product of scale-d 0 rather than registers
// zeroed by the threads: zeroing them on the epilogue's path made ptxas
// serialise the wgmmas (25% slower). Overlapping a tile's epilogue with
// the next tile's products through two sets of sums was slower still.

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's prototype (no libcuda link)

#include "igemm_tc.cuh"

namespace tcbox {
namespace {

using bf16 = __nv_bfloat16;

constexpr int TY = 8, TX = 16;        // output box rows (H), voxels (W)
constexpr int PY = TY + 2, PX = TX + 2;
constexpr int BN = 32;                // output channels a block
constexpr int NWG = 2;                // consumer warpgroups
constexpr int NT = (NWG + 1) * 128;   // and one producer warpgroup
constexpr int W_TILE = BN * 64;       // one (tap, chunk) weight tile, bytes
constexpr int EMPTY = 1;              // named barriers EMPTY + buffer

template <int TZ>
struct Box {
  static constexpr int NVOX = (TZ + 2) * PY * PX;
  // one 8-channel plane, 16 bytes a voxel (a TMA box of (8, PX, PY, TZ +
  // 2) elements), 128-byte aligned as the bulk copy's destination must be
  static constexpr int PLANE = (NVOX * 16 + 127) / 128 * 128;
  static constexpr int BYTES = 4 * PLANE;       // 32 channels
  static constexpr int TILES = TZ / NWG * (TX / 8);  // m64 tiles a warpgroup
  static_assert(TZ % NWG == 0, "whole planes a warpgroup");
  static_assert(BN == 32, "mma_n32");
  static_assert(PLANE / 16 < (1 << 14), "LBO fits its field");
};

// Dynamic shared memory for Cin = 32 nkc: the 1024-byte alignment of the
// swizzled weight tiles, the weight, two boxes.
template <int TZ>
__host__ __device__ constexpr int smem_bytes(int nkc) {
  return 1024 + 27 * nkc * W_TILE + 2 * Box<TZ>::BYTES;
}
// The most 32-channel chunks of Cin whose weight fits beside two boxes.
template <int TZ>
constexpr int max_nkc() {
  return smem_bytes<TZ>(2) <= tc::SMEM_MAX ? 2 : 1;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// d = A * B (scale_d 0) or d += A * B (scale_d 1) over one K step of 16,
// m64n32k16 with A and B through descriptors: starting a tile's sums with
// scale_d 0 leaves the accumulators written by wgmma alone, never zeroed
// by the threads, which would make ptxas serialise the wgmmas.
__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
// The bulk tensor copy of one TMA box at coordinates (c, x, y, z, b),
// completing on mbarrier bar; zero outside the tensor.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int x, int y,
                                         int z, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(z),
      "r"(b), "r"(bar)
      : "memory");
}

// The INTERLEAVE (no swizzle) K-major descriptor of an A window starting at
// addr: core matrices of 8 rows x 16 bytes, LBO the next 8 channels (one
// plane), SBO the next 8 rows of the tile (one box row of PX voxels).
template <int TZ>
__device__ __forceinline__ uint64_t box_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(Box<TZ>::PLANE >> 4) << 16) |
         (static_cast<uint64_t>(PX) << 32);
}

// The tiles of the call, and where tile t's output box starts.
struct Walk {
  int nz, ny, nx;
  long long ntiles;
  __device__ __forceinline__ Walk(const tc::Shape& s, int tz)
      : nz((s.d + tz - 1) / tz), ny((s.h + TY - 1) / TY),
        nx((s.w + TX - 1) / TX) {
    ntiles = (long long)s.nb * nz * ny * nx;
  }
  __device__ __forceinline__ void origin(long long t, int tz, int& b,
                                         int& z0, int& y0, int& x0) const {
    x0 = (int)(t % nx) * TX;
    t /= nx;
    y0 = (int)(t % ny) * TY;
    t /= ny;
    z0 = (int)(t % nz) * tz;
    b = (int)(t / nz);
  }
};

// map: x (nb, d, h, w, cin) as a TMA tensor (launch's encode), cin 32 or
// 64; wk the K-major weight (27, cout, cin); res (may be null) and out
// (nb, d, h, w, cout), cout 32 or 64; scale, bias (cout,) f32 or null.
// Launched with NT threads and smem_bytes<TZ>(cin / 32), grid (blocks,
// cout / BN).
template <int TZ>
__global__ void __launch_bounds__(NT, 1)
conv3d_box_kernel(const __grid_constant__ CUtensorMap map,
                  const bf16* __restrict__ wk,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const bf16* __restrict__ res, bf16* __restrict__ out,
                  const tc::Shape s, int relu) {
  using B = Box<TZ>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[2];
  const uint32_t wbase = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const int nkc = s.cin / tc::BK;
  const uint32_t bbase = wbase + 27 * nkc * W_TILE;
  const uint32_t full = tc::smem_u32(full_bar);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.y * BN;
  const Walk walk(s, TZ);
  const long long mine =
      blockIdx.x < walk.ntiles ? (walk.ntiles - 1 - blockIdx.x) / gridDim.x + 1
                               : 0;
  const long long nsteps = mine * nkc;   // step j: tile j / nkc, chunk j % nkc

  // The weight, by every thread, once: tile (tap, kc) row n holds output
  // channel n0 + n's channels kc * 32 ... kc * 32 + 31.
  for (int i = tid; i < 27 * nkc * BN * 4; i += NT) {
    const int c = i & 3, n = i / 4 % BN, tk = i / (4 * BN);
    const int tap = tk / nkc, kc = tk - tap * nkc;
    tc::cp_async16(
        wbase + tk * W_TILE + tc::swizzle<bf16>(n, c),
        wk + ((long long)tap * s.cout + n0 + n) * s.cin + kc * tc::BK + c * 8,
        true);
  }
  tc::cp_async_commit();
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  __syncthreads();

  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // The producer warpgroup: each step's box, four TMA boxes of 8
    // channels issued by its first thread, into buffer j % 2 once the
    // consumers are done with step j - 2's.
    for (long long j = 0; j < nsteps; ++j) {
      const int buf = (int)(j & 1);
      if (j >= 2) bar_sync(EMPTY + buf);
      if (tid == NWG * 128) {
        int b, z0, y0, x0;
        walk.origin(blockIdx.x + j / nkc * gridDim.x, TZ, b, z0, y0, x0);
        const int ch = (int)(j % nkc) * tc::BK;
        const uint32_t dst = bbase + buf * B::BYTES;
        mbar_expect_tx(full + 8 * buf, 4 * B::NVOX * 16);
        for (int c = 0; c < 4; ++c) {
          tma_load(dst + c * B::PLANE, &map, full + 8 * buf, ch + c * 8,
                   x0 - 1, y0 - 1, z0 - 1, b);
        }
      }
      __syncwarp();
    }
    // take the consumers' last arrivals, so no barrier is left half used
    for (long long j = nsteps > 2 ? nsteps - 2 : 0; j < nsteps; ++j) {
      bar_sync(EMPTY + (int)(j & 1));
    }
    return;
  }

  // A consumer warpgroup: planes wg * TZ / NWG ... of the box, both halves
  // of W; tile t is plane t / (TX / 8), half t % (TX / 8).
  // 2 x 128 x 232 + 128 x 40 registers: the SM's 65536
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  constexpr int ZW = TZ / NWG, XH = TX / 8;
  const int warp = tid % 128 / 32, lane = tid % 32;
  // the thread's columns: 8 jn + 2 (lane % 4) and the next
  float2 sc[BN / 8], bi[BN / 8];
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int co = n0 + 8 * jn + 2 * (lane % 4);
    sc[jn] = scale != nullptr ? make_float2(scale[co], scale[co + 1])
                              : make_float2(1.f, 1.f);
    bi[jn] = scale != nullptr ? make_float2(bias[co], bias[co + 1])
                              : make_float2(0.f, 0.f);
  }
  float acc[B::TILES][BN / 2];   // a tile's first product sets them

  for (long long j = 0; j < nsteps; ++j) {
    const int buf = (int)(j & 1);
    const int kc = (int)(j % nkc);
    mbar_wait(full + 8 * buf, (int)((j >> 1) & 1));
    const uint64_t da =
        box_desc<TZ>(bbase + buf * B::BYTES + wg * ZW * PY * PX * 16);
    const uint64_t db = tc::make_desc<bf16>(wbase + kc * W_TILE);
#pragma unroll
    for (int t = 0; t < B::TILES; ++t) tc::pin(acc[t]);
    tc::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int kd = tap / 9, kh = tap / 3 % 3, kw = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // descriptor units are 16 bytes: one voxel of a plane
        const uint64_t dbk = db + tap * nkc * (W_TILE / 16) + 2 * kk;
#pragma unroll
        for (int t = 0; t < B::TILES; ++t) {
          const int v = ((t / XH + kd) * PY + kh) * PX + (t % XH) * 8 + kw;
          mma_n32(acc[t], da + v + kk * 2 * (B::PLANE / 16), dbk,
                  tap > 0 || kk > 0 || kc > 0);
        }
      }
    }
    tc::wgmma_commit();
    const bool last = kc == nkc - 1;

    // The tile's output rows: fragment element 4 jn + 2 hh + e of the
    // thread is tile row r = 16 warp + lane / 4 + 8 hh, i.e. box row
    // y0 + r / 8 and voxel x0 + 8 xh + r % 8, column 8 jn + 2 (lane % 4)
    // + e. On a tile's last step its residual is read while the products
    // run.
    int b = 0, z0 = 0, y0 = 0, x0 = 0;
    long long o[B::TILES][2];
    uint32_t rv[B::TILES][2][BN / 8];
    if (last) {
      walk.origin(blockIdx.x + j / nkc * gridDim.x, TZ, b, z0, y0, x0);
#pragma unroll
      for (int t = 0; t < B::TILES; ++t) {
        const int z = z0 + wg * ZW + t / XH;
        const int xo = x0 + (t % XH) * 8 + lane / 4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int y = y0 + 2 * warp + hh;
          o[t][hh] = z < s.d && y < s.h && xo < s.w
                         ? ((((long long)b * s.d + z) * s.h + y) * s.w + xo) *
                                   s.cout + n0 + 2 * (lane % 4)
                         : -1;
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn) {
            rv[t][hh][jn] =
                res != nullptr && o[t][hh] >= 0
                    ? *reinterpret_cast<const uint32_t*>(res + o[t][hh] +
                                                         8 * jn)
                    : 0u;
          }
        }
      }
    }
    tc::wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < B::TILES; ++t) tc::pin(acc[t]);
    bar_arrive(EMPTY + buf);
    if (!last) continue;

#pragma unroll
    for (int t = 0; t < B::TILES; ++t) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (o[t][hh] < 0) continue;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          float v0 = acc[t][4 * jn + 2 * hh] * sc[jn].x + bi[jn].x;
          float v1 = acc[t][4 * jn + 2 * hh + 1] * sc[jn].y + bi[jn].y;
          if (res != nullptr) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&rv[t][hh][jn]));
            v0 += r.x;
            v1 += r.y;
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          tc::store2(out + o[t][hh] + 8 * jn, v0, v1);
        }
      }
    }
  }
}

// The tensor map of x (nb, d, h, w, cin) bf16 for the box kernel: a TMA
// box of 8 channels x PX x PY x (TZ + 2) voxels x 1 batch index, zero
// outside the tensor (the conv's padding). The encoder is the driver's,
// reached through the runtime, so nothing links libcuda.
template <int TZ>
cudaError_t encode(CUtensorMap* map, const void* x, const tc::Shape& s) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorNotSupported;
    }
    fn = reinterpret_cast<Encode>(p);
  }
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[5] = {(cuuint64_t)s.cin, (cuuint64_t)s.w,
                              (cuuint64_t)s.h, (cuuint64_t)s.d,
                              (cuuint64_t)s.nb};
  const cuuint64_t strides[4] = {s.cin * e, s.w * s.cin * e,
                                 (cuuint64_t)s.h * s.w * s.cin * e,
                                 (cuuint64_t)s.d * s.h * s.w * s.cin * e};
  const cuuint32_t box[5] = {8, PX, PY, TZ + 2, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                        const_cast<void*>(x), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches the box kernel over the call (s: tc::Shape of an unhaloed
// stride-1 call, cin 32 nkc with nkc <= max_nkc<TZ>(), cout 32 or 64): one
// block a streaming multiprocessor, the column slices of Cout side by side.
template <int TZ>
cudaError_t launch(const void* x, const void* wk, const float* scale,
                   const float* bias, const void* res, void* out,
                   const tc::Shape& s, int relu, cudaStream_t stream) {
  if (s.cin > max_nkc<TZ>() * tc::BK) return cudaErrorInvalidValue;
  static bool sized[tc::MAX_DEVICES] = {};
  cudaError_t e = tc::size_smem(conv3d_box_kernel<TZ>,
                                smem_bytes<TZ>(max_nkc<TZ>()), sized);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = encode<TZ>(&map, x, s);
  if (e != cudaSuccess) return e;
  const long long ntiles = (long long)s.nb * ((s.d + TZ - 1) / TZ) *
                           ((s.h + TY - 1) / TY) * ((s.w + TX - 1) / TX);
  const int nblk = s.cout / BN;
  const long long per = sms / nblk > 0 ? sms / nblk : 1;
  const dim3 grid((unsigned)(ntiles < per ? ntiles : per), nblk);
  conv3d_box_kernel<TZ><<<grid, NT, smem_bytes<TZ>(s.cin / tc::BK), stream>>>(
      map, static_cast<const bf16*>(wk), scale, bias,
      static_cast<const bf16*>(res), static_cast<bf16*>(out), s, relu);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tcbox
