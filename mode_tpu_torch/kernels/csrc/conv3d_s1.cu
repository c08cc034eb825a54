// Stride-1 pad-1 3x3x3 convolution of MODE stage 1 on NDHWC volumes, with
// the folded eval-BatchNorm affine, an optional residual and an optional
// ReLU in the epilogue:  out = act(conv(x, w) * scale + bias (+ residual)).
//
// Replaces the TPU kernels conv3d_band_pallas (K1,
// mode_tpu/ops/pallas/conv3d_kernel.py:269) and conv3d_fold_pallas (K6,
// conv3d_kernel.py:866). Their lane-major layouts, lane rolls and M*L lane
// fold answered the TPU's 128-lane tiles; here the volume stays NDHWC with
// the channels innermost, and one entry point serves every level.
//
// Three kernels behind the one entry point:
//  * bf16 with Cout 32 or 64 and Cin 32 or 64, unhaloed (every stride-1
//    conv of the bf16 3-D stack but the heads; the caller passes box = 1):
//    the box-tiled implicit GEMM of conv3d_box.cuh, which copies each input
//    voxel into shared memory once per output box, not once per tap, and
//    keeps the block's weight slice resident (that header's note says
//    why).
//  * Cout > 1 otherwise (f32, the halo forms, Cout 2-31 and past 64): an
//    implicit GEMM on the tensor cores, igemm_tc.cuh (wgmma; f32 as
//    3xTF32, bf16 directly).
//    What bounds it: each output voxel costs 2*27*Cin*Cout flops (110
//    kflop at 64 -> 32) against (Cin + Cout) values of compulsory traffic,
//    far above the ridge point even at the 3xTF32 rate (495/3 = 165
//    TFLOP/s), so operations; at Cout = 32 each A element meets only 32
//    output channels, and the shared-memory reads of A and B come close to
//    the tensor cores' time. The design answers with K-major tiles copied
//    once per stage by cp.async (no register round trip, no per-element
//    bounds test), the A split in registers, and B = Cout wide.
//  * Cout = 1 (the classifier heads, 32 -> 1): a dot product of 27 * Cin
//    values per voxel, bound by bytes (the input volume read once: 201 MB,
//    0.06 ms at 3.35 TB/s, at the 1/4 level of a 1024x512 pair). A block
//    takes a 32 x 8 (W x H) tile through HZ output planes: it walks the
//    input planes with one halo plane in shared memory (cp.async, double
//    buffered), and each thread adds every plane to the three output planes
//    it reaches (kd = 2, 1, 0), so a plane is read from shared memory once
//    per (kh, kw) and from device memory about (34 * 10) / (32 * 8) times.
//    The weights (f32) sit in shared memory; the sums are f32 FMAs.
//
// Under the spatial axis (mode_tpu_torch/parallel/shard_ops.py, the
// m_halo form of the TPU kernel, conv3d_kernel.py:273-335) x holds a
// shard's rows of H with one halo row above and below, and is not padded
// along H: both kernels read it from an H origin of one row (tc::Shape's
// h0; the head kernel's h0), and the output has two rows fewer than x.

#include "conv3d_box.cuh"
#include "igemm_tc.cuh"

namespace {

// The box kernel's output box depth (conv3d_box.cuh: TZ x 8 x 16 voxels)
// by Cin: at Cin 64 the resident weight leaves room for boxes of depth 2.
constexpr int BOX_TZ_CIN32 = 4, BOX_TZ_CIN64 = 2;

template <typename T, int BM, int BN, bool HALOED>
__global__ void __launch_bounds__(2 * BM)
conv3d_s1_tc_kernel(const T* __restrict__ x, const T* __restrict__ wbig,
                    const T* __restrict__ wsmall,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const T* __restrict__ res, T* __restrict__ out,
                    const tc::Shape s, int relu) {
  tc::conv_body<T, BM, BN, 1, HALOED>(x, wbig, wsmall, scale, bias, res,
                                      out, s, relu);
}

struct Kernels {
  template <typename T, int BM, int BN, bool HALOED>
  static auto get() {
    return &conv3d_s1_tc_kernel<T, BM, BN, HALOED>;
  }
};

constexpr int HW_ = 32, HH = 8, HZ = 8;  // head tile: W, H, output planes
constexpr int HALO = (HW_ + 2) * (HH + 2);
constexpr int HNT = HW_ * HH;            // one thread per (y, x)

// Four channels of one voxel from shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Dynamic shared memory: two halo planes of HALO voxels, each voxel's Cin
// channels padded by 16 bytes (so a warp's 16-byte reads of one channel
// quad across 32 neighbouring voxels fall in distinct banks), then the f32
// weights as float4 quads [(kh*3 + kw)][Cin/4][kd].
template <typename T>
int head_smem(int cin) {
  return 2 * HALO * (cin * (int)sizeof(T) + 16) + 27 * cin * 4;
}
// Within the card's tc::SMEM_MAX: f32 Cin up to 72 and bf16 Cin up to 144
// (ops/conv3d.py refuses the others).

// h: the output's rows; x has hi = h + 2 h0 of them, and output row y reads
// x's rows y - 1 + h0 .. y + 1 + h0 (zero outside x).
template <typename T>
__global__ void __launch_bounds__(HNT)
conv3d_head_kernel(const T* __restrict__ x, const T* __restrict__ wk,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ out, int nb, int d, int h, int w, int cin,
                   int relu, int h0) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int vs = cin * (int)sizeof(T) + 16;  // voxel stride, bytes
  const int plane = HALO * vs;
  const int cq = cin / 4;
  float4* wq = reinterpret_cast<float4*>(smem + 2 * plane);
  float* wsm = reinterpret_cast<float*>(wq);
  // wk[tap * cin + c], tap = (kd * 3 + kh) * 3 + kw: the weight whole
  for (int i = tid; i < 27 * cin; i += HNT) {
    const int c = i % cin, tap = i / cin;
    wsm[(((tap % 9) * cq + c / 4) * 3 + tap / 9) * 4 + c % 4] =
        tc::to_f32(wk[i]);
  }

  const int x0 = blockIdx.x * HW_, y0 = blockIdx.y * HH;
  const int zblocks = (d + HZ - 1) / HZ;
  const int b = blockIdx.z / zblocks;
  const int z0 = blockIdx.z % zblocks * HZ;
  const int z1 = min(z0 + HZ, d);
  constexpr int CH = 16 / sizeof(T);
  const int cpv = cin / CH;  // 16-byte chunks per voxel
  const int hi = h + 2 * h0;
  auto load_plane = [&](int p, int buf) {
    const uint32_t dst = tc::smem_u32(smem) + buf * plane;
    for (int i = tid; i < HALO * cpv; i += HNT) {
      const int v = i / cpv, c = i % cpv;
      const int yy = y0 - 1 + h0 + v / (HW_ + 2), xx = x0 - 1 + v % (HW_ + 2);
      const bool ok = (unsigned)p < (unsigned)d &&
                      (unsigned)yy < (unsigned)hi && (unsigned)xx < (unsigned)w;
      tc::cp_async16(
          dst + v * vs + c * 16,
          ok ? x + ((((long long)b * d + p) * hi + yy) * w + xx) * cin + c * CH
             : x,
          ok);
    }
  };

  // acc[j]: output plane p - 1 + j while input plane p is added
  float acc[3] = {0.f, 0.f, 0.f};
  const int tx = tid % HW_, ty = tid / HW_;
  const int y = y0 + ty, xo = x0 + tx;
  load_plane(z0 - 1, 0);
  tc::cp_async_commit();
  for (int p = z0 - 1; p <= z1; ++p) {
    const int buf = (p - z0 + 1) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // plane p landed; the other buffer's readers are done
    if (p < z1) load_plane(p + 1, buf ^ 1);
    tc::cp_async_commit();
    const uint8_t* pl = smem + buf * plane;
#pragma unroll
    for (int t9 = 0; t9 < 9; ++t9) {
      const T* vp = reinterpret_cast<const T*>(
          pl + ((ty + t9 / 3) * (HW_ + 2) + tx + t9 % 3) * vs);
      const float4* wt = wq + t9 * cq * 3;
#pragma unroll 4
      for (int q = 0; q < cq; ++q) {
        const float4 xv = load4(vp + 4 * q);
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const float4 wv = wt[q * 3 + kd];
          float& a = acc[2 - kd];
          a = fmaf(xv.x, wv.x, a);
          a = fmaf(xv.y, wv.y, a);
          a = fmaf(xv.z, wv.z, a);
          a = fmaf(xv.w, wv.w, a);
        }
      }
    }
    // plane p was the last (kd = 2) input of output plane p - 1
    const int z = p - 1;
    if (z >= z0 && y < h && xo < w) {
      const long long o = (((long long)b * d + z) * h + y) * w + xo;
      float v = acc[0] * scale[0] + bias[0];
      if (res != nullptr) v += tc::to_f32(res[o]);
      if (relu) v = fmaxf(v, 0.f);
      tc::store1(out + o, v);
    }
    acc[0] = acc[1];
    acc[1] = acc[2];
    acc[2] = 0.f;
  }
}

template <typename T>
cudaError_t launch_head(const void* x, const void* wk, const float* scale,
                        const float* bias, const void* res, void* out, int nb,
                        int d, int h, int w, int cin, int relu, int h0,
                        cudaStream_t stream) {
  const int smem = head_smem<T>(cin);
  if (smem > tc::SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      conv3d_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + HW_ - 1) / HW_, (h + HH - 1) / HH,
                  nb * ((d + HZ - 1) / HZ));
  conv3d_head_kernel<T><<<grid, HNT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), scale, bias,
      static_cast<const T*>(res), static_cast<T*>(out), nb, d, h, w, cin,
      relu, h0);
  return cudaGetLastError();
}

// h: x's rows; the output has h - 2 h_halo.
template <typename T>
cudaError_t launch(const void* x, const void* wbig, const void* wsmall,
                   const float* scale, const float* bias, const void* res,
                   void* out, int nb, int d, int h, int w, int cin, int cout,
                   int relu, int h_halo, int box, cudaStream_t stream) {
  const int ho = h - 2 * h_halo;
  if (cout == 1) {
    return launch_head<T>(x, wbig, scale, bias, res, out, nb, d, ho, w, cin,
                          relu, h_halo, stream);
  }
  const tc::Shape s{nb, d, ho, w, cin, cout, 3, 1, d, h, w, h_halo};
  if (box) {
    return cin == 32 ? tcbox::launch<BOX_TZ_CIN32>(x, wbig, scale, bias, res,
                                                   out, s, relu, stream)
                     : tcbox::launch<BOX_TZ_CIN64>(x, wbig, scale, bias, res,
                                                   out, s, relu, stream);
  }
  return tc::dispatch<Kernels, T>(x, wbig, wsmall, scale, bias, res, out, s,
                                  relu, stream);
}

}  // namespace

// x: (nb, d, h, w, cin), cin a multiple of 8; wbig: the K-major weight
// (27, cout, cin), tap (kd*3 + kh)*3 + kw; wsmall: for f32 with cout > 1
// its tf32 remainder (wbig + wsmall = w), else null (the head kernel takes
// wbig as the whole weight); scale, bias: (cout,) f32; res (may be
// null) and out: (nb, d, h - 2 h_halo, w, cout); h_halo 1: x's first and
// last rows are halo rows (see the top); box 1: the box kernel (bf16,
// h_halo 0, Cin and Cout 32 or 64). x, w*, res and out are f32 (bf16 ==
// 0) or bf16 (bf16 == 1), 16-byte aligned. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue without launching where the
// head kernel's Cin does not fit in shared memory, the halo leaves no row
// or the box kernel does not take the call.
extern "C" int conv3d_s1_bn_act(int bf16, const void* x, const void* wbig,
                                const void* wsmall, const void* scale,
                                const void* bias, const void* res, void* out,
                                int nb, int d, int h, int w, int cin,
                                int cout, int relu, int h_halo, int box,
                                void* stream) {
  if (cin % 8 != 0 || cout < 1 || (h_halo != 0 && h_halo != 1) ||
      h - 2 * h_halo < 1 ||
      (box != 0 && (box != 1 || !bf16 || h_halo || (cin != 32 && cin != 64) ||
                    (cout != 32 && cout != 64)))) {
    return (int)cudaErrorInvalidValue;
  }
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(x, wbig, wsmall, s, b, res, out, nb, d, h,
                                   w, cin, cout, relu, h_halo, box, st)
           : launch<float>(x, wbig, wsmall, s, b, res, out, nb, d, h, w, cin,
                           cout, relu, h_halo, 0, st);
  return (int)e;
}
