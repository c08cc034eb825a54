// The tensor-core implicit GEMM of the port's convolutions (conv3d_s1.cu,
// conv3d_s2.cu, conv3d.cu, conv2d.cu; the sphere conv's forward and grad-input,
// sphere_conv.cu and sphere_conv_bwd.cu, build their A operand themselves,
// in sphere_tc.cuh, and its weight gradient, in sphere_conv_bwd.cu, its A
// and B; they share the rest), for sm_90a.
//
// A block computes a BM x BN tile of out[M, N]: M the output voxels (or
// pixels, a 2-D map being a volume of depth 1) in NDHW order, N the output
// channels, K = taps x Cin in the order (tap, channel), the taps at
// (k - 1) * dil on each tapped axis. At stride S (a template parameter, 1
// or 2; stride 2 only with dilation 1) output voxel (z, y, x) reads input
// voxel (S z + kd - 1, S y + kh - 1 + h0, S x + kw - 1), h0 the H origin:
// 0, or 1 in the HALO instantiations, whose input holds a spatial shard's
// rows with a halo row above and below (not padded along H; the zero-fill
// below pads what lies outside the input as it is). S = DECONV walks the
// transposed conv of stride 2 instead (conv3d.cu): M the input voxels,
// each writing one output voxel of each of the eight output parity phases,
// the phases' taps one after another (see deconv_tap). One warpgroup (128
// threads) owns 64 rows of the tile; BM = 128 runs two of them.
//
// A K stage is one tap x BK = 32 input channels: one row of RB bytes per
// output row (128 in f32, 64 in bf16), which every thread copies 16 bytes
// at a time with cp.async in its zero-fill form (src-size 0 outside the
// volume or map and past Cin, from the base pointer), straight into the
// swizzled layout that wgmma's descriptor reads: 16-byte chunk c of row r
// lands at chunk c ^ (r & 7) (128-byte swizzle, f32) or c ^ ((r >> 1) & 3)
// (64-byte swizzle, bf16), each tile 1024-byte aligned. The weight comes
// K-major, (taps, Cout, Cin), so each B row is one output channel's
// channels of one tap, copied the same way; in f32 its Cin is padded to
// whole stages and each stage's channels are permuted (below). STAGES
// stages are in flight.
//
// The product:
//   bf16  wgmma m64nBNk16, A and B from shared memory, f32 accumulators;
//   f32   3xTF32 on wgmma m64nBNk8: each thread loads its A fragment from
//         shared memory and splits it, big = tf32_rna(a), small =
//         tf32_rna(a - big); the weight arrives split on the host the same
//         way (w_big, w_small), its channels permuted within each stage so
//         that a thread's fragment values are 8 neighbouring channels.
//         Each K step issues small*B_big + big*B_small + big*B_big into
//         the stage's fragment, which the FP32 pipes add to the f32
//         accumulator: the f32-level counterpart of the JAX package's
//         Precision.HIGHEST. The small*small term (2^-22 of a product) is
//         the only one dropped; one TF32 pass (2^-11) would change the
//         function.
// The epilogue writes act(acc * scale + bias (+ residual)) from the
// accumulator fragment in the input's type, two channels per store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {
// Internal linkage: each source that includes this header keeps its own
// copy in its own library (a template static shared by two ctypes-loaded
// libraries would be one GNU unique symbol across them).
namespace {

constexpr int BK = 32;  // input channels per K stage
constexpr int SMEM_MAX = 232448;  // shared memory a block can take (227 KB)

// Per input type: bytes of a stage row (the swizzle width), the
// descriptor's layout code, stages in flight, wgmma K steps per stage,
// weight parts (f32: big and small).
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int RB = 128, LAYOUT = 1, STAGES = 3, KSTEPS = 4,
                       PARTS = 2;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int RB = 64, LAYOUT = 2, STAGES = 4, KSTEPS = 2,
                       PARTS = 1;
};

// The byte offset, in a 1024-byte aligned stage tile, of 16-byte chunk c of
// row r: the swizzle that wgmma applies to the address bits of the rows it
// reads through a descriptor.
template <typename T>
__host__ __device__ constexpr uint32_t swizzle(int r, int c) {
  return sizeof(T) == 4 ? r * 128 + ((c ^ (r & 7)) << 4)
                        : r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The extents of a call, d = 1 and kd = 1 for a 2-D map. At stride 1 the
// input extents equal the output extents (padding = dilation); at stride 2
// (padding 1) the output extent is ceil(input / 2) on every axis. With a
// halo (h0 = 1) the input has two rows more than a SAME call would read:
// hi = h + 2 at stride 1 and for DECONV, hi = 2 h + 2 at stride 2.
struct Shape {
  int nb, d, h, w;  // output extents (DECONV: the input grid's)
  int cin, cout;
  int kd;           // taps along D: 3 or 1
  int dil;          // dilation (and padding) of every tapped axis
  int di, hi, wi;   // input extents
  int h0;           // H origin, 0 or 1: dispatch's choice of the HALO form
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers that an in-flight wgmma reads or writes: the compiler
// keeps them live and does not move their uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// wgmma shared-memory descriptor of a K-major swizzled tile at addr:
// 8-row groups SBO = 8 * RB bytes apart; the leading offset is unused for
// swizzled K-major tiles. A K step of 32 bytes adds 2 to the address field.
template <typename T>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t sbo = (8 * Cfg<T>::RB) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (sbo << 32) | (static_cast<uint64_t>(Cfg<T>::LAYOUT) << 62);
}

// d += A * B over one K step (tf32: d = A * B where scale_d is 0): A a
// register fragment (tf32) or a descriptor (bf16), B a descriptor, d the
// m64nN f32 fragment.
template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);
template <int N>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);
// d += A * B over one K step of 16, A a bf16 register fragment: register
// e of the thread holds the bf16 pair of row lane / 4 + 8 (e & 1) of its
// warp's 16 at K positions 2 (lane % 4) + 8 (e >> 1) and the next.
template <int N>
__device__ __forceinline__ void mma_bf16_ra(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db);

template <>
__device__ __forceinline__ void mma_tf32<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<32>(float (&d)[16], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<64>(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_bf16_ra<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_bf16_ra<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int BM, int BN>
constexpr int smem_bytes() {
  return Cfg<T>::STAGES * (BM + Cfg<T>::PARTS * BN) * Cfg<T>::RB + 1024;
}

// acc += the products of one f32 K stage: v[hh][j] is the thread's A value
// of row r0 + 8 hh (r0 = its fragment row) at channel 8 q + j of the stage
// (q = lane % 4), which the f32 weight holds at K position q + 4 j (see
// conv_body); db, ds the descriptors of the stage's big and small B parts.
// The m64k8 tf32 A fragment of K step kk holds rows r0 and r0 + 8 at K
// positions kk * 8 + q and kk * 8 + q + 4: channels 8 q + 2 kk (+ 1).
template <int BN>
__device__ __forceinline__ void mma_stage_f32(float (&acc)[BN / 2],
                                              const float (&v)[2][8],
                                              uint64_t db, uint64_t ds) {
  constexpr int KSTEPS = Cfg<float>::KSTEPS;
  uint32_t big[KSTEPS][4], small[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = v[e & 1][2 * kk + (e >> 1)];
      big[kk][e] = tf32_rna(a);
      small[kk][e] = tf32_rna(a - __uint_as_float(big[kk][e]));
    }
  }
  // The stage's products go to a fresh fragment, added to acc on the
  // FP32 pipes (round to nearest): the tensor cores' own accumulation
  // does not round to nearest, and over the thousands of products of a
  // whole K it drifts past f32 level.
  float part[BN / 2];
  pin(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    mma_tf32<BN>(part, small[kk], db + 2 * kk, kk > 0);
    mma_tf32<BN>(part, big[kk], ds + 2 * kk, 1);
    mma_tf32<BN>(part, big[kk], db + 2 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(part);
  pin(big);
  pin(small);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
}

// The epilogue: writes act(acc * scale + bias (+ residual)) in T, two
// channels per store, row m of the tile at element out_row(m) of out (and
// of res, which may be null; scale and bias null: acc as it is). Fragment
// element 4j + 2hh + e: row lane / 4 + 8 hh of the warp's 16, column
// 8j + 2 (lane % 4) + e.
template <typename T, int BN, typename OutRow>
__device__ __forceinline__ void epilogue(
    const float (&acc)[BN / 2], long long m0, long long mtot, int n0,
    int cout, const float* __restrict__ scale, const float* __restrict__ bias,
    const T* __restrict__ res, T* __restrict__ out, int relu,
    OutRow out_row) {
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const long long mr = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = cout % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = n0 + 8 * j + 2 * (lane % 4);
    if (co >= cout) continue;
    const bool two = co + 1 < cout;
    const bool aff = scale != nullptr;
    const float s0 = aff ? scale[co] : 1.f, b0 = aff ? bias[co] : 0.f;
    const float s1 = aff && two ? scale[co + 1] : 1.f;
    const float b1 = aff && two ? bias[co + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = mr + 8 * hh;
      if (m >= mtot) continue;
      const long long o = out_row(m) + co;
      float v0 = acc[4 * j + 2 * hh] * s0 + b0;
      float v1 = acc[4 * j + 2 * hh + 1] * s1 + b1;
      if (res != nullptr) {
        v0 += to_f32(res[o]);
        if (two) v1 += to_f32(res[o + 1]);
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (two && pairs) {
        store2(out + o, v0, v1);
      } else {
        store1(out + o, v0);
        if (two) store1(out + o + 1, v1);
      }
    }
  }
}

// conv_body's S for the transposed conv k3 s2 p1 output_padding 1: the
// output extents are twice the input's, and grid row (z, y, x) of the
// input-sized M writes output voxel (2z + pd, 2y + ph, 2x + pw) of each
// output parity phase p = 4 pd + 2 ph + pw. Per axis, output o = 2i - 1 + k
// for input i and kernel index k, so an even output 2z reads index 1 at
// input z, and an odd output 2z + 1 reads index 0 at input z + 1 and index
// 2 at input z: phase p has (1 + pd)(1 + ph)(1 + pw) taps, at input offsets
// 0 or +1 on each axis, 27 over the eight phases and no zero-stuffed one.
constexpr int DECONV = 0;

__host__ __device__ constexpr int phase_taps(int p) {
  return (1 + (p >> 2)) * (1 + (p >> 1 & 1)) * (1 + (p & 1));
}
// The first of phase p's taps in the walk: 0, 1, 3, 5, 9, 11, 15, 19.
__host__ __device__ constexpr int phase_start(int p) {
  int start = 0;
  for (int q = 0; q < p; ++q) start += phase_taps(q);
  return start;
}

// Tap t (< 27) of the transposed conv's walk, which takes the phases in
// the order of p and each phase's taps in (jd, jh, jw) order, jw fastest;
// on an odd axis tap j reads kernel index 2 j at input offset 1 - j. In a
// byte: bits 0-4 the weight tap (kd * 3 + kh) * 3 + kw, bits 5, 6, 7 the
// input offsets ow, oh, od.
__host__ __device__ constexpr int deconv_tap(int t) {
  int p = 0, start = 0;
  for (int q = 1; q < 8; ++q) {
    if (t >= phase_start(q)) p = q, start = phase_start(q);
  }
  const int pd = p >> 2, ph = p >> 1 & 1, pw = p & 1;
  int j = t - start;
  const int jw = pw ? j & 1 : 0;
  j >>= pw;
  const int jh = ph ? j & 1 : 0;
  const int jd = pd ? j >> ph : 0;
  const int wtap =
      ((pd ? 2 * jd : 1) * 3 + (ph ? 2 * jh : 1)) * 3 + (pw ? 2 * jw : 1);
  return wtap | (pw ? 1 - jw : 0) << 5 | (ph ? 1 - jh : 0) << 6 |
         (pd ? 1 - jd : 0) << 7;
}

// The walk as compile-time data: taps 8 w .. 8 w + 7 packed in a word,
// and the taps that end a phase (bit t for tap t).
__host__ __device__ constexpr uint64_t deconv_word(int w) {
  uint64_t r = 0;
  for (int i = 0; i < 8 && 8 * w + i < 27; ++i) {
    r |= static_cast<uint64_t>(deconv_tap(8 * w + i)) << (8 * i);
  }
  return r;
}
__host__ __device__ constexpr uint32_t phase_ends() {
  uint32_t r = 0;
  for (int p = 0; p < 8; ++p) r |= 1u << (phase_start(p + 1) - 1);
  return r;
}

// deconv_tap(t) at run time, read from the constant words.
__device__ __forceinline__ int deconv_tap_at(int t) {
  constexpr uint64_t w0 = deconv_word(0), w1 = deconv_word(1),
                     w2 = deconv_word(2), w3 = deconv_word(3);
  const uint64_t w = t < 16 ? (t < 8 ? w0 : w1) : (t < 24 ? w2 : w3);
  return static_cast<int>(w >> (8 * (t & 7))) & 0xFF;
}

// The body of a conv kernel of stride S (or S = DECONV, above) launched
// with 2 * BM threads and smem_bytes<T, BM, BN>() of dynamic shared memory;
// HALO reads the input from an H origin of one row (above). The origin is
// a template parameter, not a value of the call: a run-time origin kept one
// more 64-bit value live in the main loop and took the f32 tiles of Cout 32
// (conv3d_s1.cu, conv3d.cu) past 128 registers, one block an SM instead of
// two, 30% slower at the 1/4 level.
// wbig, wsmall: the K-major weight, bf16 (taps, Cout, Cin) (wsmall unused),
// f32 split in two parts of (taps, Cout, ceil(Cin / 32) * 32) whose K
// position p of each 32-channel stage holds channel 8 (p % 4) + p / 4 (zero
// past Cin); res may be null. For DECONV, s's output extents d, h, w are
// the input's (the M grid) and the weight's taps are the torch transpose
// weight's (kd, kh, kw).
template <typename T, int BM, int BN, int S = 1, bool HALO = false>
__device__ __forceinline__ void conv_body(
    const T* __restrict__ x, const T* __restrict__ wbig,
    const T* __restrict__ wsmall, const float* __restrict__ scale,
    const float* __restrict__ bias, const T* __restrict__ res,
    T* __restrict__ out, const Shape s, int relu) {
  using C = Cfg<T>;
  constexpr int NT = 2 * BM;            // one warpgroup per 64 rows
  constexpr int CH = 16 / sizeof(T);    // channels per 16-byte chunk
  constexpr int CPR = C::RB / 16;       // chunks per stage row
  constexpr int NA = BM * CPR / NT;     // A chunks each thread copies
  constexpr int A_BYTES = BM * C::RB;
  constexpr int B_BYTES = BN * C::RB;
  constexpr int STAGE = A_BYTES + C::PARTS * B_BYTES;
  static_assert(BM % 64 == 0 && NA * NT == BM * CPR, "whole rows per stage");
  static_assert(STAGE % 1024 == 0 && B_BYTES % 1024 == 0,
                "1024-byte aligned tiles");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const long long hw = (long long)s.h * s.w;
  const long long mtot = (long long)s.nb * s.d * hw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nkc = (s.cin + BK - 1) / BK;
  const int nsteps = s.kd * 9 * nkc;

  // The A rows this thread copies (rows tid / CPR + i * NT / CPR, chunk
  // ac) and their coordinates (the input voxel of the centre tap); the
  // same for every K stage. Off stride 2 a haloed input's index is the
  // grid's, m, plus the halo rows of the planes up to it (two a plane, one
  // in its own).
  const int ac = tid % CPR;
  long long rm[NA];
  int rz[NA], ry[NA], rx[NA];
  bool rv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const long long m = m0 + tid / CPR + i * (NT / CPR);
    rv[i] = m < mtot;
    rm[i] = rv[i] ? m : 0;
    long long t = rm[i];
    rx[i] = (int)(t % s.w);
    t /= s.w;
    ry[i] = (int)(t % s.h);
    if constexpr (S != 2) {
      rz[i] = (int)(t / s.h % s.d);
      if constexpr (HALO) {
        ry[i] += 1;
        rm[i] += (2 * (t / s.h) + 1) * (long long)s.w;
      }
    } else {
      // the input voxel (S z, S y + h0, S x) that the centre tap reads
      t /= s.h;
      rz[i] = S * (int)(t % s.d);
      ry[i] = S * ry[i] + (HALO ? 1 : 0);
      rx[i] *= S;
      rm[i] = ((t / s.d * s.di + rz[i]) * s.hi + ry[i]) * s.wi + rx[i];
    }
  }
  // The f32 weight's Cin is padded to whole stages (host-side pack).
  const int wcin = C::PARTS == 2 ? nkc * BK : s.cin;

  // the input extents (the M grid's but at stride 2, and along a haloed H)
  const int din = S == 2 ? s.di : s.d;
  const int hin = S == 2 || HALO ? s.hi : s.h;
  const int win = S == 2 ? s.wi : s.w;
  const long long ihw = S == 2 || HALO ? (long long)hin * win : hw;
  auto load = [&](int step, int slot) {
    const int tap = step / nkc, kc = step - tap * nkc;
    int od, oh, ow, wtap = tap;
    if constexpr (S == DECONV) {
      const int b = deconv_tap_at(tap);
      od = b >> 7, oh = b >> 6 & 1, ow = b >> 5 & 1, wtap = b & 31;
    } else {
      od = s.kd == 3 ? (tap / 9 - 1) * s.dil : 0;
      oh = (tap / 3 % 3 - 1) * s.dil;
      ow = (tap % 3 - 1) * s.dil;
    }
    const long long shift = od * ihw + (long long)oh * win + ow;
    const uint32_t sa = base + slot * STAGE;
    const int ch = kc * BK + ac * CH;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = tid / CPR + i * (NT / CPR);
      const bool ok = rv[i] && ch < s.cin &&
                      (unsigned)(rz[i] + od) < (unsigned)din &&
                      (unsigned)(ry[i] + oh) < (unsigned)hin &&
                      (unsigned)(rx[i] + ow) < (unsigned)win;
      cp_async16(sa + swizzle<T>(r, ac),
                 ok ? x + (rm[i] + shift) * s.cin + ch : x, ok);
    }
#pragma unroll
    for (int idx = tid; idx < BN * CPR; idx += NT) {
      const int n = idx / CPR, c = idx % CPR;
      const int co = n0 + n, chb = kc * BK + c * CH;
      const bool ok = co < s.cout && chb < wcin;
      const long long off = ((long long)wtap * s.cout + co) * wcin + chb;
      const uint32_t dst = sa + A_BYTES + swizzle<T>(n, c);
      cp_async16(dst, ok ? wbig + off : wbig, ok);
      if constexpr (C::PARTS == 2) {
        cp_async16(dst + B_BYTES, ok ? wsmall + off : wsmall, ok);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid / 128;
  const int warp = tid % 128 / 32;
  const int lane = tid % 32;

  // DECONV: the output voxel (2z, 2y, 2x) x Cout of this thread's two
  // epilogue rows (grid rows er and er + 8, the fragment's rows), to which
  // phase p adds ((pd * 2 h) + ph) * 2 w + pw voxels (phase_off). Grid row
  // m = (b d + z) h w + y w + x writes (((2 (b d + z)) * 2 h + 2 y) * 2 w +
  // 2 x). The walk's stage counters: K chunk, tap and phase.
  [[maybe_unused]] const long long er = m0 + wg * 64 + warp * 16 + lane / 4;
  [[maybe_unused]] long long eo[2] = {0, 0};
  [[maybe_unused]] int ckc = 0, ctap = 0, cphase = 0;
  [[maybe_unused]] constexpr uint32_t ENDS = phase_ends();
  [[maybe_unused]] auto phase_off = [&](int p) {
    return (((p >> 2) * 2LL * s.h + (p >> 1 & 1)) * 2 * s.w + (p & 1)) *
           s.cout;
  };
  if constexpr (S == DECONV) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = er + 8 * hh;
      const long long q = m / s.w, bz = q / s.h;
      eo[hh] = ((2 * bz * 2 * s.h + 2 * (q - bz * s.h)) * 2 * s.w +
                2 * (m - q * s.w)) * s.cout;
    }
  }

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<C::STAGES - 2>();
    fence_proxy_async();
    // Stage `step` has landed for every thread, and every warpgroup has
    // waited out its products of stage step - 1, whose slot is refilled.
    __syncthreads();
    const int next = step + C::STAGES - 1;
    if (next < nsteps) load(next, next % C::STAGES);
    cp_async_commit();

    const int slot = step % C::STAGES;
    const uint32_t sa = base + slot * STAGE;
    const uint32_t sb = sa + A_BYTES;
    if constexpr (sizeof(T) == 4) {
      // The f32 weight holds, at K position p of a stage, channel
      // 8 (p % 4) + p / 4, so the thread's A fragment values over the stage
      // are channels 8q .. 8q + 7 of each of its rows: chunks 2q and
      // 2q + 1, two 16-byte reads a row.
      const uint8_t* ta = smem + slot * STAGE;
      const int r0 = wg * 64 + warp * 16 + lane / 4, q = lane % 4;
      float v[2][8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 lo = *reinterpret_cast<const float4*>(
            ta + swizzle<T>(r0 + 8 * hh, 2 * q));
        const float4 hi = *reinterpret_cast<const float4*>(
            ta + swizzle<T>(r0 + 8 * hh, 2 * q + 1));
        v[hh][0] = lo.x, v[hh][1] = lo.y, v[hh][2] = lo.z, v[hh][3] = lo.w;
        v[hh][4] = hi.x, v[hh][5] = hi.y, v[hh][6] = hi.z, v[hh][7] = hi.w;
      }
      mma_stage_f32<BN>(acc, v, make_desc<T>(sb),
                        make_desc<T>(sb + B_BYTES));
    } else {
      const uint64_t da = make_desc<T>(sa + wg * 64 * C::RB);
      const uint64_t db = make_desc<T>(sb);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        mma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
    }
    if constexpr (S == DECONV) {
      // After a phase's last stage its sums are complete: store them at
      // that phase's output voxels and start the next phase from zero,
      // while the next phase's copies are in flight.
      if (++ckc == nkc) {
        ckc = 0;
        if (ENDS >> ctap & 1) {
          const long long po = phase_off(cphase);
          epilogue<T, BN>(acc, m0, mtot, n0, s.cout, scale, bias, res, out,
                          relu, [&](long long m) {
                            return (m == er ? eo[0] : eo[1]) + po;
                          });
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
          ++cphase;
        }
        ++ctap;
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (S != DECONV) {
    epilogue<T, BN>(acc, m0, mtot, n0, s.cout, scale, bias, res, out, relu,
                    [&](long long m) { return m * s.cout; });
  }
}

constexpr int MAX_DEVICES = 64;

// Sets kernel's dynamic shared-memory size to smem on the current device,
// once per device: the attribute belongs to the device that is current
// when it is set (the wrappers make the input's device current), and a
// process may launch on more than one. sized: the caller's flags, one
// static array per kernel.
template <typename Kernel>
cudaError_t size_smem(Kernel kernel, int smem, bool (&sized)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  return cudaSuccess;
}

// Launches kernel (a __global__ wrapper of conv_body<T, BM, BN, S, HALO>)
// over the call's tiles; returns cudaGetLastError(). HALO is a parameter
// here too so that each kernel has its own `sized` flags (the two forms'
// kernels have one type).
template <typename T, int BM, int BN, bool HALO, typename Kernel>
cudaError_t launch_tile(Kernel kernel, const void* x, const void* wbig,
                        const void* wsmall, const float* scale,
                        const float* bias, const void* res, void* out,
                        const Shape& s, int relu, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, BM, BN>();
  static bool sized[MAX_DEVICES] = {};
  const cudaError_t e = size_smem(kernel, smem, sized);
  if (e != cudaSuccess) return e;
  const long long mtot = (long long)s.nb * s.d * s.h * s.w;
  const dim3 grid((unsigned)((mtot + BM - 1) / BM), (s.cout + BN - 1) / BN);
  kernel<<<grid, 2 * BM, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wbig),
      static_cast<const T*>(wsmall), scale, bias, static_cast<const T*>(res),
      static_cast<T*>(out), s, relu);
  return cudaGetLastError();
}

// The tile for a call: BN follows Cout (32, 64 or 128 wide, more N tiles
// past 128); BM = 64 where 128-row tiles would not give every SM two.
// K::get<T, BM, BN, HALO>() names the source's kernel, HALO = s.h0.
template <class K, typename T>
cudaError_t dispatch(const void* x, const void* wbig, const void* wsmall,
                     const float* scale, const float* bias, const void* res,
                     void* out, const Shape& s, int relu,
                     cudaStream_t stream) {
  const long long mtot = (long long)s.nb * s.d * s.h * s.w;
  const bool tall = (mtot + 127) / 128 >= 2 * 132;
#define TC_LAUNCH(BM_, BN_)                                                \
  return s.h0 ? launch_tile<T, BM_, BN_, true>(                            \
                    K::template get<T, BM_, BN_, true>(), x, wbig, wsmall, \
                    scale, bias, res, out, s, relu, stream)                \
              : launch_tile<T, BM_, BN_, false>(                           \
                    K::template get<T, BM_, BN_, false>(), x, wbig, wsmall,\
                    scale, bias, res, out, s, relu, stream)
  if (s.cout > 64) {
    if (tall) TC_LAUNCH(128, 128);
    TC_LAUNCH(64, 128);
  }
  if (s.cout > 32) {
    if (tall) TC_LAUNCH(128, 64);
    TC_LAUNCH(64, 64);
  }
  if (tall) TC_LAUNCH(128, 32);
  TC_LAUNCH(64, 32);
#undef TC_LAUNCH
}

}  // namespace
}  // namespace tc
