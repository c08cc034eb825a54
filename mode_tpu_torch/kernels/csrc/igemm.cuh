// The tile machinery of the port's implicit-GEMM convolution kernels
// (conv3d.cu, conv2d.cu, sphere_conv.cu), on the FP32 pipes.
//
// A block of NT = 256 threads computes a BM x BN tile of out[M, N]: M the
// output pixels or voxels, N the output channels, K = taps x Cin. Each K
// step covers one tap and BK = 16 input channels. The kernel's A gather
// fills the thread's RA = BM * BK / NT values of the BM x 16 A slice (rows
// a_row() + r * NT / BK, channel a_k() of the step's chunk); the matching
// 16 x BN slice of the weight, laid out (taps, Cin, Cout), is loaded here.
// Both go to shared memory, double-buffered through registers, so the next
// step's global loads are in flight while the current step's FMAs run.
// Each thread keeps a TM x TN tile of f32 sums in registers; bf16 inputs
// are widened to f32 on load. The epilogue writes
// act(acc * scale + bias (+ residual)) in the input's type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace igemm {

constexpr int NT = 256;  // threads per block
constexpr int BK = 16;   // input channels per K step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The channel within a K step's chunk, and the first A row, that this
// thread gathers; its rows are a_row() + r * NT / BK for r < RA.
__device__ __forceinline__ int a_k() { return threadIdx.x % BK; }
__device__ __forceinline__ int a_row() { return threadIdx.x / BK; }

// N consecutive floats from shared memory, 16 bytes at a time where N allows
// (the tiles keep every such row 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// Sums the block's tile over ntaps * ceil(cin / BK) K steps into acc.
// gather_a(t, ci, ra) fills ra[r] with the A value of row a_row() + r * NT /
// BK at step tap t and input channel ci (zero outside the input or for
// ci >= cin) and returns the weight's tap index for step tap t.
template <typename T, int BM, int BN, int TM, int TN, typename GatherA>
__device__ __forceinline__ void mainloop(float (&acc)[TM][TN],
                                         const T* __restrict__ w, int cin,
                                         int cout, int n0, int ntaps,
                                         GatherA gather_a) {
  static_assert((BM / TM) * (BN / TN) == NT, "one thread per TM x TN tile");
  static_assert((BM * BK) % NT == 0, "every thread stages whole A rows");
  constexpr int RA = BM * BK / NT;             // A values staged per thread
  constexpr int RB = (BK * BN + NT - 1) / NT;  // B values staged per thread
  constexpr int AP = BM + 4;  // padded A row: fewer bank conflicts on stores
  __shared__ __align__(16) float As[2][BK][AP];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int nchunk = (cin + BK - 1) / BK;
  const int nsteps = ntaps * nchunk;
  float ra[RA];
  float rw[RB];
  auto fetch = [&](int s) {
    const int chunk = s % nchunk;
    const int tp = gather_a(s / nchunk, chunk * BK + a_k(), ra);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int idx = tid + r * NT;
      const int c = chunk * BK + idx / BN;
      const int co = n0 + idx % BN;
      float v = 0.f;
      if (idx < BK * BN && c < cin && co < cout) {
        v = to_f32(w[((long long)tp * cin + c) * cout + co]);
      }
      rw[r] = v;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      As[buf][a_k()][a_row() + r * (NT / BK)] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int idx = tid + r * NT;
      if (idx < BK * BN) Bs[buf][idx / BN][idx % BN] = rw[r];
    }
  };

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s & 1;
    if (s + 1 < nsteps) fetch(s + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      load_row(a, &As[buf][kk][ty * TM]);
      load_row(b, &Bs[buf][kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read in step s-1, which every thread has
    // left (the barrier below closed it), so it can be refilled now.
    if (s + 1 < nsteps) stash(buf ^ 1);
    __syncthreads();
  }
}

// Writes act(acc * scale + bias (+ res)) for the block's rows m0 + ... below
// mtot and channels n0 + ... below cout; offset(m) is the element offset of
// output row m's channel 0 in out (and res).
template <typename T, int BN, int TM, int TN, typename Offset>
__device__ __forceinline__ void epilogue(const float (&acc)[TM][TN],
                                         long long m0, long long mtot,
                                         int n0, int cout,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         const T* __restrict__ res,
                                         T* __restrict__ out, int relu,
                                         Offset offset) {
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= mtot) continue;
    const long long o = offset(m);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < cout) {
        float y = acc[i][j] * scale[co] + bias[co];
        if (res != nullptr) y += to_f32(res[o + co]);
        if (relu) y = fmaxf(y, 0.f);
        store(out + o + co, y);
      }
    }
  }
}

}  // namespace igemm
