// Fused disparity regression head of MODE stage 1: from quarter-resolution
// logits (N, d, Hq, Wq), the align_corners trilinear upsample to
// (N, maxdisp, H, W), the softmax over disparity, the soft-argmin
//   pred = sum_k k * p(k)
// and the confidence
//   conf = sum over t in clip(round(pred) + {-1, 0, 1}, 0, maxdisp - 1) of
//          p(t)
// which counts a clamped border tap twice, as the reference does.
//
// Replaces mode_tpu/ops/pallas/regression_kernel.py:fused_disparity_regression
// (K2). The TPU kernel expanded a row band through three interpolation
// matmuls in VMEM; here one thread owns two neighbouring output pixels and
// never forms the (N, maxdisp, H, W) volume (1.6 GB in f32 at 192 x 1024 x
// 512).
//
// What bounds it on the card: it reads the quarter-resolution logits once
// (6.3 MB in f32 at 48 x 256 x 128) and writes two f32 maps (4.2 MB), a few
// microseconds of memory traffic, while it takes one exp per (pixel,
// disparity), 1.0e8 at 192 x 1024 x 512: the exps go to the special-
// function units (MUFU.EX2, 16 a clock per SM, an eighth of the FP32 pipes'
// FMA rate), and they bound it, with the lerps and sums beside them on the
// FP32 pipes. The design keeps every other instruction of the per-level
// loop to the few the math needs, with no data-dependent branch. A block
// owns 128 pixels of one output row:
//   1. It stages the source columns those pixels read, for every source
//      level: the row lerp of the two source rows, scaled by log2(e), in
//      shared memory (about 35 columns x 48 levels; coalesced loads, each
//      source value read once by the block).
//   2. Each thread interpolates its two pixels' d source levels from there
//      (the column lerp) and takes their maximum as the softmax shift: each
//      upsampled logit is a convex combination of two source levels, so it
//      is never above that maximum, and no online rescale and no running
//      max is needed. (The largest logit may lie below the shift, by at
//      most the largest step between neighbouring source levels times the
//      taps' spacing; the sum keeps its top term far above f32's underflow
//      for any logits a softmax can resolve.)
//   3. One pass over the maxdisp levels, walked by source interval: the two
//      source levels of an interval are interpolated once (the lower one
//      carried from the last interval), and each level of the interval is a
//      lerp with its two weights (one broadcast 8-byte load from shared
//      memory, loaded once per block), one ex2 and two sums (an add and an
//      FMA), for each of the thread's two pixels: four independent chains.
//   4. The confidence interpolates its three logits from the same staged
//      columns.
// Everything is f32; bf16 logits are widened on load. The interpolation
// indices and weights come from the host, from the same float64 formula as
// the plain path's matrices, so the coefficients are bit-equal; the host
// also gives each source level's first disparity level (the taps' lower
// index never decreases and the upper one is the next level, clamped).
// Why the staged columns and the walk by interval: each pixel's 48 levels
// kept in shared memory would take 384 bytes a thread, leave 16 warps an SM,
// and gather them with 8 scattered loads a level, a latency-bound pass.
//
// A call may write a window of rows, [row0, row0 + h_out) of the full-h
// output (a rank of the spatial axis, mode_tpu_torch/parallel/shard_ops.py;
// the TPU kernel's ys / mh_win / h_out, regression_kernel.py:107-127): one
// block row per output row, its row taps read at row0 + blockIdx.y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 64;       // threads per block, two output pixels each
constexpr int PX = 2 * NT;   // output pixels of a block, in one row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 2^v on the special-function unit (flushes a result below 2^-126 to 0)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The most source columns a block's PX pixels read: their column taps
// span at most (PX - 1) (wq - 1) / (w - 1) source columns, plus the upper
// tap and the floors' slack.
__host__ __device__ constexpr int block_columns(int wq, int w) {
  const int span = (PX - 1) * (wq - 1) / (w > 1 ? w - 1 : 1) + 4;
  return span < wq ? span : wq;
}

// Dynamic shared memory: maxdisp float2 level weights and int lower source
// indices, d + 1 int interval starts, d x ncol staged columns. The launch
// takes at most the default 48 KB, so no attribute is set; the served
// shapes (d 48, maxdisp 192, 35 columns) take about 9 KB.
constexpr long long SMEM_MAX = 48 * 1024;
__host__ __device__ constexpr long long smem_bytes(int d, int maxdisp,
                                                   int ncol) {
  return 12LL * maxdisp + 4LL * (d + 1) + 4LL * d * ncol;
}

// idx, wgt: for j in [0, maxdisp + h + w) (disparity levels, then rows,
// then columns) the source indices idx[2j], idx[2j+1] and their weights
// wgt[2j], wgt[2j+1]; then idx holds, for each source level k <= d, the
// first disparity level whose lower index is k or more (maxdisp at k = d).
// pred, conf: (n, gridDim.y, w), output rows row0 .. row0 + gridDim.y - 1.
template <typename T>
__global__ void __launch_bounds__(NT)
regression_kernel(const T* __restrict__ cost, const int* __restrict__ idx,
                  const float* __restrict__ wgt, float* __restrict__ pred,
                  float* __restrict__ conf, int d, int hq, int wq,
                  int maxdisp, int h, int w, int ncol, int row0) {
  extern __shared__ float2 smem[];
  float2* tw = smem;                                   // level weights
  int* tk = reinterpret_cast<int*>(tw + maxdisp);      // lower index
  int* start = tk + maxdisp;                           // per source level
  float* colv = reinterpret_cast<float*>(start + d + 1);
  const int tid = threadIdx.x;
  const int xb = blockIdx.x * PX;
  const int y = row0 + blockIdx.y;
  const int n = blockIdx.z;
  const int* cidx = idx + 2 * (maxdisp + h);
  const float* cwgt = wgt + 2 * (maxdisp + h);
  const int c_lo = cidx[2 * xb];

  for (int t = tid; t < maxdisp; t += NT) {
    tw[t] = make_float2(wgt[2 * t], wgt[2 * t + 1]);
    tk[t] = idx[2 * t];
  }
  for (int k = tid; k <= d; k += NT) start[k] = idx[2 * (maxdisp + h + w) + k];
  // 1. the row lerp of the block's source columns, every level
  {
    const int ry = 2 * (maxdisp + y);
    const float a0 = wgt[ry] * LOG2E, a1 = wgt[ry + 1] * LOG2E;
    const long long plane = (long long)hq * wq;
    const T* r0 = cost + (long long)n * d * plane + (long long)idx[ry] * wq;
    const T* r1 = cost + (long long)n * d * plane + (long long)idx[ry + 1] * wq;
    for (int i = tid; i < d * ncol; i += NT) {
      const int k = i / ncol, c = min(c_lo + i % ncol, wq - 1);
      const long long o = k * plane + c;
      colv[i] = fmaf(a1, to_f32(r1[o]), a0 * to_f32(r0[o]));
    }
  }
  __syncthreads();
  const int x0 = xb + 2 * tid;
  if (x0 >= w) return;
  const int x1 = min(x0 + 1, w - 1);

  // 2. the column lerp: source level k at the two pixels (log2 units)
  const int c00 = cidx[2 * x0] - c_lo, c01 = cidx[2 * x0 + 1] - c_lo;
  const int c10 = cidx[2 * x1] - c_lo, c11 = cidx[2 * x1 + 1] - c_lo;
  const float b00 = cwgt[2 * x0], b01 = cwgt[2 * x0 + 1];
  const float b10 = cwgt[2 * x1], b11 = cwgt[2 * x1 + 1];
  auto level = [&](int k) {
    const float* cv = colv + k * ncol;
    return make_float2(fmaf(b01, cv[c01], b00 * cv[c00]),
                       fmaf(b11, cv[c11], b10 * cv[c10]));
  };
  float2 mx = make_float2(-INFINITY, -INFINITY);
  for (int k = 0; k < d; ++k) {
    const float2 v = level(k);
    mx.x = fmaxf(mx.x, v.x);
    mx.y = fmaxf(mx.y, v.y);
  }

  // 3. the softmax's sum and its disparity-weighted sum, by source interval
  float s0 = 0.f, s1 = 0.f, sd0 = 0.f, sd1 = 0.f, tf = 0.f;
  float2 vb = level(0);
  int t = 0;
  for (int k = 0; k < d; ++k) {
    const float2 va = vb;
    vb = level(min(k + 1, d - 1));
    const int tend = start[k + 1];
    for (; t < tend; ++t) {
      const float2 wt = tw[t];
      const float e0 = ex2(fmaf(wt.y, vb.x, wt.x * va.x) - mx.x);
      const float e1 = ex2(fmaf(wt.y, vb.y, wt.x * va.y) - mx.y);
      s0 += e0;
      s1 += e1;
      sd0 = fmaf(e0, tf, sd0);
      sd1 = fmaf(e1, tf, sd1);
      tf += 1.f;
    }
  }
  const float p0 = sd0 / s0, p1 = sd1 / s1;

  // 4. the confidence: three slices around round(pred), clamped
  float ce0 = 0.f, ce1 = 0.f;
  const float rp0 = rintf(p0), rp1 = rintf(p1);  // half to even: torch.round
  const float top = maxdisp - 1.f;
#pragma unroll
  for (int delta = -1; delta <= 1; ++delta) {
    const int t0 = (int)fminf(fmaxf(rp0 + (float)delta, 0.f), top);
    const int t1 = (int)fminf(fmaxf(rp1 + (float)delta, 0.f), top);
    const float2 w0 = tw[t0], w1 = tw[t1];
    const float2 l0 = level(tk[t0]), h0 = level(min(tk[t0] + 1, d - 1));
    const float2 l1 = level(tk[t1]), h1 = level(min(tk[t1] + 1, d - 1));
    ce0 += ex2(fmaf(w0.y, h0.x, w0.x * l0.x) - mx.x);
    ce1 += ex2(fmaf(w1.y, h1.y, w1.x * l1.y) - mx.y);
  }
  const long long o = ((long long)n * gridDim.y + blockIdx.y) * w + x0;
  pred[o] = p0;
  conf[o] = ce0 / s0;
  if (x0 + 1 < w) {
    pred[o + 1] = p1;
    conf[o + 1] = ce1 / s1;
  }
}

template <typename T>
cudaError_t launch(const void* cost, const int* idx, const float* wgt,
                   float* pred, float* conf, int n, int d, int hq, int wq,
                   int maxdisp, int h, int w, int row0, int h_out,
                   cudaStream_t stream) {
  const int ncol = block_columns(wq, w);
  const dim3 grid((w + PX - 1) / PX, h_out, n);
  regression_kernel<T><<<grid, NT, smem_bytes(d, maxdisp, ncol), stream>>>(
      static_cast<const T*>(cost), idx, wgt, pred, conf, d, hq, wq, maxdisp,
      h, w, ncol, row0);
  return cudaGetLastError();
}

}  // namespace

// cost: (n, d, hq, wq), f32 (bf16 == 0) or bf16 (bf16 == 1); idx, wgt: the
// taps of the trilinear upsample to (maxdisp, h, w) and the source levels'
// first disparity levels (see regression_kernel); pred, conf: (n, h_out, w)
// f32, rows [row0, row0 + h_out) of the full-h output. Returns
// cudaErrorInvalidValue where the block's shared memory (smem_bytes)
// exceeds SMEM_MAX or the window is not rows of the output, else
// cudaGetLastError() after the launch.
extern "C" int fused_disparity_regression(int bf16, const void* cost,
                                          const void* idx, const void* wgt,
                                          void* pred, void* conf, int n, int d,
                                          int hq, int wq, int maxdisp, int h,
                                          int w, int row0, int h_out,
                                          void* stream) {
  if (smem_bytes(d, maxdisp, block_columns(wq, w)) > SMEM_MAX ||
      maxdisp < 1 || d < 1 || row0 < 0 || h_out < 1 || row0 + h_out > h) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(idx);
  const float* tw = static_cast<const float*>(wgt);
  float* pp = static_cast<float*>(pred);
  float* pc = static_cast<float*>(conf);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(cost, ti, tw, pp, pc, n, d, hq, wq,
                                   maxdisp, h, w, row0, h_out, st)
           : launch<float>(cost, ti, tw, pp, pc, n, d, hq, wq, maxdisp, h, w,
                           row0, h_out, st);
  return (int)e;
}
