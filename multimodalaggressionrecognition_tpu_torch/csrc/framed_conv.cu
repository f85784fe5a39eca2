// Framed conv1d forward (kernel K1) for Hopper, f32.
//
// Replaces `framed_conv1d_pallas` (with its body `_kernel`) in
// multimodalaggressionrecognition_tpu/ops/pallas/framed_conv.py: a strided
// convolution over a single-channel signal,
//
//   y[b, t, c] = act((sum_f xpad[b, t*hop + f] * w[f, c] + bias[c])
//                    * scale[c] + shift[c]),
//   xpad = x zero-padded by `pad` on each side,
//   T = (L + 2*pad - F) / hop + 1,  act = ReLU or identity,
//
// with x (B, L), w (F, C), y (B, T, C), all row-major f32.  Any F and hop
// (F need not be a multiple of hop), any pad >= 0, ragged T and C edges.
//
// Bound.  At the CNN1D stem (B=32, L=80 000, F=160, hop=40, pad=80, C=64,
// T=2001) the work is 2*B*T*F*C = 1.31 GFLOP of f32 FMAs and the traffic is
// x 10.24 MB + y 16.39 MB + w 0.04 MB = 26.7 MB.  On an H100 SXM that is
// 19.6 us at the 67 TFLOP/s f32 (non-tensor-core) peak against 8.0 us at
// 3.35 TB/s: the kernel is bound by operations, not bytes.
//
// Design.  The padded copy and the (B, T, F) frame matrix never reach
// device memory: each block gathers the frames it needs straight from x
// (zero outside [0, L), so `pad` costs nothing) into shared memory, TILE_F
// taps at a time, next to the matching TILE_F x TILE_C slab of w.  Chunking
// F keeps shared memory at 8.5 KB for every route (stem, STFT F=512,
// resample) instead of staging all of w (40 KB at the stem, 1 MB for the
// STFT).  Each x element is gathered F/hop times (4x at the stem), from L1
// and the 50 MB L2, which hold the whole 10 MB signal: the redundant reads
// never touch HBM.  The arithmetic is an f32 register-tiled product: each
// thread keeps 8 frames x 2 channels of accumulators and, per tap, reads
// its 8 frames as two warp-broadcast float4 loads and its 2 weights as
// conflict-free scalars: 4 shared-memory loads per 16 FMAs, so the
// shared-memory pipe, not the FMA units, sets the pace (chip_smoke.py
// measured 0.058 ms on an H100 SXM at 700 W, 34 % of the bound).
// The epilogue applies bias, scale/shift (a folded inference BatchNorm)
// and ReLU in registers; each store instruction writes 32 consecutive
// channels of one frame (128 B, coalesced).  Offsets are 64-bit.
// Not yet done (later work): a larger register tile to cut loads per FMA,
// double-buffered cp.async staging, and TF32 or bf16 tensor cores, which
// would change the numerics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_T = 64;    // output frames per block
constexpr int TILE_C = 64;    // output channels per block
constexpr int TILE_F = 16;    // taps staged per step
constexpr int THREADS = 256;  // 8 warps: warp w owns frames 8w..8w+7
constexpr int XS_STRIDE = TILE_T + 4;  // float4-aligned, few bank conflicts

__global__ void __launch_bounds__(THREADS)
framed_conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ y,
                     int L, int F, int C, int T, int hop, int pad, int relu) {
  __shared__ __align__(16) float xs[TILE_F][XS_STRIDE];  // frames, tap-major
  __shared__ __align__(16) float ws[TILE_F][TILE_C];

  const int tid = threadIdx.x;
  const int lane = tid % 32;  // channels lane and lane + 32
  const int warp = tid / 32;  // frames 8*warp .. 8*warp + 7
  const int t0 = blockIdx.x * TILE_T;
  const int c0 = blockIdx.y * TILE_C;
  const int64_t b = blockIdx.z;
  const float* xb = x + b * static_cast<int64_t>(L);

  float acc[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int f0 = 0; f0 < F; f0 += TILE_F) {
#pragma unroll
    for (int k = 0; k < TILE_T * TILE_F / THREADS; ++k) {
      const int idx = tid + k * THREADS;
      const int f = idx % TILE_F;
      const int t = idx / TILE_F;
      const int64_t pos =
          static_cast<int64_t>(t0 + t) * hop + (f0 + f) - pad;
      float v = 0.f;
      if (t0 + t < T && f0 + f < F && pos >= 0 && pos < L) v = xb[pos];
      xs[f][t] = v;
    }
#pragma unroll
    for (int k = 0; k < TILE_C * TILE_F / THREADS; ++k) {
      const int idx = tid + k * THREADS;
      const int c = idx % TILE_C;
      const int f = idx / TILE_C;
      float v = 0.f;
      if (f0 + f < F && c0 + c < C)
        v = w[static_cast<int64_t>(f0 + f) * C + (c0 + c)];
      ws[f][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < TILE_F; ++f) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[f][warp * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[f][warp * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w0 = ws[f][lane];
      const float w1 = ws[f][lane + 32];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(a[i], w0, acc[i][0]);
        acc[i][1] = fmaf(a[i], w1, acc[i][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = c0 + lane + 32 * j;
    if (c >= C) continue;
    const float bc = bias[c];
    const float sc = scale ? scale[c] : 1.f;
    const float sh = shift ? shift[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + warp * 8 + i;
      if (t >= T) continue;
      float v = (acc[i][j] + bc) * sc + sh;
      if (relu) v = fmaxf(v, 0.f);
      y[(b * T + t) * static_cast<int64_t>(C) + c] = v;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  `scale`
// and `shift` may be null (1 and 0).  The caller checks shapes, dtypes,
// contiguity and B <= 65535.
extern "C" int framed_conv1d_f32(const void* x, const void* w, const void* bias,
                                 const void* scale, const void* shift, void* y,
                                 int B, int L, int F, int C, int T, int hop,
                                 int pad, int relu, void* stream) {
  const dim3 grid((T + TILE_T - 1) / TILE_T, (C + TILE_C - 1) / TILE_C, B);
  framed_conv1d_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(y), L, F, C, T,
      hop, pad, relu);
  return static_cast<int>(cudaGetLastError());
}
