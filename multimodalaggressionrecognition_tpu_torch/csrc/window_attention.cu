// Fused (shifted-)window attention forward (kernel K2) for Hopper, f32.
//
// Replaces `_fused_fwd` (with its body `_kernel`) in
// multimodalaggressionrecognition_tpu/ops/pallas/window_attention.py: for
// every window w and head h of Swin3D's window attention,
//
//   out[w, i, h*d:(h+1)*d] = sum_j p[i, j] * v[w, j, h],
//   p[i, :] = softmax_j(q[w, i, h] . k[w, j, h] / sqrt(d)
//                       + bias[h, i, j] + mask[w mod nW, i, j]),
//
// with q, k, v the three C-wide thirds of the packed qkv (W, N, 3C) and each
// head a d-wide slice of them (C = heads * d), bias (heads, N, N), mask
// (nW, N, N) or none, out (W, N, C), all row-major f32.  The (W, heads, N, N)
// score tensor never reaches device memory.
//
// Bound.  At Swin3D-T's stage 0 served at batch 8 (W=2048 windows of
// N=196 tokens, C=96, 3 heads, d=32, shifted mask nW=16) one launch does
// 4*W*heads*N^2*d = 30.2 GFLOP of f32 FMAs and moves
// 4*(W*N*3C + heads*N^2 + nW*N^2 + W*N*C) = 619 MB: 0.451 ms at the
// 67 TFLOP/s f32 (non-tensor-core) peak of an H100 SXM against 0.185 ms at
// 3.35 TB/s, so the kernel is bound by operations.  The twelve launches of
// one served forward come to 139 GFLOP, 2.08 ms.
//
// Design.  One block per (window, head), 8 warps.  The head's K and V
// slices are staged once in shared memory (K rows padded to d+4 floats, so
// the float4 loads of neighbouring keys by a quarter-warp hit distinct
// banks).  Each warp then takes ROWS=2 query rows at a time, held in
// registers and pre-scaled by 1/sqrt(d):
//   - scores: lanes split the keys; per key a lane reads K's row once (d/4
//     float4 loads) and feeds 2*d FMAs, then adds bias and mask read from
//     global memory (coalesced; both stay in L2) and writes the row into
//     the warp's slice of shared memory, tracking the row maxima;
//   - softmax: max and sum with warp shuffles, exp in place; the division
//     by the sum is postponed to the output (a d-wide instead of an N-wide
//     divide);
//   - p.v: lane e accumulates output dim e (d < 32: 32/d lane groups split
//     the keys and combine with shuffles), reading four keys' p as one
//     broadcast float4 and V's rows conflict-free.
// Shared memory is 4*(Np*(d+4) + Np*d + 16*Np) bytes, Np = N rounded up to
// 4: 66 KB at N=196 and 132 KB at the full N=392, so above 48 KB it is
// dynamic shared memory, with the limit raised before each launch.
// Measured, the kernel reaches about a fifth of the f32 peak: it is bound
// by latency, not by the FMA units or the shared-memory pipe, and more
// warps with fewer rows each (8 x 2) beat fewer with more (4 x 4).
// Not yet done (later work): register tiling of both products (several
// rows and keys or dims per thread, as an SGEMM does), and TF32 or bf16
// tensor cores, which would change the numerics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 2;       // query rows per warp pass
constexpr int MAX_N = 392;    // a full (8, 7, 7) window
constexpr unsigned FULL_MASK = 0xffffffffu;

int padded(int n) { return (n + 3) & ~3; }

size_t smem_bytes(int n, int d) {
  const size_t np = static_cast<size_t>(padded(n));
  return sizeof(float) * (np * (d + 4) + np * d + np * WARPS * ROWS);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
window_attention_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, float* __restrict__ out,
                        int N, int heads, int nw_img, float scale) {
  constexpr int KS = D + 4;  // K row stride (floats)
  constexpr int D4 = D / 4;
  constexpr int G = 32 / D;  // lane groups splitting the keys in p.v
  extern __shared__ __align__(16) float smem[];
  const int NP = (N + 3) & ~3;
  float* ks = smem;             // [NP][KS]
  float* vs = ks + NP * KS;     // [NP][D]
  float* ps = vs + NP * D;      // [WARPS][ROWS][NP]

  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const int64_t w = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const float* win = qkv + w * N * C3;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // stage K and V of (w, h); rows N..NP-1 are zero so p.v may read them
  for (int idx = threadIdx.x; idx < NP * D4; idx += THREADS) {
    const int j = idx / D4;
    const int c = (idx % D4) * 4;
    float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v4 = k4;
    if (j < N) {
      const float* row = win + j * C3 + h * D + c;
      k4 = __ldg(reinterpret_cast<const float4*>(row + C));
      v4 = __ldg(reinterpret_cast<const float4*>(row + 2 * C));
    }
    *reinterpret_cast<float4*>(ks + j * KS + c) = k4;
    *reinterpret_cast<float4*>(vs + j * D + c) = v4;
  }
  __syncthreads();

  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;
  const float* mask_w =
      mask ? mask + (w % nw_img) * static_cast<int64_t>(N) * N : nullptr;
  float* prow = ps + warp * ROWS * NP;
  const int g = lane / D;
  const int e = lane % D;

  for (int i0 = warp * ROWS; i0 < N; i0 += WARPS * ROWS) {
    int row[ROWS];
    float q[ROWS][D];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      row[r] = min(i0 + r, N - 1);  // a ragged last pass repeats row N-1
      const float4* qr =
          reinterpret_cast<const float4*>(win + row[r] * C3 + h * D);
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 q4 = __ldg(qr + c);
        q[r][4 * c + 0] = q4.x * scale;
        q[r][4 * c + 1] = q4.y * scale;
        q[r][4 * c + 2] = q4.z * scale;
        q[r][4 * c + 3] = q4.w * scale;
      }
    }

    // scores + bias + mask -> shared row, running maxima
    float mx[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) mx[r] = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < N; j += 32) {
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
      const float* kr = ks + j * KS;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          s[r] = fmaf(q[r][c + 0], k4.x, s[r]);
          s[r] = fmaf(q[r][c + 1], k4.y, s[r]);
          s[r] = fmaf(q[r][c + 2], k4.z, s[r]);
          s[r] = fmaf(q[r][c + 3], k4.w, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int64_t at = static_cast<int64_t>(row[r]) * N + j;
        float v = s[r] + __ldg(bias_h + at);
        if (mask_w) v += __ldg(mask_w + at);
        prow[r * NP + j] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }

    // softmax numerators in place (zero past N), and their sums
    float sum[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      mx[r] = warp_max(mx[r]);
      sum[r] = 0.f;
    }
    for (int j = lane; j < NP; j += 32) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float p = 0.f;
        if (j < N) p = __expf(prow[r * NP + j] - mx[r]);
        prow[r * NP + j] = p;
        sum[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sum[r] = warp_sum(sum[r]);
    __syncwarp();

    // p.v: lane group g takes keys 4g.., 4g+4G.., lane e output dim e
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int j = 4 * g; j < NP; j += 4 * G) {
      const float v0 = vs[(j + 0) * D + e];
      const float v1 = vs[(j + 1) * D + e];
      const float v2 = vs[(j + 2) * D + e];
      const float v3 = vs[(j + 3) * D + e];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + r * NP + j);
        acc[r] = fmaf(p4.x, v0, acc[r]);
        acc[r] = fmaf(p4.y, v1, acc[r]);
        acc[r] = fmaf(p4.z, v2, acc[r]);
        acc[r] = fmaf(p4.w, v3, acc[r]);
      }
    }
#pragma unroll
    for (int o = D; o < 32; o <<= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc[r] += __shfl_xor_sync(FULL_MASK, acc[r], o);
    }
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (i0 + r < N)
          out[(w * N + i0 + r) * C + h * D + e] = acc[r] / sum[r];
      }
    }
    __syncwarp();  // the next pass overwrites this warp's rows
  }
}

template <int D>
int launch(const float* qkv, const float* bias, const float* mask, float* out,
           int W, int N, int heads, int nw_img, float scale,
           cudaStream_t stream) {
  // per call, so that it holds on whichever device is current
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(MAX_N, D)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(W) * static_cast<unsigned>(heads);
  window_attention_kernel<D><<<blocks, THREADS, smem_bytes(N, D), stream>>>(
      qkv, bias, mask, out, N, heads, nw_img, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched).  `mask` may be
// null (no shifted-window mask; `nw_img` is then ignored).  The caller checks
// dtypes, contiguity, 16-byte alignment, W % nw_img == 0 and W * heads <
// 2**31; the shapes the kernel does not take (d not 8, 16 or 32; N outside
// 1..392) return cudaErrorInvalidValue.
extern "C" int window_attention_f32(const void* qkv, const void* bias,
                                    const void* mask, void* out, int W, int N,
                                    int heads, int d, int nw_img, float scale,
                                    void* stream) {
  if (W < 1 || heads < 1 || N < 1 || N > MAX_N || (mask && nw_img < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const float*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8>(q, b, m, o, W, N, heads, nw_img, scale, s);
    case 16:
      return launch<16>(q, b, m, o, W, N, heads, nw_img, scale, s);
    case 32:
      return launch<32>(q, b, m, o, W, N, heads, nw_img, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
