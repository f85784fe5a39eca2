// Fused (shifted-)window attention forward (kernel K2) for Hopper, f32
// accuracy on the tensor cores (3xTF32), with f32 or bf16 qkv and output.
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
// (nW, N, N) or none, out (W, N, C), all row-major; qkv and out are f32 or
// both bf16 (the model's compute dtype), bias and mask f32.  The TPU kernel
// reads bf16 qkv the same way: it widens each operand to f32 and rounds only
// its output to the output's dtype; so does this one (tf32x3.cuh, storage
// types).  The (W, heads, N, N) score tensor never reaches device memory.
//
// Bound.  At Swin3D-T's stage 0 served at batch 8 (W=2048 windows of
// N=196 tokens, C=96, 3 heads, d=32, shifted mask nW=16) one launch does
// 4*W*heads*N^2*d = 30.2 GFLOP and moves
// 4*(W*N*3C + heads*N^2 + nW*N^2 + W*N*C) = 619 MB.  On an H100 SXM that is
// 0.185 ms at 3.35 TB/s against 0.183 ms for the three TF32 passes of every
// product at 495 TFLOP/s: bound by bytes (0.451 ms at the 67 TFLOP/s f32
// FMA peak, which the earlier designs used).  In bf16 qkv and out move half
// the bytes, 311 MB, 0.093 ms: the operations bound it, as the same 3xTF32
// products still run on the widened operands.
//
// Design (FlashAttention-2's layout on mma.sync.m16n8k8, see tf32x3.cuh).
// One block of 4 warps per (window, head).  The head's K and V slices are
// copied to shared memory with 16-byte cp.async (unpadded, swizzled rows,
// zero past N: 57 KB at N=196, so three blocks fit on an SM).  A warp owns
// 16 query rows at a time, their q / sqrt(d) split into tf32 halves in
// registers; for each step of 32 keys (four 8-key tiles, four independent
// mma chains) it computes S = q K^T on the tensor cores, adds the bias and
// mask[w mod nW] at the accumulator's positions (fetched through L2 one
// step ahead), sets keys past N to -inf, updates the rows' running max and
// sum (reduced over the lane quad that shares a row), rescales the output
// accumulator and adds P V, with P taken straight from S's accumulator by
// the permuted reduction index.  The division by the row sum happens once,
// at the end.  The score tile never leaves registers.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_N = 392;  // a full (8, 7, 7) window

// 8-key tiles per step, each with its own score accumulator, so that a warp
// keeps JT independent mma chains in flight (4 beat 2 and 1 at stage 0)
constexpr int JT = 4;
constexpr int STEP = 8 * JT;

__host__ __device__ constexpr int keys_padded(int n) {
  return (n + STEP - 1) / STEP * STEP;
}

// K and V tiles, N rounded up to STEP rows of d floats each
size_t smem_bytes(int n, int d) {
  return sizeof(float) * 2 * static_cast<size_t>(keys_padded(n)) * d;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 3)
window_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int N, int heads, int nw_img, float scale) {
  constexpr int KT = D / 8;  // k-steps of q.k, n-tiles of p.v
  extern __shared__ __align__(16) float smem[];
  const int NK = keys_padded(N);
  float* ks = smem;       // [NK][D], swizzled
  float* vs = ks + NK * D;

  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const int64_t w = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const T* win = qkv + w * N * C3 + h * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);

  stage<D>(ks, win + C, C3, N, NK);
  stage<D>(vs, win + 2 * C, C3, N, NK);
  cp_async_wait_all();
  __syncthreads();

  const float* bias_h = bias + static_cast<int64_t>(h) * N * N;
  const float* mask_w =
      mask ? mask + (w % nw_img) * static_cast<int64_t>(N) * N : nullptr;

  for (int r0 = warp * 16; r0 < N; r0 += WARPS * 16) {
    // rows a = r0+g and b = r0+g+8; a row past N repeats row N-1 (discarded)
    const int ra = min(r0 + g, N - 1), rb = min(r0 + g + 8, N - 1);
    FragA qa[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      qa[kk] = load_a_rows(win + ra * C3, win + rb * C3, kk * 8, lane, scale);
    const RowBias<JT> rows(bias_h, mask_w, ra, rb, N, t);

    float o[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;
    float bv[JT][4], mv[JT][4];
    rows.fetch(0, bv, mv);

#pragma unroll 1
    for (int j0 = 0; j0 < N; j0 += STEP) {
      float s[JT][4];
#pragma unroll
      for (int u = 0; u < JT; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int u = 0; u < JT; ++u)
          mma3(s[u], qa[kk], load_bt<D>(ks, j0 + 8 * u, kk * 8, lane));
      float x0 = neg_inf, x1 = neg_inf;
#pragma unroll
      for (int u = 0; u < JT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] = s[u][e] + bv[u][e] + mv[u][e];
        x0 = fmaxf(x0, fmaxf(s[u][0], s[u][1]));
        x1 = fmaxf(x1, fmaxf(s[u][2], s[u][3]));
      }
      rows.fetch(j0 + STEP, bv, mv);  // the next step's, in flight meanwhile
      // key j0 < N is in every step, so the new maxima are finite
      const float n0 = fmaxf(m0, quad_max(x0));
      const float n1 = fmaxf(m1, quad_max(x1));
      const float corr0 = __expf(m0 - n0), corr1 = __expf(m1 - n1);  // 0 first
      m0 = n0;
      m1 = n1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        o[nt][0] *= corr0;
        o[nt][1] *= corr0;
        o[nt][2] *= corr1;
        o[nt][3] *= corr1;
      }
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        s[u][0] = __expf(s[u][0] - n0);
        s[u][1] = __expf(s[u][1] - n0);
        s[u][2] = __expf(s[u][2] - n1);
        s[u][3] = __expf(s[u][3] - n1);
        l0 += s[u][0] + s[u][1];
        l1 += s[u][2] + s[u][3];
        const FragA pa = acc_as_a(s[u]);
#pragma unroll
        for (int nt = 0; nt < KT; ++nt)
          mma3(o[nt], pa, load_b_pairs<D>(vs, j0 + 8 * u, nt * 8, lane));
      }
    }
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
    T* oa = out + (w * N + r0 + g) * C + h * D + 2 * t;
    T* ob = oa + 8 * C;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      if (r0 + g < N) st2(oa + nt * 8, o[nt][0] * inv0, o[nt][1] * inv0);
      if (r0 + g + 8 < N) st2(ob + nt * 8, o[nt][2] * inv1, o[nt][3] * inv1);
    }
  }
}

template <int D, typename T>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(window_attention_kernel<D, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(MAX_N, D)));
}

template <int D, typename T>
int launch(const T* qkv, const float* bias, const float* mask, T* out, int W,
           int N, int heads, int nw_img, float scale, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<D, T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(W) * static_cast<unsigned>(heads);
  window_attention_kernel<D, T><<<blocks, THREADS, smem_bytes(N, D), stream>>>(
      qkv, bias, mask, out, N, heads, nw_img, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int info(int N, int* out) {
  cudaError_t err = raise_smem_limit<D, float>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], window_attention_kernel<D, float>, THREADS, smem_bytes(N, D));
  out[0] = THREADS;
  out[1] = static_cast<int>(smem_bytes(N, D));
  return static_cast<int>(err);
}

template <typename T>
int dispatch(const void* qkv, const void* bias, const void* mask, void* out,
             int W, int N, int heads, int d, int nw_img, float scale,
             void* stream) {
  if (W < 1 || heads < 1 || N < 1 || N > MAX_N || (mask && nw_img < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const T*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<T*>(out);
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

}  // namespace

// Launch on `stream`; return a cudaError_t (0 = launched).  qkv and out are
// f32 (window_attention_f32) or bf16 (window_attention_bf16), bias and mask
// f32.  `mask` may be null (no shifted-window mask; `nw_img` is then
// ignored).  The caller checks dtypes, contiguity, 16-byte alignment,
// W % nw_img == 0 and W * heads < 2**31; the shapes the kernel does not take
// (d not 8, 16 or 32; N outside 1..392) return cudaErrorInvalidValue.
extern "C" int window_attention_f32(const void* qkv, const void* bias,
                                    const void* mask, void* out, int W, int N,
                                    int heads, int d, int nw_img, float scale,
                                    void* stream) {
  return dispatch<float>(qkv, bias, mask, out, W, N, heads, d, nw_img, scale,
                         stream);
}

extern "C" int window_attention_bf16(const void* qkv, const void* bias,
                                     const void* mask, void* out, int W,
                                     int N, int heads, int d, int nw_img,
                                     float scale, void* stream) {
  return dispatch<bf16>(qkv, bias, mask, out, W, N, heads, d, nw_img, scale,
                        stream);
}

// The launch at (N, d): out = {threads per block, dynamic shared memory
// bytes, resident blocks per SM}; returns a cudaError_t.
extern "C" int window_attention_info(int N, int d, int* out) {
  if (N < 1 || N > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8:
      return info<8>(N, out);
    case 16:
      return info<16>(N, out);
    case 32:
      return info<32>(N, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
