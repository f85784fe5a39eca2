// Fused (shifted-)window attention forward (kernel K2) for Hopper, in two
// instantiations: f32 qkv and output at f32 accuracy on the tensor cores
// (3xTF32, tf32x3.cuh), and bf16 qkv and output on the bf16 tensor cores
// (bf16mma.cuh).
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
// widens bf16 operands to f32, keeps p in f32 for p.v and rounds only its
// output to the output's dtype.  The bf16 instantiation gets the same
// numbers to f32 accuracy without widening: q.k^T of bf16 operands is exact
// products summed in f32, and p.v takes p as two bf16 pieces (bf16mma.cuh);
// only the output is rounded.  The (W, heads, N, N) score tensor never
// reaches device memory.  On the training path the kernel also writes each
// row's logsumexp, lse (W, heads, N) f32, from the running max and sum it
// already keeps (base e in f32, base 2 in bf16, where the scores are kept
// in base 2), so that the backward (K3) rebuilds p = exp(s - lse) without a
// sweep of its own to find them; 4*W*heads*N bytes more (4.8 MB at stage
// 0), and the output is the same bit for bit with and without it.
//
// Bound.  At Swin3D-T's stage 0 served at batch 8 (W=2048 windows of
// N=196 tokens, C=96, 3 heads, d=32, shifted mask nW=16) one launch does
// 4*W*heads*N^2*d = 30.2 GFLOP and moves
// 4*(W*N*3C + heads*N^2 + nW*N^2 + W*N*C) = 619 MB.  On an H100 SXM that is
// 0.185 ms at 3.35 TB/s against 0.183 ms for the three TF32 passes of every
// product at 495 TFLOP/s: bound by bytes (0.451 ms at the 67 TFLOP/s f32
// FMA peak, which the earlier designs used).  In bf16 qkv and out move half
// the bytes, 311 MB, 0.093 ms, against 0.046 ms for the products (q.k^T in
// one bf16 pass, p.v in two, at 989 TFLOP/s): bound by bytes.
//
// f32 design (FlashAttention-2's layout on mma.sync.m16n8k8, see
// tf32x3.cuh).  One block of 4 warps per (window, head).  The head's K and
// V slices are copied to shared memory with 16-byte cp.async (unpadded,
// swizzled rows, zero past N: 57 KB at N=196, so three blocks fit on an
// SM).  A warp owns 16 query rows at a time, their q / sqrt(d) split into
// tf32 halves in registers; for each step of 32 keys (four 8-key tiles, four
// independent mma chains) it computes S = q K^T on the tensor cores, adds
// the bias and mask[w mod nW] at the accumulator's positions (fetched
// through L2 one step ahead), sets keys past N to -inf, updates the rows'
// running max and sum (reduced over the lane quad that shares a row),
// rescales the output accumulator and adds P V, with P taken straight from
// S's accumulator by the permuted reduction index.  The division by the row
// sum happens once, at the end.  The score tile never leaves registers.
//
// bf16 design, the same flow on mma.sync.m16n8k16 (FlashAttention-2's
// register reuse).  K and V stay bf16 in shared memory, copied as they are
// with 16-byte cp.async into swizzled tiles (26 KB at N=196, 52 KB at 392)
// that ldmatrix reads without bank conflicts.  A warp's 16 query rows are
// their raw bf16 q in registers (A fragments, loaded once); per step of 16
// keys (32 where N > 256), S = q K^T is one bf16 pass (K's B fragments by
// ldmatrix), the scores s = S / sqrt(d) + bias + mask are f32 and kept in
// base 2 (times log2e, so each exponential is one MUFU.EX2), and so are
// the online max, sum and p; p is split into bf16 hi and lo from each two
// adjacent 8-key accumulators, which are exactly one 16-deep A fragment,
// and p.v is two m16n8k16 per 8 output columns (V's B fragments by
// transposed ldmatrix).  mma.sync rather than wgmma: N=196 fills 13 tiles
// of 16 rows (208) where wgmma's 64-row tiles would take 256, and a warp's
// rows keep their softmax in the warp.  What bounds it is the bias and
// mask reads: each block reads 2*N^2*4 bytes of them through L2 (1.9 GB a
// launch at stage 0, 4.5 GB at the extraction's N = 392, where the bound
// counts them once), and at stage 0 the launch without its mask takes a
// fifth less.  A block over two windows of one head and mask slot, whose
// warps share those reads through L1, halved the mask's cost but ran
// slower as a whole.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int MAX_N = 392;  // a full (8, 7, 7) window

namespace f32path {

using namespace tf32x3;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

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

template <int D>
__global__ void __launch_bounds__(THREADS, 3)
window_attention_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        float* __restrict__ out, float* __restrict__ lse,
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
  const float* win = qkv + w * N * C3 + h * D;
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
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    float* oa = out + (w * N + r0 + g) * C + h * D + 2 * t;
    float* ob = oa + 8 * C;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      if (r0 + g < N) st2(oa + nt * 8, o[nt][0] * inv0, o[nt][1] * inv0);
      if (r0 + g + 8 < N) st2(ob + nt * 8, o[nt][2] * inv1, o[nt][3] * inv1);
    }
    if (lse && t == 0) {  // the rows' logsumexp, base e, for K3
      float* la = lse + (w * heads + h) * N + r0 + g;
      if (r0 + g < N) la[0] = m0 + __logf(l0);
      if (r0 + g + 8 < N) la[8] = m1 + __logf(l1);
    }
  }
}

template <int D>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(window_attention_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(MAX_N, D)));
}

template <int D>
int launch(const float* qkv, const float* bias, const float* mask,
           float* out, float* lse, int W, int N, int heads, int nw_img,
           float scale, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(W) * static_cast<unsigned>(heads);
  window_attention_kernel<D><<<blocks, THREADS, smem_bytes(N, D), stream>>>(
      qkv, bias, mask, out, lse, N, heads, nw_img, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int info(int N, int* out) {
  cudaError_t err = raise_smem_limit<D>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], window_attention_kernel<D>, THREADS, smem_bytes(N, D));
  out[0] = THREADS;
  out[1] = static_cast<int>(smem_bytes(N, D));
  return static_cast<int>(err);
}

}  // namespace f32path

namespace bf16path {

using namespace bf16mma;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// JT 8-key tiles per step, each with its own score accumulator; an even
// count, as p.v takes the keys 16 at a time.  Up to N = 256 two tiles, at
// 111 registers and 4 blocks an SM, beat four (167 registers, 3 blocks) at
// stage 0; at N = 392, where shared memory allows 4 blocks at most, four
// tiles' independent mma chains beat two.
constexpr int jt_for(int n) { return n <= 256 ? 2 : 4; }

__host__ __device__ constexpr int keys_padded(int n, int jt) {
  return (n + 8 * jt - 1) / (8 * jt) * (8 * jt);
}

// bf16 K and V tiles, N rounded up to a step's keys, of d elements each
size_t smem_bytes(int n, int d) {
  return sizeof(bf16) * 2 * static_cast<size_t>(keys_padded(n, jt_for(n))) *
         d;
}

template <int D, int JT>
__global__ void __launch_bounds__(THREADS, JT == 2 ? 4 : 3)
window_attention_bf16_kernel(const bf16* __restrict__ qkv,
                             const float* __restrict__ bias,
                             const float* __restrict__ mask,
                             bf16* __restrict__ out, float* __restrict__ lse,
                             int N, int heads, int nw_img, float scale) {
  static_assert(JT % 2 == 0, "p.v's A fragments are pairs of 8-key tiles");
  constexpr int KC = D / 8;  // 8-wide chunks of d: the n-tiles of p.v
  constexpr int STEP = 8 * JT;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int NK = keys_padded(N, JT);
  bf16* ks = reinterpret_cast<bf16*>(smem_bf16);  // [NK][D], swizzled
  bf16* vs = ks + NK * D;

  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const int64_t w = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const bf16* win = qkv + w * N * C3 + h * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
  const float scale2 = scale * LOG2E;

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
    const Rows<D> qa = load_a_rows<D>(win + ra * C3, win + rb * C3, lane);
    const RowBias<JT> rows(bias_h, mask_w, ra, rb, N, t);

    float o[KC][4];
#pragma unroll
    for (int nt = 0; nt < KC; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;
    float bv[JT][4], mv[JT][4];
    rows.fetch(0, bv, mv);

#pragma unroll 1
    for (int j0 = 0; j0 < N; j0 += STEP) {
      float s[JT][4];
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
        uint32_t kb[KC];
        load_bt<D>(ks, j0 + 8 * u, lane, kb);
        mma_d<D>(s[u], qa, kb);
      }
      float x0 = neg_inf, x1 = neg_inf;
#pragma unroll
      for (int u = 0; u < JT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e)  // in base 2: s * log2e
          s[u][e] = fmaf(s[u][e], scale2, (bv[u][e] + mv[u][e]) * LOG2E);
        x0 = fmaxf(x0, fmaxf(s[u][0], s[u][1]));
        x1 = fmaxf(x1, fmaxf(s[u][2], s[u][3]));
      }
      rows.fetch(j0 + STEP, bv, mv);  // the next step's, in flight meanwhile
      // key j0 < N is in every step, so the new maxima are finite
      const float n0 = fmaxf(m0, quad_max(x0));
      const float n1 = fmaxf(m1, quad_max(x1));
      const float corr0 = exp2_ftz(m0 - n0), corr1 = exp2_ftz(m1 - n1);  // 0 first
      m0 = n0;
      m1 = n1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) {
        o[nt][0] *= corr0;
        o[nt][1] *= corr0;
        o[nt][2] *= corr1;
        o[nt][3] *= corr1;
      }
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        s[u][0] = exp2_ftz(s[u][0] - n0);
        s[u][1] = exp2_ftz(s[u][1] - n0);
        s[u][2] = exp2_ftz(s[u][2] - n1);
        s[u][3] = exp2_ftz(s[u][3] - n1);
        l0 += s[u][0] + s[u][1];
        l1 += s[u][2] + s[u][3];
      }
#pragma unroll
      for (int u = 0; u < JT; u += 2) {
        uint32_t hi[4], lo[4];
        acc_pair_a(s[u], s[u + 1], hi, lo);
        uint32_t vb[KC][2];
        load_b_rows16<D>(vs, j0 + 8 * u, lane, vb);
#pragma unroll
        for (int nt = 0; nt < KC; ++nt)
          mma_pieces(o[nt], hi, lo, vb[nt][0], vb[nt][1]);
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* oa = out + (w * N + r0 + g) * C + h * D + 2 * t;
    bf16* ob = oa + 8 * C;
#pragma unroll
    for (int nt = 0; nt < KC; ++nt) {
      if (r0 + g < N) st2(oa + nt * 8, o[nt][0] * inv0, o[nt][1] * inv0);
      if (r0 + g + 8 < N) st2(ob + nt * 8, o[nt][2] * inv1, o[nt][3] * inv1);
    }
    if (lse && t == 0) {  // the rows' logsumexp, base 2 (as m is), for K3
      float* la = lse + (w * heads + h) * N + r0 + g;
      if (r0 + g < N) la[0] = m0 + __log2f(l0);
      if (r0 + g + 8 < N) la[8] = m1 + __log2f(l1);
    }
  }
}

template <int D, int JT>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(window_attention_bf16_kernel<D, JT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(MAX_N, D)));
}

template <int D, int JT>
int launch_jt(const bf16* qkv, const float* bias, const float* mask,
              bf16* out, float* lse, int W, int N, int heads, int nw_img,
              float scale, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<D, JT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(W) * static_cast<unsigned>(heads);
  window_attention_bf16_kernel<D, JT><<<blocks, THREADS, smem_bytes(N, D),
                                        stream>>>(qkv, bias, mask, out, lse,
                                                  N, heads, nw_img, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const bf16* qkv, const float* bias, const float* mask, bf16* out,
           float* lse, int W, int N, int heads, int nw_img, float scale,
           cudaStream_t stream) {
  return jt_for(N) == 2 ? launch_jt<D, 2>(qkv, bias, mask, out, lse, W, N,
                                          heads, nw_img, scale, stream)
                        : launch_jt<D, 4>(qkv, bias, mask, out, lse, W, N,
                                          heads, nw_img, scale, stream);
}

template <int D, int JT>
int info_jt(int N, int* out) {
  cudaError_t err = raise_smem_limit<D, JT>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], window_attention_bf16_kernel<D, JT>, THREADS,
        smem_bytes(N, D));
  out[0] = THREADS;
  out[1] = static_cast<int>(smem_bytes(N, D));
  return static_cast<int>(err);
}

template <int D>
int info(int N, int* out) {
  return jt_for(N) == 2 ? info_jt<D, 2>(N, out) : info_jt<D, 4>(N, out);
}

}  // namespace bf16path

// f(std::integral_constant<int, d>()) for the head dims the kernels take
template <typename F>
int with_head_dim(int d, F f) {
  switch (d) {
    case 8:
      return f(std::integral_constant<int, 8>());
    case 16:
      return f(std::integral_constant<int, 16>());
    case 32:
      return f(std::integral_constant<int, 32>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(int W, int N, int heads, const void* mask, int nw_img) {
  return W >= 1 && heads >= 1 && N >= 1 && N <= MAX_N &&
         (!mask || nw_img >= 1);
}

}  // namespace

// Launch on `stream`; return a cudaError_t (0 = launched).  qkv and out are
// f32 (window_attention_f32) or bf16 (window_attention_bf16), bias and mask
// f32.  `mask` may be null (no shifted-window mask; `nw_img` is then
// ignored).  `lse` may be null; otherwise it gets each row's logsumexp of
// its scores, (W, heads, N) f32, for the backward (K3): in base e from
// window_attention_f32, in base 2 (log2 of the sum of 2^(s log2e)) from
// window_attention_bf16.  `out` is the same with and without it.  The
// caller checks dtypes, contiguity, 16-byte alignment, W % nw_img == 0 and
// W * heads < 2**31; the shapes the kernel does not take (d not 8, 16 or
// 32; N outside 1..392) return cudaErrorInvalidValue.
extern "C" int window_attention_f32(const void* qkv, const void* bias,
                                    const void* mask, void* out, void* lse,
                                    int W, int N, int heads, int d,
                                    int nw_img, float scale, void* stream) {
  if (!valid(W, N, heads, mask, nw_img))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(d, [&](auto D) {
    return f32path::launch<decltype(D)::value>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<float*>(out),
        static_cast<float*>(lse), W, N, heads, nw_img, scale,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" int window_attention_bf16(const void* qkv, const void* bias,
                                     const void* mask, void* out, void* lse,
                                     int W, int N, int heads, int d,
                                     int nw_img, float scale, void* stream) {
  if (!valid(W, N, heads, mask, nw_img))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(d, [&](auto D) {
    return bf16path::launch<decltype(D)::value>(
        static_cast<const bf16mma::bf16*>(qkv),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<bf16mma::bf16*>(out), static_cast<float*>(lse), W, N,
        heads, nw_img, scale, static_cast<cudaStream_t>(stream));
  });
}

// The launch of the f32 (bf16 = 0) or the bf16 (bf16 = 1) instantiation at
// (N, d): out = {threads per block, dynamic shared memory bytes, resident
// blocks per SM}; returns a cudaError_t.
extern "C" int window_attention_info(int N, int d, int bf16, int* out) {
  if (N < 1 || N > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(d, [&](auto D) {
    constexpr int d_ = decltype(D)::value;
    return bf16 ? bf16path::info<d_>(N, out) : f32path::info<d_>(N, out);
  });
}
