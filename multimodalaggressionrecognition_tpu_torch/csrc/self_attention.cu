// Self-attention forward for bf16 qkv on Hopper's bf16 tensor cores, with
// dropout of the attention weights drawn by the caller.
//
// It replaces no TPU kernel: the JAX package leaves this attention to XLA.
// It is the unmasked bf16 path of models/layers.py's
// `MultiheadSelfAttention._attend` (XLS-R's and the wav2vec-2 family's
// transformer layers), whose plain composition makes a pass over device
// memory per op of the (B, heads, T, T) scores: f32 q.k^T, the 1/sqrt(d)
// scale, softmax, a cast, the dropout's compare, 1/keep and select, and
// P.V, each 255-510 MB a layer at XLS-R's 10 s clips.  For packed qkv
// (B, T, 3C), C = heads * d, each head a d-wide slice of the q, k and v
// thirds, and uniforms u (B, heads, T, T) f32 (the layer dropout's one
// torch.rand, or none) it computes
//
//   out[b, i, h*d:(h+1)*d] = sum_j p[i, j] * m[i, j] / keep * v[b, j, h],
//   p[i, :] = softmax_j(q[b, i, h] . k[b, j, h] / sqrt(d)),
//   m[i, j] = u[b, h, i, j] < keep,
//
// the comparison the plain dropout makes in f32, so the keep mask is the
// same bit for bit; without uniforms m = 1 and keep = 1 (eval, or rate 0).
// On the training path it also writes each row's logsumexp (base 2, f32)
// and the keep mask, one bit an element (self_attention.cuh), for the
// backward: (B, heads, T, T) of anything else never reaches device memory.
//
// Precision.  q.k^T is one bf16 pass with f32 accumulation: the products
// of bf16 operands are exact, as the plain composition's f32 upcast makes
// them.  The scores are scaled by log2(e) / sqrt(d) in f32 and the online
// softmax runs in base 2 in f32.  P.V takes the kept, unnormalized weights
// as two bf16 pieces (bf16mma.cuh), and the division by the row sum and by
// keep happens once, in f32, before the output is rounded to bf16: the
// plain composition rounds the weights to bf16 twice (the cast, then
// x / keep).
//
// Bound.  At XLS-R's shape (B = 32, 16 heads, T = 499, d = 64) a layer's
// launch does 2 * 2 * B * heads * T^2 * d = 32.6 GFLOP and moves the
// uniforms (4 * B * heads * T^2 = 510 MB, read once), qkv (98 MB), the
// output (33 MB), the mask (16 MB) and lse (1 MB): 0.196 ms at 3.35 TB/s
// against 0.050 ms for the products at 989 TFLOP/s (q.k^T one pass, P.V
// two): bound by bytes, most of them the uniforms.
//
// Design (FlashAttention-2's forward on mma.sync.m16n8k16).  One block of
// 4 warps per (batch, head, 64 query rows), a warp's 16 rows their raw
// bf16 q in registers (A fragments).  The keys go by in tiles of 64: each
// tile's K and V (bf16, swizzled, zero past T) and its 64 x 64 uniforms
// are copied into shared memory with cp.async while the previous tile is
// computed (double-buffered).  The uniforms come 4 bytes a thread, fully
// coalesced (a row of T floats is not 16-byte aligned for odd T), with an
// evict-first L2 policy, since they are read once; their tile's rows are
// padded to 72 floats, so that a warp's 8-byte reads of its fragments'
// positions hit 32 distinct banks.  Per tile, S = q K^T (8 score
// accumulators of 8 keys), keys past T set to -inf, the running max and
// sum, exp2, the mask from u < keep, and P.V with p from each two adjacent
// accumulators as one 16-deep A fragment (hi and lo pieces).  Rows past T
// repeat row T - 1 and are not stored.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "self_attention.cuh"

namespace {

using namespace bf16mma;
using namespace self_attention;

// row stride of a staged uniform tile, in floats
constexpr int US = TILE + 8;

template <int D>
size_t smem_bytes(bool drop) {
  return sizeof(bf16) * 4 * TILE * D +
         (drop ? sizeof(float) * 2 * TILE * US : 0);
}

// rows [0, nr) and columns [0, nc) of a 64 x 64 block of the T x T
// uniforms at src (row stride T) into a [TILE][US] tile; the rest 1
// (dropped), which only positions past T take
__device__ __forceinline__ void stage_uniforms(float* tile, const float* src,
                                               int T, int nr, int nc,
                                               uint64_t policy) {
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    const int r = idx / TILE;
    const int c = idx % TILE;
    float* dst = tile + r * US + c;
    if (r < nr && c < nc)
      cp_async4_evict_first(dst, src + static_cast<int64_t>(r) * T + c,
                            policy);
    else
      *dst = 1.f;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 3)
self_attention_kernel(const bf16* __restrict__ qkv,
                      const float* __restrict__ uni, bf16* __restrict__ out,
                      float* __restrict__ lse, uint32_t* __restrict__ bits,
                      int T, int heads, float scale2, float keep) {
  constexpr int KC = D / 8;  // 8-wide chunks of d: the n-tiles of P.V
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][TILE][D], swizzled
  bf16* vs = ks + 2 * TILE * D;              // [2][TILE][D]
  float* us = reinterpret_cast<float*>(vs + 2 * TILE * D);  // [2][TILE][US]

  const int nt = tiles(T);
  const int64_t bh = blockIdx.x / nt;
  const int q0 = static_cast<int>(blockIdx.x % nt) * TILE;
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const bf16* tok = qkv + b * T * C3 + h * D;  // q of token i at tok + i*C3
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
  const int r0 = q0 + warp * 16;
  // rows a = r0+g and b = r0+g+8; a row past T repeats row T-1 (discarded)
  const int ra = min(r0 + g, T - 1), rb = min(r0 + g + 8, T - 1);
  const int nq = min(TILE, T - q0);
  const float* urows = DROP ? uni + (bh * T + q0) * T : nullptr;
  const uint64_t policy = DROP ? evict_first_policy() : 0;

  auto stage_tile = [&](int kt) {
    const int j0 = kt * TILE, n = min(TILE, T - j0), buf = kt & 1;
    stage<D>(ks + buf * TILE * D, tok + C + j0 * C3, C3, n, TILE);
    stage<D>(vs + buf * TILE * D, tok + 2 * C + j0 * C3, C3, n, TILE);
    if constexpr (DROP)
      stage_uniforms(us + buf * TILE * US, urows + j0, T, nq, n, policy);
    cp_async_commit();
  };

  const Rows<D> qa = load_a_rows<D>(tok + ra * C3, tok + rb * C3, lane);
  float o[KC][4];
#pragma unroll
  for (int n = 0; n < KC; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;

  stage_tile(0);
#pragma unroll 1
  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) {
      stage_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (r0 < T) {
      const bf16* kts = ks + (kt & 1) * TILE * D;
      const bf16* vts = vs + (kt & 1) * TILE * D;
      const int left = T - kt * TILE;  // key 8u + x of the tile is in if < left
      float s[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
        uint32_t kb[KC];
        load_bt<D>(kts, 8 * u, lane, kb);
        mma_d<D>(s[u], qa, kb);
      }
      float x0 = neg_inf, x1 = neg_inf;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // in base 2: s * log2e / sqrt(d)
          s[u][e] = 8 * u + 2 * t + (e & 1) < left ? s[u][e] * scale2
                                                   : neg_inf;
          if (e < 2)
            x0 = fmaxf(x0, s[u][e]);
          else
            x1 = fmaxf(x1, s[u][e]);
        }
      // the tile's first key is in, so the new maxima are finite
      const float n0 = fmaxf(m0, quad_max(x0));
      const float n1 = fmaxf(m1, quad_max(x1));
      const float c0 = exp2_ftz(m0 - n0), c1 = exp2_ftz(m1 - n1);  // 0 first
      m0 = n0;
      m1 = n1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int n = 0; n < KC; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
      // this lane's keep bits of rows a and b: words 0 (keys 0-31) and 1
      uint32_t wa[2] = {0u, 0u}, wb[2] = {0u, 0u};
      const float* ua = us + (kt & 1) * TILE * US + (warp * 16 + g) * US + 2 * t;
      const float* ub = ua + 8 * US;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s[u][0] = exp2_ftz(s[u][0] - n0);
        s[u][1] = exp2_ftz(s[u][1] - n0);
        s[u][2] = exp2_ftz(s[u][2] - n1);
        s[u][3] = exp2_ftz(s[u][3] - n1);
        l0 += s[u][0] + s[u][1];  // the row sum counts dropped weights too
        l1 += s[u][2] + s[u][3];
        if constexpr (DROP) {
          const float2 xa = *reinterpret_cast<const float2*>(ua + 8 * u);
          const float2 xb = *reinterpret_cast<const float2*>(ub + 8 * u);
          const bool k0 = xa.x < keep, k1 = xa.y < keep;
          const bool k2 = xb.x < keep, k3 = xb.y < keep;
          const int at_bit = 8 * (u & 3) + 2 * t;
          wa[u >> 2] |= (static_cast<uint32_t>(k0) |
                         static_cast<uint32_t>(k1) << 1) << at_bit;
          wb[u >> 2] |= (static_cast<uint32_t>(k2) |
                         static_cast<uint32_t>(k3) << 1) << at_bit;
          s[u][0] = k0 ? s[u][0] : 0.f;
          s[u][1] = k1 ? s[u][1] : 0.f;
          s[u][2] = k2 ? s[u][2] : 0.f;
          s[u][3] = k3 ? s[u][3] : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4], vb[KC][2];
        acc_pair_a(s[2 * kk], s[2 * kk + 1], hi, lo);
        load_b_rows16<D>(vts, 16 * kk, lane, vb);
#pragma unroll
        for (int n = 0; n < KC; ++n)
          mma_pieces(o[n], hi, lo, vb[n][0], vb[n][1]);
      }
      if (DROP && bits) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {  // the row's word from its lane quad
          wa[w] |= __shfl_xor_sync(FULL_MASK, wa[w], 1);
          wa[w] |= __shfl_xor_sync(FULL_MASK, wa[w], 2);
          wb[w] |= __shfl_xor_sync(FULL_MASK, wb[w], 1);
          wb[w] |= __shfl_xor_sync(FULL_MASK, wb[w], 2);
        }
        if (t == 0) {
          const int mw = mask_words(T);
          uint32_t* row = bits + (bh * T + r0 + g) * mw + 2 * kt;
          if (r0 + g < T)
            *reinterpret_cast<uint2*>(row) = make_uint2(wa[0], wa[1]);
          if (r0 + g + 8 < T)
            *reinterpret_cast<uint2*>(row + 8 * mw) = make_uint2(wb[0], wb[1]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for the tile after next
  }
  if (r0 >= T) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv_keep = DROP ? 1.f / keep : 1.f;
  const float i0 = inv_keep / l0, i1 = inv_keep / l1;
  bf16* oa = out + (b * T + r0 + g) * C + h * D + 2 * t;
  bf16* ob = oa + 8 * C;
#pragma unroll
  for (int n = 0; n < KC; ++n) {
    if (r0 + g < T) st2(oa + n * 8, o[n][0] * i0, o[n][1] * i0);
    if (r0 + g + 8 < T) st2(ob + n * 8, o[n][2] * i1, o[n][3] * i1);
  }
  if (lse && t == 0) {  // the rows' logsumexp, base 2 (as m is)
    float* la = lse + bh * T + r0 + g;
    if (r0 + g < T) la[0] = m0 + log2f(l0);
    if (r0 + g + 8 < T) la[8] = m1 + log2f(l1);
  }
}

template <int D, bool DROP>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(self_attention_kernel<D, DROP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<D>(DROP)));
}

template <int D, bool DROP>
int launch(const bf16* qkv, const float* uni, bf16* out, float* lse,
           uint32_t* bits, int B, int T, int heads, float keep,
           cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<D, DROP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(B) * heads * tiles(T);
  const float scale2 = bf16mma::LOG2E / sqrtf(static_cast<float>(D));
  self_attention_kernel<D, DROP><<<blocks, THREADS, smem_bytes<D>(DROP),
                                   stream>>>(qkv, uni, out, lse, bits, T,
                                             heads, scale2, keep);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DROP>
int info(int* out) {
  cudaError_t err = raise_smem_limit<D, DROP>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], self_attention_kernel<D, DROP>, THREADS,
        smem_bytes<D>(DROP));
  out[0] = THREADS;
  out[1] = static_cast<int>(smem_bytes<D>(DROP));
  return static_cast<int>(err);
}

// f(std::integral_constant<int, d>()) for the head dims the kernel takes
template <typename F>
int with_head_dim(int d, F f) {
  switch (d) {
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; return a cudaError_t (0 = launched).  qkv (B, T,
// 3 * heads * d) and out (B, T, heads * d) bf16; `uniforms` (B, heads, T, T)
// f32, or null for no dropout (`keep` is then ignored); `lse` (B, heads, T)
// f32 and `bits` (B, heads, T, mask_words(T)) 32-bit words may be null,
// which skips writing them (the mask needs uniforms).  The caller checks
// dtypes, contiguity, 16-byte alignment and B * heads * tiles(T) < 2**31;
// d other than 32 or 64 returns cudaErrorInvalidValue.
extern "C" int self_attention_bf16(const void* qkv, const void* uniforms,
                                   void* out, void* lse, void* bits, int B,
                                   int T, int heads, int d, float keep,
                                   void* stream) {
  if (B < 1 || T < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(d, [&](auto D) {
    constexpr int d_ = decltype(D)::value;
    const auto* q = static_cast<const bf16mma::bf16*>(qkv);
    auto* o = static_cast<bf16mma::bf16*>(out);
    auto* l = static_cast<float*>(lse);
    auto* m = static_cast<uint32_t*>(bits);
    auto* s = static_cast<cudaStream_t>(stream);
    return uniforms ? launch<d_, true>(q, static_cast<const float*>(uniforms),
                                       o, l, m, B, T, heads, keep, s)
                    : launch<d_, false>(q, nullptr, o, l, nullptr, B, T,
                                        heads, 1.f, s);
  });
}

// The launch at head dim d with (drop = 1) or without dropout: out =
// {threads per block, dynamic shared memory bytes, resident blocks per
// SM}; returns a cudaError_t.
extern "C" int self_attention_info(int d, int drop, int* out) {
  return with_head_dim(d, [&](auto D) {
    constexpr int d_ = decltype(D)::value;
    return drop ? info<d_, true>(out) : info<d_, false>(out);
  });
}
