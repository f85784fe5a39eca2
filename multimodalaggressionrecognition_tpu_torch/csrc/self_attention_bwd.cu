// Self-attention backward for bf16 qkv on Hopper's bf16 tensor cores: the
// gradient of self_attention.cu's forward, reading the row logsumexp and
// the bit-packed keep mask it wrote.
//
// It replaces no TPU kernel (the JAX package leaves this attention to
// XLA): it is the backward of the unmasked bf16 path of models/layers.py's
// `MultiheadSelfAttention._attend`, whose plain composition makes a pass
// over device memory per op of the (B, heads, T, T) scores.  For each
// (batch b, head h), with q, k, v the head's d-wide slices of the packed
// qkv (B, T, 3C), g the head's slice of the output gradient (B, T, C),
// lse the forward's row logsumexp (base 2) and m its keep mask, it
// recomputes
//
//   p = exp2(q k^T log2(e) / sqrt(d) - lse),   z = p m / keep,
//
// and from it
//
//   dV = z^T g,   dZ = g v^T,   dP = dZ m / keep,   D = rowsum(p dP),
//   dS = p (dP - D),   dQ = dS k / sqrt(d),   dK = dS^T q / sqrt(d),
//
// writing dqkv (B, T, 3C) bf16.  Without a mask (eval, rate 0) m = 1 and
// keep = 1.  Neither p nor dS reaches device memory; D (B, heads, T) f32
// goes from the first kernel to the second.
//
// Precision.  q.k^T and g.v^T are one bf16 pass each, exact products
// summed in f32.  The products with z, p dP, p and dS (f32) take them as
// two bf16 pieces (bf16mma.cuh): the plain composition runs them on bf16
// weights (z^T g) or in f32 (dS k, dS^T q).  D comes from p and dP in f32,
// in the same sweep as dQ (K3's bf16 route, window_attention_bwd.cu): the
// forward's output is rounded to bf16, too coarsely for D = g . o.
//
// Bound.  At XLS-R's shape (B = 32, 16 heads, T = 499, d = 64) the least
// work is q.k^T and g.v^T once each in one bf16 pass and z^T g, dS k and
// dS^T q in two (5 products of 2 * B * heads * T^2 * d = 16.3 GFLOP, 130.6
// GFLOP of passes: 0.132 ms at 989 TFLOP/s), against qkv, g, lse, the mask
// and dqkv (246 MB, 0.073 ms at 3.35 TB/s): bound by operations.  The two
// kernels below compute q.k^T and g.v^T twice, once a kernel, and dS k as
// (p dP) k - D (p k).
//
// Design (FlashAttention-2's backward, in two kernels, so that every sum
// stays in one warp's accumulators: no atomics, deterministic bit for bit).
// Each is one block of 4 warps per (batch, head, 64 rows), a warp per 16,
// walking the other side in tiles of 64 staged with cp.async while the
// previous tile is computed (double-buffered; bf16, swizzled, zero past
// T); the A operands are the raw bf16 rows in registers, and each 16 keys
// (or queries) of a tile go through the products in turn.
//   - row kernel, a block per 64 query rows, K and V staged: S = Q K^T and
//     dZ = G V^T, p from lse, dP from the mask words (read once a tile from
//     device memory), and in one sweep D = sum_j p dP, A = (p dP) K and
//     B = p K; then dQ = (A - D B) / sqrt(d), and D to device memory.
//   - column kernel, a block per 64 keys, Q, G, the rows' lse and D, and
//     the tile's two mask words a row staged: S^T = K Q^T and dZ^T = V G^T,
//     p, z and dS, dV += z^T G and dK += dS^T Q.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "self_attention.cuh"

namespace {

using namespace bf16mma;
using namespace self_attention;

static_assert(THREADS == 2 * TILE, "the column kernel stages a row a thread");

template <int D>
size_t smem_bytes_dq() {
  return sizeof(bf16) * 4 * TILE * D;
}

// + each staged row's lse, D and two mask words
template <int D>
size_t smem_bytes_dkv() {
  return sizeof(bf16) * 4 * TILE * D + 2 * TILE * 4 * sizeof(float);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 2)
self_attention_dq_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ gout,
                         const float* __restrict__ row_lse,
                         const uint32_t* __restrict__ bits,
                         bf16* __restrict__ dqkv, float* __restrict__ dsum,
                         int T, int heads, float scale2, float scale,
                         float inv_keep) {
  constexpr int KC = D / 8;  // 8-wide chunks of d, and n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][TILE][D], swizzled
  bf16* vs = ks + 2 * TILE * D;              // [2][TILE][D]

  const int nt = tiles(T);
  const int64_t bh = blockIdx.x / nt;
  const int q0 = static_cast<int>(blockIdx.x % nt) * TILE;
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const bf16* tok = qkv + b * T * C3 + h * D;
  const bf16* gtok = gout + b * T * C + h * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;
  // rows a = r0+g and b = r0+g+8; a row past T repeats row T-1 (discarded)
  const int ra = min(r0 + g, T - 1), rb = min(r0 + g + 8, T - 1);
  const int mw = mask_words(T);
  const uint32_t* ma = DROP ? bits + (bh * T + ra) * mw : nullptr;
  const uint32_t* mb = DROP ? bits + (bh * T + rb) * mw : nullptr;

  auto stage_tile = [&](int kt) {
    const int j0 = kt * TILE, n = min(TILE, T - j0), buf = kt & 1;
    stage<D>(ks + buf * TILE * D, tok + C + j0 * C3, C3, n, TILE);
    stage<D>(vs + buf * TILE * D, tok + 2 * C + j0 * C3, C3, n, TILE);
    cp_async_commit();
  };

  const Rows<D> qa = load_a_rows<D>(tok + ra * C3, tok + rb * C3, lane);
  const Rows<D> ga = load_a_rows<D>(gtok + ra * C, gtok + rb * C, lane);
  const float lse0 = __ldg(row_lse + bh * T + ra);
  const float lse1 = __ldg(row_lse + bh * T + rb);
  float ak[KC][4], bk[KC][4];
#pragma unroll
  for (int n = 0; n < KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = bk[n][e] = 0.f;
  float a0 = 0.f, a1 = 0.f;

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
      const int left = T - kt * TILE;
      uint2 wa = make_uint2(0u, 0u), wb = make_uint2(0u, 0u);
      if constexpr (DROP) {
        wa = __ldg(reinterpret_cast<const uint2*>(ma + 2 * kt));
        wb = __ldg(reinterpret_cast<const uint2*>(mb + 2 * kt));
      }
#pragma unroll
      for (int j0 = 0; j0 < TILE; j0 += 16) {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = 0.f;
          uint32_t kb[KC], vb[KC];
          load_bt<D>(kts, j0 + 8 * u, lane, kb);
          load_bt<D>(vts, j0 + 8 * u, lane, vb);
          mma_d<D>(s[u], qa, kb);
          mma_d<D>(dp[u], ga, vb);
        }
        // p in s and p dP in dp, 0 past T
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 8 * u + 2 * t + (e & 1);
            const float p =
                j < left ? exp2_ftz(s[u][e] * scale2 - (e < 2 ? lse0 : lse1))
                         : 0.f;
            float x = dp[u][e];
            if constexpr (DROP) {
              const uint2 w = e < 2 ? wa : wb;
              const uint32_t word = (j0 + 8 * u) < 32 ? w.x : w.y;
              x = (word >> (j & 31)) & 1u ? x * inv_keep : 0.f;
            }
            s[u][e] = p;
            dp[u][e] = p * x;
            if (e < 2)
              a0 += dp[u][e];
            else
              a1 += dp[u][e];
          }
        uint32_t phi[4], plo[4], dhi[4], dlo[4], kb[KC][2];
        acc_pair_a(s[0], s[1], phi, plo);
        acc_pair_a(dp[0], dp[1], dhi, dlo);
        load_b_rows16<D>(kts, j0, lane, kb);
#pragma unroll
        for (int n = 0; n < KC; ++n) {
          mma_pieces(ak[n], dhi, dlo, kb[n][0], kb[n][1]);
          mma_pieces(bk[n], phi, plo, kb[n][0], kb[n][1]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for the tile after next
  }
  if (r0 >= T) return;
  const float d0 = quad_sum(a0), d1 = quad_sum(a1);
  bf16* qa_out = dqkv + (b * T + r0 + g) * C3 + h * D + 2 * t;
  bf16* qb_out = qa_out + 8 * C3;
#pragma unroll
  for (int n = 0; n < KC; ++n) {
    if (r0 + g < T)
      st2(qa_out + n * 8, (ak[n][0] - d0 * bk[n][0]) * scale,
          (ak[n][1] - d0 * bk[n][1]) * scale);
    if (r0 + g + 8 < T)
      st2(qb_out + n * 8, (ak[n][2] - d1 * bk[n][2]) * scale,
          (ak[n][3] - d1 * bk[n][3]) * scale);
  }
  if (t == 0) {
    float* da = dsum + bh * T + r0 + g;
    if (r0 + g < T) da[0] = d0;
    if (r0 + g + 8 < T) da[8] = d1;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 2)
self_attention_dkv_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ gout,
                          const float* __restrict__ row_lse,
                          const float* __restrict__ dsum,
                          const uint32_t* __restrict__ bits,
                          bf16* __restrict__ dqkv, int T, int heads,
                          float scale2, float scale, float inv_keep) {
  constexpr int KC = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [2][TILE][D], swizzled
  bf16* gs = qs + 2 * TILE * D;              // [2][TILE][D]
  float* ls = reinterpret_cast<float*>(gs + 2 * TILE * D);  // [2][TILE]
  float* ds = ls + 2 * TILE;                                // [2][TILE]
  uint32_t* ms = reinterpret_cast<uint32_t*>(ds + 2 * TILE);  // [2][TILE][2]

  const int nt = tiles(T);
  const int64_t bh = blockIdx.x / nt;
  const int kt = static_cast<int>(blockIdx.x % nt);
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const bf16* tok = qkv + b * T * C3 + h * D;
  const bf16* gtok = gout + b * T * C + h * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float pos_inf = __int_as_float(0x7f800000);
  const int j0 = kt * TILE + warp * 16;
  // keys a = j0+g and b = j0+g+8; a key past T repeats key T-1 (discarded)
  const int ja = min(j0 + g, T - 1), jb = min(j0 + g + 8, T - 1);
  const int mw = mask_words(T);
  // the warp's 16 keys lie in one word of a row's two for the tile: word
  // warp / 2, key a at bit ka_bit, key b 8 bits above
  const int ka_bit = 16 * (warp & 1) + g;

  auto stage_tile = [&](int it) {
    const int i0 = it * TILE, n = min(TILE, T - i0), buf = it & 1;
    stage<D>(qs + buf * TILE * D, tok + i0 * C3, C3, n, TILE);
    stage<D>(gs + buf * TILE * D, gtok + i0 * C, C, n, TILE);
    // each row's lse (+inf past T: p = 0 there), D and mask words
    const int r = threadIdx.x % TILE;
    if (threadIdx.x < TILE) {
      if (r < n) {
        cp_async4(ls + buf * TILE + r, row_lse + bh * T + i0 + r);
        if constexpr (DROP)
          cp_async8(ms + (buf * TILE + r) * 2,
                    bits + (bh * T + i0 + r) * mw + 2 * kt);
      } else {
        ls[buf * TILE + r] = pos_inf;
        ms[(buf * TILE + r) * 2] = ms[(buf * TILE + r) * 2 + 1] = 0u;
      }
    } else if (r < n) {
      cp_async4(ds + buf * TILE + r, dsum + bh * T + i0 + r);
    } else {
      ds[buf * TILE + r] = 0.f;
    }
    cp_async_commit();
  };

  const Rows<D> ka = load_a_rows<D>(tok + C + ja * C3, tok + C + jb * C3,
                                    lane);
  const Rows<D> va = load_a_rows<D>(tok + 2 * C + ja * C3,
                                    tok + 2 * C + jb * C3, lane);
  float dk[KC][4], dv[KC][4];
#pragma unroll
  for (int n = 0; n < KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  stage_tile(0);
#pragma unroll 1
  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      stage_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j0 < T) {
      const int buf = it & 1;
      const bf16* qts = qs + buf * TILE * D;
      const bf16* gts = gs + buf * TILE * D;
      const float* lt = ls + buf * TILE;
      const float* dt = ds + buf * TILE;
      const uint32_t* mt = ms + buf * TILE * 2 + (warp >> 1);
#pragma unroll
      for (int i0 = 0; i0 < TILE; i0 += 16) {
        float s[2][4], dz[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = dz[u][e] = 0.f;
          uint32_t qb[KC], gb[KC];
          load_bt<D>(qts, i0 + 8 * u, lane, qb);
          load_bt<D>(gts, i0 + 8 * u, lane, gb);
          mma_d<D>(s[u], ka, qb);
          mma_d<D>(dz[u], va, gb);
        }
        // z in s and dS in dz at (key, query)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * u + 2 * t + (e & 1);
            const float p = exp2_ftz(s[u][e] * scale2 - lt[i]);
            float z = p, x = dz[u][e];
            if constexpr (DROP) {
              const bool kept = (mt[2 * i] >> (ka_bit + (e < 2 ? 0 : 8))) & 1u;
              z = kept ? p : 0.f;
              x = kept ? x * inv_keep : 0.f;
            }
            s[u][e] = z;
            dz[u][e] = p * (x - dt[i]);
          }
        uint32_t zhi[4], zlo[4], shi[4], slo[4], gb[KC][2], qb[KC][2];
        acc_pair_a(s[0], s[1], zhi, zlo);
        acc_pair_a(dz[0], dz[1], shi, slo);
        load_b_rows16<D>(gts, i0, lane, gb);
        load_b_rows16<D>(qts, i0, lane, qb);
#pragma unroll
        for (int n = 0; n < KC; ++n) {
          mma_pieces(dv[n], zhi, zlo, gb[n][0], gb[n][1]);
          mma_pieces(dk[n], shi, slo, qb[n][0], qb[n][1]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are free for the tile after next
  }
  if (j0 >= T) return;
  bf16* ka_out = dqkv + (b * T + j0 + g) * C3 + C + h * D + 2 * t;
  bf16* kb_out = ka_out + 8 * C3;
#pragma unroll
  for (int n = 0; n < KC; ++n) {
    if (j0 + g < T) {
      st2(ka_out + n * 8, dk[n][0] * scale, dk[n][1] * scale);
      st2(ka_out + C + n * 8, dv[n][0] * inv_keep, dv[n][1] * inv_keep);
    }
    if (j0 + g + 8 < T) {
      st2(kb_out + n * 8, dk[n][2] * scale, dk[n][3] * scale);
      st2(kb_out + C + n * 8, dv[n][2] * inv_keep, dv[n][3] * inv_keep);
    }
  }
}

template <int D, bool DROP>
cudaError_t raise_smem_limits() {
  // per call, so that they hold on whichever device is current
  cudaError_t err = cudaFuncSetAttribute(
      self_attention_dq_kernel<D, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes_dq<D>()));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(self_attention_dkv_kernel<D, DROP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes_dkv<D>()));
}

template <int D, bool DROP>
int launch(const bf16* qkv, const bf16* g, const float* lse,
           const uint32_t* bits, bf16* dqkv, float* dsum, int B, int T,
           int heads, float keep, cudaStream_t stream) {
  cudaError_t err = raise_smem_limits<D, DROP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(B) * heads * tiles(T);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale2 = bf16mma::LOG2E * scale;
  const float inv_keep = 1.f / keep;
  self_attention_dq_kernel<D, DROP><<<blocks, THREADS, smem_bytes_dq<D>(),
                                      stream>>>(qkv, g, lse, bits, dqkv,
                                                dsum, T, heads, scale2, scale,
                                                inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  self_attention_dkv_kernel<D, DROP><<<blocks, THREADS, smem_bytes_dkv<D>(),
                                       stream>>>(qkv, g, lse, dsum, bits,
                                                 dqkv, T, heads, scale2,
                                                 scale, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DROP>
int info(int* out) {
  cudaError_t err = raise_smem_limits<D, DROP>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], self_attention_dq_kernel<D, DROP>, THREADS,
        smem_bytes_dq<D>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4], self_attention_dkv_kernel<D, DROP>, THREADS,
        smem_bytes_dkv<D>());
  out[0] = THREADS;
  out[1] = static_cast<int>(smem_bytes_dq<D>());
  out[3] = static_cast<int>(smem_bytes_dkv<D>());
  return static_cast<int>(err);
}

// f(std::integral_constant<int, d>()) for the head dims the kernels take
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

// Launch both kernels on `stream`; return a cudaError_t (0 = launched).
// qkv and dqkv (B, T, 3 * heads * d), g (B, T, heads * d) bf16; lse
// (B, heads, T) f32 as self_attention_bf16 wrote it; `bits` its keep mask
// (self_attention.cuh), or null where the forward drew no uniforms (`keep`
// is then ignored); `dsum` (B, heads, T) f32 scratch for D.  The caller
// checks dtypes, contiguity, 16-byte alignment and B * heads * tiles(T) <
// 2**31; d other than 32 or 64 returns cudaErrorInvalidValue.
extern "C" int self_attention_bwd_bf16(const void* qkv, const void* g,
                                       const void* lse, const void* bits,
                                       void* dqkv, void* dsum, int B, int T,
                                       int heads, int d, float keep,
                                       void* stream) {
  if (B < 1 || T < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(d, [&](auto D) {
    constexpr int d_ = decltype(D)::value;
    const auto* q = static_cast<const bf16mma::bf16*>(qkv);
    const auto* go = static_cast<const bf16mma::bf16*>(g);
    const auto* l = static_cast<const float*>(lse);
    const auto* m = static_cast<const uint32_t*>(bits);
    auto* dq = static_cast<bf16mma::bf16*>(dqkv);
    auto* ds = static_cast<float*>(dsum);
    auto* s = static_cast<cudaStream_t>(stream);
    return bits ? launch<d_, true>(q, go, l, m, dq, ds, B, T, heads, keep, s)
                : launch<d_, false>(q, go, l, nullptr, dq, ds, B, T, heads,
                                    1.f, s);
  });
}

// The two kernels at head dim d with (drop = 1) or without dropout: out =
// {threads per block, the row kernel's dynamic shared memory bytes and
// resident blocks per SM, the column kernel's}; returns a cudaError_t.
extern "C" int self_attention_bwd_info(int d, int drop, int* out) {
  return with_head_dim(d, [&](auto D) {
    constexpr int d_ = decltype(D)::value;
    return drop ? info<d_, true>(out) : info<d_, false>(out);
  });
}
