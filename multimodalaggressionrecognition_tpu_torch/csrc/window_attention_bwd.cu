// Fused (shifted-)window attention backward (kernel K3) for Hopper, in two
// instantiations: f32 qkv, g and dqkv at f32 accuracy on the tensor cores
// (3xTF32, tf32x3.cuh), and bf16 qkv, g and dqkv on the bf16 tensor cores
// (bf16mma.cuh).
//
// Replaces `_fused_bwd` (with its body `_bwd_kernel`) in
// multimodalaggressionrecognition_tpu/ops/pallas/window_attention.py: the
// flash-style backward of window attention (the forward is K2,
// csrc/window_attention.cu).  For every window w and head h, with q, k, v
// the head's d-wide slices of the packed qkv (W, N, 3C), g the head's slice
// of the output gradient (W, N, C), and the forward's row logsumexp lse
// (W, heads, N), it recomputes
//
//   s = q k^T / sqrt(d) + bias[h] + mask[w mod nW],   p = exp(s - lse),
//
// and from it
//
//   dV = p^T g,   dP = g v^T,   D = rowsum(dP o p),   dS = p o (dP - D),
//   dQ = dS k / sqrt(d),   dK = dS^T q / sqrt(d),   dbias[h] = sum_w dS,
//
// writing dqkv (W, N, 3C) and dbias (heads, N, N); the mask gets no
// gradient.  Neither p nor dS, (W, heads, N, N) each, reaches device memory.
// qkv, g and dqkv are f32 or all three bf16 (the model's compute dtype);
// bias, mask, lse and dbias (and its partials) are f32.  The TPU kernel
// widens bf16 operands to f32 and rounds each stored result once.  The bf16
// instantiation gets the same numbers to f32 accuracy without widening:
// q.k^T and g.v^T of bf16 operands are exact products summed in f32, and
// the products with p, p o dP or dS (f32) take them as two bf16 pieces
// (bf16mma.cuh); each stored result is rounded once.
//
// Bound.  The JAX kernel's own count (its CostEstimate) is
// 10*W*heads*N^2*d operations and 4*(2*W*N*3C + 2*heads*N^2 + W*N*C) bytes;
// K2's lse (4*W*heads*N bytes) and, in f32, its output (4*W*N*C) are read
// besides.  At Swin3D-T's stage 0 trained at batch 8 (W=2048, N=196, C=96,
// 3 heads, d=32, the mask nW=16) that is 75.5 GFLOP against 1.24 GB.  On an
// H100 SXM the three TF32 passes of every product take 0.458 ms at 495
// TFLOP/s, the bytes 0.371 ms at 3.35 TB/s: bound by tensor-core operations
// (1.127 ms at the 67 TFLOP/s f32 FMA peak, which the earlier designs
// used).  In bf16 qkv, g and dqkv move half the bytes, 547.7 MB with the
// mask and lse, 0.163 ms, against 0.122 ms for the products (q.k^T and
// g.v^T in one bf16 pass, p^T.g, dS.k and dS^T.q in two, at 989 TFLOP/s):
// bound by bytes.
//
// Design.  The unit of work is one warp per 16-token tile.  A block of 4
// warps per (group of windows, head) walks its group's windows, in two
// passes per window, each with its own staging: the pass's B operands are
// staged in shared memory (zero past N), and its A operands come straight
// from device memory into registers.  K2 hands over each row's lse, so
// neither pass has to find the rows' softmax statistics.
//   - row pass (K and V staged), a warp per 16 query rows, their Q and G in
//     registers, one sweep over the keys, 16 a step: S = Q K^T / sqrt(d) and
//     dP = G V^T, p from lse, and dQ; D by one of two routes (below).  Each
//     row's lse and D go to shared memory for the column pass.
//   - column pass (Q and G staged), a warp per 16 keys, their K and V in
//     registers: for 16 queries a step S^T = K Q^T / sqrt(d) and
//     dP^T = V G^T, p and dS from the rows' lse and D,
//     dV += P^T G, dK += dS^T Q, and dS into the block's dbias partial.
// dK and dV are sums over queries and dQ a sum over keys, so each pass
// keeps its sums inside one warp's accumulators, with no atomics; the price
// is computing S and dP twice, once a pass.  Each step fetches the next
// step's bias, mask and dbias partial (through L2, 8 consecutive keys per
// row of the tile in both passes) while its products run.
//   - f32 (mma.sync.m16n8k8, 3xTF32): D = g . o over the head's d columns,
//     o the forward's f32 output (equal to rowsum(dP o p), as o = p v),
//     before the sweep; the sweep forms dS = p (dP - D) in the accumulators
//     and adds dS K to dQ, dS the A operand straight from them.  7*d
//     multiply-adds per (i, j) (S, dP and dS.K; S, dP, P^T.G and dS^T.Q)
//     where the bound counts 5*d.  The staged tiles hold each element
//     already split (big, small), 106 KB at N=196 and 205 KB at N=392, and
//     the A operands are split in registers; S and dP each run in two
//     accumulators (mma3x), 8 independent mma chains a warp.  ptxas gives
//     the d=32 kernel ~250 registers, so an SM holds 2 blocks, 8 warps, and
//     13 tiles of 16 rows over 4 warps leave a warp idle a quarter of each
//     pass; a version of 8 warps a block at 128 registers spilled and ran
//     slower.
//   - bf16 (mma.sync.m16n8k16, m16n8k8 over d = 8): the output K2 stores
//     is rounded to bf16, too coarse for D (its rounding moves dQ by more
//     than one bf16 ulp), so the sweep sums D = rowsum(p o dP) itself beside
//     A = (p o dP) K and B = p K, and sets dQ = (A - D B) / sqrt(d), which
//     is dS K: 8*d per (i, j).  The staged tiles are the bf16 values as
//     they are, copied with 16-byte cp.async into swizzled tiles (28 KB at
//     N=196, 53 KB at N=392) that ldmatrix reads plain (the B operands over
//     d) and transposed (over keys or queries) without bank conflicts; the
//     A operands are the raw bf16 rows, and p, p o dP and dS go from two
//     adjacent 8-wide accumulators into hi and lo A fragments; the scores
//     and lse are kept in base 2, so each exponential is one MUFU.EX2.
//     Fewer registers than the split fragments: at 128 (0 B spilled) an SM
//     holds 4 blocks, 16 warps, and shared memory does not cap them.  As
//     in K2 the bias and mask reads through L2 are a large share of the
//     time: two sweeps read them, 3.8 GB a launch at stage 0, and the
//     column pass also reads and writes the dbias partial, 1.9 GB more.

// dbias is a sum over all W windows, which the TPU kernel accumulates in a
// block revisited across its sequential grid.  A GPU grid has no order, so
// the sum is split: each block adds its windows' dS into its own
// (heads, N, N) slice of a partials array in device memory, and a second
// small kernel sums the partials over the groups.  Every (i, j) of a block
// belongs to a fixed lane of a fixed warp across all its windows, so the
// read-modify-write needs no atomics and the result does not depend on
// scheduling: it is deterministic.  The number of groups fills the card
// (the instantiation's blocks per SM from the occupancy API, times the SM
// count, over the heads).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int MAX_N = 392;  // a full (8, 7, 7) window

__host__ __device__ constexpr int rows_padded(int n) {
  return (n + 15) & ~15;
}

namespace f32path {

using namespace tf32x3;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// 8-wide tiles per step of a sweep, each with its own accumulators, so that
// a warp keeps 2 * JT independent mma chains in flight
constexpr int JT = 2;
constexpr int STEP = 8 * JT;
static_assert(16 % STEP == 0, "a step must not run past the 16-row padding");

// two split tiles (N rounded up to 16 rows of d (big, small) pairs) and the
// rows' logsumexp and D: 108,160 bytes at N=196, 208,000 at N=392 (d=32)
size_t smem_bytes(int n, int d) {
  const size_t np = static_cast<size_t>(rows_padded(n));
  return sizeof(float2) * 2 * np * d + sizeof(float) * 2 * np;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
window_attention_bwd_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const float* __restrict__ gout,
                            const float* __restrict__ fwd_out,
                            const float* __restrict__ row_lse,
                            float* __restrict__ dqkv,
                            float* __restrict__ partial, int W, int N,
                            int heads, int nw_img, int groups, float scale) {
  constexpr int KT = D / 8;  // k-steps over d, and n-tiles of d
  extern __shared__ __align__(16) float smem[];
  const int NP = rows_padded(N);
  // split tiles [NP][D]: K and V in the row pass, Q / sqrt(d) and G in the
  // column pass
  float2* xs = reinterpret_cast<float2*>(smem);
  float2* ys = xs + NP * D;
  float* lse = reinterpret_cast<float*>(ys + NP * D);  // [NP]
  float* dsum = lse + NP;                               // [NP]

  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const int64_t NN = static_cast<int64_t>(N) * N;
  const int h = blockIdx.x % heads;
  const int grp = blockIdx.x / heads;
  const int64_t w0 = static_cast<int64_t>(W) * grp / groups;
  const int64_t w1 = static_cast<int64_t>(W) * (grp + 1) / groups;
  float* part = partial + (static_cast<int64_t>(grp) * heads + h) * NN;
  const float* bias_h = bias + h * NN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);

  for (int64_t w = w0; w < w1; ++w) {
    const float* win = qkv + w * N * C3 + h * D;
    const float* gwin = gout + w * N * C + h * D;
    const float* owin = fwd_out + w * N * C + h * D;
    const float* lse_w = row_lse + (w * heads + h) * N;
    float* dwin = dqkv + w * N * C3 + h * D;
    const float* mask_w = mask ? mask + (w % nw_img) * NN : nullptr;

    __syncthreads();  // the previous window's column pass is done
    stage_split<D>(xs, win + C, C3, N, NP, 1.f);
    stage_split<D>(ys, win + 2 * C, C3, N, NP, 1.f);
    __syncthreads();

    // row pass: a warp per 16 query rows; D and dQ
    for (int r0 = warp * 16; r0 < N; r0 += WARPS * 16) {
      // rows a = r0+g and b = r0+g+8; a row past N repeats row N-1 (its
      // results are discarded)
      const int ra = min(r0 + g, N - 1), rb = min(r0 + g + 8, N - 1);
      FragA qa[KT], ga[KT];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        qa[kk] = load_a_rows(win + ra * C3, win + rb * C3, kk * 8, lane,
                             scale);
        ga[kk] = load_a_rows(gwin + ra * C, gwin + rb * C, kk * 8, lane, 1.f);
      }
      // D = sum_j p dP = g . o over the head's d columns (a lane takes every
      // fourth), o the forward's output; the logsumexp is K2's, base e
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int c = t; c < D; c += 4) {
        d0 = fmaf(ldf(gwin + ra * C + c), ldf(owin + ra * C + c), d0);
        d1 = fmaf(ldf(gwin + rb * C + c), ldf(owin + rb * C + c), d1);
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
      const float lse0 = ldf(lse_w + ra), lse1 = ldf(lse_w + rb);
      const RowBias<JT> rows(bias_h, mask_w, ra, rb, N, t);
      // S (with bias and mask) and dP of keys j0 .. j0+STEP-1
      auto scores = [&](int j0, const float (&bv)[JT][4],
                        const float (&mv)[JT][4], float (&s)[JT][4],
                        float (&dp)[JT][4]) {
        float s2[JT][4], dp2[JT][4];
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = s2[u][e] = dp2[u][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
#pragma unroll
          for (int u = 0; u < JT; ++u) {
            mma3x(s[u], s2[u], qa[kk],
                  load_bt_split<D>(xs, j0 + 8 * u, kk * 8, lane));
            mma3x(dp[u], dp2[u], ga[kk],
                  load_bt_split<D>(ys, j0 + 8 * u, kk * 8, lane));
          }
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[u][e] = (s[u][e] + s2[u][e]) + bv[u][e] + mv[u][e];
            dp[u][e] += dp2[u][e];
          }
      };

      // the sweep: S and dP, dS in the accumulators, dQ += dS K; each step
      // fetches the next step's bias and mask while its products run
      float dq[KT][4];
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
        dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
      float bv[JT][4], mv[JT][4];
      rows.fetch(0, bv, mv);
#pragma unroll 1
      for (int j0 = 0; j0 < N; j0 += STEP) {
        float s[JT][4], dp[JT][4];
        scores(j0, bv, mv, s, dp);
        rows.fetch(j0 + STEP, bv, mv);
#pragma unroll
        for (int u = 0; u < JT; ++u) {
          s[u][0] = __expf(s[u][0] - lse0) * (dp[u][0] - d0);  // 0 past N
          s[u][1] = __expf(s[u][1] - lse0) * (dp[u][1] - d0);
          s[u][2] = __expf(s[u][2] - lse1) * (dp[u][2] - d1);
          s[u][3] = __expf(s[u][3] - lse1) * (dp[u][3] - d1);
          const FragA da = acc_as_a(s[u]);
#pragma unroll
          for (int nt = 0; nt < KT; ++nt)
            mma3(dq[nt], da,
                 load_b_pairs_split<D>(xs, j0 + 8 * u, nt * 8, lane));
        }
      }
      float* qa_out = dwin + (r0 + g) * C3 + 2 * t;
      float* qb_out = qa_out + 8 * C3;
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        if (r0 + g < N)
          st2(qa_out + nt * 8, dq[nt][0] * scale, dq[nt][1] * scale);
        if (r0 + g + 8 < N)
          st2(qb_out + nt * 8, dq[nt][2] * scale, dq[nt][3] * scale);
      }
      if (t == 0) {
        lse[r0 + g] = lse0;
        dsum[r0 + g] = d0;
        lse[r0 + g + 8] = lse1;
        dsum[r0 + g + 8] = d1;
      }
    }
    __syncthreads();  // every row's logsumexp and D; K and V read
    stage_split<D>(xs, win, C3, N, NP, scale);
    stage_split<D>(ys, gwin, C, N, NP, 1.f);
    __syncthreads();

    // column pass: a warp per 16 keys; dK, dV and dS into the partials
    const bool first = w == w0;
    for (int j0 = warp * 16; j0 < N; j0 += WARPS * 16) {
      // keys a = j0+g and b = j0+g+8; a key past N repeats key N-1 (its
      // results are discarded)
      const int ja = j0 + g, jb = j0 + g + 8;
      const float* ka_row = win + C + min(ja, N - 1) * C3;
      const float* kb_row = win + C + min(jb, N - 1) * C3;
      FragA ka[KT], va[KT];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        ka[kk] = load_a_rows(ka_row, kb_row, kk * 8, lane, 1.f);
        va[kk] = load_a_rows(ka_row + C, kb_row + C, kk * 8, lane, 1.f);
      }
      // bias, mask and the dbias partial at the accumulators' (u, e): key a
      // (e < 2) or b, query i + 2t with i = i0 + 8u + (e & 1), at o0(i0) +
      // (8u + (e & 1)) * N (+ 8 for key b), offsets the loop keeps; outside
      // N x N the bias is -inf and the partial 0 (as it is at the group's
      // first window)
      const bool a_in = ja < N, b_in = jb < N;
      auto o0 = [&](int i0) { return (i0 + 2 * t) * N + ja; };
      auto off = [&](int u, int e) {
        return (8 * u + (e & 1)) * N + (e < 2 ? 0 : 8);
      };
      auto inside = [&](int i0, int u, int e) {
        return (e < 2 ? a_in : b_in) && i0 + 8 * u + (e & 1) + 2 * t < N;
      };
      auto fetch = [&](int i0, float (&bv)[JT][4], float (&mv)[JT][4],
                       float (&pv)[JT][4]) {
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = inside(i0, u, e);
            const int o = o0(i0) + off(u, e);
            bv[u][e] = in ? __ldg(bias_h + o) : neg_inf;
            mv[u][e] = in && mask_w ? __ldg(mask_w + o) : 0.f;
            pv[u][e] = in && !first ? part[o] : 0.f;
          }
      };
      float dk[KT][4], dv[KT][4];
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
      float bv[JT][4], mv[JT][4], pv[JT][4];
      fetch(0, bv, mv, pv);
#pragma unroll 1
      for (int i0 = 0; i0 < N; i0 += STEP) {
        float s[JT][4], dp[JT][4], s2[JT][4], dp2[JT][4];
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = s2[u][e] = dp2[u][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
#pragma unroll
          for (int u = 0; u < JT; ++u) {
            mma3x(s[u], s2[u], ka[kk],
                  load_bt_split<D>(xs, i0 + 8 * u, kk * 8, lane));
            mma3x(dp[u], dp2[u], va[kk],
                  load_bt_split<D>(ys, i0 + 8 * u, kk * 8, lane));
          }
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[u][e] += s2[u][e];
            dp[u][e] += dp2[u][e];
          }
        // p and dS at (key, query); 0 outside N x N
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int query = i0 + 8 * u + (e & 1) + 2 * t;
            const float p =
                __expf(s[u][e] + bv[u][e] + mv[u][e] - lse[query]);
            const float ds = p * (dp[u][e] - dsum[query]);
            if (inside(i0, u, e)) part[o0(i0) + off(u, e)] = pv[u][e] + ds;
            s[u][e] = p;
            dp[u][e] = ds;
          }
        fetch(i0 + STEP, bv, mv, pv);
#pragma unroll
        for (int u = 0; u < JT; ++u) {
          const FragA pa = acc_as_a(s[u]), da = acc_as_a(dp[u]);
#pragma unroll
          for (int nt = 0; nt < KT; ++nt) {
            mma3(dv[nt], pa,
                 load_b_pairs_split<D>(ys, i0 + 8 * u, nt * 8, lane));
            mma3(dk[nt], da,
                 load_b_pairs_split<D>(xs, i0 + 8 * u, nt * 8, lane));
          }
        }
      }
      float* ka_out = dwin + ja * C3 + C + 2 * t;
      float* kb_out = ka_out + 8 * C3;
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        if (ja < N) {
          st2(ka_out + nt * 8, dk[nt][0], dk[nt][1]);
          st2(ka_out + C + nt * 8, dv[nt][0], dv[nt][1]);
        }
        if (jb < N) {
          st2(kb_out + nt * 8, dk[nt][2], dk[nt][3]);
          st2(kb_out + C + nt * 8, dv[nt][2], dv[nt][3]);
        }
      }
    }
  }
}

template <int D>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(window_attention_bwd_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(MAX_N, D)));
}

template <int D>
cudaError_t blocks_per_sm(int N, int* per_sm) {
  cudaError_t err = raise_smem_limit<D>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, window_attention_bwd_kernel<D>, THREADS,
      smem_bytes(N, D));
}

template <int D>
cudaError_t launch(const float* qkv, const float* bias, const float* mask,
                   const float* g, const float* out, const float* lse,
                   float* dqkv, float* partial, int W, int N, int heads,
                   int nw_img, int groups, float scale, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<D>();
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(groups) * static_cast<unsigned>(heads);
  window_attention_bwd_kernel<D><<<blocks, THREADS, smem_bytes(N, D),
                                   stream>>>(qkv, bias, mask, g, out, lse,
                                             dqkv, partial, W, N, heads,
                                             nw_img, groups, scale);
  return cudaGetLastError();
}

}  // namespace f32path

namespace bf16path {

using namespace bf16mma;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// 8-wide tiles per step of a sweep, each with its own accumulators: a pair
// of them is one 16-deep A fragment of the products with p and dS
constexpr int JT = 2;
constexpr int STEP = 8 * JT;
static_assert(STEP == 16, "a step is one 16-deep k-step over the padding");

// two bf16 tiles (N rounded up to 16 rows of d elements) and the rows'
// logsumexp and D: 28,288 bytes at N=196, 54,400 at N=392 (d=32)
size_t smem_bytes(int n, int d) {
  const size_t np = static_cast<size_t>(rows_padded(n));
  return sizeof(bf16) * 2 * np * d + sizeof(float) * 2 * np;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 4)
window_attention_bwd_bf16_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mask,
                                 const bf16* __restrict__ gout,
                                 const float* __restrict__ row_lse,
                                 bf16* __restrict__ dqkv,
                                 float* __restrict__ partial, int W, int N,
                                 int heads, int nw_img, int groups,
                                 float scale) {
  constexpr int KC = D / 8;  // 8-wide chunks of d, and n-tiles of d
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int NP = rows_padded(N);
  // bf16 tiles [NP][D], swizzled: K and V in the row pass, Q and G in the
  // column pass
  bf16* xs = reinterpret_cast<bf16*>(smem_bf16);
  bf16* ys = xs + NP * D;
  float* lse = reinterpret_cast<float*>(ys + NP * D);  // [NP], base 2
  float* dsum = lse + NP;                              // [NP]

  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const int64_t NN = static_cast<int64_t>(N) * N;
  const int h = blockIdx.x % heads;
  const int grp = blockIdx.x / heads;
  const int64_t w0 = static_cast<int64_t>(W) * grp / groups;
  const int64_t w1 = static_cast<int64_t>(W) * (grp + 1) / groups;
  float* part = partial + (static_cast<int64_t>(grp) * heads + h) * NN;
  const float* bias_h = bias + h * NN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float neg_inf = __int_as_float(0xff800000);
  const float scale2 = scale * LOG2E;  // scores in base 2: s * log2e

  for (int64_t w = w0; w < w1; ++w) {
    const bf16* win = qkv + w * N * C3 + h * D;
    const bf16* gwin = gout + w * N * C + h * D;
    const float* lse_w = row_lse + (w * heads + h) * N;
    bf16* dwin = dqkv + w * N * C3 + h * D;
    const float* mask_w = mask ? mask + (w % nw_img) * NN : nullptr;

    __syncthreads();  // the previous window's column pass is done
    stage<D>(xs, win + C, C3, N, NP);
    stage<D>(ys, win + 2 * C, C3, N, NP);
    cp_async_wait_all();
    __syncthreads();

    // row pass: a warp per 16 query rows; D and dQ
    for (int r0 = warp * 16; r0 < N; r0 += WARPS * 16) {
      // rows a = r0+g and b = r0+g+8; a row past N repeats row N-1 (its
      // results are discarded)
      const int ra = min(r0 + g, N - 1), rb = min(r0 + g + 8, N - 1);
      const Rows<D> qa = load_a_rows<D>(win + ra * C3, win + rb * C3, lane);
      const Rows<D> ga = load_a_rows<D>(gwin + ra * C, gwin + rb * C, lane);
      // the logsumexp is K2's, base 2
      const float lse0 = __ldg(lse_w + ra), lse1 = __ldg(lse_w + rb);
      const RowBias<JT> rows(bias_h, mask_w, ra, rb, N, t);
      // S (scaled, with bias and mask, in base 2) and dP of keys j0 ..
      // j0+STEP-1
      auto scores = [&](int j0, const float (&bv)[JT][4],
                        const float (&mv)[JT][4], float (&s)[JT][4],
                        float (&dp)[JT][4]) {
#pragma unroll
        for (int u = 0; u < JT; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = 0.f;
          uint32_t kb[KC], vb[KC];
          load_bt<D>(xs, j0 + 8 * u, lane, kb);
          load_bt<D>(ys, j0 + 8 * u, lane, vb);
          mma_d<D>(s[u], qa, kb);
          mma_d<D>(dp[u], ga, vb);
        }
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[u][e] = fmaf(s[u][e], scale2, (bv[u][e] + mv[u][e]) * LOG2E);
      };

      // the sweep: p = exp2(s - lse) and, with dP, D = sum_j p dP,
      // A = sum_j (p dP) k_j and B = sum_j p k_j, the products with p dP and
      // p in two bf16 pieces each; then dQ = dS K = (A - D B) / sqrt(d).
      // Each step fetches the next step's bias and mask while its products
      // run.
      float ak[KC][4], bk[KC][4];
#pragma unroll
      for (int nt = 0; nt < KC; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[nt][e] = bk[nt][e] = 0.f;
      float a0 = 0.f, a1 = 0.f;
      float bv[JT][4], mv[JT][4];
      rows.fetch(0, bv, mv);
#pragma unroll 1
      for (int j0 = 0; j0 < N; j0 += STEP) {
        float s[JT][4], dp[JT][4];
        scores(j0, bv, mv, s, dp);
        rows.fetch(j0 + STEP, bv, mv);
#pragma unroll
        for (int u = 0; u < JT; ++u) {
          // p in s and p dP in dp, 0 past N
          s[u][0] = exp2_ftz(s[u][0] - lse0);
          s[u][1] = exp2_ftz(s[u][1] - lse0);
          s[u][2] = exp2_ftz(s[u][2] - lse1);
          s[u][3] = exp2_ftz(s[u][3] - lse1);
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[u][e] *= s[u][e];
          a0 += dp[u][0] + dp[u][1];
          a1 += dp[u][2] + dp[u][3];
        }
        uint32_t phi[4], plo[4], dhi[4], dlo[4], kb[KC][2];
        acc_pair_a(s[0], s[1], phi, plo);
        acc_pair_a(dp[0], dp[1], dhi, dlo);
        load_b_rows16<D>(xs, j0, lane, kb);
#pragma unroll
        for (int nt = 0; nt < KC; ++nt) {
          mma_pieces(ak[nt], dhi, dlo, kb[nt][0], kb[nt][1]);
          mma_pieces(bk[nt], phi, plo, kb[nt][0], kb[nt][1]);
        }
      }
      const float d0 = quad_sum(a0), d1 = quad_sum(a1);
      bf16* qa_out = dwin + (r0 + g) * C3 + 2 * t;
      bf16* qb_out = qa_out + 8 * C3;
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) {
        if (r0 + g < N)
          st2(qa_out + nt * 8, (ak[nt][0] - d0 * bk[nt][0]) * scale,
              (ak[nt][1] - d0 * bk[nt][1]) * scale);
        if (r0 + g + 8 < N)
          st2(qb_out + nt * 8, (ak[nt][2] - d1 * bk[nt][2]) * scale,
              (ak[nt][3] - d1 * bk[nt][3]) * scale);
      }
      if (t == 0) {
        lse[r0 + g] = lse0;
        dsum[r0 + g] = d0;
        lse[r0 + g + 8] = lse1;
        dsum[r0 + g + 8] = d1;
      }
    }
    __syncthreads();  // every row's logsumexp and D; K and V read
    stage<D>(xs, win, C3, N, NP);
    stage<D>(ys, gwin, C, N, NP);
    cp_async_wait_all();
    __syncthreads();

    // column pass: a warp per 16 keys; dK, dV and dS into the partials
    const bool first = w == w0;
    for (int j0 = warp * 16; j0 < N; j0 += WARPS * 16) {
      // keys a = j0+g and b = j0+g+8; a key past N repeats key N-1 (its
      // results are discarded)
      const int ja = j0 + g, jb = j0 + g + 8;
      const bf16* ka_row = win + C + min(ja, N - 1) * C3;
      const bf16* kb_row = win + C + min(jb, N - 1) * C3;
      const Rows<D> ka = load_a_rows<D>(ka_row, kb_row, lane);
      const Rows<D> va = load_a_rows<D>(ka_row + C, kb_row + C, lane);
      // bias, mask and the dbias partial at the accumulators' (u, e): key a
      // (e < 2) or b, query i + 2t with i = i0 + 8u + (e & 1), at o0(i0) +
      // (8u + (e & 1)) * N (+ 8 for key b), offsets the loop keeps; outside
      // N x N the bias is -inf and the partial 0 (as it is at the group's
      // first window)
      const bool a_in = ja < N, b_in = jb < N;
      auto o0 = [&](int i0) { return (i0 + 2 * t) * N + ja; };
      auto off = [&](int u, int e) {
        return (8 * u + (e & 1)) * N + (e < 2 ? 0 : 8);
      };
      auto inside = [&](int i0, int u, int e) {
        return (e < 2 ? a_in : b_in) && i0 + 8 * u + (e & 1) + 2 * t < N;
      };
      auto fetch = [&](int i0, float (&bv)[JT][4], float (&mv)[JT][4],
                       float (&pv)[JT][4]) {
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = inside(i0, u, e);
            const int o = o0(i0) + off(u, e);
            bv[u][e] = in ? __ldg(bias_h + o) : neg_inf;
            mv[u][e] = in && mask_w ? __ldg(mask_w + o) : 0.f;
            pv[u][e] = in && !first ? part[o] : 0.f;
          }
      };
      float dk[KC][4], dv[KC][4];
#pragma unroll
      for (int nt = 0; nt < KC; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
      float bv[JT][4], mv[JT][4], pv[JT][4];
      fetch(0, bv, mv, pv);
#pragma unroll 1
      for (int i0 = 0; i0 < N; i0 += STEP) {
        float s[JT][4], dp[JT][4];
#pragma unroll
        for (int u = 0; u < JT; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = 0.f;
          uint32_t qb[KC], gb[KC];
          load_bt<D>(xs, i0 + 8 * u, lane, qb);
          load_bt<D>(ys, i0 + 8 * u, lane, gb);
          mma_d<D>(s[u], ka, qb);
          mma_d<D>(dp[u], va, gb);
        }
        // p and dS at (key, query); 0 outside N x N
#pragma unroll
        for (int u = 0; u < JT; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int query = i0 + 8 * u + (e & 1) + 2 * t;
            const float p = exp2_ftz(
                fmaf(s[u][e], scale2, (bv[u][e] + mv[u][e]) * LOG2E) -
                lse[query]);
            const float ds = p * (dp[u][e] - dsum[query]);
            if (inside(i0, u, e)) part[o0(i0) + off(u, e)] = pv[u][e] + ds;
            s[u][e] = p;
            dp[u][e] = ds;
          }
        fetch(i0 + STEP, bv, mv, pv);
        uint32_t phi[4], plo[4], dhi[4], dlo[4], gb[KC][2], qb[KC][2];
        acc_pair_a(s[0], s[1], phi, plo);
        acc_pair_a(dp[0], dp[1], dhi, dlo);
        load_b_rows16<D>(ys, i0, lane, gb);
        load_b_rows16<D>(xs, i0, lane, qb);
#pragma unroll
        for (int nt = 0; nt < KC; ++nt) {
          mma_pieces(dv[nt], phi, plo, gb[nt][0], gb[nt][1]);
          mma_pieces(dk[nt], dhi, dlo, qb[nt][0], qb[nt][1]);
        }
      }
      bf16* ka_out = dwin + ja * C3 + C + 2 * t;
      bf16* kb_out = ka_out + 8 * C3;
#pragma unroll
      for (int nt = 0; nt < KC; ++nt) {
        if (ja < N) {
          st2(ka_out + nt * 8, dk[nt][0] * scale, dk[nt][1] * scale);
          st2(ka_out + C + nt * 8, dv[nt][0], dv[nt][1]);
        }
        if (jb < N) {
          st2(kb_out + nt * 8, dk[nt][2] * scale, dk[nt][3] * scale);
          st2(kb_out + C + nt * 8, dv[nt][2], dv[nt][3]);
        }
      }
    }
  }
}

template <int D>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(window_attention_bwd_bf16_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(MAX_N, D)));
}

template <int D>
cudaError_t blocks_per_sm(int N, int* per_sm) {
  cudaError_t err = raise_smem_limit<D>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, window_attention_bwd_bf16_kernel<D>, THREADS,
      smem_bytes(N, D));
}

template <int D>
cudaError_t launch(const bf16* qkv, const float* bias, const float* mask,
                   const bf16* g, const float* lse, bf16* dqkv,
                   float* partial, int W, int N, int heads, int nw_img,
                   int groups, float scale, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<D>();
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(groups) * static_cast<unsigned>(heads);
  window_attention_bwd_bf16_kernel<D><<<blocks, THREADS, smem_bytes(N, D),
                                        stream>>>(qkv, bias, mask, g, lse,
                                                  dqkv, partial, W, N, heads,
                                                  nw_img, groups, scale);
  return cudaGetLastError();
}

}  // namespace bf16path

// dbias[x] = sum over groups of partial[g][x], x over heads * N * N
__global__ void sum_groups_kernel(const float* __restrict__ partial,
                                  float* __restrict__ dbias, int64_t count,
                                  int groups) {
  for (int64_t x = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       x < count; x += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += partial[g * count + x];
    dbias[x] = s;
  }
}

cudaError_t sum_groups(const float* partial, float* dbias, int N, int heads,
                       int groups, cudaStream_t stream) {
  const int64_t count = static_cast<int64_t>(heads) * N * N;
  const int64_t want = (count + 255) / 256;
  sum_groups_kernel<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0,
                      stream>>>(partial, dbias, count, groups);
  return cudaGetLastError();
}

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

// resident blocks per SM of the f32 (bf16 = 0) or bf16 instantiation
cudaError_t blocks_per_sm(int N, int d, int bf16, int* per_sm) {
  return static_cast<cudaError_t>(with_head_dim(d, [&](auto D) {
    constexpr int d_ = decltype(D)::value;
    return static_cast<int>(bf16 ? bf16path::blocks_per_sm<d_>(N, per_sm)
                                 : f32path::blocks_per_sm<d_>(N, per_sm));
  }));
}

bool valid(int W, int N, int heads, const void* mask, int nw_img,
           int groups) {
  return W >= 1 && heads >= 1 && N >= 1 && N <= MAX_N && groups >= 1 &&
         groups <= W && (!mask || nw_img >= 1);
}

}  // namespace

// How many window groups the backward of the f32 (bf16 = 0) or the bf16
// (bf16 = 1) instantiation splits W windows into (the first dimension of its
// partials scratch, groups x heads x N x N floats): enough blocks of that
// instantiation to fill the current device, at most W.  Negative:
// -cudaError_t.
extern "C" int window_attention_bwd_groups(int W, int N, int heads, int d,
                                           int bf16) {
  if (W < 1 || heads < 1 || N < 1 || N > MAX_N)
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = blocks_per_sm(N, d, bf16, &per_sm)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (static_cast<int64_t>(sms) * per_sm + heads - 1) / heads;
  return static_cast<int>(want < W ? want : W);
}

// Launch both kernels on `stream`; return a cudaError_t (0 = launched).
// qkv, g and dqkv are f32 (window_attention_bwd_f32) or bf16
// (window_attention_bwd_bf16); bias, dbias and the partials f32.  `mask`
// may be null (no shifted-window mask; `nw_img` is then ignored).  `lse` is
// the forward's (K2's) row logsumexp, (W, heads, N) f32, in base e for f32
// and base 2 for bf16, as K2 writes it; the f32 backward also takes the
// forward's output `out` (W, N, C).  `partial` holds groups * heads * N * N
// floats, groups from window_attention_bwd_groups for the same
// instantiation.  The caller checks dtypes, contiguity, 16-byte alignment of
// qkv and g, W % nw_img == 0 and the grid size.
extern "C" int window_attention_bwd_f32(const void* qkv, const void* bias,
                                        const void* mask, const void* g,
                                        const void* out, const void* lse,
                                        void* dqkv, void* dbias, void* partial,
                                        int W, int N, int heads, int d,
                                        int nw_img, int groups, float scale,
                                        void* stream) {
  if (!valid(W, N, heads, mask, nw_img, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = with_head_dim(d, [&](auto D) {
    return static_cast<int>(f32path::launch<decltype(D)::value>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<const float*>(g),
        static_cast<const float*>(out), static_cast<const float*>(lse),
        static_cast<float*>(dqkv), static_cast<float*>(partial), W, N, heads,
        nw_img, groups, scale, s));
  });
  if (err != 0) return err;
  return static_cast<int>(sum_groups(static_cast<const float*>(partial),
                                     static_cast<float*>(dbias), N, heads,
                                     groups, s));
}

extern "C" int window_attention_bwd_bf16(const void* qkv, const void* bias,
                                         const void* mask, const void* g,
                                         const void* lse, void* dqkv,
                                         void* dbias, void* partial, int W,
                                         int N, int heads, int d, int nw_img,
                                         int groups, float scale,
                                         void* stream) {
  if (!valid(W, N, heads, mask, nw_img, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = with_head_dim(d, [&](auto D) {
    return static_cast<int>(bf16path::launch<decltype(D)::value>(
        static_cast<const bf16mma::bf16*>(qkv),
        static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<const bf16mma::bf16*>(g), static_cast<const float*>(lse),
        static_cast<bf16mma::bf16*>(dqkv), static_cast<float*>(partial), W,
        N, heads, nw_img, groups, scale, s));
  });
  if (err != 0) return err;
  return static_cast<int>(sum_groups(static_cast<const float*>(partial),
                                     static_cast<float*>(dbias), N, heads,
                                     groups, s));
}

// The main kernel's launch of the f32 (bf16 = 0) or the bf16 (bf16 = 1)
// instantiation at (N, d): out = {threads per block, dynamic shared memory
// bytes, resident blocks per SM}; returns a cudaError_t.
extern "C" int window_attention_bwd_info(int N, int d, int bf16, int* out) {
  if (N < 1 || N > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = bf16 ? bf16path::THREADS : f32path::THREADS;
  out[1] = static_cast<int>(bf16 ? bf16path::smem_bytes(N, d)
                                 : f32path::smem_bytes(N, d));
  return static_cast<int>(blocks_per_sm(N, d, bf16, &out[2]));
}
