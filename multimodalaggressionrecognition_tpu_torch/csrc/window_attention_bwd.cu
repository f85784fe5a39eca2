// Fused (shifted-)window attention backward (kernel K3) for Hopper, f32.
//
// Replaces `_fused_bwd` (with its body `_bwd_kernel`) in
// multimodalaggressionrecognition_tpu/ops/pallas/window_attention.py: the
// flash-style backward of window attention (the forward is K2,
// csrc/window_attention.cu).  For every window w and head h, with q, k, v
// the head's d-wide slices of the packed qkv (W, N, 3C) and g the head's
// slice of the output gradient (W, N, C), it recomputes
//
//   s = q k^T / sqrt(d) + bias[h] + mask[w mod nW],   p = softmax_rows(s),
//
// and from it
//
//   dV = p^T g,   dP = g v^T,   dS = p o (dP - rowsum(dP o p)),
//   dQ = dS k / sqrt(d),   dK = dS^T q / sqrt(d),   dbias[h] = sum_w dS,
//
// writing dqkv (W, N, 3C) and dbias (heads, N, N); the mask gets no
// gradient.  Neither p nor dS, (W, heads, N, N) each, reaches device memory.
//
// Bound.  The JAX kernel's own count (its CostEstimate) is
// 10*W*heads*N^2*d operations and 4*(2*W*N*3C + 2*heads*N^2 + W*N*C) bytes.
// At Swin3D-T's stage 0 trained at batch 8 (W=2048, N=196, C=96, 3 heads,
// d=32) that is 75.5 GFLOP, 1.127 ms at the 67 TFLOP/s f32 (non-tensor-core)
// peak of an H100 SXM, against 1.08 GB, 0.322 ms at 3.35 TB/s: bound by
// operations.
//
// Design.  One block per (group of windows, head), one thread per token
// (whole warps, at most 8; a larger N loops).  The block walks its group's
// windows one at a time; for each it stages Q (pre-scaled by 1/sqrt(d)), K,
// V and G in dynamic shared memory (4*N*d floats, row-major), then:
//   - row pass: thread i owns query row i, its q_i and g_i in registers.
//     A first sweep over the keys gives the row's logsumexp and
//     D_i = sum_j p dP online (running max, rescaled sums); a second
//     recomputes p and dS and accumulates dQ_i = sum_j dS k_j in registers.
//   - column pass: thread j owns key j, its k_j and v_j in registers, and
//     sweeps the query rows: p and dS from the stored logsumexp and D, then
//     dV_j = sum_i p g_i and dK_j = sum_i dS q_i in registers.
// Every lane of a warp reads the same shared-memory row at the same time (a
// broadcast), and no sum crosses threads, so nothing needs atomics or
// shuffles; the price is 9*d FMAs per (i, j) instead of the 5*d of one pass
// (s and dP are computed three times).  The bias and mask, which stay in L2,
// are loaded a step ahead of their use; the row pass reads them transposed
// (the wrapper transposes both) so that, like the column pass's, its loads
// coalesce.  A warp per token instead (lanes splitting the keys, the sums
// over rows through shared-memory row buffers) moved ~5 times more
// shared-memory bytes per (i, j) and ran 1.6 times slower on an H100.  Here
// the registers (k, v, dK and dV are 4*d per thread) allow one block of at
// most 8 warps per SM, too few to hide the latencies: the kernel runs at a
// quarter of the FMA peak.
//
// dbias is a sum over all W windows, which the TPU kernel accumulates in a
// block revisited across its sequential grid.  A GPU grid has no order, so
// the sum is split: each block adds its windows' dS into its own
// (heads, N, N) slice of a partials array in device memory, and a second
// small kernel sums the partials over the groups.  Every (i, j) of a block
// belongs to a fixed thread (the owner of key j in the column pass) across
// all its windows, so the read-modify-write needs no atomics, and the
// result does not depend on scheduling: it is deterministic.  The number of
// groups fills the card (blocks per SM from the occupancy API, times the SM
// count, over the heads).
// Not yet done (later work): register tiling over several rows or keys and
// a slice of d per thread (fewer registers, so more warps, and each shared
// load feeding several FMAs), and tensor cores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_THREADS = 256;  // 8 warps
// keys per step of the row pass and query rows per step of the column pass;
// the column pass, which also holds k, v, dK and dV in registers, spills at 2
constexpr int ROW_STEP = 4;
constexpr int COL_STEP = 1;
constexpr int MAX_N = 392;  // a full (8, 7, 7) window

// one thread per token, in whole warps, at most MAX_THREADS
int threads_for(int n) {
  const int t = 32 * ((n + 31) / 32);
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// Q, K, V, G tiles (N x d each) and the rows' logsumexp and D:
// 203,840 bytes at N=392, d=32
size_t smem_bytes(int n, int d) {
  return sizeof(float) * (4 * static_cast<size_t>(n) * d + 2 * static_cast<size_t>(n));
}

// r = src[0:D] * mul, from global memory (16-byte aligned)
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&r)[D], float mul) {
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + c);
    r[4 * c + 0] = v.x * mul;
    r[4 * c + 1] = v.y * mul;
    r[4 * c + 2] = v.z * mul;
    r[4 * c + 3] = v.w * mul;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[D],
                                          float mul) {
#pragma unroll
  for (int c = 0; c < D / 4; ++c)
    reinterpret_cast<float4*>(dst)[c] =
        make_float4(r[4 * c] * mul, r[4 * c + 1] * mul, r[4 * c + 2] * mul,
                    r[4 * c + 3] * mul);
}

// the tile rows r0 .. r0+STEP-1, clamped to the last one (a row past the
// end is read, and its result discarded by the caller)
template <int S>
__device__ __forceinline__ void step_rows(int r0, int n, int (&row)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) row[k] = min(r0 + k, n - 1);
}

// sx[k] = x . a[row[k]], sy[k] = y . b[row[k]] over D-wide tile rows; every
// lane reads the same rows, so each float4 load is a broadcast.  Each dot
// runs as 4/S interleaved partial sums, so that a thread has at least eight
// independent FMA chains in flight.
template <int D, int S>
__device__ __forceinline__ void dots(const float* a, const float* b,
                                     const int (&row)[S],
                                     const float (&x)[D], const float (&y)[D],
                                     float (&sx)[S], float (&sy)[S]) {
  constexpr int P = S >= 4 ? 1 : 4 / S;
  float ax[S][P], ay[S][P];
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int t = 0; t < P; ++t) ax[k][t] = ay[k][t] = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      float& u_acc = ax[k][c % P];
      const float4 u = *reinterpret_cast<const float4*>(a + row[k] * D + 4 * c);
      u_acc = fmaf(x[4 * c + 0], u.x, u_acc);
      u_acc = fmaf(x[4 * c + 1], u.y, u_acc);
      u_acc = fmaf(x[4 * c + 2], u.z, u_acc);
      u_acc = fmaf(x[4 * c + 3], u.w, u_acc);
      float& v_acc = ay[k][c % P];
      const float4 v = *reinterpret_cast<const float4*>(b + row[k] * D + 4 * c);
      v_acc = fmaf(y[4 * c + 0], v.x, v_acc);
      v_acc = fmaf(y[4 * c + 1], v.y, v_acc);
      v_acc = fmaf(y[4 * c + 2], v.z, v_acc);
      v_acc = fmaf(y[4 * c + 3], v.w, v_acc);
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    sx[k] = ax[k][0];
    sy[k] = ay[k][0];
#pragma unroll
    for (int t = 1; t < P; ++t) {
      sx[k] += ax[k][t];
      sy[k] += ay[k][t];
    }
  }
}

// acc += sum_k f[k] * tile[row[k]] (broadcast loads, as in dots)
template <int D, int S>
__device__ __forceinline__ void axpy(const float* tile, const int (&row)[S],
                                     const float (&f)[S], float (&acc)[D]) {
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(tile + row[k] * D + 4 * c);
      acc[4 * c + 0] = fmaf(f[k], u.x, acc[4 * c + 0]);
      acc[4 * c + 1] = fmaf(f[k], u.y, acc[4 * c + 1]);
      acc[4 * c + 2] = fmaf(f[k], u.z, acc[4 * c + 2]);
      acc[4 * c + 3] = fmaf(f[k], u.w, acc[4 * c + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS, 1)
window_attention_bwd_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ bias_t,
                            const float* __restrict__ mask,
                            const float* __restrict__ mask_t,
                            const float* __restrict__ gout,
                            float* __restrict__ dqkv,
                            float* __restrict__ partial, int W, int N,
                            int heads, int nw_img, int groups, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;        // [N][D], q / sqrt(d)
  float* ks = qs + N * D;  // [N][D]
  float* vs = ks + N * D;
  float* gs = vs + N * D;
  float* lse = gs + N * D;  // [N]
  float* dsum = lse + N;    // [N]

  const int C = heads * D;
  const int64_t C3 = 3 * static_cast<int64_t>(C);
  const int64_t NN = static_cast<int64_t>(N) * N;
  const int h = blockIdx.x % heads;
  const int grp = blockIdx.x / heads;
  const int64_t w0 = static_cast<int64_t>(W) * grp / groups;
  const int64_t w1 = static_cast<int64_t>(W) * (grp + 1) / groups;
  const float* bias_h = bias + h * NN;
  const float* bias_th = bias_t + h * NN;
  float* part = partial + (static_cast<int64_t>(grp) * heads + h) * NN;
  const float neg_inf = __int_as_float(0xff800000);

  for (int64_t w = w0; w < w1; ++w) {
    const float* win = qkv + w * N * C3;
    const float* gwin = gout + w * N * C;
    float* dwin = dqkv + w * N * C3;
    const int64_t m_off = mask ? (w % nw_img) * NN : 0;
    const float* mask_w = mask ? mask + m_off : nullptr;
    const float* mask_tw = mask ? mask_t + m_off : nullptr;

    __syncthreads();  // the previous window's readers are done
    for (int idx = threadIdx.x; idx < N * (D / 4); idx += blockDim.x) {
      const int j = idx / (D / 4);
      const int c = idx % (D / 4);
      const float* row = win + j * C3 + h * D + 4 * c;
      float4 q4 = __ldg(reinterpret_cast<const float4*>(row));
      q4.x *= scale;
      q4.y *= scale;
      q4.z *= scale;
      q4.w *= scale;
      const int at = j * D + 4 * c;
      *reinterpret_cast<float4*>(qs + at) = q4;
      *reinterpret_cast<float4*>(ks + at) =
          __ldg(reinterpret_cast<const float4*>(row + C));
      *reinterpret_cast<float4*>(vs + at) =
          __ldg(reinterpret_cast<const float4*>(row + 2 * C));
      *reinterpret_cast<float4*>(gs + at) = __ldg(
          reinterpret_cast<const float4*>(gwin + j * C + h * D + 4 * c));
    }
    __syncthreads();

    // row pass: thread i owns query row i; logsumexp, D and dQ
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float q[D], g[D];
      load_row<D>(win + i * C3 + h * D, q, scale);
      load_row<D>(gwin + i * C + h * D, g, 1.f);
      // bias[h][i][j] and mask[i][j] at column offset j * N of these
      const float* bias_i = bias_th + i;
      const float* mask_i = mask_tw ? mask_tw + i : nullptr;
      // the bias (+ mask) of the keys of step j0, loaded one step ahead
      auto load_bm = [&](int j0, float (&bm)[ROW_STEP]) {
#pragma unroll
        for (int k = 0; k < ROW_STEP; ++k) {
          const int at = min(j0 + k, N - 1) * N;
          bm[k] = __ldg(bias_i + at) + (mask_i ? __ldg(mask_i + at) : 0.f);
        }
      };
      float mx = neg_inf, l = 0.f, acc = 0.f;
      float bm[ROW_STEP], bm_next[ROW_STEP];
      load_bm(0, bm_next);
#pragma unroll 1
      for (int j0 = 0; j0 < N; j0 += ROW_STEP) {
#pragma unroll
        for (int k = 0; k < ROW_STEP; ++k) bm[k] = bm_next[k];
        load_bm(j0 + ROW_STEP, bm_next);
        int row[ROW_STEP];
        step_rows(j0, N, row);
        float s[ROW_STEP], dp[ROW_STEP];
        dots<D>(ks, vs, row, q, g, s, dp);
        float m_new = mx;
#pragma unroll
        for (int k = 0; k < ROW_STEP; ++k) {
          s[k] = j0 + k < N ? s[k] + bm[k] : neg_inf;
          m_new = fmaxf(m_new, s[k]);
        }
        const float corr = expf(mx - m_new);  // 0 at the first step
        l *= corr;
        acc *= corr;
#pragma unroll
        for (int k = 0; k < ROW_STEP; ++k) {
          const float e = expf(s[k] - m_new);
          l += e;
          acc = fmaf(e, dp[k], acc);
        }
        mx = m_new;
      }
      const float li = mx + logf(l);
      const float di = acc / l;  // D_i = sum_j p dP
      float dq[D];
#pragma unroll
      for (int e = 0; e < D; ++e) dq[e] = 0.f;
      load_bm(0, bm_next);
#pragma unroll 1
      for (int j0 = 0; j0 < N; j0 += ROW_STEP) {
#pragma unroll
        for (int k = 0; k < ROW_STEP; ++k) bm[k] = bm_next[k];
        load_bm(j0 + ROW_STEP, bm_next);
        int row[ROW_STEP];
        step_rows(j0, N, row);
        float s[ROW_STEP], dp[ROW_STEP], ds[ROW_STEP];
        dots<D>(ks, vs, row, q, g, s, dp);
#pragma unroll
        for (int k = 0; k < ROW_STEP; ++k)
          ds[k] = j0 + k < N ? expf(s[k] + bm[k] - li) * (dp[k] - di) : 0.f;
        axpy<D>(ks, row, ds, dq);
      }
      store_row<D>(dwin + i * C3 + h * D, dq, scale);
      lse[i] = li;
      dsum[i] = di;
    }
    __syncthreads();  // every row's logsumexp and D

    // column pass: thread j owns key j; dK, dV and dS into the partials
    const bool first = w == w0;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      // the bias (+ mask) and the partial of the rows of step i0, loaded one
      // step ahead (a row past the end reads the last row, and is unused)
      auto load_step = [&](int i0, float (&bm)[COL_STEP],
                           float (&old)[COL_STEP]) {
#pragma unroll
        for (int r = 0; r < COL_STEP; ++r) {
          const int at = min(i0 + r, N - 1) * N + j;
          bm[r] = __ldg(bias_h + at) + (mask_w ? __ldg(mask_w + at) : 0.f);
          old[r] = first ? 0.f : part[at];
        }
      };
      float k[D], v[D], dk[D], dv[D];
      load_row<D>(win + j * C3 + C + h * D, k, 1.f);
      load_row<D>(win + j * C3 + 2 * C + h * D, v, 1.f);
#pragma unroll
      for (int e = 0; e < D; ++e) dk[e] = dv[e] = 0.f;
      float bm[COL_STEP], bm_next[COL_STEP], old[COL_STEP], old_next[COL_STEP];
      load_step(0, bm_next, old_next);
#pragma unroll 1
      for (int i0 = 0; i0 < N; i0 += COL_STEP) {
#pragma unroll
        for (int r = 0; r < COL_STEP; ++r) {
          bm[r] = bm_next[r];
          old[r] = old_next[r];
        }
        load_step(i0 + COL_STEP, bm_next, old_next);
        int row[COL_STEP];
        step_rows(i0, N, row);
        float s[COL_STEP], dp[COL_STEP], p[COL_STEP], ds[COL_STEP];
        dots<D>(qs, gs, row, k, v, s, dp);
#pragma unroll
        for (int r = 0; r < COL_STEP; ++r) {
          const bool valid = i0 + r < N;
          p[r] = valid ? expf(s[r] + bm[r] - lse[row[r]]) : 0.f;
          ds[r] = p[r] * (dp[r] - dsum[row[r]]);
          if (valid) part[row[r] * N + j] = old[r] + ds[r];
        }
        axpy<D>(gs, row, p, dv);
        axpy<D>(qs, row, ds, dk);
      }
      store_row<D>(dwin + j * C3 + C + h * D, dk, 1.f);
      store_row<D>(dwin + j * C3 + 2 * C + h * D, dv, 1.f);
    }
  }
}

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

template <int D>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(window_attention_bwd_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(MAX_N, D)));
}

template <int D>
int groups_for(int W, int N, int heads) {
  cudaError_t err = raise_smem_limit<D>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, window_attention_bwd_kernel<D>, threads_for(N),
           smem_bytes(N, D))) != cudaSuccess)
    return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (static_cast<int64_t>(sms) * per_sm + heads - 1) / heads;
  return static_cast<int>(want < W ? want : W);
}

template <int D>
int launch(const float* qkv, const float* bias, const float* bias_t,
           const float* mask, const float* mask_t, const float* g, float* dqkv,
           float* dbias, float* partial, int W, int N, int heads, int nw_img,
           int groups, float scale, cudaStream_t stream) {
  cudaError_t err = raise_smem_limit<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(groups) * static_cast<unsigned>(heads);
  window_attention_bwd_kernel<D><<<blocks, threads_for(N), smem_bytes(N, D),
                                   stream>>>(qkv, bias, bias_t, mask, mask_t, g,
                                             dqkv, partial, W, N, heads,
                                             nw_img, groups, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t count = static_cast<int64_t>(heads) * N * N;
  const int64_t want = (count + 255) / 256;
  sum_groups_kernel<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0,
                      stream>>>(partial, dbias, count, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many window groups the backward splits W windows into (the first
// dimension of its partials scratch, groups x heads x N x N floats): enough
// blocks to fill the current device, at most W.  Negative: -cudaError_t.
extern "C" int window_attention_bwd_groups(int W, int N, int heads, int d) {
  if (W < 1 || heads < 1 || N < 1 || N > MAX_N)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8:
      return groups_for<8>(W, N, heads);
    case 16:
      return groups_for<16>(W, N, heads);
    case 32:
      return groups_for<32>(W, N, heads);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches both kernels on `stream`; returns a cudaError_t (0 = launched).
// bias_t and mask_t are bias and mask with their last two axes swapped;
// `mask`/`mask_t` may be null (no shifted-window mask; `nw_img` is then
// ignored).  `partial` holds groups * heads * N * N floats, groups from
// window_attention_bwd_groups.  The caller checks dtypes, contiguity,
// 16-byte alignment of qkv and g, W % nw_img == 0 and the grid size.
extern "C" int window_attention_bwd_f32(const void* qkv, const void* bias,
                                        const void* bias_t, const void* mask,
                                        const void* mask_t, const void* g,
                                        void* dqkv, void* dbias, void* partial,
                                        int W, int N, int heads, int d,
                                        int nw_img, int groups, float scale,
                                        void* stream) {
  if (W < 1 || heads < 1 || N < 1 || N > MAX_N || groups < 1 || groups > W ||
      (mask && (nw_img < 1 || !mask_t)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const float*>(qkv);
  const auto* b = static_cast<const float*>(bias);
  const auto* bt = static_cast<const float*>(bias_t);
  const auto* m = static_cast<const float*>(mask);
  const auto* mt = static_cast<const float*>(mask_t);
  const auto* go = static_cast<const float*>(g);
  auto* dq = static_cast<float*>(dqkv);
  auto* db = static_cast<float*>(dbias);
  auto* pa = static_cast<float*>(partial);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8>(q, b, bt, m, mt, go, dq, db, pa, W, N, heads, nw_img,
                       groups, scale, s);
    case 16:
      return launch<16>(q, b, bt, m, mt, go, dq, db, pa, W, N, heads, nw_img,
                        groups, scale, s);
    case 32:
      return launch<32>(q, b, bt, m, mt, go, dq, db, pa, W, N, heads, nw_img,
                        groups, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
