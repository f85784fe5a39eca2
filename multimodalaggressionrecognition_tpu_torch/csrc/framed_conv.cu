// Framed conv1d forward (kernel K1) for Hopper, f32 accuracy on the tensor
// cores (3xTF32).
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
// Bound.  The work is 2*B*T*F*C operations against x, w and y once each.
// On an H100 SXM, with every product in three TF32 passes at 495 TFLOP/s
// and 3.35 TB/s: the CNN1D stem (B=32, L=80 000, F=160, hop 40, pad 80,
// C=64, T=2001; 1.31 GFLOP, 26.7 MB) is bound by bytes at 8.0 us (the
// operations take 7.9 us); the STFT of 5 s at 16 kHz (F=512, hop 256,
// C=514, T=313; 5.27 GFLOP, 32.0 MB) by operations at 32.0 us.
//
// Design: an implicit GEMM, M = frames of the flattened (B, T), N =
// channels, K = taps, each product on mma.sync.m16n8k8 in 3xTF32
// (tf32x3.cuh: big*small + small*big + big*big, accumulated in f32).  A
// block of 4 warps owns 64 consecutive frames (the narrow tile, 16 a warp)
// or 128 (the wide tile, 32 a warp, 2 m-tiles), at most two batch rows when
// T covers a tile, so no tile idles at T's edge, and 64 channels (8 n-tiles).
// The wide tile halves the weight staging and B-fragment loads per product,
// which pays only where each block runs many chunks: it takes launches of
// at least 8 chunks (F > 224) whose grid gives every SM at least 2 blocks
// (the STFT and the resample at b32).  The stem (5 chunks) takes the narrow
// one, whose 16 warps an SM hide more of each block's first loads and
// epilogue: at b8 the wide tile made 126 blocks for 132 SMs, one warp a
// scheduler.  Both tiles run each output's sum in the same order.  Per
// chunk of 32 taps, double-buffered (chunk k + 1's copies and weight loads
// are in flight during chunk k's products, one barrier a chunk):
//   - the frame tile A[m][f] = x[b, t*hop + f0 + f - pad] is gathered by
//     cp.async into shared memory, zero-filled outside [0, L) (so `pad`
//     costs nothing), past F and past B*T: 16-byte copies when hop, pad and
//     L are multiples of 4 (the stem, the STFT), else 4-byte ones (the 44.1
//     -> 16 kHz resample, hop 441).  Rows are 40 floats apart whatever the
//     hop, so that a lane's two A values of a k-step are one conflict-free
//     8-byte load.  Each A element feeds one warp only: it is split into
//     (big, small) as its fragment is loaded, once;
//   - the weight chunk is read into registers one chunk ahead and stored
//     split, one float4 (big, big, small, small) per tap pair and channel,
//     rows padded to a conflict-free stride: a B fragment is one 16-byte
//     load and no arithmetic for the 4 warps that share it.  The mma's
//     reduction index is permuted so that its k = t and t + 4 are the
//     adjacent taps 2t and 2t + 1 on both sides;
//   - the products run term by term over the warp's 8 or 16 tiles, so that
//     independent mma lie between two on one accumulator.
// A ragged last channel tile runs 4, 2 or 1 n-tiles instead of 8.  The
// epilogue applies bias, scale/shift (a folded inference BatchNorm) and ReLU
// in registers and writes each lane's two adjacent channels (8 bytes), so
// each store instruction fills 8 whole 32-byte sectors.  Each output's sum
// runs in a fixed order with no atomics: two launches agree bit for bit.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W), with the
// signal coming from device memory as a served clip's does: about 0.046 ms
// at the stem at b32, 17 % of the bound, and 0.019 ms at b8; 0.122 ms at
// the STFT, 26 %.  128 registers and 4 blocks an SM for the narrow tile,
// 168 and 3 for the wide.  What holds it back: at the STFT the gathers, each
// frame tile re-read per 64-channel tile and each weight chunk per frame
// tile, move 279 MB through L2 for a 32 MB problem; with each A operand
// split in the loop, 12 to 16 warps an SM leave the tensor pipe idle
// between products; each block waits on device memory for its first
// chunks.  Right after a cuBLAS GEMM or a cuDNN conv it runs 15-40 % slower
// than after a copy, which the earlier FMA-pipe design did not.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int TN = 64;            // channels per block
constexpr int THREADS = 128;      // 4 warps
constexpr int KC = 32;            // taps per staged chunk: 4 k-steps
constexpr int A_STRIDE = KC + 8;  // = 8 mod 32: 8-byte A loads hit 32 banks
// float4 slots per row of the split weight tile (one row per tap pair of a
// chunk); = 2 mod 8, so a fragment's 8-lane phases hit 8 distinct 16-byte
// bank groups
constexpr int W_STRIDE = TN + 2;
constexpr int W_SLOTS = (KC / 2) * W_STRIDE;
constexpr int W_ITEMS = (KC / 2) * TN / THREADS;  // weight pairs a thread
// The wide tile (MT = 2) takes a launch whose blocks each run at least
// WIDE_MIN_CHUNKS chunks and whose grid gives every SM at least
// WIDE_MIN_BLOCKS_PER_SM blocks; any other takes the narrow one (MT = 1),
// with twice the blocks.
constexpr int WIDE_MIN_CHUNKS = 8;
constexpr int WIDE_MIN_BLOCKS_PER_SM = 2;

// A warp owns MT m-tiles of 16 frames, a block TM = 64 * MT frames.  Two
// frame tiles and two split weight tiles in shared memory: 74,752 bytes
// (3 blocks an SM) at MT = 2, 54,272 (4 blocks) at MT = 1.
template <int MT>
struct Tile {
  static constexpr int TM = 64 * MT;
  static constexpr int A_FLOATS = TM * A_STRIDE;
  static constexpr size_t SMEM =
      2 * (sizeof(float) * A_FLOATS + sizeof(uint4) * W_SLOTS);
  static constexpr int MIN_BLOCKS = MT == 2 ? 3 : 4;
};

// The block's frames m0 .. m0 + TM - 1 of the flattened (B, T); frame m0
// is (b0, t0).  With T >= TM they span at most two batch rows, the second
// (b0 + 1, from frame 0) from tile row `split` on.  A shorter T takes a
// division per row.
struct Frames {
  int m0, M, T, b0, t0, split;

  __device__ __forceinline__ Frames(int m0_, int M_, int T_)
      : m0(m0_), M(M_), T(T_), b0(m0_ / T_), t0(m0_ - b0 * T_),
        split(T_ - t0) {}
};

// Start chunk f0's frame tile: row r, column c holds x[b, t*hop - pad + f0
// + c] for tile frame r = (b, t), zero outside [0, L), past F and past B*T.
// Each thread copies column c of every STEP-th row.
template <int TM, int COLS, int BYTES, bool SPAN2>
__device__ __forceinline__ void stage_rows(float* sa, const float* x,
                                           const Frames& rows, int f0, int L,
                                           int F, int hop, int pad) {
  constexpr int STEP = THREADS / COLS;
  const int c = (threadIdx.x % COLS) * (BYTES / 4);
  const int f = f0 + c;
  const int keep = max(0, min(BYTES, 4 * (F - f)));  // bytes before F
  const float* xb = x + static_cast<int64_t>(rows.b0) * L;
#pragma unroll 2
  for (int r = threadIdx.x / COLS; r < TM; r += STEP) {
    int pos;      // the tap's place in its batch row
    int64_t off;  // and in x, from batch row b0
    if (SPAN2) {
      const bool next = r >= rows.split;
      pos = (next ? r - rows.split : rows.t0 + r) * hop - pad + f;
      off = next ? static_cast<int64_t>(L) + pos : pos;
    } else {
      const int b = (rows.m0 + r) / rows.T;
      pos = (rows.m0 + r - b * rows.T) * hop - pad + f;
      off = static_cast<int64_t>(b - rows.b0) * L + pos;
    }
    const bool in = rows.m0 + r < rows.M && keep > 0 && pos >= 0 && pos < L;
    const float* src = in ? xb + off : x;
    if (BYTES == 16)
      cp_async16_zfill(sa + r * A_STRIDE + c, src, in ? keep : 0);
    else
      cp_async4_zfill(sa + r * A_STRIDE + c, src, in ? keep : 0);
  }
}

// 16-byte copies when every one lies wholly inside or outside [0, L) (hop,
// pad and L multiples of 4, x 16-byte aligned), else 4-byte ones
template <int TM>
__device__ __forceinline__ void stage_frames(float* sa, const float* x,
                                             const Frames& rows, int f0,
                                             int L, int F, int hop, int pad,
                                             bool vec) {
  if (rows.T >= TM) {
    if (vec)
      stage_rows<TM, KC / 4, 16, true>(sa, x, rows, f0, L, F, hop, pad);
    else
      stage_rows<TM, KC, 4, true>(sa, x, rows, f0, L, F, hop, pad);
  } else {
    if (vec)
      stage_rows<TM, KC / 4, 16, false>(sa, x, rows, f0, L, F, hop, pad);
    else
      stage_rows<TM, KC, 4, false>(sa, x, rows, f0, L, F, hop, pad);
  }
}

// Chunk f0's weights for this thread: taps f0 + 2p and f0 + 2p + 1 of
// channel c0 + n, p = tid / TN + i * THREADS / TN (zero past F and C)
__device__ __forceinline__ void load_weights(float (&wr)[W_ITEMS][2],
                                             const float* __restrict__ w,
                                             int f0, int c0, int F, int C) {
  const int n = threadIdx.x % TN;
  const bool cin = c0 + n < C;
#pragma unroll
  for (int i = 0; i < W_ITEMS; ++i) {
    const int f = f0 + 2 * (threadIdx.x / TN + i * (THREADS / TN));
#pragma unroll
    for (int e = 0; e < 2; ++e)
      wr[i][e] = cin && f + e < F
                     ? __ldg(w + static_cast<int64_t>(f + e) * C + c0 + n)
                     : 0.f;
  }
}

__device__ __forceinline__ void store_weights(uint4* sw,
                                              const float (&wr)[W_ITEMS][2]) {
  const int n = threadIdx.x % TN;
#pragma unroll
  for (int i = 0; i < W_ITEMS; ++i) {
    const int p = threadIdx.x / TN + i * (THREADS / TN);
    uint4 v;  // (big, big, small, small): each operand's registers adjacent
    split(wr[i][0], v.x, v.z);
    split(wr[i][1], v.y, v.w);
    sw[p * W_STRIDE + n] = v;
  }
}

// One chunk's products for a warp: acc[m][j] += A[rows m] W[:, tile j], for
// its MT m-tiles and the block's first NT n-tiles.  `a` points at the warp's
// row g, column 2t of the frame tile; `bw` at the split weights' row t,
// channel g.
template <int MT, int NT>
__device__ __forceinline__ void chunk_products(float (&acc)[MT][NT][4],
                                               const float* a,
                                               const uint4* bw) {
#pragma unroll
  for (int s = 0; s < KC / 8; ++s) {
    FragA af[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // k = t and t + 4 are taps 2t and 2t + 1: rows g and g + 8
      const float2 lo = *reinterpret_cast<const float2*>(
          a + m * 16 * A_STRIDE + 8 * s);
      const float2 hi = *reinterpret_cast<const float2*>(
          a + (m * 16 + 8) * A_STRIDE + 8 * s);
      af[m] = split_a(lo.x, hi.x, lo.y, hi.y);
    }
    FragB bf[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint4 v = bw[4 * s * W_STRIDE + 8 * j];
      bf[j].big[0] = v.x;
      bf[j].big[1] = v.y;
      bf[j].small[0] = v.z;
      bf[j].small[1] = v.w;
    }
    // term by term over the MT * NT tiles (the small terms first, as mma3),
    // so that independent products lie between two on one accumulator
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], af[m].big, bf[j].small);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], af[m].small, bf[j].big);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], af[m].big, bf[j].big);
  }
}

// The block's frames m0.. of the flattened (B, T) and channels c0..: NT
// n-tiles of products (those past C have zero weights), stored where they
// lie inside B*T and C.
template <int MT, int NT>
__device__ __forceinline__ void block_tile(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, float* __restrict__ y, int m0, int c0,
    int M, int L, int F, int C, int T, int hop, int pad, int relu, bool vec) {
  constexpr int TM = Tile<MT>::TM, A_FLOATS = Tile<MT>::A_FLOATS;
  extern __shared__ __align__(16) float smem[];
  // two frame tiles, then two split weight tiles: chunk k in buffer k & 1
  float* const sa = smem;
  uint4* const sw = reinterpret_cast<uint4*>(smem + 2 * A_FLOATS);
  const Frames rows(m0, M, T);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int mw = m0 + 16 * MT * warp;  // this warp's first frame
  const bool active = mw < M;          // else its frames all lie past B*T

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  float wr[W_ITEMS][2];
  const int chunks = (F + KC - 1) / KC;
  stage_frames<TM>(sa, x, rows, 0, L, F, hop, pad, vec);
  load_weights(wr, w, 0, c0, F, C);
  store_weights(sw, wr);

  const float* a = sa + (16 * MT * warp + g) * A_STRIDE + 2 * t;
  const uint4* bw = sw + t * W_STRIDE + g;
  for (int k = 0; k < chunks; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    cp_async_wait_all();
    __syncthreads();  // chunk k landed; every warp is past chunk k - 1
    const bool next = k + 1 < chunks;
    if (next) {  // chunk k + 1's copies and weights, during chunk k's products
      stage_frames<TM>(sa + nxt * A_FLOATS, x, rows, (k + 1) * KC, L, F,
                       hop, pad, vec);
      load_weights(wr, w, (k + 1) * KC, c0, F, C);
    }
    if (active)
      chunk_products<MT, NT>(acc, a + cur * A_FLOATS, bw + cur * W_SLOTS);
    if (next) store_weights(sw + nxt * W_SLOTS, wr);
  }
  if (!active) return;

  // epilogue: lane (g, t) holds frames (rows g, g + 8 of each m-tile) x
  // channels 2t, 2t + 1 of each n-tile
  const bool pairs = (C % 2) == 0;  // 8-byte aligned channel pairs
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    float bc[2], sc[2], sh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = c + e < C;
      bc[e] = in ? bias[c + e] : 0.f;
      sc[e] = in && scale ? scale[c + e] : 1.f;
      sh[e] = in && shift ? shift[c + e] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int frame = mw + 16 * m + g + 8 * h;
        if (frame >= M) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = (acc[m][j][2 * h + e] + bc[e]) * sc[e] + sh[e];
          if (relu) v[e] = fmaxf(v[e], 0.f);
        }
        float* dst = y + static_cast<int64_t>(frame) * C + c;
        if (pairs && c < C) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          if (c < C) dst[0] = v[0];
          if (c + 1 < C) dst[1] = v[1];
        }
      }
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, Tile<MT>::MIN_BLOCKS)
framed_conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ y,
                     int M, int L, int F, int C, int T, int hop, int pad,
                     int relu, int vec) {
  const int m0 = blockIdx.x * Tile<MT>::TM;
  const int c0 = blockIdx.y * TN;
  // n-tiles inside C, rounded up to a power of two: only a ragged last
  // channel tile takes a narrower instance
  const int nt = (C - c0 + 7) / 8;
  if (nt >= 5)
    block_tile<MT, 8>(x, w, bias, scale, shift, y, m0, c0, M, L, F, C, T,
                      hop, pad, relu, vec);
  else if (nt >= 3)
    block_tile<MT, 4>(x, w, bias, scale, shift, y, m0, c0, M, L, F, C, T,
                      hop, pad, relu, vec);
  else if (nt == 2)
    block_tile<MT, 2>(x, w, bias, scale, shift, y, m0, c0, M, L, F, C, T,
                      hop, pad, relu, vec);
  else
    block_tile<MT, 1>(x, w, bias, scale, shift, y, m0, c0, M, L, F, C, T,
                      hop, pad, relu, vec);
}

template <int MT>
cudaError_t raise_smem_limit() {
  // per call, so that it holds on whichever device is current
  return cudaFuncSetAttribute(framed_conv1d_kernel<MT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Tile<MT>::SMEM));
}

template <int MT>
int launch(const void* x, const void* w, const void* bias, const void* scale,
           const void* shift, void* y, int M, int L, int F, int C, int T,
           int hop, int pad, int relu, int vec, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<MT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + Tile<MT>::TM - 1) / Tile<MT>::TM, (C + TN - 1) / TN);
  framed_conv1d_kernel<MT><<<grid, THREADS, Tile<MT>::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(y), M, L, F, C,
      T, hop, pad, relu, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched).  `scale` and
// `shift` may be null (1 and 0).  The caller checks shapes, dtypes,
// contiguity, L + 2*pad < 2**31 and B*T rounded up to 128 frames < 2**31.
extern "C" int framed_conv1d_f32(const void* x, const void* w, const void* bias,
                                 const void* scale, const void* shift, void* y,
                                 int B, int L, int F, int C, int T, int hop,
                                 int pad, int relu, void* stream) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = hop % 4 == 0 && pad % 4 == 0 && L % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int M = B * T;  // frames of the flattened (B, T)
  const int64_t wide_blocks =
      static_cast<int64_t>((M + Tile<2>::TM - 1) / Tile<2>::TM) *
      ((C + TN - 1) / TN);
  const auto s = static_cast<cudaStream_t>(stream);
  if ((F + KC - 1) / KC >= WIDE_MIN_CHUNKS &&
      wide_blocks >= static_cast<int64_t>(WIDE_MIN_BLOCKS_PER_SM) * sms)
    return launch<2>(x, w, bias, scale, shift, y, M, L, F, C, T, hop, pad,
                     relu, vec, s);
  return launch<1>(x, w, bias, scale, shift, y, M, L, F, C, T, hop, pad,
                   relu, vec, s);
}

// The launch of the tile with `mt` m-tiles a warp (1 or 2): out = {threads
// per block, dynamic shared memory bytes, resident blocks per SM}; returns a
// cudaError_t.
extern "C" int framed_conv1d_info(int mt, int* out) {
  const auto info = [out](auto kernel, size_t smem, cudaError_t err) {
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                          THREADS, smem);
    out[0] = THREADS;
    out[1] = static_cast<int>(smem);
    return static_cast<int>(err);
  };
  if (mt == 2)
    return info(framed_conv1d_kernel<2>, Tile<2>::SMEM, raise_smem_limit<2>());
  return info(framed_conv1d_kernel<1>, Tile<1>::SMEM, raise_smem_limit<1>());
}
