// Circular roll of a (B, T, H, W, C) tensor over T, H and W (kernel K4) for
// Hopper, f32.
//
// Replaces `pallas_roll` in benchmarks/proto_swin_levers.py, the Pallas
// prototype of Swin3D's shifted-window roll (`jnp.roll` at
// multimodalaggressionrecognition_tpu/models/swin3d.py:113 and :181): for
// shifts (st, sh, sw), each reduced into [0, size),
//
//   out[b, t, h, w, :] = x[b, (t + st) mod T, (h + sh) mod H, (w + sw) mod W, :],
//
// which is torch.roll(x, (-st, -sh, -sw), (1, 2, 3)).  The prototype rolls
// H and W only (st = 0, as in Swin3D-T's windowed tower, where T = 4 is no
// larger than the window and its shift is clamped to 0); the kernel takes T
// too, so that no roll of the port's Swin tower is left to torch.roll.
//
// Bound.  A roll does no arithmetic: it reads x once and writes out once.
// At stage 0 of the tower at batch 8 (B = 128 windows, T = 4, 28 x 28, C =
// 96) that is 2 * 38.5 M floats = 308 MB, 0.092 ms at 3.35 TB/s; bytes bound
// it, and the design only has to keep both streams coalesced.
//
// Design.  Whole C-rows move together, and a (b, t, h) plane row of W * C
// floats is contiguous in both tensors: output row (b, t, h) is input row
// (b, (t+st) mod T, (h+sh) mod H) rotated left by sw * C floats.  One block
// owns one plane row, so its source row costs two divisions once per block;
// its threads walk the row in 16-byte vectors (C % 4 == 0, 16-byte aligned
// pointers: 96 and 192 on Swin3D-T) or single floats otherwise, each read
// and write coalesced apart from the one wrap point of the rotation.  A copy
// is exact, so two launches agree bit for bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int MAX_THREADS = 256;

// VEC floats move as one V (a float4 or a float); `row` and `shift` count
// V's
template <int VEC>
using Vec = typename std::conditional<VEC == 4, float4, float>::type;

template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
roll_kernel(const Vec<VEC>* __restrict__ x, Vec<VEC>* __restrict__ out,
            int T, int H, int row, int st, int sh, int shift) {
  using V = Vec<VEC>;
  const int r = blockIdx.x;  // output plane row (b, t, h)
  const int h = r % H;
  const int bt = r / H;
  const int t = bt % T;
  const int b = bt / T;
  int ts = t + st;
  if (ts >= T) ts -= T;
  int hs = h + sh;
  if (hs >= H) hs -= H;
  const V* src = x + (static_cast<int64_t>(b * T + ts) * H + hs) * row;
  V* dst = out + static_cast<int64_t>(r) * row;
#pragma unroll 4
  for (int j = threadIdx.x; j < row; j += blockDim.x) {
    int k = j + shift;
    if (k >= row) k -= row;
    dst[j] = src[k];
  }
}

// threads per block: the fewest 32-multiples that cover a row in as few
// passes as MAX_THREADS would (a 672-vector row of Swin3D-T: 3 x 224)
int block_threads(int row) {
  const int passes = (row + MAX_THREADS - 1) / MAX_THREADS;
  const int per_pass = (row + passes - 1) / passes;
  return (per_pass + 31) / 32 * 32;
}

template <int VEC>
int launch(const void* x, void* out, int rows, int T, int H, int row,
           int st, int sh, int shift, cudaStream_t stream) {
  roll_kernel<VEC><<<rows, block_threads(row), 0, stream>>>(
      static_cast<const Vec<VEC>*>(x), static_cast<Vec<VEC>*>(out), T, H,
      row, st, sh, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched).  x and out are
// contiguous f32 (B, T, H, W, C); st, sh, sw in [0, T), [0, H), [0, W).  The
// caller checks dtype, contiguity and B * T * H * W * C < 2**31; `vec4`
// (C % 4 == 0 and both pointers 16-byte aligned) moves 16-byte vectors.
extern "C" int roll_f32(const void* x, void* out, int B, int T, int H, int W,
                        int C, int st, int sh, int sw, int vec4,
                        void* stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < 1 || st < 0 || st >= T ||
      sh < 0 || sh >= H || sw < 0 || sw >= W || (vec4 && C % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * T * H;
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec4)
    return launch<4>(x, out, rows, T, H, W * (C / 4), st, sh, sw * (C / 4),
                     s);
  return launch<1>(x, out, rows, T, H, W * C, st, sh, sw * C, s);
}
