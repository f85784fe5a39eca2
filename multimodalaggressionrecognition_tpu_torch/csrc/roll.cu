// Circular roll of a (B, T, H, W, C) tensor over T, H and W (kernel K4) for
// Hopper, of 4-byte (f32) or 2-byte (bf16) elements.
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
// 96) that is 2 * 38.5 M floats = 308 MB, 0.092 ms at 3.35 TB/s (in bf16
// half of it, 0.046 ms); bytes bound it, and the design only has to keep
// both streams coalesced.
//
// Design.  Whole C-rows move together, and a (b, t, h) plane row of W * C
// floats is contiguous in both tensors: output row (b, t, h) is input row
// (b, (t+st) mod T, (h+sh) mod H) rotated left by sw * C elements.  One
// block owns one plane row, so its source row costs two divisions once per
// block; its threads walk the row in 16-byte vectors (4 f32 or 8 bf16 when
// C is a multiple of that and both pointers are 16-byte aligned: 96 and 192
// on Swin3D-T) or single elements otherwise, each read and write coalesced
// apart from the one wrap point of the rotation.  A copy moves bits without
// looking at them, so any dtype of the element's size is rolled exactly,
// and two launches agree bit for bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int MAX_THREADS = 256;

// a unit of BYTES bytes moves as one V (16: a uint4, 4: a uint32, 2: a
// uint16); `row` and `shift` count V's
template <int BYTES>
using Vec = typename std::conditional<
    BYTES == 16, uint4,
    typename std::conditional<BYTES == 4, uint32_t, uint16_t>::type>::type;

template <int BYTES>
__global__ void __launch_bounds__(MAX_THREADS)
roll_kernel(const Vec<BYTES>* __restrict__ x, Vec<BYTES>* __restrict__ out,
            int T, int H, int row, int st, int sh, int shift) {
  using V = Vec<BYTES>;
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

template <int BYTES>
int launch(const void* x, void* out, int rows, int T, int H, int row,
           int st, int sh, int shift, cudaStream_t stream) {
  roll_kernel<BYTES><<<rows, block_threads(row), 0, stream>>>(
      static_cast<const Vec<BYTES>*>(x), static_cast<Vec<BYTES>*>(out), T, H,
      row, st, sh, shift);
  return static_cast<int>(cudaGetLastError());
}

// elements of `elem` bytes; `vec16` moves 16-byte vectors (C a multiple of
// 16 / elem, both pointers 16-byte aligned)
template <int ELEM>
int roll(const void* x, void* out, int B, int T, int H, int W, int C, int st,
         int sh, int sw, int vec16, void* stream) {
  constexpr int PER_VEC = 16 / ELEM;
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < 1 || st < 0 || st >= T ||
      sh < 0 || sh >= H || sw < 0 || sw >= W || (vec16 && C % PER_VEC))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * T * H;
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec16)
    return launch<16>(x, out, rows, T, H, W * (C / PER_VEC), st, sh,
                      sw * (C / PER_VEC), s);
  return launch<ELEM>(x, out, rows, T, H, W * C, st, sh, sw * C, s);
}

}  // namespace

// Launch on `stream`; return a cudaError_t (0 = launched).  x and out are
// contiguous (B, T, H, W, C) of 4-byte (roll_f32) or 2-byte (roll_16bit: bf16)
// elements; st, sh, sw in [0, T), [0, H), [0, W).  The caller checks dtype,
// contiguity and B * T * H * W * C < 2**31; `vec4` (C % 4 == 0) and `vec8`
// (C % 8 == 0), with both pointers 16-byte aligned, move 16-byte vectors.
extern "C" int roll_f32(const void* x, void* out, int B, int T, int H, int W,
                        int C, int st, int sh, int sw, int vec4,
                        void* stream) {
  return roll<4>(x, out, B, T, H, W, C, st, sh, sw, vec4, stream);
}

extern "C" int roll_16bit(const void* x, void* out, int B, int T, int H,
                          int W, int C, int st, int sh, int sw, int vec8,
                          void* stream) {
  return roll<2>(x, out, B, T, H, W, C, st, sh, sw, vec8, stream);
}
