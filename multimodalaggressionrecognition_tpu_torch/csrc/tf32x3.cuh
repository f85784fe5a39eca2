// f32-accurate products on Hopper's tensor cores (3xTF32), and the
// shared-memory tiles and bias reads of the window-attention kernels' f32
// instantiations (K2, window_attention.cu; K3, window_attention_bwd.cu).  The framed conv (K1,
// framed_conv.cu) takes the split, the mma and the cp.async helpers.
//
// 3xTF32.  Each f32 operand x is split into big, x rounded to tf32, and
// small = x - big (split below).  A product a*b is then big_a*small_b +
// small_a*big_b + big_a*big_b, each term on mma.sync.m16n8k8 with f32
// accumulation: a tf32 x tf32 product is exact in f32, and what is dropped
// (small_a*small_b, and small's truncation to tf32) is below ~2^-21 of
// |a||b|, the level of f32 rounding, at three tensor-core passes per product.
//
// m16n8k8 fragments, g = lane / 4, t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x n):      b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// An accumulator feeds the next product as its A operand without shuffles
// by permuting that product's reduction index: A's column t is C's column
// 2t and A's column t+4 is C's 2t+1 (acc_as_a); the B operand's rows are
// then read in the same order (load_b_pairs).
//
// Tiles.  An f32 tile (K2's K and V) sits in shared memory unpadded, its
// 16-byte chunks XOR-swizzled per row (at): for D=32 both fragment access
// patterns (rows n0+g at columns k0+t: load_bt; rows k0+2t and k0+2t+1 at
// column n0+g: load_b_pairs) hit 32 distinct banks; D=16 and D=8 rows are
// shorter than the 32 banks, and some of their loads conflict 2-way.  A
// split tile (K3's) holds each element already split (at2, below).
//
// The bf16 instantiations of K2 and K3 do not come here: they run on the
// bf16 tensor cores (bf16mma.cuh).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

constexpr unsigned FULL_MASK = 0xffffffffu;

template <int R>
struct Frag {
  uint32_t big[R], small[R];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// big = x rounded to tf32's 11 significant bits (to nearest) by Veltkamp's
// split, small = x - big exactly (at most 13 significant bits; the mma's
// truncation of it to tf32 loses less than 2^-21 |x|).  Four f32 operations,
// where cvt.rna.tf32.f32 (to nearest, ties away from zero) expands on
// sm_90 into an add, an inf/NaN guard (compare, select) and a mask, twice
// per operand.  A NaN or inf in x reaches the products through small.
// Valid for |x| < 2^128 / 8193 (~4e34).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  const float c = __fmul_rn(x, 8193.f);  // 2^13 + 1; never contracted
  const float b = c - (c - x);
  big = __float_as_uint(b);
  small = __float_as_uint(x - b);
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b to f32 accuracy: the two small terms first, then big * big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

// c += a b as mma3, with the two small terms in c2 instead: the caller adds
// c2 to c once the k-steps are done, so that a chain of k-steps is two mma
// deep per step, not three
__device__ __forceinline__ void mma3x(float (&c)[4], float (&c2)[4],
                                      const FragA& a, const FragB& b) {
  mma_tf32(c2, a.big, b.small);
  mma_tf32(c2, a.small, b.big);
  mma_tf32(c, a.big, b.big);
}

// the accumulator as the A operand of the next product, reduction index
// permuted (A's column t = C's 2t, A's column t+4 = C's 2t+1)
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// an element of device memory (through the read-only cache)
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }

// four consecutive elements (16-byte aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// two consecutive results (8-byte aligned)
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// offset of element (r, c) of a swizzled D-wide tile: the 4-float chunks of
// row r are XORed with swz(r), which depends on r mod 8 only
template <int D>
__device__ __forceinline__ int swz(int r) {
  return ((r / (32 / D)) & (D / 4 - 1)) << 2;
}

template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + (c ^ swz<D>(r));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// cp.async of `bytes` (at most 16, or 4) from gmem, the rest of the 16 (4)
// destination bytes zero-filled; with bytes == 0 nothing is read
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* gmem,
                                                 int bytes) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* gmem,
                                                int bytes) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// Start copying rows [0, n) of a D-wide slice (row j at src + j * stride,
// 16-byte aligned) into a swizzled tile with 16-byte cp.async, and zero
// rows [n, rows).  Every thread of the block takes its share; the caller
// waits (cp_async_wait_all) and synchronizes.
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* src,
                                      int64_t stride, int n, int rows) {
  constexpr int CH = D / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    float* dst = tile + at<D>(r, c);
    if (r < n)
      cp_async16(dst, src + r * stride + c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The fragment loaders take tiles whose first row (r0, n0, k0) is a multiple
// of 8 and columns (c0, k0, n0) that are multiples of 8, so that a lane's
// swizzle is a constant of the lane and its offsets can be hoisted out of
// the loops; (c + t) ^ s = (c ^ s) + t for c and s multiples of 4, t < 4.

// B operand X^T (k = column, n = row): rows n0 .. n0+7, columns k0 .. k0+7
template <int D>
__device__ __forceinline__ FragB load_bt(const float* tile, int n0, int k0,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3, s = swz<D>(g);
  const float* p = tile + (n0 + g) * D + t;
  return split_b(p[k0 ^ s], p[(k0 + 4) ^ s]);
}

// B operand X (k = row, n = column) with the rows in acc_as_a's order:
// rows k0+2t and k0+2t+1, column n0+g
template <int D>
__device__ __forceinline__ FragB load_b_pairs(const float* tile, int k0,
                                              int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int s0 = swz<D>(2 * t), s1 = swz<D>(2 * t + 1);
  // (n0 + g) ^ s = (n0 ^ (s & ~7)) + (g ^ (s & 7)) for n0 a multiple of 8
  const float* p = tile + (k0 + 2 * t) * D;
  return split_b(p[(n0 ^ (s0 & ~7)) + (g ^ (s0 & 7))],
                 p[D + (n0 ^ (s1 & ~7)) + (g ^ (s1 & 7))]);
}

// A operand from device memory: rows a and b (g and g+8 of the tile) of a
// row-major matrix, columns c0 .. c0+7, times mul
__device__ __forceinline__ FragA load_a_rows(const float* row_a,
                                             const float* row_b, int c0,
                                             int lane, float mul) {
  const int t = lane & 3;
  return split_a(ldf(row_a + c0 + t) * mul, ldf(row_b + c0 + t) * mul,
                 ldf(row_a + c0 + t + 4) * mul,
                 ldf(row_b + c0 + t + 4) * mul);
}

// The bias and mask of query rows a and b (g and g+8 of a tile) from key 2t
// on.  fetch() reads, for the accumulators' (u, e), row a (e < 2) or b at
// key 2t + j0 + 8u + (e & 1): a step's loads are one base and immediate
// offsets.  The bias is -inf past N (so are those keys' scores), the mask 0
// when there is none.
template <int JT>
struct RowBias {
  const float *ba, *bb, *ma, *mb;
  int n, t;

  __device__ __forceinline__ RowBias(const float* bias, const float* mask,
                                     int ra, int rb, int n_, int t_)
      : ba(bias + ra * n_ + 2 * t_),
        bb(bias + rb * n_ + 2 * t_),
        ma(mask ? mask + ra * n_ + 2 * t_ : nullptr),
        mb(mask ? mask + rb * n_ + 2 * t_ : nullptr),
        n(n_),
        t(t_) {}

  __device__ __forceinline__ void fetch(int j0, float (&bv)[JT][4],
                                        float (&mv)[JT][4]) const {
    const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
    for (int u = 0; u < JT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * u + (e & 1);
        const bool in = j + 2 * t < n;
        bv[u][e] = in ? __ldg((e < 2 ? ba : bb) + j) : neg_inf;
        mv[u][e] = in && ma ? __ldg((e < 2 ? ma : mb) + j) : 0.f;
      }
  }
};

// Split tiles.  A (rows x D) tile whose elements are stored already split,
// as (big, small) float2 pairs: a B fragment is then two 8-byte loads and no
// arithmetic, and each element is split once per staging instead of once
// per use.  Chunks of 4 elements are XOR-swizzled per row (at2): the loads
// of load_bt_split and load_b_pairs_split, 16 lanes of 8 bytes at a time,
// hit 16 distinct bank pairs for D=32 and D=16 (D=8's 64-byte rows conflict
// 2-way in load_b_pairs_split).  The swizzle depends on r mod 8 only.
template <int D>
__device__ __forceinline__ int swz2(int r) {
  return D == 8 ? ((r >> 1) & 1) << 2 : ((r ^ ((r >> 2) & 1)) & 3) << 2;
}

template <int D>
__device__ __forceinline__ int at2(int r, int c) {
  return r * D + (c ^ swz2<D>(r));
}

// Rows [0, n) of a D-wide f32 slice (row j at src + j * stride, 16-byte
// aligned), times mul, split into a split tile; rows [n, rows) zero.  Every
// thread of the block takes its share; the caller synchronizes.
template <int D>
__device__ __forceinline__ void stage_split(float2* tile, const float* src,
                                            int64_t stride, int n, int rows,
                                            float mul) {
  constexpr int CH = D / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = ld4(src + r * stride + c);
    uint32_t b[4], sm[4];
    split(x.x * mul, b[0], sm[0]);
    split(x.y * mul, b[1], sm[1]);
    split(x.z * mul, b[2], sm[2]);
    split(x.w * mul, b[3], sm[3]);
    auto* dst = reinterpret_cast<uint4*>(tile + at2<D>(r, c));
    dst[0] = make_uint4(b[0], sm[0], b[1], sm[1]);
    dst[1] = make_uint4(b[2], sm[2], b[3], sm[3]);
  }
}

__device__ __forceinline__ FragB pair_b(float2 x, float2 y) {
  FragB f;
  f.big[0] = __float_as_uint(x.x);
  f.small[0] = __float_as_uint(x.y);
  f.big[1] = __float_as_uint(y.x);
  f.small[1] = __float_as_uint(y.y);
  return f;
}

// load_bt from a split tile
template <int D>
__device__ __forceinline__ FragB load_bt_split(const float2* tile, int n0,
                                               int k0, int lane) {
  const int g = lane >> 2, t = lane & 3, s = swz2<D>(g);
  const float2* p = tile + (n0 + g) * D + t;
  return pair_b(p[k0 ^ s], p[(k0 + 4) ^ s]);
}

// load_b_pairs from a split tile
template <int D>
__device__ __forceinline__ FragB load_b_pairs_split(const float2* tile,
                                                    int k0, int n0,
                                                    int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int s0 = swz2<D>(2 * t), s1 = swz2<D>(2 * t + 1);
  const float2* p = tile + (k0 + 2 * t) * D;
  return pair_b(p[(n0 ^ (s0 & ~7)) + (g ^ (s0 & 7))],
                p[D + (n0 ^ (s1 & ~7)) + (g ^ (s1 & 7))]);
}

}  // namespace tf32x3
