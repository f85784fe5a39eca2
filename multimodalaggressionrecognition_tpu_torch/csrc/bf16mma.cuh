// bf16 products on Hopper's tensor cores for the window-attention kernels'
// bf16 instantiations (K2, window_attention.cu; K3,
// window_attention_bwd.cu) and the self-attention pair
// (self_attention.cu, self_attention_bwd.cu): fragments, ldmatrix loads
// from swizzled bf16 tiles in shared memory, cp.async staging, and the
// bias and mask reads.
// The f32 instantiations use tf32x3.cuh instead.
//
// Products.  A product of two bf16 operands (q.k^T, g.v^T) is one
// mma.sync.m16n8k16 (m16n8k8 where d = 8) with f32 accumulation: each
// bf16 x bf16 product is exact in f32.  A product with an f32 operand x
// (the probabilities p and dS, computed in f32 from the score
// accumulators) splits x into two bf16 pieces, hi = bf16(x) and lo =
// bf16(x - hi) (split2, round to nearest even both), and runs one mma
// per piece into the same accumulator: what is dropped is below 2^-16 |x|,
// which holds the f32 kernels' tolerances, where one bf16 piece of p
// (2^-8 |p|) does not.
//
// m16n8k16 fragments, g = lane / 4, t = lane % 4, two bf16 a register (the
// lower column in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8, k x n): b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// m16n8k8 takes a0, a1 and b0.  So an A operand over d is kept as 8-wide
// chunks of two registers each (Rows), and the accumulators of two
// adjacent 8-column tiles are exactly one 16-deep A fragment (acc_pair_a):
// p goes from the score accumulators into the next product without
// leaving registers.
//
// Tiles.  A (rows x D) bf16 tile sits in shared memory unpadded, its
// 16-byte chunks (8 elements) XOR-swizzled per row (at): an ldmatrix reads
// 8 rows of one 16-byte chunk, and for rows r0 .. r0+7 (r0 a multiple of 8)
// the swizzle puts them in 8 distinct bank groups, for D = 64, 32, 16 and 8,
// in both the plain and the transposed loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bf16mma {

using bf16 = __nv_bfloat16;

constexpr unsigned FULL_MASK = 0xffffffffu;

// an A operand: 16 rows by D columns as D/8 chunks {a0, a1} (rows g and
// g+8, columns 8c+2t and 8c+2t+1)
template <int D>
struct Rows {
  uint32_t r[D / 8][2];
};

__device__ __forceinline__ uint32_t pack(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 -> hi (their bf16 values) and lo (bf16 of what hi leaves)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x0 - back.x, x1 - back.y);
}

// The f32 accumulators of two adjacent 8-column tiles (c, c2) as the hi
// and lo pieces of one 16-deep A fragment (columns of c, then of c2)
__device__ __forceinline__ void acc_pair_a(const float (&c)[4],
                                           const float (&c2)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(c[0], c[1], hi[0], lo[0]);
  split2(c[2], c[3], hi[1], lo[1]);
  split2(c2[0], c2[1], hi[2], lo[2]);
  split2(c2[2], c2[3], hi[3], lo[3]);
}

__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma8(float (&c)[4], uint32_t a0, uint32_t a1,
                                     uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// c += a b over the d columns of a, b an 8-column B operand given as D/8
// chunk registers (load_bt): D/16 m16n8k16, or one m16n8k8 where D = 8
template <int D>
__device__ __forceinline__ void mma_d(float (&c)[4], const Rows<D>& a,
                                      const uint32_t (&b)[D / 8]) {
  if constexpr (D == 8) {
    mma8(c, a.r[0][0], a.r[0][1], b[0]);
  } else {
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const uint32_t ak[4] = {a.r[2 * k][0], a.r[2 * k][1],
                              a.r[2 * k + 1][0], a.r[2 * k + 1][1]};
      mma16(c, ak, b[2 * k], b[2 * k + 1]);
    }
  }
}

// c += (hi + lo) b: the two pieces of an f32 A operand
__device__ __forceinline__ void mma_pieces(float (&c)[4],
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4],
                                           uint32_t b0, uint32_t b1) {
  mma16(c, lo, b0, b1);
  mma16(c, hi, b0, b1);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x, one MUFU.EX2 (ex2.approx.ftz: results below 2^-126 flush to 0).  The
// kernels keep their scores in base 2 (s * log2e, folded into the scale
// and the bias) and take exp(s - m) as exp2 of the difference, where
// __expf adds a multiply and a range guard.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// A operand from device memory: rows a and b (g and g+8 of the tile) of a
// row-major bf16 matrix, all D columns (4-byte loads through the read-only
// cache)
template <int D>
__device__ __forceinline__ Rows<D> load_a_rows(const bf16* row_a,
                                               const bf16* row_b, int lane) {
  const int t = lane & 3;
  const auto* pa = reinterpret_cast<const unsigned*>(row_a) + t;
  const auto* pb = reinterpret_cast<const unsigned*>(row_b) + t;
  Rows<D> f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    f.r[c][0] = __ldg(pa + 4 * c);
    f.r[c][1] = __ldg(pb + 4 * c);
  }
  return f;
}

// two consecutive results, rounded to bf16 (4-byte aligned)
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the 16-byte chunks of row r are XORed with swz(r), which depends on r
// mod 8 only
template <int D>
__device__ __forceinline__ int swz(int r) {
  constexpr int U = D / 8;  // chunks a row
  return (r / (8 / U)) & (U - 1);
}

// element offset of chunk c of row r
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + ((c ^ swz<D>(r)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// double buffering: close the copies started since the last commit into a
// group, and wait until at most N groups are in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 4- and 8-byte copies (through L1) for data whose rows are not 16-byte
// aligned; the _evict_first copy takes an evict_first_policy()
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4_evict_first(void* smem,
                                                      const void* gmem,
                                                      uint64_t policy) {
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;" ::"r"(
          smem_addr(smem)),
      "l"(gmem), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// an L2 policy for data read once: its lines are evicted first
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// Start copying rows [0, n) of a D-wide bf16 slice (row j at src + j *
// stride, 16-byte aligned) into a swizzled tile with 16-byte cp.async, as
// they are, and zero rows [n, rows).  Every thread of the block takes its
// share; the caller waits (cp_async_wait_all) and synchronizes.
template <int D>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src,
                                      int64_t stride, int n, int rows) {
  constexpr int U = D / 8;
  for (int idx = threadIdx.x; idx < rows * U; idx += blockDim.x) {
    const int r = idx / U;
    const int c = idx % U;
    bf16* dst = tile + at<D>(r, c);
    if (r < n)
      cp_async16(dst, src + r * stride + 8 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int X>
__device__ __forceinline__ void ldsm(uint32_t (&r)[X], uint32_t addr) {
  if constexpr (X == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else if constexpr (X == 2)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];"
                 : "=r"(r[0])
                 : "r"(addr));
}

template <int X>
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[X], uint32_t addr) {
  if constexpr (X == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr));
}

// B operand X^T over d (k = column, n = row) for rows n0 .. n0+7 (n0 a
// multiple of 8): chunk c's register b[c] holds (row n0+g, columns 8c+2t,
// 8c+2t+1); one ldmatrix of D/8 matrices, lane l addressing row n0 + l % 8
// of chunk l / 8
template <int D>
__device__ __forceinline__ void load_bt(const bf16* tile, int n0, int lane,
                                        uint32_t (&b)[D / 8]) {
  constexpr int U = D / 8;
  const int r = n0 + (lane & 7);
  if constexpr (U == 8) {  // D = 64: two loads of four chunks
    uint32_t x[4], y[4];
    ldsm<4>(x, smem_addr(tile + at<D>(r, lane >> 3)));
    ldsm<4>(y, smem_addr(tile + at<D>(r, 4 + (lane >> 3))));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[c] = x[c];
      b[4 + c] = y[c];
    }
  } else {
    ldsm<U>(b, smem_addr(tile + at<D>(r, (lane >> 3) & (U - 1))));
  }
}

// B operand X over 16 rows (k = row k0 .. k0+15, k0 a multiple of 8, n =
// column): for each 8-column tile c, b[c] = {b0, b1} of m16n8k16; transposed
// ldmatrix, lane l addressing row k0 + l % 8 (+8 for odd l / 8) of chunk
// c + l / 16
template <int D>
__device__ __forceinline__ void load_b_rows16(const bf16* tile, int k0,
                                              int lane,
                                              uint32_t (&b)[D / 8][2]) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  if constexpr (D == 8) {
    uint32_t x[2];
    ldsm_t<2>(x, smem_addr(tile + at<D>(r, 0)));
    b[0][0] = x[0];
    b[0][1] = x[1];
  } else {
#pragma unroll
    for (int c = 0; c < D / 8; c += 2) {
      uint32_t x[4];
      ldsm_t<4>(x, smem_addr(tile + at<D>(r, c + (lane >> 4))));
      b[c][0] = x[0];
      b[c][1] = x[1];
      b[c + 1][0] = x[2];
      b[c + 1][1] = x[3];
    }
  }
}

// The bias and mask of query rows a and b (g and g+8 of a tile) from key
// 2t on, f32 through L2.  fetch() reads, for the accumulators' (u, e), row
// a (e < 2) or b at key 2t + j0 + 8u + (e & 1).  The bias is -inf past N
// (so are those keys' scores), the mask 0 when there is none.  Where N is
// even (and bias and mask 8-byte aligned) the two keys of a pair are one
// 8-byte load.
template <int JT>
struct RowBias {
  const float *ba, *bb, *ma, *mb;
  int n, t;
  bool pairs;

  __device__ __forceinline__ RowBias(const float* bias, const float* mask,
                                     int ra, int rb, int n_, int t_)
      : ba(bias + ra * n_ + 2 * t_),
        bb(bias + rb * n_ + 2 * t_),
        ma(mask ? mask + ra * n_ + 2 * t_ : nullptr),
        mb(mask ? mask + rb * n_ + 2 * t_ : nullptr),
        n(n_),
        t(t_),
        pairs((n_ & 1) == 0 &&
              ((reinterpret_cast<uintptr_t>(bias) |
                reinterpret_cast<uintptr_t>(mask)) & 7) == 0) {}

  __device__ __forceinline__ void fetch(int j0, float (&bv)[JT][4],
                                        float (&mv)[JT][4]) const {
    const float neg_inf = __int_as_float(0xff800000);
    const int left = n - 2 * t - j0;  // key 8u + x of the step is in if < left
    if (pairs) {
      const auto* pa = reinterpret_cast<const float2*>(ba + j0);
      const auto* pb = reinterpret_cast<const float2*>(bb + j0);
      const auto* qa = reinterpret_cast<const float2*>(ma + j0);
      const auto* qb = reinterpret_cast<const float2*>(mb + j0);
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        const bool in = 8 * u < left;  // both keys of the pair, N even
        const float2 x0 = in ? __ldg(pa + 4 * u) : make_float2(neg_inf, neg_inf);
        const float2 x1 = in ? __ldg(pb + 4 * u) : make_float2(neg_inf, neg_inf);
        const float2 y0 = in && ma ? __ldg(qa + 4 * u) : make_float2(0.f, 0.f);
        const float2 y1 = in && ma ? __ldg(qb + 4 * u) : make_float2(0.f, 0.f);
        bv[u][0] = x0.x;
        bv[u][1] = x0.y;
        bv[u][2] = x1.x;
        bv[u][3] = x1.y;
        mv[u][0] = y0.x;
        mv[u][1] = y0.y;
        mv[u][2] = y1.x;
        mv[u][3] = y1.y;
      }
      return;
    }
    const float *pa = ba + j0, *pb = bb + j0, *qa = ma + j0, *qb = mb + j0;
#pragma unroll
    for (int u = 0; u < JT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * u + (e & 1);
        const bool in = j < left;
        bv[u][e] = in ? __ldg((e < 2 ? pa : pb) + j) : neg_inf;
        mv[u][e] = in && ma ? __ldg((e < 2 ? qa : qb) + j) : 0.f;
      }
  }
};

}  // namespace bf16mma
