// What the self-attention forward (self_attention.cu) and backward
// (self_attention_bwd.cu) share: the tiling, and the layout of the keep
// mask the forward writes and the backward reads.

#pragma once

#include "bf16mma.cuh"

namespace self_attention {

// A block of 4 warps owns 64 query rows (the forward, the backward's row
// pass) or 64 keys (its column pass), a warp 16 of them, and walks the
// other side in staged tiles of 64.
constexpr int TILE = 64;
constexpr int WARPS = TILE / 16;
constexpr int THREADS = 32 * WARPS;

__host__ __device__ constexpr int tiles(int t) {
  return (t + TILE - 1) / TILE;
}

// The keep mask, one bit an element: row i of (batch, head) bh holds
// mask_words(T) 32-bit words at bits + (bh * T + i) * mask_words(T), two a
// 64-key tile (8-byte aligned), key j at bit j % 32 of word j / 32; bits
// past T are 0.
__host__ __device__ constexpr int mask_words(int t) { return 2 * tiles(t); }

}  // namespace self_attention
