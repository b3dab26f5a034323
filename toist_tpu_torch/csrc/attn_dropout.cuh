// In-kernel attention dropout bits, shared by the forward kernels
// (flash_attn_fwd.cu, flash_attn_fwd_tc.cu), the backward kernels
// (flash_attn_bwd.cu, flash_attn_bwd_tc.cu) and the mask-materialising
// kernel.
//
// Replaces the TPU's `_drop_tile` / `_drop_row` (toist_tpu/ops/
// flash_attention.py), which seed the core's PRNG per (bh, q-tile, k-tile).
// Here the bits are a counter-based hash keyed on (seed, bh, query row, key
// column): any kernel regenerates any element's bit without storing a mask,
// whatever its tiling. The seed is a 64-bit value read from device memory,
// drawn per attention call from the training step's generator, so no host
// synchronisation is needed to launch.
//
// The unit is a 2x2 block: query rows {2p, 2p+1} x key columns {2j, 2j+1}.
// Per query-row pair p, a SplitMix64 finaliser mixes (seed, bh, p) into a
// 64-bit pair key (amortised over the S columns of two rows); per block, one
// MurmurHash3 32-bit finaliser mixes j into the key's low word, and the
// word's four bytes are the block's four dropout bytes, byte
// (row & 1) * 2 + (col & 1) for element (row, col). As in `_dropout_u8`
// (toist_tpu/models/layers.py): keep iff byte >= q, kept values scaled by
// 1 / (1 - q/256). In an m16n8 accumulator fragment a lane holds two
// adjacent columns of two rows g, g + 8 (or, transposed, two adjacent rows
// of two columns), and lanes g, g ^ 1 hold the rest of the same two blocks,
// so the tensor-core kernels compute each word once per lane pair and swap
// (flash_attn_tc.cuh attn_drop_word_pair): a quarter of a 32-bit mix and a
// quarter of a shuffle per element.
// `dropout_keep_mask_plain` (ops/flash_attention.py) is the same function in
// numpy.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint64_t attn_mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__device__ __forceinline__ uint32_t attn_mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Key of query rows {2 pair, 2 pair + 1} of batch*head bh.
__device__ __forceinline__ uint64_t attn_drop_pair_key(uint64_t seed, int bh,
                                                       int pair) {
  return attn_mix64(attn_mix64(seed + 0x9E3779B97F4A7C15ull * (uint64_t)(bh + 1))
                    + (uint64_t)(uint32_t)pair);
}

// The four dropout bytes of key columns {2 key_pair, 2 key_pair + 1} in the
// rows of `pair_key`.
__device__ __forceinline__ uint32_t attn_drop_word(uint64_t pair_key,
                                                   int key_pair) {
  return attn_mix32((uint32_t)pair_key ^ ((uint32_t)key_pair * 0x9E3779B9u));
}

// Left shift that brings element (row, col)'s byte of its block's word to
// the top 8 bits.
__device__ __forceinline__ int attn_drop_lshift(int row, int col) {
  return 24 - ((row & 1) * 2 + (col & 1)) * 8;
}

// Whether the byte that `lshift` brings to the top of `word` is >= q: with
// the byte on top and the bytes below it under it, (word << lshift) >=
// q << 24 holds iff byte >= q (one shift and one compare, no extraction).
__device__ __forceinline__ bool attn_drop_keep(uint32_t word, int lshift,
                                               int drop_q) {
  return (word << lshift) >= ((uint32_t)drop_q << 24);
}
