// In-kernel attention dropout bits, shared by the forward kernel
// (flash_attn_fwd.cu), both backward kernels (flash_attn_bwd.cu) and the
// mask-materialising kernel.
//
// Replaces the TPU's `_drop_tile` / `_drop_row` (toist_tpu/ops/
// flash_attention.py), which seed the core's PRNG per (bh, q-tile, k-tile).
// Here the bits are a counter-based hash keyed on (seed, bh, query row, key
// column): any kernel regenerates any element's bit without storing a mask,
// whatever its tiling. The seed is a 64-bit value read from device memory,
// drawn per attention call from the training step's generator, so no host
// synchronisation is needed to launch.
//
// Per row, a SplitMix64 finaliser mixes (seed, bh, row) into a 64-bit row key
// (amortised over the row's S columns); per element, two rounds of the
// MurmurHash3 32-bit finaliser mix the column into it. The top 8 bits are the
// element's dropout byte, as in `_dropout_u8` (toist_tpu/models/layers.py):
// keep iff byte >= q, kept values scaled by 1 / (1 - q/256).
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

__device__ __forceinline__ uint64_t attn_drop_row_key(uint64_t seed, int bh,
                                                      int row) {
  return attn_mix64(attn_mix64(seed + 0x9E3779B97F4A7C15ull * (uint64_t)(bh + 1))
                    + (uint64_t)(uint32_t)row);
}

// Dropout byte (0..255) of key column `col` in the row with key `row_key`.
__device__ __forceinline__ uint32_t attn_drop_byte(uint64_t row_key, int col) {
  const uint32_t h = attn_mix32((uint32_t)row_key ^ ((uint32_t)col * 0x9E3779B9u));
  return attn_mix32(h + (uint32_t)(row_key >> 32)) >> 24;
}
