// Tiling constants and tile loaders shared by the flash-attention kernels:
// the f32 forward (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu), and,
// for the constants and key_flag, the bf16 tensor-core kernels
// (flash_attn_tc.cuh).
//
// q/k/v/o/dO are [B, S, H*hd] row-major and read in place at column h*hd;
// a tile of the f32 kernels is 64 rows of one head in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // rows of a q / k / v / dO tile
constexpr int BQ = TILE;      // query rows per tile
constexpr int BK = TILE;      // keys per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Vec8;   // 8 elements -> 8 floats, 16-byte aligned

template <> struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }

// Copy rows [row0, row0 + TILE) of one head into smem[TILE][LD];
// rows at or past n_rows are zero-filled.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float (*smem)[LD], const T* base,
                                          int row0, int n_rows, int row_stride) {
  constexpr int CHUNKS = TILE * HD / 8;
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int r = c / (HD / 8);
    const int col = (c % (HD / 8)) * 8;
    float v[8];
    if (row0 + r < n_rows) {
      Vec8<T>::load(base + (size_t)(row0 + r) * row_stride + col, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) smem[r][col + i] = v[i];
  }
}

// Per-key flag of a key tile: 0 = real key, 1 = masked (logit -> NEG_INF),
// 2 = past S (probability exactly 0).
__device__ __forceinline__ float key_flag(const uint8_t* mask_b, int key,
                                          int S) {
  return key >= S ? 2.f : (mask_b && mask_b[key] ? 1.f : 0.f);
}

}  // namespace
