// Building blocks of the bf16 tensor-core attention kernels: the forward
// (flash_attn_fwd_tc.cu) and the backward pair (flash_attn_bwd_tc.cu).
//
// A CTA has 4 warps and works on 64-row tiles, 16 rows per warp. Tiles are
// copied from device memory with cp.async into bf16 shared memory whose
// rows are padded to hd + 8 elements (80 or 48 bytes), which puts the 8 rows
// of every ldmatrix phase on distinct banks. Products are
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with A fragments held in
// registers and B fragments from ldmatrix; the f32 accumulators of one
// product, packed to bf16, are the A operand of the next (acc_to_a), so no
// intermediate goes through shared memory.
#pragma once

#include "attn_dropout.cuh"
#include "flash_attn_common.cuh"

namespace {

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_TILE = 64;     // rows of every tile; 16 per warp

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (or 4-byte) copy from device to shared memory; zero-fills the
// destination when !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a b for one m16n8k16 tile: a 16x16 row-major, b 16x8 column-major.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A key's per-element branches folded into constants: its term (a, b) gives
// s * a + b, the base-2 logit of raw score s. A real key (scale*log2(e), 0),
// a masked one (0, NEG_INF*log2(e): the logit is replaced, not added to),
// one past S (0, -inf: P = 0; its zero-filled k and v rows give s = 0).
// flag is the key's key_flag.
__device__ __forceinline__ float2 key_term(float scale_log2, float flag) {
  return flag == 0.f ? make_float2(scale_log2, 0.f)
                     : make_float2(0.f, flag == 1.f ? NEG_INF * LOG2E
                                                    : -INFINITY);
}

// The A operand of k-step kk (columns 16*kk ...) from the accumulators of a
// 16x64 product: the C fragments of n-tiles 2kk and 2kk+1 are, element for
// element, the A fragment of that 16x16 block.
__device__ __forceinline__ void acc_to_a(const float (&c)[8][4], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// The dropout words of the two 2x2 blocks of a lane's m16n8 fragment
// elements. Lanes l and l ^ 4 (fragment rows g and g ^ 1) need the same two
// words: each computes one, that of (pair_key, key_pair), the first block's
// for even g and the second's for odd g, and the two swap. w[0] is then the
// first block's word, w[1] the second's.
__device__ __forceinline__ void attn_drop_word_pair(uint64_t pair_key,
                                                    int key_pair, bool odd_g,
                                                    uint32_t (&w)[2]) {
  const uint32_t mine = attn_drop_word(pair_key, key_pair);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 4);
  w[0] = odd_g ? other : mine;
  w[1] = odd_g ? mine : other;
}

// Copy rows [row0, row0 + 64) of one head (hd columns at `base`, row stride
// `stride`) into tile[64][HD + 8]; rows at or past n_rows are zero-filled.
template <int HD>
__device__ __forceinline__ void cp_tile(bf16 (*tile)[HD + 8], const bf16* base,
                                        int row0, int n_rows, int stride) {
  constexpr int CPR = HD / 8;    // 16-byte chunks per row
  static_assert(TC_TILE * CPR % TC_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < TC_TILE * CPR / TC_THREADS; ++i) {
    const int c = threadIdx.x + i * TC_THREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(&tile[r][col], base + (size_t)(ok ? row0 + r : 0) * stride + col,
               ok);
  }
}

// A fragments (all k-steps) of this warp's 16 rows of a [64][HD + 8] tile.
template <int HD>
__device__ __forceinline__ void ldsm_a(const bf16 (*tile)[HD + 8], int warp,
                                       int lane, uint32_t (&a)[HD / 16][4]) {
  const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldsm_x4(smem_u32(&tile[row][ks * 16 + (lane / 16) * 8]), a[ks][0],
            a[ks][1], a[ks][2], a[ks][3]);
}

// B fragments (b0, b1 of each k-step) of n-tile nt of a tile stored [n][k]
// (rows are the product's columns, the head dim is its depth).
template <int HD>
__device__ __forceinline__ void ldsm_b(const bf16 (*tile)[HD + 8], int nt,
                                       int lane, uint32_t (&b)[HD / 16][2]) {
  const uint32_t addr =
      smem_u32(&tile[nt * 8 + lane % 8][((lane / 8) * 8) % HD]);
  if constexpr (HD == 32)
    ldsm_x4(addr, b[0][0], b[0][1], b[1][0], b[1][1]);
  else
    ldsm_x2(addr, b[0][0], b[0][1]);
}

// B fragments of k-step kk and n-tiles j, j+1 of a tile stored [k][n] (rows
// are the product's depth, the head dim its columns), transposed on load.
template <int HD>
__device__ __forceinline__ void ldsm_bt(const bf16 (*tile)[HD + 8], int kk,
                                        int j, int lane, uint32_t (&b)[2][2]) {
  ldsm_x4_t(smem_u32(&tile[kk * 16 + ((lane / 8) & 1) * 8 + lane % 8]
                          [(j + lane / 16) * 8]),
            b[0][0], b[0][1], b[1][0], b[1][1]);
}

// Store this thread's f32 accumulators of a [16 x HD] block (rows row_lo and
// row_lo + 8 of the warp, columns 8j + 2t, +1) as bf16 pairs, the rows
// multiplied by mul_lo and mul_hi.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 8][4],
                                           int row_lo, int n_rows, int stride,
                                           int col0, int t, float mul_lo,
                                           float mul_hi) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (row_lo < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_lo * stride + col) =
          __floats2bfloat162_rn(acc[j][0] * mul_lo, acc[j][1] * mul_lo);
    if (row_lo + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row_lo + 8) * stride +
                                         col) =
          __floats2bfloat162_rn(acc[j][2] * mul_hi, acc[j][3] * mul_hi);
  }
}

}  // namespace
