// Flash-attention backward for Hopper (sm_90a), bfloat16 route: dK/dV and
// dQ on the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate), with
// the forward's in-kernel dropout regenerated, not stored.
//
// Replaces the TPU kernels `_dkv_kernel` (toist_tpu/ops/flash_attention.py:
// 147) and `_dq_kernel` (:193), launched by `_backward`. The math and the
// semantics of masked, fully masked and out-of-range keys are those of the
// f32 route, stated in flash_attn_bwd.cuh; the dropout bits are the
// forward's (attn_dropout.cuh), keyed on (seed, batch*head, query row, key).
//
// What bounds it: at the encoder shape (q, k, v [6, 1156, 256], 8 heads of
// 32, B*H = 48) the dK/dV kernel does 4 products of 2*S^2*hd*BH = 1.64e10
// FLOP and the dQ kernel 3 (1.23e10), 0.0166 ms and 0.0124 ms at the H100's
// 989 TFLOP/s bf16 rate; its bytes (q, k, v, dO, dq, dk, dv: 28.4 MB for
// the pair) take 0.0085 ms at 3.35 TB/s. So the products set the bound, and
// with hd = 32 each product has a depth of only two k16 steps: the
// elementwise work between them (exp2 of the recomputed P, the dropout hash,
// dS) takes as many instruction slots as the products, which is why they
// run as warp-level mma.sync with their operands in registers rather than
// as wgmma from shared memory.
//
// Design (FlashAttention-2's backward, deterministic: no atomics):
//  * dK/dV kernel: one CTA of 4 warps per (64-key tile, batch*head); each
//    warp owns 16 keys. K and V are copied once (cp.async) into bf16 shared
//    memory and held as mma A fragments in registers. The loop over 64-row
//    query tiles double-buffers Q, dO, lse and D with cp.async (tile i+1 in
//    flight while tile i computes) and computes, per warp,
//        S^T = K Q^T, dP^T = V dO^T   [16 keys x 64 queries], B from ldmatrix
//    then P~^T and dS^T in registers, which are converted to bf16 and fed
//    straight back as the A operand of
//        dV += P~^T dO, dK += dS^T Q  (dO, Q as B via ldmatrix.trans).
//    dK and dV accumulate in f32 registers and are stored once.
//  * dQ kernel: one CTA of 4 warps per (64-query tile, batch*head); each
//    warp owns 16 rows, whose Q and dO are held as A fragments. K and V
//    are double-buffered with cp.async (the keys' mask terms beside them);
//    S = Q K^T and dP = dO V^T come from mma.sync, dS stays in registers as
//    the A operand of dQ += dS K (K as B via ldmatrix.trans), and dQ is
//    written once.
// Shared-memory rows are padded to hd + 8 elements (80 or 48 bytes), which
// puts the 8 rows of every ldmatrix phase on distinct banks.
//
// Registers and shared memory at hd 32 (nvcc -Xptxas -v as chip_smoke.py's
// build phase prints it for sm_90a; PERF.md keeps all four
// instantiations of each): dK/dV 165 registers and 31,744 B of static
// shared memory without dropout, 168 and 32,768 B with it, no spills; dQ
// 168 registers, 31,744 B, 8 B (24 B with dropout) of spill stores. Both
// are held to 168 registers by __launch_bounds__(128, 3): three CTAs, 12
// warps, per SM.

#include "flash_attn_bwd.cuh"

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

// The per-element branches of grad_pair (flash_attn_bwd.cu), folded into
// constants. A key's term (a, b) gives s * a + b, the base-2 logit: a real
// key (scale*log2(e), 0), a masked one (0, NEG_INF*log2(e)), one past S
// (0, -inf: P = 0; its zero-filled k and v rows give s = dP = 0). A row's
// term (P multiplier, dS multiplier) is (1, 1), or (1/S, 0) for a fully
// masked row: its saved lse equals NEG_INF*log2(e) exactly, so each of its
// (masked) keys gives exp2(0) = 1, times 1/S; in any other row a masked key
// gives exp2(-1.4e9 - lse) = 0, and so dS = 0 there with no test. A query
// row past Sq (zero-filled q and dO, lse = D = 0) contributes 0 to dK/dV.
__device__ __forceinline__ float2 key_term(const BwdParams& p, float flag) {
  return flag == 0.f ? make_float2(p.scale_log2, 0.f)
                     : make_float2(0.f, flag == 1.f ? NEG_INF * LOG2E
                                                    : -INFINITY);
}

__device__ __forceinline__ float2 row_term(const BwdParams& p, float lse) {
  return lse < 0.5f * NEG_INF * LOG2E ? make_float2(p.inv_S, 0.f)
                                      : make_float2(1.f, 1.f);
}

// One (row, key) element: s -> P~ = P o M and dp -> dS = P o (dP o M - D),
// M the element's dropout multiplier (1 without dropout).
__device__ __forceinline__ void grad_elem(float& s, float& dp, float2 kt,
                                          float lse, float dsum, float2 rt,
                                          float m) {
  const float e = fast_exp2(fmaf(s, kt.x, kt.y) - lse);
  const float d = dp;
  s = e * rt.x * m;
  dp = (d * m - dsum) * (e * rt.y);
}

template <bool DROP>
__device__ __forceinline__ float drop_mult(const BwdParams& p, uint64_t rk,
                                           int key) {
  if constexpr (DROP)
    return attn_drop_byte(rk, key) >= (uint32_t)p.drop_q ? p.drop_scale
                                                           : 0.f;
  return 1.f;
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
// row_lo + 8 of the warp, columns 8j + 2t, +1) times `mul` as bf16 pairs.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 8][4],
                                           int row_lo, int n_rows, int stride,
                                           int col0, int t, float mul) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (row_lo < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_lo * stride + col) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    if (row_lo + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row_lo + 8) * stride +
                                         col) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// Start the copies of query tile [q0, q0 + 64) for the dK/dV kernel: its Q
// and dO rows, lse and D (zero past Sq), and the rows' dropout keys, then
// commit them as one group.
template <int HD, bool DROP>
__device__ __forceinline__ void prefetch_query_tile(
    bf16 (*qs)[HD + 8], bf16 (*dos)[HD + 8], float* ls, float* dl,
    uint64_t* rk, const bf16* qb, const bf16* ob, const float* lse_bh,
    const float* dsum_bh, int q0, int Sq, int D, uint64_t sd, int bh) {
  cp_tile<HD>(qs, qb, q0, Sq, D);
  cp_tile<HD>(dos, ob, q0, Sq, D);
  const int tid = threadIdx.x;
  if (tid < TC_TILE) {
    const int row = q0 + tid;
    const bool ok = row < Sq;
    cp_async4(&ls[tid], lse_bh + (ok ? row : 0), ok);
    cp_async4(&dl[tid], dsum_bh + (ok ? row : 0), ok);
    if (DROP) rk[tid] = attn_drop_row_key(sd, bh, row);
  }
  cp_async_commit();
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, 3)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, BwdParams p,
                        const uint64_t* __restrict__ seed) {
  constexpr int LDS = HD + 8;
  constexpr int KS = HD / 16;     // k-steps over the head dim
  constexpr int NT = HD / 8;      // n-tiles over the head dim
  __shared__ __align__(16) bf16 Ks[TC_TILE][LDS];
  __shared__ __align__(16) bf16 Vs[TC_TILE][LDS];
  __shared__ __align__(16) bf16 Qs[2][TC_TILE][LDS];
  __shared__ __align__(16) bf16 dOs[2][TC_TILE][LDS];
  __shared__ __align__(16) float Lse[2][TC_TILE];
  __shared__ __align__(16) float Dl[2][TC_TILE];
  __shared__ uint64_t RowKey[2][TC_TILE];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = blockIdx.x * TC_TILE;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int D = p.H * HD;
  const int Sq = p.Sq, S = p.S;

  const bf16* qb = q + (size_t)b * Sq * D + h * HD;
  const bf16* ob = dout + (size_t)b * Sq * D + h * HD;
  const bf16* kb = k + (size_t)b * S * D + h * HD;
  const bf16* vb = v + (size_t)b * S * D + h * HD;
  const uint8_t* mb = mask ? mask + (size_t)b * S : nullptr;
  const float* lse_bh = lse + (size_t)bh * Sq;
  const float* dsum_bh = dsum + (size_t)bh * Sq;
  const uint64_t sd = DROP ? *seed : 0;

  cp_tile<HD>(Ks, kb, k0, S, D);
  cp_tile<HD>(Vs, vb, k0, S, D);
  prefetch_query_tile<HD, DROP>(Qs[0], dOs[0], Lse[0], Dl[0], RowKey[0], qb,
                                ob, lse_bh, dsum_bh, 0, Sq, D, sd, bh);
  cp_async_wait_all();
  __syncthreads();

  uint32_t kf[KS][4], vf[KS][4];   // A fragments of the warp's 16 keys
  ldsm_a<HD>(Ks, warp, lane, kf);
  ldsm_a<HD>(Vs, warp, lane, vf);
  // This thread's keys: rows g and g + 8 of the warp's 16.
  const int key_lo = k0 + warp * 16 + g;
  const float2 key_t[2] = {key_term(p, key_flag(mb, key_lo, S)),
                           key_term(p, key_flag(mb, key_lo + 8, S))};

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int n_tiles = (Sq + TC_TILE - 1) / TC_TILE;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int q0 = it * TC_TILE;
    if (it + 1 < n_tiles)
      prefetch_query_tile<HD, DROP>(Qs[buf ^ 1], dOs[buf ^ 1], Lse[buf ^ 1],
                                    Dl[buf ^ 1], RowKey[buf ^ 1], qb, ob,
                                    lse_bh, dsum_bh, q0 + TC_TILE, Sq, D, sd,
                                    bh);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp.
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
      uint32_t qf[KS][2], of[KS][2];
      ldsm_b<HD>(Qs[buf], nt, lane, qf);
      ldsm_b<HD>(dOs[buf], nt, lane, of);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_bf16(st[nt], kf[ks], qf[ks][0], qf[ks][1]);
        mma_bf16(dpt[nt], vf[ks], of[ks][0], of[ks][1]);
      }
    }

    // P~^T into st, dS^T into dpt. Element 2 i + j of n-tile nt is key
    // key_lo + 8 i, query column 8 nt + 2 t + j.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nt * 8 + 2 * t + j;
        const float lse_c = Lse[buf][c];
        const float d_c = Dl[buf][c];
        const float2 rt = row_term(p, lse_c);
        const uint64_t rk = DROP ? RowKey[buf][c] : 0;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          grad_elem(st[nt][2 * i + j], dpt[nt][2 * i + j], key_t[i], lse_c,
                    d_c, rt, drop_mult<DROP>(p, rk, key_lo + 8 * i));
      }

    // dV += P~^T dO and dK += dS^T Q over the tile's 64 queries.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(st, kk, pa);
      acc_to_a(dpt, kk, da);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t ofr[2][2], qfr[2][2];
        ldsm_bt<HD>(dOs[buf], kk, j, lane, ofr);
        ldsm_bt<HD>(Qs[buf], kk, j, lane, qfr);
        mma_bf16(dv_acc[j], pa, ofr[0][0], ofr[0][1]);
        mma_bf16(dv_acc[j + 1], pa, ofr[1][0], ofr[1][1]);
        mma_bf16(dk_acc[j], da, qfr[0][0], qfr[0][1]);
        mma_bf16(dk_acc[j + 1], da, qfr[1][0], qfr[1][1]);
      }
    }
    // Tile it + 1 has landed and tile it is consumed.
    cp_async_wait_all();
    __syncthreads();
  }

  const size_t base = (size_t)b * S * D;
  store_rows<HD>(dk + base, dk_acc, key_lo, S, D, h * HD, t, p.scale);
  store_rows<HD>(dv + base, dv_acc, key_lo, S, D, h * HD, t, 1.f);
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, 3)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum, bf16* __restrict__ dq,
                       BwdParams p, const uint64_t* __restrict__ seed) {
  constexpr int LDS = HD + 8;
  constexpr int KS = HD / 16;
  constexpr int NT = HD / 8;
  __shared__ __align__(16) bf16 Qs[TC_TILE][LDS];
  __shared__ __align__(16) bf16 dOs[TC_TILE][LDS];
  __shared__ __align__(16) bf16 Ks[2][TC_TILE][LDS];
  __shared__ __align__(16) bf16 Vs[2][TC_TILE][LDS];
  __shared__ float2 KeyT[2][TC_TILE];    // key terms of the K/V tiles

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * TC_TILE;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int D = p.H * HD;
  const int Sq = p.Sq, S = p.S;

  const bf16* qb = q + (size_t)b * Sq * D + h * HD;
  const bf16* ob = dout + (size_t)b * Sq * D + h * HD;
  const bf16* kb = k + (size_t)b * S * D + h * HD;
  const bf16* vb = v + (size_t)b * S * D + h * HD;
  const uint8_t* mb = mask ? mask + (size_t)b * S : nullptr;

  cp_tile<HD>(Qs, qb, q0, Sq, D);
  cp_tile<HD>(dOs, ob, q0, Sq, D);
  cp_tile<HD>(Ks[0], kb, 0, S, D);
  cp_tile<HD>(Vs[0], vb, 0, S, D);
  cp_async_commit();
  if (tid < TC_TILE) KeyT[0][tid] = key_term(p, key_flag(mb, tid, S));

  // This thread's rows: g and g + 8 of the warp's 16.
  const int row_lo = q0 + warp * 16 + g;
  float row_lse[2], row_d[2];
  float2 row_t[2];
  uint64_t row_key[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    row_lse[i] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    row_d[i] = row < Sq ? dsum[(size_t)bh * Sq + row] : 0.f;
    row_t[i] = row_term(p, row_lse[i]);
    if (DROP) row_key[i] = attn_drop_row_key(*seed, bh, row);
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4], of[KS][4];   // A fragments of the warp's 16 rows
  ldsm_a<HD>(Qs, warp, lane, qf);
  ldsm_a<HD>(dOs, warp, lane, of);

  float dq_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  const int n_tiles = (S + TC_TILE - 1) / TC_TILE;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int k0 = it * TC_TILE;
    float next_flag = 0.f;
    if (it + 1 < n_tiles) {
      cp_tile<HD>(Ks[buf ^ 1], kb, k0 + TC_TILE, S, D);
      cp_tile<HD>(Vs[buf ^ 1], vb, k0 + TC_TILE, S, D);
      cp_async_commit();
      // Read now, stored after this tile's work: the load's latency hides.
      if (tid < TC_TILE) next_flag = key_flag(mb, k0 + TC_TILE + tid, S);
    }

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      uint32_t kf[KS][2], vf[KS][2];
      ldsm_b<HD>(Ks[buf], nt, lane, kf);
      ldsm_b<HD>(Vs[buf], nt, lane, vf);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_bf16(s[nt], qf[ks], kf[ks][0], kf[ks][1]);
        mma_bf16(dp[nt], of[ks], vf[ks][0], vf[ks][1]);
      }
    }

    // dS into s. Element 2 i + j of n-tile nt is row row_lo + 8 i, key
    // column 8 nt + 2 t + j.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nt * 8 + 2 * t + j;
        const float2 kt = KeyT[buf][c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& se = s[nt][2 * i + j];
          float& de = dp[nt][2 * i + j];
          grad_elem(se, de, kt, row_lse[i], row_d[i], row_t[i],
                    drop_mult<DROP>(p, row_key[i], k0 + c));
          se = de;
        }
      }

    // dQ += dS K over the tile's 64 keys.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      acc_to_a(s, kk, da);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kfr[2][2];
        ldsm_bt<HD>(Ks[buf], kk, j, lane, kfr);
        mma_bf16(dq_acc[j], da, kfr[0][0], kfr[0][1]);
        mma_bf16(dq_acc[j + 1], da, kfr[1][0], kfr[1][1]);
      }
    }
    if (it + 1 < n_tiles && tid < TC_TILE)
      KeyT[buf ^ 1][tid] = key_term(p, next_flag);
    // Tile it + 1 has landed and tile it is consumed.
    cp_async_wait_all();
    __syncthreads();
  }

  store_rows<HD>(dq + (size_t)b * Sq * D, dq_acc, row_lo, Sq, D, h * HD, t,
                 p.scale);
}

template <int HD>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const uint8_t* mask, const void* dout,
                          const float* lse, const float* dsum, void* dk,
                          void* dv, BwdParams p, int B, const uint64_t* seed,
                          cudaStream_t stream) {
  dim3 grid((p.S + TC_TILE - 1) / TC_TILE, B * p.H);
  auto kernel = p.drop_q > 0 ? flash_bwd_dkv_tc_kernel<HD, true>
                             : flash_bwd_dkv_tc_kernel<HD, false>;
  kernel<<<grid, TC_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<const bf16*>(dout), lse,
      dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), p, seed);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const uint8_t* mask, const void* dout,
                         const float* lse, const float* dsum, void* dq,
                         BwdParams p, int B, const uint64_t* seed,
                         cudaStream_t stream) {
  dim3 grid((p.Sq + TC_TILE - 1) / TC_TILE, B * p.H);
  auto kernel = p.drop_q > 0 ? flash_bwd_dq_tc_kernel<HD, true>
                             : flash_bwd_dq_tc_kernel<HD, false>;
  kernel<<<grid, TC_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<const bf16*>(dout), lse,
      dsum, static_cast<bf16*>(dq), p, seed);
  return cudaGetLastError();
}

}  // namespace

// The arguments of toist_flash_attn_bwd_dkv / _dq (flash_attn_bwd.cu), for
// bfloat16 only (dtype 1; hd 16 or 32). Each returns a cudaError_t
// (0 = launched).
#define TOIST_TC_DISPATCH(FN, ...)                                           \
  if (dtype == 1 && hd == 32) return FN<32>(__VA_ARGS__);                    \
  if (dtype == 1 && hd == 16) return FN<16>(__VA_ARGS__);                    \
  return (int)cudaErrorInvalidValue;

extern "C" int toist_flash_attn_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
    int B, int H, int Sq, int S, int hd, int dtype, int drop_q,
    const void* seed, void* stream) {
  BwdParams p;
  if (!make_params(B, H, Sq, S, hd, drop_q, seed, &p))
    return (int)cudaErrorInvalidValue;
  TOIST_TC_DISPATCH(launch_dkv_tc, q, k, v, static_cast<const uint8_t*>(mask),
                    dout, static_cast<const float*>(lse),
                    static_cast<const float*>(dsum), dk, dv, p, B,
                    static_cast<const uint64_t*>(seed),
                    static_cast<cudaStream_t>(stream))
}

extern "C" int toist_flash_attn_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* dsum, void* dq, int B,
    int H, int Sq, int S, int hd, int dtype, int drop_q, const void* seed,
    void* stream) {
  BwdParams p;
  if (!make_params(B, H, Sq, S, hd, drop_q, seed, &p))
    return (int)cudaErrorInvalidValue;
  TOIST_TC_DISPATCH(launch_dq_tc, q, k, v, static_cast<const uint8_t*>(mask),
                    dout, static_cast<const float*>(lse),
                    static_cast<const float*>(dsum), dq, p, B,
                    static_cast<const uint64_t*>(seed),
                    static_cast<cudaStream_t>(stream))
}
