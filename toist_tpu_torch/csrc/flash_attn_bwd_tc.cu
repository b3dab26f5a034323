// Flash-attention backward for Hopper (sm_90a), bfloat16 route: dK/dV and
// dQ on the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate), with
// the forward's in-kernel dropout regenerated, not stored.
//
// Replaces the TPU kernels `_dkv_kernel` (toist_tpu/ops/flash_attention.py:
// 147) and `_dq_kernel` (:193), launched by `_backward`. The math and the
// semantics of masked, fully masked and out-of-range keys are those of the
// f32 route, stated in flash_attn_bwd.cuh; the dropout bits are the
// forward's (attn_dropout.cuh), keyed on (seed, batch*head, query row, key).
// The tensor-core building blocks are shared with the forward
// (flash_attn_tc.cuh).
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
//
// Dropout: one word per 2x2 block, computed once per lane pair
// (attn_drop_word_pair), the keep test a shift and a compare, and the
// dropout scale multiplied into dK, dV and dQ once, when they are stored.
//
// Registers and shared memory at hd 32 (nvcc -Xptxas -v as chip_smoke.py's
// build phase prints it for sm_90a; PERF.md keeps all four
// instantiations of each): dK/dV 165 registers and 31,744 B of static
// shared memory without dropout, 166 and 32,256 B with it, no spills; dQ
// 168 registers, 31,744 B, 8 B of spill stores without dropout and none
// with it. Both are held to 168 registers by __launch_bounds__(128, 3):
// three CTAs, 12 warps, per SM.

#include "flash_attn_bwd.cuh"
#include "flash_attn_tc.cuh"

namespace {

// A row's term (P multiplier, dS multiplier) is (1, 1), or (1/S, 0) for a
// fully masked row: its saved lse equals NEG_INF*log2(e) exactly, so each of
// its (masked) keys gives exp2(0) = 1, times 1/S; in any other row a masked
// key gives exp2(-1.4e9 - lse) = 0, and so dS = 0 there with no test. With
// the key terms of key_term (flash_attn_tc.cuh) this folds the per-element
// branches of grad_pair (flash_attn_bwd.cu) into constants; a key past S
// also has dP = 0 (zero-filled v row). A query row past Sq (zero-filled q
// and dO, lse = D = 0) contributes 0 to dK/dV.
__device__ __forceinline__ float2 row_term(const BwdParams& p, float lse) {
  return lse < 0.5f * NEG_INF * LOG2E ? make_float2(p.inv_S, 0.f)
                                      : make_float2(1.f, 1.f);
}

// One (row, key) element: s -> P~ = P o M and dp -> dS = P o (dP o M - D),
// M = keep * c the element's dropout multiplier, c = 1 / (1 - q/256). With
// dropout the element keeps s -> P~ / c and dp -> dS / c, given D / c in
// dsum: the kernels multiply c back in once, when they store dK, dV, dQ.
// Without it, keep is true and c is 1.
template <bool DROP>
__device__ __forceinline__ void grad_elem(float& s, float& dp, float2 kt,
                                          float lse, float dsum, float2 rt,
                                          bool keep) {
  const float e = fast_exp2(fmaf(s, kt.x, kt.y) - lse);
  const bool drop = DROP && !keep;
  const float d = drop ? 0.f : dp;
  s = drop ? 0.f : e * rt.x;
  dp = (d - dsum) * (e * rt.y);
}

// Start the copies of query tile [q0, q0 + 64) for the dK/dV kernel: its Q
// and dO rows, lse and D (zero past Sq), then commit them as one group; and
// store the dropout keys of the tile's 32 row pairs.
template <int HD, bool DROP>
__device__ __forceinline__ void prefetch_query_tile(
    bf16 (*qs)[HD + 8], bf16 (*dos)[HD + 8], float* ls, float* dl,
    uint64_t* pk, const bf16* qb, const bf16* ob, const float* lse_bh,
    const float* dsum_bh, int q0, int Sq, int D, uint64_t sd, int bh) {
  cp_tile<HD>(qs, qb, q0, Sq, D);
  cp_tile<HD>(dos, ob, q0, Sq, D);
  const int tid = threadIdx.x;
  if (tid < TC_TILE) {
    const int row = q0 + tid;
    const bool ok = row < Sq;
    cp_async4(&ls[tid], lse_bh + (ok ? row : 0), ok);
    cp_async4(&dl[tid], dsum_bh + (ok ? row : 0), ok);
  }
  if (DROP && tid < TC_TILE / 2)
    pk[tid] = attn_drop_pair_key(sd, bh, q0 / 2 + tid);
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
  __shared__ uint64_t PairKey[2][TC_TILE / 2];   // dropout keys, row pairs

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
  prefetch_query_tile<HD, DROP>(Qs[0], dOs[0], Lse[0], Dl[0], PairKey[0],
                                qb, ob, lse_bh, dsum_bh, 0, Sq, D, sd, bh);
  cp_async_wait_all();
  __syncthreads();

  uint32_t kf[KS][4], vf[KS][4];   // A fragments of the warp's 16 keys
  ldsm_a<HD>(Ks, warp, lane, kf);
  ldsm_a<HD>(Vs, warp, lane, vf);
  // This thread's keys: rows g and g + 8 of the warp's 16.
  const int key_lo = k0 + warp * 16 + g;
  const float2 key_t[2] = {key_term(p.scale_log2, key_flag(mb, key_lo, S)),
                           key_term(p.scale_log2,
                                    key_flag(mb, key_lo + 8, S))};
  // Dropout: this thread's keys lie in key pairs key_lo / 2 and that + 4
  // (the two blocks of each n-tile), at byte (query & 1) * 2 + (g & 1) of
  // each word; this lane hashes the second pair's block if g is odd
  // (attn_drop_word_pair). D enters divided by the dropout scale c, and dK
  // and dV are multiplied by it when stored (grad_elem).
  const bool odd_g = g & 1;
  const int my_key_pair = key_lo / 2 + 4 * (g & 1);
  const int lshift = 24 - 8 * (g & 1);   // 16 less for odd queries
  const float inv_c = DROP ? 1.f / p.drop_scale : 1.f;

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
                                    Dl[buf ^ 1], PairKey[buf ^ 1], qb, ob,
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
    // key_lo + 8 i, query column 8 nt + 2 t + j: one dropout word per key
    // (query pair 4 nt + t of the tile), two of its bytes.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t w[2] = {0, 0};
      if (DROP)
        attn_drop_word_pair(PairKey[buf][4 * nt + t], my_key_pair, odd_g, w);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nt * 8 + 2 * t + j;
        const float lse_c = Lse[buf][c];
        const float d_c = Dl[buf][c] * inv_c;
        const float2 rt = row_term(p, lse_c);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          grad_elem<DROP>(st[nt][2 * i + j], dpt[nt][2 * i + j], key_t[i],
                          lse_c, d_c, rt,
                          attn_drop_keep(w[i], lshift - 16 * j, p.drop_q));
      }
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
  const float c = DROP ? p.drop_scale : 1.f;
  store_rows<HD>(dk + base, dk_acc, key_lo, S, D, h * HD, t, p.scale * c,
                 p.scale * c);
  store_rows<HD>(dv + base, dv_acc, key_lo, S, D, h * HD, t, c, c);
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
  if (tid < TC_TILE)
    KeyT[0][tid] = key_term(p.scale_log2, key_flag(mb, tid, S));

  // This thread's rows: g and g + 8 of the warp's 16.
  const int row_lo = q0 + warp * 16 + g;
  float row_lse[2], row_d[2];
  float2 row_t[2];
  // Dropout: rows row_lo and row_lo + 8 lie in row pairs row_lo / 2 and
  // that + 4 (the two blocks of each n-tile), at byte (g & 1) * 2 +
  // (key & 1) of each word; this lane hashes the second pair's blocks if g
  // is odd (attn_drop_word_pair). D enters divided by the dropout scale c,
  // and dQ is multiplied by it when stored (grad_elem).
  const bool odd_g = g & 1;
  const int lshift = 24 - 16 * (g & 1);   // 8 less for odd keys
  const uint64_t pair_key =
      DROP ? attn_drop_pair_key(*seed, bh, row_lo / 2 + 4 * (g & 1)) : 0;
  const float c = DROP ? p.drop_scale : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    row_lse[i] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    row_d[i] = row < Sq ? dsum[(size_t)bh * Sq + row] / c : 0.f;
    row_t[i] = row_term(p, row_lse[i]);
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
    // column 8 nt + 2 t + j: one dropout word per row (key pair
    // k0 / 2 + 4 nt + t), two of its bytes.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t w[2] = {0, 0};
      if (DROP) attn_drop_word_pair(pair_key, k0 / 2 + 4 * nt + t, odd_g, w);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 kt = KeyT[buf][nt * 8 + 2 * t + j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& se = s[nt][2 * i + j];
          float& de = dp[nt][2 * i + j];
          grad_elem<DROP>(se, de, kt, row_lse[i], row_d[i], row_t[i],
                          attn_drop_keep(w[i], lshift - 8 * j, p.drop_q));
          se = de;
        }
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
      KeyT[buf ^ 1][tid] = key_term(p.scale_log2, next_flag);
    // Tile it + 1 has landed and tile it is consumed.
    cp_async_wait_all();
    __syncthreads();
  }

  store_rows<HD>(dq + (size_t)b * Sq * D, dq_acc, row_lo, Sq, D, h * HD, t,
                 p.scale * c, p.scale * c);
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
