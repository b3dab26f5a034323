// Flash-attention forward for Hopper (sm_90a), bfloat16 route: QK^T and PV
// on the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate), with
// in-kernel dropout. float32 inputs go to the scalar kernel of
// flash_attn_fwd.cu instead; the wrapper chooses by dtype.
//
// Replaces the TPU kernel `_fwd_kernel` (toist_tpu/ops/flash_attention.py:
// 124, launched by `_forward`) and its dropout (`_drop_tile` / `_drop_row`)
// for bf16. It computes what flash_attn_fwd.cu computes, with the same
// contract: per (batch, head) and query row
//     P = softmax(Q K^T / sqrt(hd) with masked logits replaced by -1e9)
//     O = (P o M) V,   M = keep / (1 - q/256) (all ones when q = 0)
// and lse = log2(sum_k exp2(s_k)), s_k = (q.k / sqrt(hd)) * log2(e), f32
// [B, H, Sq]. q [B, Sq, H*hd], k and v [B, S, H*hd], read in place at column
// h*hd; mask [B, S] u8 (nonzero = padding) or null; o like q. A masked key's
// logit is replaced by -1e9, so a fully masked row averages V over its S
// real keys and its lse rounds to -1e9*log2(e) in f32 (the backward's
// row_term reads that); keys past S get probability exactly 0; rows past Sq
// are not stored. Dropout multiplies P after the row sum has taken it in, so
// the lse is the undropped one; the bits are attn_dropout.cuh's.
//
// What bounds it: two products of 2*B*Sq*S*D FLOP. At the serving encoder
// shape (q, k, v [8, 1114, 256], 8 heads of 32) that is 1.02e10 FLOP, 0.0103
// ms at 989 TFLOP/s bf16; at the training encoder [6, 1156, 256] 8.2e9 FLOP,
// 0.0083 ms. Its bytes (q, k, v, o, lse: 18.5 MB and 14.6 MB) take 0.0055 and
// 0.0044 ms at 3.35 TB/s. With hd = 32 each product is only two k16 steps
// deep, so the exp2 of every score is the real floor: 8*8*1114^2 = 79M exp2
// per serving encoder call at 16 ex2 per clock per SM on 132 SMs is about
// 0.02 ms at the boost clock, twice the tensor-core bound (chip_smoke.py
// records it as exp_bound_ms). The rest of the elementwise work per score
// (scale, max, sum, bf16 pack) costs instruction slots beside it, as does
// dropout at rate > 0: a quarter of a 32-bit mix and of a shuffle (one word
// per 2x2 block, computed once per lane pair, attn_drop_word_pair), then a
// shift, a compare and a select; its scale multiplies O once, at the end.
//
// Design (FlashAttention-2's forward on mma.sync, the building blocks of
// flash_attn_tc.cuh): one CTA of 4 warps per (64-query tile, batch*head);
// each warp owns 16 query rows and holds their Q as A fragments in
// registers. K and V tiles of 64 keys are double-buffered with cp.async
// (zero-filled past S), the keys' mask terms beside them, so masked and
// past-S keys cost no per-element branch. Per key tile a warp computes
// S = Q K^T into f32 accumulators (K as B via ldmatrix), runs the online
// softmax in registers (row max over the 4 lanes of a quad by two shuffles;
// each lane keeps its share of the row sum, summed over the quad once at
// the end), and feeds the unnormalised P, packed to bf16, straight back as
// the A operand of O += P V (V as B via ldmatrix.trans): no P in shared
// memory and one __syncthreads per key tile. O is divided by the row sum
// once, at the end, as the TPU kernel defers its 1/l.
//
// Registers and shared memory: chip_smoke.py's build phase prints what
// ptxas reports for each instantiation (PERF.md keeps them); 26,624 B of
// static shared memory at hd 32. __launch_bounds__(128, 4) asks for four
// CTAs, 16 warps, per SM.

#include "attn_dropout.cuh"
#include "flash_attn_tc.cuh"

namespace {

struct FwdParams {
  int H, Sq, S;
  float scale_log2;   // log2(e) / sqrt(hd)
  int drop_q;
  float drop_scale;
};

template <int HD, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, 4)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ mask, bf16* __restrict__ o,
                    float* __restrict__ lse, FwdParams p,
                    const uint64_t* __restrict__ seed) {
  constexpr int LDS = HD + 8;
  constexpr int KS = HD / 16;     // k-steps over the head dim
  constexpr int NT = HD / 8;      // n-tiles over the head dim
  __shared__ __align__(16) bf16 Qs[TC_TILE][LDS];
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
  const bf16* kb = k + (size_t)b * S * D + h * HD;
  const bf16* vb = v + (size_t)b * S * D + h * HD;
  const uint8_t* mb = mask ? mask + (size_t)b * S : nullptr;

  cp_tile<HD>(Qs, qb, q0, Sq, D);
  cp_tile<HD>(Ks[0], kb, 0, S, D);
  cp_tile<HD>(Vs[0], vb, 0, S, D);
  cp_async_commit();
  if (tid < TC_TILE)
    KeyT[0][tid] = key_term(p.scale_log2, key_flag(mb, tid, S));

  // This thread's rows: g and g + 8 of the warp's 16. Dropout: they lie in
  // row pairs row_lo / 2 and that + 4 (the two blocks of each n-tile), at
  // byte (g & 1) * 2 + (key & 1) of each word; this lane hashes the blocks
  // of the second pair if g is odd (attn_drop_word_pair).
  const int row_lo = q0 + warp * 16 + g;
  const bool odd_g = g & 1;
  const int lshift = 24 - 16 * (g & 1);   // 8 less for odd keys
  const uint64_t pair_key =
      DROP ? attn_drop_pair_key(*seed, bh, row_lo / 2 + 4 * (g & 1)) : 0;
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4];   // A fragments of the warp's 16 rows
  ldsm_a<HD>(Qs, warp, lane, qf);

  float o_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // running row max, base 2
  float l_run[2] = {0.f, 0.f};               // this lane's share of the sum

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

    // S = Q K^T: 16 rows x 64 keys per warp. Element 2 i + j of n-tile nt
    // is row row_lo + 8 i, key column 8 nt + 2 t + j.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      uint32_t kf[KS][2];
      ldsm_b<HD>(Ks[buf], nt, lane, kf);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(s[nt], qf[ks], kf[ks][0], kf[ks][1]);
    }

    // Base-2 logits and the tile's row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 kt = KeyT[buf][nt * 8 + 2 * t + j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& e = s[nt][2 * i + j];
          e = fmaf(e, kt.x, kt.y);
          mx[i] = fmaxf(mx[i], e);
        }
      }
    // The 4 lanes of a quad hold one row's 64 keys. Every tile holds a key
    // below S, so the new max is finite; on the first tile alpha is 0.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = fast_exp2(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }

    // P = exp2(s - m): the row sum takes the undropped P, the product the
    // kept elements (the dropout scale multiplies O once, at the end). One
    // dropout word per row and n-tile (key pair k0 / 2 + 4 nt + t), two of
    // its bytes.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t w[2] = {0, 0};
      if (DROP) attn_drop_word_pair(pair_key, k0 / 2 + 4 * nt + t, odd_g, w);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& e = s[nt][2 * i + j];
          e = fast_exp2(e - m_run[i]);
          l_run[i] += e;
          if (DROP && !attn_drop_keep(w[i], lshift - 8 * j, p.drop_q))
            e = 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    // O += P V over the tile's 64 keys.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      acc_to_a(s, kk, pa);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t vfr[2][2];
        ldsm_bt<HD>(Vs[buf], kk, j, lane, vfr);
        mma_bf16(o_acc[j], pa, vfr[0][0], vfr[0][1]);
        mma_bf16(o_acc[j + 1], pa, vfr[1][0], vfr[1][1]);
      }
    }
    if (it + 1 < n_tiles && tid < TC_TILE)
      KeyT[buf ^ 1][tid] = key_term(p.scale_log2, next_flag);
    // Tile it + 1 has landed and tile it is consumed.
    cp_async_wait_all();
    __syncthreads();
  }

  // The row sums over the quad, then O * (dropout scale) / l once.
  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    inv_l[i] = (DROP ? p.drop_scale : 1.f) / l_run[i];
  }
  store_rows<HD>(o + (size_t)b * Sq * D, o_acc, row_lo, Sq, D, h * HD, t,
                 inv_l[0], inv_l[1]);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row < Sq) lse[(size_t)bh * Sq + row] = m_run[i] + log2f(l_run[i]);
    }
  }
}

template <int HD>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          const uint8_t* mask, void* o, float* lse,
                          FwdParams p, int B, const uint64_t* seed,
                          cudaStream_t stream) {
  dim3 grid((p.Sq + TC_TILE - 1) / TC_TILE, B * p.H);
  auto kernel = p.drop_q > 0 ? flash_fwd_tc_kernel<HD, true>
                             : flash_fwd_tc_kernel<HD, false>;
  kernel<<<grid, TC_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(o), lse, p, seed);
  return cudaGetLastError();
}

}  // namespace

// The arguments of toist_flash_attn_fwd (flash_attn_fwd.cu), for bfloat16
// only (dtype 1; hd 16 or 32). Returns a cudaError_t (0 = launched).
extern "C" int toist_flash_attn_fwd_tc(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       void* o, void* lse, int B, int H,
                                       int Sq, int S, int hd, int dtype,
                                       int drop_q, const void* seed,
                                       void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || S <= 0 || B * H > 65535 || drop_q < 0 ||
      drop_q > 255 || (drop_q > 0 && seed == nullptr) || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const FwdParams p{H, Sq, S, LOG2E / sqrtf((float)hd), drop_q,
                    (float)(1.0 / (1.0 - drop_q / 256.0))};
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  const uint64_t* sd = static_cast<const uint64_t*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 32) return launch_fwd_tc<32>(q, k, v, m, o, l, p, B, sd, s);
  if (hd == 16) return launch_fwd_tc<16>(q, k, v, m, o, l, p, B, sd, s);
  return (int)cudaErrorInvalidValue;
}
