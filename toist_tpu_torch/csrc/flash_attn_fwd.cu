// Flash-attention forward for Hopper (sm_90a), float32 route, with in-kernel
// dropout. bfloat16 inputs go to the tensor-core kernel of
// flash_attn_fwd_tc.cu instead, which computes the same O and LSE; the
// wrapper chooses by dtype.
//
// Replaces the TPU kernel `_fwd_kernel` (toist_tpu/ops/flash_attention.py,
// launched by `_forward`) and its dropout (`_drop_tile` / `_drop_row`). It
// computes, per (batch, head) and query row,
//     P = softmax(Q K^T / sqrt(hd) with masked logits replaced by -1e9)
//     O = (P o M) V,   M = keep / (1 - q/256) (all ones when q = 0)
// and the row's log-sum-exp, for the joint encoder's self-attention
// (Sq = S = 1156 at the 832x1344 eval canvas) and the decoder's image
// cross-attention (Sq = 100, S = 1156), d_model 256 split into 8 heads of 32.
//
// What bounds it: the plain version writes and re-reads the [B, H, Sq, S]
// f32 scores and probabilities, 8*8*1156^2*4 B = 342 MB per encoder layer,
// while q, k and v together are 3*8*1156*256*2 B = 14 MB in bf16. This kernel
// keeps scores and probabilities in registers and shared memory (an online,
// flash-2 style softmax over key tiles) and reads only q, k, v and the key
// padding mask, so its device-memory traffic is that of its inputs and
// output. Arithmetic is scalar f32 FMAs (about 11 GFLOP per encoder call),
// which the f32 checks need (phases 5 and 9 of chip_smoke.py): TF32 or bf16
// tensor-core products would not meet their tolerance.
//
// Layout: q [B, Sq, H*hd], k and v [B, S, H*hd], contiguous, read in place
// at column offset h*hd (no head-major transpose, no padding of the head
// dim or the sequence: keys past S are skipped by bounds checks). mask is
// [B, S] uint8 (nonzero = padding key) or null. o has q's layout and dtype.
// lse is [B, H, Sq] f32 in base 2 over the scaled scores:
//     lse = log2(sum_k exp2(s_k)),  s_k = (q.k / sqrt(hd)) * log2(e),
// the convention of the TPU kernel, which the backward kernels will read.
//
// A masked key's logit is replaced by NEG_INF = -1e9 (not added to), so a
// row whose keys are all masked softmaxes uniformly over its S real keys,
// as the unfused path in toist_tpu/models/layers.py does.
//
// Dropout (q = drop_q > 0): the mask multiplies the unnormalised
// probabilities after the row sum l has taken them in, as the TPU kernel
// does, so the LSE is that of the undropped softmax and the backward kernels
// recompute P from it. The keep bits come from attn_dropout.cuh, keyed on
// (*seed, bh, row, column); q = 0 skips them and is the inference path.

//
// Tiling: one CTA of 256 threads per (64-query tile, batch*head). Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows 4*ty .. 4*ty+3 of the
// tile, score columns tx + 16*j of each 64-key tile, and output columns
// tx*(HD/16) .. of the head. The 16 threads that share a row sit in one
// half-warp, so row max and row sum are half-warp shuffles.

#include "attn_dropout.cuh"
#include "flash_attn_common.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int S, float scale_log2, int drop_q,
                 float drop_scale, const uint64_t* __restrict__ seed) {
  constexpr int LD = HD + 4;      // padded rows: 16-byte aligned, conflict-free
  constexpr int OC = HD / 16;     // output columns per thread
  __shared__ __align__(16) float Qs[BQ][LD];
  __shared__ __align__(16) float Ks[BK][LD];
  __shared__ __align__(16) float Vs[BK][HD];
  __shared__ __align__(16) float Ps[BQ][BK + 4];
  __shared__ float Bias[BK];      // 0 = real key, 1 = masked, 2 = past S

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int D = H * HD;

  const T* qb = q + (size_t)b * Sq * D + h * HD;
  const T* kb = k + (size_t)b * S * D + h * HD;
  const T* vb = v + (size_t)b * S * D + h * HD;
  const uint8_t* mb = mask ? mask + (size_t)b * S : nullptr;

  load_tile<T, HD, LD>(Qs, qb, q0, Sq, D);

  // Rows 4*ty .. 4*ty+3 are the dropout row pairs 2*ty and 2*ty + 1 of the
  // tile (q0 is even).
  uint64_t pair_key[2] = {0, 0};
  if (drop_q > 0) {
    const uint64_t sd = *seed;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      pair_key[i] = attn_drop_pair_key(sd, bh, (q0 + 4 * ty) / 2 + i);
  }

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();   // the previous tile's Ks/Vs/Ps/Bias are consumed
    load_tile<T, HD, LD>(Ks, kb, k0, S, D);
    load_tile<T, HD, HD>(Vs, vb, k0, S, D);
    if (tid < BK) Bias[tid] = key_flag(mb, k0 + tid, S);
    __syncthreads();

    // Scores for rows 4*ty+i, keys tx+16*j of this tile.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[4 * ty + i][d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[tx + 16 * j][d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    // Scaled, masked scores in log2 space; online softmax update.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float flag = Bias[tx + 16 * j];
        s[i][j] = flag == 0.f ? s[i][j] * scale_log2
                : flag == 1.f ? NEG_INF * LOG2E : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Every tile holds at least one key below S, so m_new is finite.
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(s[i][j] - m_new);
        rs += p;
        if (drop_q > 0) {
          const int col = k0 + tx + 16 * j;
          p = attn_drop_keep(attn_drop_word(pair_key[i / 2], col / 2),
                             attn_drop_lshift(i, col), drop_q)
                  ? p * drop_scale : 0.f;
        }
        Ps[4 * ty + i][tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // Ps complete

    // acc[i][:] += P[row i, :] V[:, tx*OC ..]
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[4 * ty + i][kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[OC];
#pragma unroll
        for (int c = 0; c < OC; ++c) vv[c] = Vs[kk + u][tx * OC + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < OC; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float inv_l = 1.f / l[i];
    T* orow = o + ((size_t)b * Sq + row) * D + h * HD + tx * OC;
#pragma unroll
    for (int c = 0; c < OC; ++c) store_elem(orow + c, acc[i][c] * inv_l);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + row] = m[i] + log2f(l[i]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* lse, int B, int H,
                   int Sq, int S, int drop_q, const uint64_t* seed,
                   cudaStream_t stream) {
  const float scale_log2 = LOG2E / sqrtf((float)HD);
  const float drop_scale = (float)(1.0 / (1.0 - drop_q / 256.0));
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Sq, S,
      scale_log2, drop_q, drop_scale, seed);
  return cudaGetLastError();
}

// keep[bh, row, col] = 1 where the kernels keep the element, else 0.
__global__ void dropout_mask_kernel(const uint64_t* __restrict__ seed,
                                    uint8_t* __restrict__ keep, int Sq, int S,
                                    int drop_q) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  const int bh = blockIdx.z;
  if (col >= S) return;
  const uint32_t word =
      attn_drop_word(attn_drop_pair_key(*seed, bh, row / 2), col / 2);
  keep[((size_t)bh * Sq + row) * S + col] =
      attn_drop_keep(word, attn_drop_lshift(row, col), drop_q);
}

}  // namespace

// dtype: 0 = float32 only (bfloat16 has toist_flash_attn_fwd_tc); drop_q in
// [0, 255] (0 = no dropout; seed is then not read). Returns a cudaError_t
// (0 = launched).
extern "C" int toist_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, const void* mask, void* o,
                                    void* lse, int B, int H, int Sq, int S,
                                    int hd, int dtype, int drop_q,
                                    const void* seed, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || S <= 0 || B * H > 65535 || drop_q < 0 ||
      drop_q > 255 || (drop_q > 0 && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  const uint64_t* sd = static_cast<const uint64_t*>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 32) return launch<float, 32>(q, k, v, m, o, l, B, H, Sq, S, drop_q, sd, s);
  if (dtype == 0 && hd == 16) return launch<float, 16>(q, k, v, m, o, l, B, H, Sq, S, drop_q, sd, s);
  return (int)cudaErrorInvalidValue;
}

// The dropout keep mask [BH, Sq, S] u8 that the attention kernels apply for
// this seed and q (for tests and chip_smoke.py, which hand it to the plain
// version). Returns a cudaError_t.
extern "C" int toist_attn_dropout_mask(const void* seed, void* keep, int BH,
                                       int Sq, int S, int drop_q,
                                       void* stream) {
  if (BH <= 0 || BH > 65535 || Sq <= 0 || Sq > 65535 || S <= 0 ||
      drop_q <= 0 || drop_q > 255 || seed == nullptr)
    return (int)cudaErrorInvalidValue;
  dim3 grid((S + 255) / 256, Sq, BH);
  dropout_mask_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(seed), static_cast<uint8_t*>(keep), Sq, S,
      drop_q);
  return (int)cudaGetLastError();
}
