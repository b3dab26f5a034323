// Flash-attention backward for Hopper (sm_90a), float32 route: dK/dV and
// dQ as scalar f32 FMAs, with the forward's in-kernel dropout regenerated,
// not stored. bfloat16 inputs go to the tensor-core kernels of
// flash_attn_bwd_tc.cu instead; the wrapper chooses by dtype.
//
// Replaces the TPU kernels `_dkv_kernel` and `_dq_kernel`
// (toist_tpu/ops/flash_attention.py, launched by `_backward`). The math and
// the semantics of masked, fully masked and out-of-range keys are stated in
// flash_attn_bwd.cuh.
//
// What bounds it: like the forward, the scores never reach device memory;
// each kernel reads q, k, v, dO (and the mask) once per tile pass and writes
// its gradients once. The arithmetic is scalar f32 FMAs: about twice the
// forward's per (row, key) pair in each kernel. It serves the f32 checks
// (the f32 training step compared with the plain version), where TF32 or
// bf16 tensor-core products would not meet their tolerance.
//
// Layout: dK/dV kernel, one CTA of 256 threads per (64-key tile, batch*head),
// looping over all 64-row query tiles, so dK and dV are complete in one CTA
// (no atomics); thread t accumulates key t/4, head columns (t%4)*HD/4 ...
// dQ kernel, one CTA per (64-query tile, batch*head), looping over key
// tiles; thread t accumulates row t/4. Scores use the forward's thread map:
// rows 4*ty+i, keys tx+16*j. Both kernels take dynamic shared memory above
// 48 KB (about 72 KB and 55 KB at hd 32).

#include "flash_attn_bwd.cuh"

namespace {

constexpr int LP = TILE + 4;    // padded row of a [64, 64] score tile

// P~ = P o M and dS of one (row, key) pair; row_ok is row < Sq, flag the
// key's key_flag, pair_key the dropout key of the row's pair.
__device__ __forceinline__ void grad_pair(const BwdParams& p, bool row_ok,
                                          float flag, float s, float dp,
                                          float lse, float dsum,
                                          uint64_t pair_key, int row, int key,
                                          float* pt, float* ds) {
  *pt = 0.f;
  *ds = 0.f;
  if (!row_ok || flag == 2.f) return;
  const float prob = lse < 0.5f * NEG_INF * LOG2E
                         ? p.inv_S
                         : exp2f((flag == 0.f ? s * p.scale_log2
                                              : NEG_INF * LOG2E) - lse);
  float m = 1.f;
  if (p.drop_q > 0)
    m = attn_drop_keep(attn_drop_word(pair_key, key / 2),
                       attn_drop_lshift(row, key), p.drop_q)
            ? p.drop_scale : 0.f;
  *pt = prob * m;
  if (flag == 0.f) *ds = prob * (dp * m - dsum);
}

// Scores of this thread's 4x4 (row, key) block: s = Q K^T and dp = dO V^T.
template <int HD, int LD>
__device__ __forceinline__ void score_block(const float (*Qs)[LD],
                                            const float (*dOs)[LD],
                                            const float (*Ks)[LD],
                                            const float (*Vs)[LD], int ty,
                                            int tx, float s[4][4],
                                            float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&Qs[4 * ty + i][d]);
      ov[i] = *reinterpret_cast<const float4*>(&dOs[4 * ty + i][d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(&Ks[tx + 16 * j][d]);
      vv[j] = *reinterpret_cast<const float4*>(&Vs[tx + 16 * j][d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                   qv[i].z * kv[j].z + qv[i].w * kv[j].w;
        dp[i][j] += ov[i].x * vv[j].x + ov[i].y * vv[j].y +
                    ov[i].z * vv[j].z + ov[i].w * vv[j].w;
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, BwdParams p,
                     const uint64_t* __restrict__ seed) {
  constexpr int LD = HD + 4;
  constexpr int CPT = HD / 4;     // head columns per thread
  extern __shared__ __align__(16) float smem[];
  float (*Ks)[LD] = reinterpret_cast<float (*)[LD]>(smem);
  float (*Vs)[LD] = Ks + BK;
  float (*Qs)[LD] = Vs + BK;
  float (*dOs)[LD] = Qs + BQ;
  float (*PT)[LP] = reinterpret_cast<float (*)[LP]>(dOs + BQ);
  float (*DS)[LP] = PT + BQ;
  float* Lse = reinterpret_cast<float*>(DS + BQ);
  float* Dl = Lse + BQ;
  float* Flag = Dl + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int D = p.H * HD;
  const int Sq = p.Sq, S = p.S;

  const T* qb = q + (size_t)b * Sq * D + h * HD;
  const T* ob = dout + (size_t)b * Sq * D + h * HD;
  const T* kb = k + (size_t)b * S * D + h * HD;
  const T* vb = v + (size_t)b * S * D + h * HD;
  const uint8_t* mb = mask ? mask + (size_t)b * S : nullptr;
  const uint64_t sd = p.drop_q > 0 ? *seed : 0;

  load_tile<T, HD, LD>(Ks, kb, k0, S, D);
  load_tile<T, HD, LD>(Vs, vb, k0, S, D);
  if (tid < BK) Flag[tid] = key_flag(mb, k0 + tid, S);

  const int kk = tid / 4;              // accumulated key of this thread
  const int c0 = (tid % 4) * CPT;      // its first head column
  float dk_acc[CPT], dv_acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();   // the previous query tile's Qs/dOs/PT/DS are consumed
    load_tile<T, HD, LD>(Qs, qb, q0, Sq, D);
    load_tile<T, HD, LD>(dOs, ob, q0, Sq, D);
    if (tid < BQ) {
      const int row = q0 + tid;
      Lse[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
      Dl[tid] = row < Sq ? dsum[(size_t)bh * Sq + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    score_block<HD, LD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int row = q0 + r;
      const uint64_t pk = p.drop_q > 0 ? attn_drop_pair_key(sd, bh, row / 2)
                                       : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        grad_pair(p, row < Sq, Flag[c], s[i][j], dp[i][j], Lse[r], Dl[r], pk,
                  row, k0 + c, &PT[r][c], &DS[r][c]);
      }
    }
    __syncthreads();   // PT, DS complete

    // dV[kk] += sum_r PT[r][kk] dO[r];  dK[kk] += sum_r DS[r][kk] Q[r]
    for (int r = 0; r < BQ; ++r) {
      const float pt = PT[r][kk];
      const float ds = DS[r][kk];
#pragma unroll
      for (int c = 0; c < CPT; c += 4) {
        const float4 o4 = *reinterpret_cast<const float4*>(&dOs[r][c0 + c]);
        const float4 q4 = *reinterpret_cast<const float4*>(&Qs[r][c0 + c]);
        dv_acc[c] += pt * o4.x; dv_acc[c + 1] += pt * o4.y;
        dv_acc[c + 2] += pt * o4.z; dv_acc[c + 3] += pt * o4.w;
        dk_acc[c] += ds * q4.x; dk_acc[c + 1] += ds * q4.y;
        dk_acc[c + 2] += ds * q4.z; dk_acc[c + 3] += ds * q4.w;
      }
    }
  }

  const int key = k0 + kk;
  if (key < S) {
    const size_t off = ((size_t)b * S + key) * D + h * HD + c0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store_elem(dk + off + c, dk_acc[c] * p.scale);
      store_elem(dv + off + c, dv_acc[c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    BwdParams p, const uint64_t* __restrict__ seed) {
  constexpr int LD = HD + 4;
  constexpr int CPT = HD / 4;
  extern __shared__ __align__(16) float smem[];
  float (*Qs)[LD] = reinterpret_cast<float (*)[LD]>(smem);
  float (*dOs)[LD] = Qs + BQ;
  float (*Ks)[LD] = dOs + BQ;
  float (*Vs)[LD] = Ks + BK;
  float (*DS)[LP] = reinterpret_cast<float (*)[LP]>(Vs + BK);
  float* Lse = reinterpret_cast<float*>(DS + BQ);
  float* Dl = Lse + BQ;
  float* Flag = Dl + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int D = p.H * HD;
  const int Sq = p.Sq, S = p.S;

  const T* qb = q + (size_t)b * Sq * D + h * HD;
  const T* ob = dout + (size_t)b * Sq * D + h * HD;
  const T* kb = k + (size_t)b * S * D + h * HD;
  const T* vb = v + (size_t)b * S * D + h * HD;
  const uint8_t* mb = mask ? mask + (size_t)b * S : nullptr;

  load_tile<T, HD, LD>(Qs, qb, q0, Sq, D);
  load_tile<T, HD, LD>(dOs, ob, q0, Sq, D);
  if (tid < BQ) {
    const int row = q0 + tid;
    Lse[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    Dl[tid] = row < Sq ? dsum[(size_t)bh * Sq + row] : 0.f;
  }
  uint64_t pair_key[2] = {0, 0};   // rows 4*ty .. 4*ty+3: two row pairs
  if (p.drop_q > 0) {
    const uint64_t sd = *seed;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      pair_key[i] = attn_drop_pair_key(sd, bh, (q0 + 4 * ty) / 2 + i);
  }

  const int rr = tid / 4;              // accumulated row of this thread
  const int c0 = (tid % 4) * CPT;
  float dq_acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dq_acc[c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();   // the previous key tile's Ks/Vs/DS/Flag are consumed
    load_tile<T, HD, LD>(Ks, kb, k0, S, D);
    load_tile<T, HD, LD>(Vs, vb, k0, S, D);
    if (tid < BK) Flag[tid] = key_flag(mb, k0 + tid, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_block<HD, LD>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float pt;
        grad_pair(p, q0 + r < Sq, Flag[c], s[i][j], dp[i][j], Lse[r], Dl[r],
                  pair_key[i / 2], q0 + r, k0 + c, &pt, &DS[r][c]);
      }
    }
    __syncthreads();   // DS complete

    // dQ[rr] += sum_key DS[rr][key] K[key]
    for (int kc = 0; kc < BK; ++kc) {
      const float ds = DS[rr][kc];
#pragma unroll
      for (int c = 0; c < CPT; c += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&Ks[kc][c0 + c]);
        dq_acc[c] += ds * k4.x; dq_acc[c + 1] += ds * k4.y;
        dq_acc[c + 2] += ds * k4.z; dq_acc[c + 3] += ds * k4.w;
      }
    }
  }

  const int row = q0 + rr;
  if (row < Sq) {
    const size_t off = ((size_t)b * Sq + row) * D + h * HD + c0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store_elem(dq + off + c, dq_acc[c] * p.scale);
  }
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * TILE * (HD + 4) + 2 * TILE * LP + 3 * TILE);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * TILE * (HD + 4) + TILE * LP + 3 * TILE);
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const uint8_t* mask, const void* dout, const float* lse,
                       const float* dsum, void* dk, void* dv, BwdParams p,
                       int B, const uint64_t* seed, cudaStream_t stream) {
  static const cudaError_t attr =
      allow_smem(flash_bwd_dkv_kernel<T, HD>, dkv_smem_bytes<HD>());
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.S + BK - 1) / BK, B * p.H);
  flash_bwd_dkv_kernel<T, HD><<<grid, THREADS, dkv_smem_bytes<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), p, seed);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const uint8_t* mask, const void* dout, const float* lse,
                      const float* dsum, void* dq, BwdParams p, int B,
                      const uint64_t* seed, cudaStream_t stream) {
  static const cudaError_t attr =
      allow_smem(flash_bwd_dq_kernel<T, HD>, dq_smem_bytes<HD>());
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  flash_bwd_dq_kernel<T, HD><<<grid, THREADS, dq_smem_bytes<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), p, seed);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout as the forward's inputs and output (dtype 0 = float32 only:
// bfloat16 has the tensor-core entries of flash_attn_bwd_tc.cu; hd 16 or
// 32); mask [B, S] u8 or null; lse and dsum [B, H, Sq] f32; dk, dv like k;
// dq like q. drop_q and seed as given to the forward. Each returns a
// cudaError_t (0 = launched).
#define TOIST_DISPATCH(FN, ...)                                              \
  if (dtype == 0 && hd == 32) return FN<float, 32>(__VA_ARGS__);             \
  if (dtype == 0 && hd == 16) return FN<float, 16>(__VA_ARGS__);             \
  return (int)cudaErrorInvalidValue;

extern "C" int toist_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
    int B, int H, int Sq, int S, int hd, int dtype, int drop_q,
    const void* seed, void* stream) {
  BwdParams p;
  if (!make_params(B, H, Sq, S, hd, drop_q, seed, &p))
    return (int)cudaErrorInvalidValue;
  TOIST_DISPATCH(launch_dkv, q, k, v, static_cast<const uint8_t*>(mask), dout,
                 static_cast<const float*>(lse),
                 static_cast<const float*>(dsum), dk, dv, p, B,
                 static_cast<const uint64_t*>(seed),
                 static_cast<cudaStream_t>(stream))
}

extern "C" int toist_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* dsum, void* dq, int B,
    int H, int Sq, int S, int hd, int dtype, int drop_q, const void* seed,
    void* stream) {
  BwdParams p;
  if (!make_params(B, H, Sq, S, hd, drop_q, seed, &p))
    return (int)cudaErrorInvalidValue;
  TOIST_DISPATCH(launch_dq, q, k, v, static_cast<const uint8_t*>(mask), dout,
                 static_cast<const float*>(lse),
                 static_cast<const float*>(dsum), dq, p, B,
                 static_cast<const uint64_t*>(seed),
                 static_cast<cudaStream_t>(stream))
}
