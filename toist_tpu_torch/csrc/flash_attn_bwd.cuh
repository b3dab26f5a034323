// The parameters and the semantics shared by the two routes of the
// flash-attention backward: the f32 scalar kernels (flash_attn_bwd.cu) and
// the bf16 tensor-core kernels (flash_attn_bwd_tc.cu).
//
// With
//     s  = q.k * scale * log2(e)        (NEG_INF * log2(e) for a masked key)
//     P  = exp2(s - lse)                 (lse saved by the forward, base 2)
//     M  = keep / (1 - q/256)            (1 without dropout)
//     dP = dO V^T,   D = rowsum(dO o O)  (D computed by the caller)
//     dS = P o (dP o M - D)              (0 for a masked key)
// the kernels compute dV = (P o M)^T dO, dK = scale * dS^T Q and
// dQ = scale * dS K, accumulating in f32 and storing in the input dtype.
//
// Masked keys: the forward replaces a masked logit by NEG_INF, as the plain
// version's masked_fill does, and masked_fill passes no gradient to q or k
// through a masked key. So dS is 0 there, unlike the TPU kernel's additive
// bias (which sends a gradient through the fully masked rows of a padded
// sample). A fully masked row softmaxes uniformly over its S real keys; its
// saved lse = NEG_INF*log2(e) + log2(S) rounds to NEG_INF*log2(e) in f32, so
// exp2(s - lse) would give 1, not 1/S. Such a row (lse below half of
// NEG_INF*log2(e), which no real logit reaches) takes P = 1/S directly.
// Keys past S have P = 0: bounds checks as in the forward, no padding.
#pragma once

#include "attn_dropout.cuh"
#include "flash_attn_common.cuh"

namespace {

struct BwdParams {
  int H, Sq, S;
  float scale;        // 1 / sqrt(hd)
  float scale_log2;   // scale * log2(e)
  float inv_S;        // P of every key in a fully masked row
  int drop_q;
  float drop_scale;
};

bool make_params(int B, int H, int Sq, int S, int hd, int drop_q,
                 const void* seed, BwdParams* p) {
  if (B <= 0 || H <= 0 || Sq <= 0 || S <= 0 || B * H > 65535 || drop_q < 0 ||
      drop_q > 255 || (drop_q > 0 && seed == nullptr))
    return false;
  p->H = H;
  p->Sq = Sq;
  p->S = S;
  p->scale = 1.f / sqrtf((float)hd);
  p->scale_log2 = LOG2E / sqrtf((float)hd);
  p->inv_S = 1.f / (float)S;
  p->drop_q = drop_q;
  p->drop_scale = (float)(1.0 / (1.0 - drop_q / 256.0));
  return true;
}

}  // namespace
