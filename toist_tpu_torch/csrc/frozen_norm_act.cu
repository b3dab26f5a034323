// The ResNet trunk's per-convolution epilogue in one pass: frozen BatchNorm,
// the residual (an identity or the downsample convolution under its own
// frozen norm), ReLU and the stage's pad mask, over a channels-last tensor.
//
// Replaces no TPU kernel: XLA fuses `x * scale + shift`, the add, the ReLU
// and the mask into the convolution's consumer on the TPU
// (toist_tpu/models/resnet.py). In eager PyTorch each was a pass of its own;
// the per-channel broadcast over a channels-last tensor went to the strided,
// un-vectorized `elementwise_kernel<128, 4>`, two passes per norm.
//
// Forward, over z [B, H, W, C] (NHWC memory; P = B*H*W pixel rows of C):
//   y = relu(z * s[c] + b[c] (+ r | + z_ds * s_ds[c] + b_ds[c])) * keep[p]
//   s = weight / sqrt(var + eps), b = bias - mean * s, in f32 from the norm's
//   four buffers (bf16 or f32) in the order FrozenBatchNorm2d computes them;
//   keep[p] = !pad_mask[b, floor(h * sy), floor(w * sx)] (the image-level
//   mask read at the feature stride, downsample_mask's index rule; sy, sx the
//   f32 ratios of image to feature size). In f32 and in the modules' order
//   (z * s, + b, + the residual or z_ds * s_ds + b_ds), each step rounded to
//   nearest with no contraction, then one rounding to the storage type on
//   store: in f32 that is the plain route bit for bit.
// Backward: dz = g * [y > 0] * s, and dr = g * [y > 0] (residual) or
//   dz_ds = g * [y > 0] * s_ds (downsample pair). [y > 0] folds in the ReLU
//   and the mask, as relu's own backward reads its output.
//
// What bounds it: bytes. 4-6 bytes an element in bf16 against a handful of
// FLOPs. The design:
//   - 16-byte vector loads and stores along C, the contiguous dimension (8
//     bf16 or 4 f32 a thread), so a warp moves 512 contiguous bytes;
//   - a thread's channel slice is fixed: its s and b (and s_ds, b_ds) are
//     computed once from the buffers and kept in registers across a
//     grid-stride loop over pixel rows, unrolled 4 deep with every load issued
//     before the arithmetic;
//   - a block holds `rows` pixel rows of up to 256 channel vectors; wider
//     tensors take more blocks along grid y. No shared memory, no barrier.
// The buffers are read on every call, so an in-place load_state_dict is seen
// by the next launch and by a CUDA graph that captured one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads of a block
constexpr int kUnroll = 4;      // pixel rows in flight per thread

// 16 bytes of T as V floats.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ uint4 raw(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(uint4 q, float* v) {
    v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ uint4 raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(uint4 q, float* v) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is a shift into the high half: exact.
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 q;
    uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

__device__ __forceinline__ float buffer_at(const void* p, int bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// One frozen norm's four buffers and eps.
struct Norm {
  const void* weight;
  const void* bias;
  const void* mean;
  const void* var;
  float eps;
};

// s and b of channel c in FrozenBatchNorm2d's f32 order, with no
// contraction: scale = weight / sqrt(var + eps); shift = bias - mean * scale.
__device__ __forceinline__ void scale_shift(const Norm& n, int bf16, int c,
                                            float* s, float* b) {
  const float sc = __fdiv_rn(buffer_at(n.weight, bf16, c),
                             __fsqrt_rn(__fadd_rn(buffer_at(n.var, bf16, c),
                                                  n.eps)));
  *s = sc;
  if (b) *b = __fsub_rn(buffer_at(n.bias, bf16, c),
                        __fmul_rn(buffer_at(n.mean, bf16, c), sc));
}

struct Geometry {
  long long P;    // pixel rows B*H*W
  int C;          // channels
  int cvecs;      // C / V
  int cvb;        // channel vectors a block covers
  int rows;       // pixel rows a block covers
  int H, W;       // feature size
  int Hi, Wi;     // image (mask) size
  float sy, sx;   // image rows (columns) per feature row (column)
};

__device__ __forceinline__ float keep_of(const uint8_t* mask,
                                         const Geometry& g, long long p) {
  const long long hw = (long long)g.H * g.W;
  const long long bi = p / hw;
  const int rem = (int)(p - bi * hw);
  const int h = rem / g.W;
  const int w = rem - h * g.W;
  // downsample_mask: (arange(h) * (H / h)).long() in f32.
  int yi = (int)__fmul_rn((float)h, g.sy);
  int xi = (int)__fmul_rn((float)w, g.sx);
  yi = min(yi, g.Hi - 1);
  xi = min(xi, g.Wi - 1);
  return mask[(bi * g.Hi + yi) * g.Wi + xi] ? 0.f : 1.f;
}

// MODE 0: norm + ReLU; 1: + residual r; 2: + the downsample pair.
template <typename T, int MODE, bool MASK>
__global__ void __launch_bounds__(kThreads)
frozen_norm_act_fwd_kernel(const T* __restrict__ z, const T* __restrict__ r,
                           const T* __restrict__ zd,
                           const uint8_t* __restrict__ mask, Norm n, Norm nd,
                           int bf16_buffers, T* __restrict__ y, Geometry g) {
  constexpr int V = Pack<T>::V;
  const int cv = blockIdx.y * g.cvb + threadIdx.x % g.cvb;
  const int row = threadIdx.x / g.cvb;
  if (cv >= g.cvecs || row >= g.rows) return;
  const int c0 = cv * V;
  float s[V], b[V], sd[MODE == 2 ? V : 1], bd[MODE == 2 ? V : 1];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale_shift(n, bf16_buffers, c0 + i, &s[i], &b[i]);
    if constexpr (MODE == 2)
      scale_shift(nd, bf16_buffers, c0 + i, &sd[i], &bd[i]);
  }
  const long long stride = (long long)gridDim.x * g.rows;
  long long p = (long long)blockIdx.x * g.rows + row;
  for (; p < g.P; p += kUnroll * stride) {
    uint4 qz[kUnroll], qr[kUnroll];
    float kp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long pu = p + u * stride;
      if (pu < g.P) {
        const long long off = pu * g.C + c0;
        qz[u] = Pack<T>::raw(z + off);
        if constexpr (MODE == 1) qr[u] = Pack<T>::raw(r + off);
        if constexpr (MODE == 2) qr[u] = Pack<T>::raw(zd + off);
        kp[u] = MASK ? keep_of(mask, g, pu) : 1.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long pu = p + u * stride;
      if (pu >= g.P) break;
      float vz[V], vr[V], out[V];
      Pack<T>::unpack(qz[u], vz);
      if constexpr (MODE != 0) Pack<T>::unpack(qr[u], vr);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float v = __fadd_rn(__fmul_rn(vz[i], s[i]), b[i]);
        if constexpr (MODE == 1) v = __fadd_rn(v, vr[i]);
        if constexpr (MODE == 2)
          v = __fadd_rn(v, __fadd_rn(__fmul_rn(vr[i], sd[i]), bd[i]));
        v = v < 0.f ? 0.f : v;          // NaN passes, as torch.relu's
        out[i] = MASK ? v * kp[u] : v;
      }
      Pack<T>::store(y + pu * g.C + c0, out);
    }
  }
}

// MODE 0: dz; 1: dz and dr; 2: dz and dz_ds.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
frozen_norm_act_bwd_kernel(const T* __restrict__ y, const T* __restrict__ gr,
                           Norm n, Norm nd, int bf16_buffers,
                           T* __restrict__ dz, T* __restrict__ dx,
                           Geometry g) {
  constexpr int V = Pack<T>::V;
  const int cv = blockIdx.y * g.cvb + threadIdx.x % g.cvb;
  const int row = threadIdx.x / g.cvb;
  if (cv >= g.cvecs || row >= g.rows) return;
  const int c0 = cv * V;
  float s[V], sd[MODE == 2 ? V : 1];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale_shift(n, bf16_buffers, c0 + i, &s[i], nullptr);
    if constexpr (MODE == 2)
      scale_shift(nd, bf16_buffers, c0 + i, &sd[i], nullptr);
  }
  const long long stride = (long long)gridDim.x * g.rows;
  long long p = (long long)blockIdx.x * g.rows + row;
  for (; p < g.P; p += kUnroll * stride) {
    uint4 qy[kUnroll], qg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long pu = p + u * stride;
      if (pu < g.P) {
        const long long off = pu * g.C + c0;
        qy[u] = Pack<T>::raw(y + off);
        qg[u] = Pack<T>::raw(gr + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long pu = p + u * stride;
      if (pu >= g.P) break;
      float vy[V], vg[V], a[V], x[V];
      Pack<T>::unpack(qy[u], vy);
      Pack<T>::unpack(qg[u], vg);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gi = vy[i] > 0.f ? vg[i] : 0.f;
        a[i] = gi * s[i];
        if constexpr (MODE == 1) x[i] = gi;
        if constexpr (MODE == 2) x[i] = gi * sd[i];
      }
      const long long off = pu * g.C + c0;
      Pack<T>::store(dz + off, a);
      if constexpr (MODE != 0) Pack<T>::store(dx + off, x);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// The launch shape for P rows of C values of V a vector; false if C is not
// a whole number of vectors.
bool geometry(long long P, int C, int V, Geometry* g, dim3* grid,
              dim3* block) {
  if (P <= 0 || C <= 0 || C % V) return false;
  g->P = P;
  g->C = C;
  g->cvecs = C / V;
  g->cvb = g->cvecs < kThreads ? g->cvecs : kThreads;
  g->rows = kThreads / g->cvb;
  const int gy = (g->cvecs + g->cvb - 1) / g->cvb;
  const long long want = (P + (long long)g->rows * kUnroll - 1)
                         / ((long long)g->rows * kUnroll);
  long long cap = 8LL * sm_count() / gy;
  if (cap < 1) cap = 1;
  *grid = dim3((unsigned)(want < cap ? want : cap), gy);
  *block = dim3(g->rows * g->cvb);
  return true;
}

template <typename T>
int launch_fwd(const void* z, const void* r, const void* zd,
               const void* mask, Norm n, Norm nd, int bf16_buffers, void* y,
               Geometry g, dim3 grid, dim3 block, cudaStream_t s) {
  const T* tz = static_cast<const T*>(z);
  const T* tr = static_cast<const T*>(r);
  const T* td = static_cast<const T*>(zd);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  T* ty = static_cast<T*>(y);
  const int mode = r ? 1 : (zd ? 2 : 0);
#define TOIST_FNA_FWD(MODE, MASK)                                            \
  frozen_norm_act_fwd_kernel<T, MODE, MASK><<<grid, block, 0, s>>>(          \
      tz, tr, td, m, n, nd, bf16_buffers, ty, g)
  if (mask) {
    if (mode == 0) TOIST_FNA_FWD(0, true);
    else if (mode == 1) TOIST_FNA_FWD(1, true);
    else TOIST_FNA_FWD(2, true);
  } else {
    if (mode == 0) TOIST_FNA_FWD(0, false);
    else if (mode == 1) TOIST_FNA_FWD(1, false);
    else TOIST_FNA_FWD(2, false);
  }
#undef TOIST_FNA_FWD
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* y, const void* gr, Norm n, Norm nd,
               int bf16_buffers, void* dz, void* dr, void* dzd, Geometry g,
               dim3 grid, dim3 block, cudaStream_t s) {
  const T* ty = static_cast<const T*>(y);
  const T* tg = static_cast<const T*>(gr);
  T* a = static_cast<T*>(dz);
  if (dr) {
    frozen_norm_act_bwd_kernel<T, 1><<<grid, block, 0, s>>>(
        ty, tg, n, nd, bf16_buffers, a, static_cast<T*>(dr), g);
  } else if (dzd) {
    frozen_norm_act_bwd_kernel<T, 2><<<grid, block, 0, s>>>(
        ty, tg, n, nd, bf16_buffers, a, static_cast<T*>(dzd), g);
  } else {
    frozen_norm_act_bwd_kernel<T, 0><<<grid, block, 0, s>>>(
        ty, tg, n, nd, bf16_buffers, a, nullptr, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y = relu(z*s + b (+ r | + zd*sd + bd)) * keep, over P rows of C channels
// (NHWC). r and zd: null, or one of them. mask: null, or the [B, Hi, Wi]
// uint8 image pad mask (1 = pad) read at (floor(h*sy), floor(w*sx)) of the
// [B, H, W] feature grid. dtype: 0 f32, 1 bf16 (z, r, zd, y); bf16_buffers:
// the four buffers of both norms are bf16 (else f32). Returns a cudaError_t.
extern "C" int toist_frozen_norm_act_fwd(
    const void* z, const void* r, const void* zd, const void* mask,
    const void* weight, const void* bias, const void* mean, const void* var,
    float eps, const void* weight_ds, const void* bias_ds,
    const void* mean_ds, const void* var_ds, float eps_ds, void* y,
    long long P, int C, int H, int W, int Hi, int Wi, float sy, float sx,
    int dtype, int bf16_buffers, void* stream) {
  if (r && zd) return (int)cudaErrorInvalidValue;
  if (mask && (H <= 0 || W <= 0 || Hi <= 0 || Wi <= 0))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  dim3 grid, block;
  const int V = dtype == 1 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (!geometry(P, C, V, &g, &grid, &block))
    return (int)cudaErrorInvalidValue;
  g.H = H; g.W = W; g.Hi = Hi; g.Wi = Wi; g.sy = sy; g.sx = sx;
  const Norm n{weight, bias, mean, var, eps};
  const Norm nd{weight_ds, bias_ds, mean_ds, var_ds, eps_ds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(z, r, zd, mask, n, nd, bf16_buffers, y,
                                     g, grid, block, s);
  if (dtype == 0)
    return launch_fwd<float>(z, r, zd, mask, n, nd, bf16_buffers, y, g, grid,
                             block, s);
  return (int)cudaErrorInvalidValue;
}

// dz = g*[y>0]*s; with dr, dr = g*[y>0]; with dzd, dzd = g*[y>0]*sd (one of
// the two at most). Buffers as the forward's; only weight and var are read.
extern "C" int toist_frozen_norm_act_bwd(
    const void* y, const void* grad, const void* weight, const void* var,
    float eps, const void* weight_ds, const void* var_ds, float eps_ds,
    void* dz, void* dr, void* dzd, long long P, int C, int dtype,
    int bf16_buffers, void* stream) {
  if (dr && dzd) return (int)cudaErrorInvalidValue;
  Geometry g;
  dim3 grid, block;
  const int V = dtype == 1 ? Pack<__nv_bfloat16>::V : Pack<float>::V;
  if (!geometry(P, C, V, &g, &grid, &block))
    return (int)cudaErrorInvalidValue;
  const Norm n{weight, nullptr, nullptr, var, eps};
  const Norm nd{weight_ds, nullptr, nullptr, var_ds, eps_ds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(y, grad, n, nd, bf16_buffers, dz, dr,
                                     dzd, g, grid, block, s);
  if (dtype == 0)
    return launch_bwd<float>(y, grad, n, nd, bf16_buffers, dz, dr, dzd, g,
                             grid, block, s);
  return (int)cudaErrorInvalidValue;
}
