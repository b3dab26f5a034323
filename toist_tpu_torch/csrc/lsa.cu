// Exact linear-sum assignment on the card: one warp per problem.
//
// Replaces the TPU kernel `_kernel` (toist_tpu/ops/lsa_pallas.py, launched
// by `solve_lsa_batch_pallas`) and stands for the vmapped XLA solver
// `solve_lsa` (toist_tpu/ops/lsa.py) as well: its algorithm is lsa.py's, step
// for step, so on continuous costs (and on ties) it returns the JAX solver's
// assignment exactly:
//   1. non-finite costs become (max finite |cost| + 1) * (R + 1), a finite
//      sentinel above any all-finite assignment;
//   2. row-reduction warm start: u = row minima over the valid rows, v = 0,
//      each valid row claims its arg-min column (lowest index on ties) and a
//      column claimed by several rows goes to the lowest row;
//   3. for every valid row the warm start left unmatched, in row order, a
//      shortest augmenting path (Dijkstra over columns with dual potentials,
//      scipy's method), then the dual update and the augmentation.
// The scan stops on a found sink or when no unscanned column is reachable
// (minimum tentative distance >= CUT, the Pallas kernel's `_CUT` exit), so
// a matrix of NaN rows terminates; such a row is left unassigned (-1) rather
// than corrupting the duals. Rows at or past n_rows get -1.
//
// What bounds it: latency, not bytes or FLOPs. A solve is a chain of
// dependent steps (ops/lsa.py lsa_scan_steps counts them): each scan step
// relaxes the C columns from one row and takes a masked arg-min over them,
// whose column names the next row; each augmentation walks its path back
// one hop at a time. The kernel's time is the longest problem's steps times
// the latency of one step. The design keeps that latency short:
//   - one warp per problem (W problems per CTA, each in its own slice of
//     shared memory), so no step needs a block barrier: lanes of one warp
//     order their shared-memory traffic with __syncwarp alone;
//   - column j belongs to lane j % 32: its dual v, its tentative distance
//     and its scanned flag live in that lane's registers for C <= 128 (a
//     template on ceil(C / 32)), in shared memory that only that lane
//     touches for wider problems;
//   - a scan step has no branch per column: the lane loads its columns'
//     costs first; each column's tentative distance is kept as an
//     order-preserving integer key of the float, so a relaxation is one
//     integer minimum, and the lane's minimum is a two-level tree; two
//     redux.sync (the minimum key, then the lowest column that holds it)
//     give every lane the winner, ties to the lowest index as jnp.argmin.
//     What is left per step is two shared loads, two redux.sync and about
//     fifteen dependent ALU operations;
//   - the dual update needs no gather: the scanned rows other than the start
//     row are the owners of the scanned columns other than the sink, so the
//     lane that owns such a column updates its owner's u;
//   - the warm start takes no warp reductions: one lane per row, four
//     interleaved column streams; it also detects non-finite costs, and only
//     then is the matrix sanitised and the warm start run again;
//   - the costs are copied with cp.async, every copy in flight at once, 16
//     bytes each where alignment allows.
// Row state (u, col4row) and row4col, path (read by the serial path walk on
// lane 0) live in the problem's shared memory.
//
// Floating-point order follows lsa.py: r = ((minval + cost) - u_i) - v_j,
// u += minval, u = (u + minval) - shortest[col], v -= (minval - shortest).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;      // tentative distance of an unreached column
constexpr float CUT = 5e29f;      // minval >= CUT: nothing reachable
constexpr int REG_K = 4;          // columns per lane kept in registers
constexpr int MAX_WARPS = 8;      // problems per CTA
constexpr size_t MAX_SMEM = 232448;   // 227 KB, the most a block can take
// Words after a problem's state that the scan may read and ignore: it loads
// four columns per lane at a time without bounds checks.
constexpr int OVERREAD = 128;

// Order-preserving key of a float that is not NaN (a larger float, a larger
// key), and its inverse. -0 and +0 get different keys; the scan never makes
// -0: a round-to-nearest sum is -0 only if both terms are -0 and a
// difference only if it is -0 - (+0), and r = ((minval + c) - u) - v starts
// from minval, which is never -0 (it is +0 or an earlier r).
__device__ __forceinline__ unsigned fkey(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float fkey_value(unsigned k) {
  return __uint_as_float(k ^ ((unsigned)((int)~k >> 31) | 0x80000000u));
}

// (ka, ja) <- the smaller key of (ka, ja) and (kb, jb); on equal keys the
// first, whose column is the lower.
__device__ __forceinline__ void keep_min(unsigned& ka, int& ja, unsigned kb,
                                         int jb) {
  const bool take = kb < ka;
  ka = take ? kb : ka;
  ja = take ? jb : ja;
}

// The state of the lane's columns j = lane + 32 k: dual v, the key of the
// tentative distance (fkey) and the scanned flag. K > 0: registers
// (C <= 32 K).
template <int K>
struct Cols {
  float v_[K];
  unsigned sk_[K], sc_ = 0;
  __device__ Cols(float*, int, int) {
#pragma unroll
    for (int k = 0; k < K; ++k) v_[k] = 0.f;
  }
  __device__ float& v(int k) { return v_[k]; }
  __device__ unsigned& sk(int k) { return sk_[k]; }
  __device__ bool sc(int k) const { return (sc_ >> k) & 1u; }
  __device__ void set_sc(bool mine, int k) { sc_ |= (mine ? 1u : 0u) << k; }
  __device__ void reset(int) {
    sc_ = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) sk_[k] = fkey(BIG);
  }
};

// K = 0: C > 32 * REG_K; the same state in the problem's shared memory,
// where entry 32 k + lane is touched only by that lane.
template <>
struct Cols<0> {
  float* v_;
  unsigned *sk_, *sc_;
  __device__ Cols(float* base, int nk, int lane)
      : v_(base + lane),
        sk_(reinterpret_cast<unsigned*>(base + 32 * nk) + lane),
        sc_(reinterpret_cast<unsigned*>(base + 64 * nk) + lane) {
    for (int k = 0; k < nk; ++k) v_[32 * k] = 0.f;
  }
  __device__ float& v(int k) { return v_[32 * k]; }
  __device__ unsigned& sk(int k) { return sk_[32 * k]; }
  __device__ bool sc(int k) const { return sc_[32 * k] != 0; }
  __device__ void set_sc(bool mine, int k) {
    if (mine) sc_[32 * k] = 1;
  }
  __device__ void reset(int nk) {
    for (int k = 0; k < nk; ++k) {
      sc_[32 * k] = 0;
      sk_[32 * k] = fkey(BIG);
    }
  }
};

// 4-byte words of one problem's shared memory: cost[R*C], u[R], col4row[R],
// row4col[C], path[C], for K = 0 v, shortest, scanned [32 * nk] each, and
// OVERREAD; rounded up to 16 bytes.
__host__ __device__ size_t problem_words(int R, int C) {
  const size_t nk = (C + 31) / 32;
  size_t w = (size_t)R * C + 2 * (size_t)R + 2 * (size_t)C + OVERREAD;
  if (nk > REG_K) w += 3 * 32 * nk;
  return (w + 3) & ~(size_t)3;
}

// Row-reduction warm start, one lane per row (rows lane + 32 t): u = the
// row's minimum on valid rows (0 past n), col4row = its arg-min column,
// lowest on ties. Four interleaved column streams keep four compare chains
// in flight. Returns whether this lane met a non-finite cost.
__device__ __forceinline__ bool row_minima(const float* cost, int R, int C,
                                           int n, int lane, float* u,
                                           int* col4row) {
  unsigned abs_bits = 0;   // the largest |cost| bits: >= inf's if non-finite
  for (int r = lane; r < R; r += 32) {
    const float* row = cost + (size_t)r * C;
    float best[4];
    int bj[4];
    unsigned ab[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = min(q, C - 1);   // C < 4: a stream repeats column C - 1
      best[q] = row[j];
      bj[q] = j;
      ab[q] = __float_as_uint(best[q]) & 0x7fffffffu;
    }
    // Each stream meets its columns in order, so its first minimum stays.
    int c = 4;
    for (; c + 4 <= C; c += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = row[c + q];
        ab[q] = max(ab[q], __float_as_uint(x) & 0x7fffffffu);
        const bool take = x < best[q];
        best[q] = take ? x : best[q];
        bj[q] = take ? c + q : bj[q];
      }
    }
    for (; c < C; ++c) {
      const float x = row[c];
      ab[0] = max(ab[0], __float_as_uint(x) & 0x7fffffffu);
      const bool take = x < best[0] || (x == best[0] && c < bj[0]);
      best[0] = take ? x : best[0];
      bj[0] = take ? c : bj[0];
    }
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const bool take =
          best[q] < best[0] || (best[q] == best[0] && bj[q] < bj[0]);
      best[0] = take ? best[q] : best[0];
      bj[0] = take ? bj[q] : bj[0];
      ab[0] = max(ab[0], ab[q]);
    }
    col4row[r] = bj[0];
    u[r] = r < n ? best[0] : 0.f;
    abs_bits = max(abs_bits, ab[0]);
  }
  return abs_bits >= 0x7f800000u;
}

// One CTA per SM is the target: without the 1, ptxas aims for more and
// spills the shared-memory variant (K = 0).
template <int K>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
lsa_kernel(const float* __restrict__ cost_g, const int* __restrict__ n_rows_g,
           int* __restrict__ out, int B, int R, int C) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;   // no block barrier below: a warp may leave early
  const int nk = K > 0 ? K : (C + 31) / 32;
  float* cost = sm + (size_t)warp * problem_words(R, C);
  float* u = cost + (size_t)R * C;
  int* col4row = reinterpret_cast<int*>(u + R);
  int* row4col = col4row + R;
  int* path = row4col + C;
  Cols<K> cs(reinterpret_cast<float*>(path + C), nk, lane);
  const int n = min(max(n_rows_g[b], 0), R);
  const int RC = R * C;
  const float* cg = cost_g + (size_t)b * RC;

  // 1. Load: every lane's copies in flight at once (cp.async), 16 bytes
  // each where the problem is 16-byte aligned and a multiple of 4 floats.
  const unsigned dst = (unsigned)__cvta_generic_to_shared(cost);
  if ((RC & 3) == 0 && (reinterpret_cast<uintptr_t>(cg) & 15) == 0) {
    for (int e = lane; e < RC / 4; e += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + 16 * e),
                   "l"(cg + 4 * e));
  } else {
    for (int e = lane; e < RC; e += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       dst + 4 * e),
                   "l"(cg + e));
  }
  for (int j = lane; j < C; j += 32) row4col[j] = INT_MAX;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // 2. Row-reduction warm start; it also finds non-finite costs. If there
  // are any, sanitise and start again.
  if (__any_sync(FULL, row_minima(cost, R, C, n, lane, u, col4row))) {
    float mx = 0.f;
    for (int e = lane; e < RC; e += 32)
      if (isfinite(cost[e])) mx = fmaxf(mx, fabsf(cost[e]));
    // mx >= 0, so its bits order as its values.
    mx = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(mx)));
    const float big = (mx + 1.0f) * (float)(R + 1);
    __syncwarp();
    for (int e = lane; e < RC; e += 32)
      if (!isfinite(cost[e])) cost[e] = big;
    __syncwarp();
    row_minima(cost, R, C, n, lane, u, col4row);
  }
  __syncwarp();
  // Each valid row claims its arg-min column; the lowest row wins.
  for (int r = lane; r < n; r += 32) atomicMin(&row4col[col4row[r]], r);
  __syncwarp();
  for (int j = lane; j < C; j += 32)
    if (row4col[j] == INT_MAX) row4col[j] = -1;
  __syncwarp();
  for (int r = lane; r < R; r += 32) {
    const int bj = col4row[r];
    col4row[r] = r < n && row4col[bj] == r ? bj : -1;
  }
  __syncwarp();

  // 3. One shortest augmenting path per row the warm start left unmatched.
  const float* cost_lane = cost + lane;
  // The row stride in a register: the scan's address chain then does not
  // start with a constant-bank load.
  const int stride = __shfl_sync(FULL, C, 0);
  for (int cur = 0; cur < n; ++cur) {
    if (col4row[cur] >= 0) continue;   // the same value in every lane
    cs.reset(nk);
    int i = cur, sink = -1;
    float minval = 0.f;
    while (true) {
      const float* ci = cost_lane + i * stride;
      const float ui = u[i];
      unsigned bkey = FULL;
      int bj = INT_MAX;
      // Four columns per lane at a time: their loads first, no branches,
      // then a two-level minimum. A relaxation is the minimum of two keys.
      // Columns past C read what follows the row and are not taken;
      // scanned columns keep their distance and are not taken either.
      for (int k0 = 0; k0 < nk; k0 += 4) {
        float c[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) c[t] = ci[32 * (k0 + t)];
        unsigned key[4];
        int jj[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = k0 + t, j = lane + 32 * k;
          key[t] = FULL;
          jj[t] = INT_MAX;
          if (k < nk) {
            const bool open = j < C && !cs.sc(k);
            const unsigned kr = fkey(((minval + c[t]) - ui) - cs.v(k));
            const unsigned ks = cs.sk(k);
            if (open && kr < ks) path[j] = i;
            const unsigned m = min(kr, ks);
            cs.sk(k) = open ? m : ks;
            key[t] = open ? m : FULL;
            jj[t] = j;
          }
        }
        keep_min(key[0], jj[0], key[1], jj[1]);
        keep_min(key[2], jj[2], key[3], jj[3]);
        keep_min(key[0], jj[0], key[2], jj[2]);
        keep_min(bkey, bj, key[0], jj[0]);
      }
      // The warp's minimum key, then the lowest column that holds it.
      const unsigned kmin = __reduce_min_sync(FULL, bkey);
      const int j =
          (int)__reduce_min_sync(FULL, bkey == kmin ? (unsigned)bj : FULL);
      minval = fkey_value(kmin);
      cs.set_sc(lane == (j & 31), j >> 5);
      if (!(minval < CUT)) break;   // nothing reachable: cur stays -1
      const int owner = row4col[j];
      if (owner < 0) {
        sink = j;
        break;
      }
      i = owner;
    }
    if (sink < 0) continue;

    // Dual update. The scanned rows are cur and the owners of the scanned
    // columns other than the sink (col4row[owner] is that column). Four
    // columns per lane at a time, their loads first.
    if (lane == 0) u[cur] = u[cur] + minval;
    for (int k0 = 0; k0 < nk; k0 += 4) {
      int r[4];
      float ur[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + t, j = lane + 32 * k;
        r[t] = k < nk && j < C && cs.sc(k) && j != sink ? row4col[j] : -1;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) ur[t] = r[t] >= 0 ? u[r[t]] : 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + t, j = lane + 32 * k;
        if (k < nk && j < C && cs.sc(k)) {
          const float s = fkey_value(cs.sk(k));
          if (r[t] >= 0) u[r[t]] = (ur[t] + minval) - s;
          cs.v(k) = cs.v(k) - (minval - s);
        }
      }
    }
    __syncwarp();   // path and row4col as the scan and the update left them
    if (lane == 0) {
      int j = sink;
      for (int hops = 0; hops <= R; ++hops) {
        const int r = path[j];
        row4col[j] = r;
        const int prev = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = prev;
      }
    }
    __syncwarp();   // the augmented matching and u, for every lane
  }

  for (int r = lane; r < R; r += 32)
    out[(size_t)b * R + r] = r < n ? col4row[r] : -1;
}

template <int K>
int launch(const float* cost, const int* n_rows, int* col4row, int B, int R,
           int C, cudaStream_t stream) {
  const size_t bytes = problem_words(R, C) * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Enough CTAs for every SM before a CTA takes a second problem.
  int w = B / sms;
  w = w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
  while (w > 1 && w * bytes > MAX_SMEM) --w;
  const size_t smem = w * bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lsa_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lsa_kernel<K><<<(B + w - 1) / w, 32 * w, smem, stream>>>(cost, n_rows,
                                                          col4row, B, R, C);
  return (int)cudaGetLastError();
}

}  // namespace

// cost [B, R, C] f32 (R <= C), n_rows [B] int32 -> col4row [B, R] int32, on
// one stream. Returns a cudaError_t (0 = launched).
extern "C" int toist_lsa_solve_batch(const void* cost, const void* n_rows,
                                     void* col4row, int B, int R, int C,
                                     void* stream) {
  if (B <= 0 || R <= 0 || C <= 0 || R > C) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cost);
  const int* n = static_cast<const int*>(n_rows);
  int* o = static_cast<int*>(col4row);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 31) / 32) {
    case 1: return launch<1>(c, n, o, B, R, C, s);
    case 2: return launch<2>(c, n, o, B, R, C, s);
    case 3: return launch<3>(c, n, o, B, R, C, s);
    case 4: return launch<4>(c, n, o, B, R, C, s);
    default: return launch<0>(c, n, o, B, R, C, s);
  }
}
