// Exact linear-sum assignment on the card: one CTA per problem.
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
// What bounds it: latency, not bytes or FLOPs. The matcher's problems are
// [6 levels * B, 25, 100] f32 (10 KB each); a solve is a chain of dependent
// relaxation steps, each an O(C) relaxation and a masked arg-min over the C
// columns. The cost matrix, duals and scan state live in shared memory for
// the whole solve; 128 threads relax the columns in parallel and the arg-min
// is a warp-shuffle reduction across the block (ties to the lowest index, as
// jnp.argmin), so one step costs a few block barriers. All problems of a
// batch run concurrently, one per SM.
//
// Floating-point order follows lsa.py: r = ((minval + cost) - u_i) - v_j,
// u += minval, u = (u + minval) - shortest[col], v -= (minval - shortest).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float BIG = 1e30f;   // tentative distance of an unreached column
constexpr float CUT = 5e29f;   // minval >= CUT: nothing reachable

struct ArgMin {
  float v;
  int i;
};

__device__ __forceinline__ ArgMin pick(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin o;
    o.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, x.i, off);
    x = pick(x, o);
  }
  return x;
}

// Block-wide arg-min; every thread gets the result. red holds WARPS + 1
// entries.
__device__ ArgMin block_argmin(ArgMin x, ArgMin* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  x = warp_argmin(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    ArgMin y = lane < WARPS ? red[lane] : ArgMin{BIG, 0x7fffffff};
    y = warp_argmin(y);
    if (lane == 0) red[WARPS] = y;
  }
  __syncthreads();
  return red[WARPS];
}

__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float y = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, off));
    if (lane == 0) red[WARPS] = y;
  }
  __syncthreads();
  return red[WARPS];
}

size_t smem_bytes(int R, int C) {
  // cost[R*C], v[C], shortest[C], u[R] (floats); path[C], row4col[C],
  // sc[C], col4row[R], sr[R], best[R] (ints).
  return sizeof(float) * ((size_t)R * C + 2 * C + R) +
         sizeof(int) * (3 * (size_t)C + 3 * R);
}

__global__ void __launch_bounds__(THREADS)
lsa_kernel(const float* __restrict__ cost_g, const int* __restrict__ n_rows_g,
           int* __restrict__ out, int R, int C) {
  extern __shared__ __align__(16) float sm[];
  float* cost = sm;
  float* v = cost + (size_t)R * C;
  float* shortest = v + C;
  float* u = shortest + C;
  int* path = reinterpret_cast<int*>(u + R);
  int* row4col = path + C;
  int* sc = row4col + C;
  int* col4row = sc + C;
  int* sr = col4row + R;
  int* best = sr + R;
  __shared__ ArgMin red[WARPS + 1];
  __shared__ float fred[WARPS + 1];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x;
  const int n = min(max(n_rows_g[b], 0), R);
  const float* cg = cost_g + (size_t)b * R * C;

  // 1. Load and sanitise.
  float mx = 0.f;
  for (int e = tid; e < R * C; e += THREADS) {
    const float c = cg[e];
    cost[e] = c;
    if (isfinite(c)) mx = fmaxf(mx, fabsf(c));
  }
  const float big = (block_max(mx, fred) + 1.0f) * (float)(R + 1);
  for (int e = tid; e < R * C; e += THREADS)
    if (!isfinite(cost[e])) cost[e] = big;
  for (int j = tid; j < C; j += THREADS) {
    v[j] = 0.f;
    row4col[j] = 0x7fffffff;
  }
  __syncthreads();

  // 2. Row-reduction warm start: one warp per row.
  for (int r = warp; r < R; r += WARPS) {
    ArgMin m{BIG, 0x7fffffff};
    for (int j = lane; j < C; j += 32) m = pick(m, ArgMin{cost[r * C + j], j});
    m = warp_argmin(m);
    if (lane == 0) {
      best[r] = m.i;
      u[r] = r < n ? m.v : 0.f;
    }
  }
  __syncthreads();
  for (int r = tid; r < n; r += THREADS) atomicMin(&row4col[best[r]], r);
  __syncthreads();
  for (int j = tid; j < C; j += THREADS)
    if (row4col[j] == 0x7fffffff) row4col[j] = -1;
  __syncthreads();
  for (int r = tid; r < R; r += THREADS)
    col4row[r] = r < n && row4col[best[r]] == r ? best[r] : -1;
  __syncthreads();

  // 3. One shortest augmenting path per row the warm start left unmatched.
  for (int cur = 0; cur < n; ++cur) {
    if (col4row[cur] >= 0) continue;   // uniform: read after a barrier
    for (int j = tid; j < C; j += THREADS) {
      shortest[j] = BIG;
      path[j] = -1;
      sc[j] = 0;
    }
    for (int r = tid; r < R; r += THREADS) sr[r] = 0;
    __syncthreads();

    int i = cur, sink = -1;
    float minval = 0.f;
    while (sink < 0 && minval < CUT) {
      if (tid == 0) sr[i] = 1;
      const float ui = u[i];
      const float* ci = cost + (size_t)i * C;
      ArgMin cand{BIG, 0x7fffffff};
      // Column j is touched only by thread j % THREADS until the barrier
      // after the scan, so shortest/path/sc need no barrier in between.
      for (int j = tid; j < C; j += THREADS) {
        if (!sc[j]) {
          const float r = minval + ci[j] - ui - v[j];
          if (r < shortest[j]) {
            path[j] = i;
            shortest[j] = r;
          }
        }
        cand = pick(cand, ArgMin{sc[j] ? BIG : shortest[j], j});
      }
      const ArgMin m = block_argmin(cand, red);
      const int j = m.i;
      minval = m.v;
      if (tid == j % THREADS) sc[j] = 1;
      const int owner = row4col[j];
      const bool free_col = owner < 0 && minval < CUT;
      sink = free_col ? j : -1;
      i = free_col ? i : owner;
    }
    __syncthreads();   // shortest, path, sc, sr complete

    if (sink >= 0) {
      for (int r = tid; r < R; r += THREADS) {
        if (r == cur)
          u[r] = u[r] + minval;
        else if (sr[r])
          u[r] = u[r] + minval - shortest[col4row[r]];
      }
      for (int j = tid; j < C; j += THREADS)
        if (sc[j]) v[j] = v[j] - (minval - shortest[j]);
      __syncthreads();   // the dual update read col4row before it changes
      if (tid == 0) {
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
    }
    __syncthreads();
  }

  for (int r = tid; r < R; r += THREADS)
    out[(size_t)b * R + r] = r < n ? col4row[r] : -1;
}

}  // namespace

// cost [B, R, C] f32 (R <= C), n_rows [B] int32 -> col4row [B, R] int32, on
// one stream. Returns a cudaError_t (0 = launched).
extern "C" int toist_lsa_solve_batch(const void* cost, const void* n_rows,
                                     void* col4row, int B, int R, int C,
                                     void* stream) {
  if (B <= 0 || B > 2147483647 || R <= 0 || C <= 0 || R > C)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(R, C);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  lsa_kernel<<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_rows),
      static_cast<int*>(col4row), R, C);
  return (int)cudaGetLastError();
}
