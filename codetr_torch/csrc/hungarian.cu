// Batched linear assignment (the Hungarian matching of the DINO losses) for
// Hopper (sm_90a).
//
// No TPU kernel: the JAX package solves each assignment on the device with
// optax.assignment.hungarian_algorithm (codetr_tpu/parallel/losses.py:116),
// a shortest-augmenting-path search inside lax.while_loop that XLA compiles.
// PyTorch has no device loop with a data-dependent exit, so the search is a
// kernel here.  It is the same algorithm (the e-maxx form optax uses):
//
//   for each valid row i, in index order:
//     p[0] = i, j0 = 0, minv = inf, used = {}
//     repeat:                                     (one Dijkstra step)
//       used += j0, i0 = p[j0]
//       for each column j not used:
//         cur = (cost[i0][j] - u[i0]) - v[j]
//         if cur < minv[j]: minv[j] = cur, way[j] = j0
//       delta, j1 = min, argmin over unused j of minv[j]  (lowest j on ties)
//       for used j: u[p[j]] += delta, v[j] -= delta
//       for unused j: minv[j] -= delta
//       j0 = j1
//     until p[j0] == 0
//     augment along way[] back to column 0
//
// Potentials and distances are fp64 (the cost is fp32, widened on read).
// The plain version (codetr_torch/ops/hungarian.py:linear_assignment_plain)
// does the same fp64 operations in the same order, so the two agree
// exactly, ties included.
//
// Each problem takes one of two branches, on V, its count of valid rows,
// which the block counts itself (a block reduction; no host read):
//   V <= C: the search over the valid rows only.  An invalid row of the
//     losses carries a flat cost, which cannot change the valid rows'
//     optimum, and solving it would put potentials near the flat cost (1e6)
//     beside costs of ~10.
//   V > C: optax's answer to a problem with more rows than columns: the
//     transposed problem, each of the C columns taking one of the R rows,
//     an invalid row's cost read as kInvalidCost.  The same search with the
//     strides swapped; a row no column takes gets 0.
// Either way every row searched has a free column, so a search ends within
// its column count of steps.  A step that finds no free column at a finite
// distance (non-finite costs) stops the problem, whose rows all get -1.
//
// Design: one thread block per problem; its threads split the columns.  A
// step is one pass over the columns (the minv update, fused with the
// previous step's "minv -= delta", and each thread's running (value, index)
// minimum), then a block-wide argmin by warp shuffles with the lowest-index
// tie rule, then one thread updates the potentials of the few used columns
// (at most one more than the rows assigned so far).  The per-column state
// (minv, v: fp64; way, p: int32; used: a byte; 25 bytes a column) sits in
// shared memory when it fits (the decoder's 900 queries), and otherwise in
// a global scratch the caller allocates, which the pass reads from L2 (the
// encoder's 30,785 or 73,656 queries: 0.8 or 1.8 MB a problem).
//
// What bounds it: neither bytes nor operations but the search's serial
// steps.  The work a step does grows with the columns, yet each step waits
// for the previous one's argmin, and a problem is one block on one SM.  The
// least the card could take is reading the valid rows' costs once
// (chip_smoke.py reports it); a step at 73,656 columns streams ~1.8 MB of
// state through one SM.  A cluster sharing the columns over several SMs
// is the design that would cut it.
//
// C entry points: hungarian_solve (launches; returns cudaGetLastError(), or
// a negative code for arguments the kernel does not take; does not
// synchronise), and hungarian_col_bytes / hungarian_uses_shared, which tell
// the caller how much global scratch to allocate.  A branch searches at
// most R rows (V > C only where R > C) over at most max(R, C) columns, and
// the state is sized so, for either branch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on H100
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kInvalidCost = 1e6f;  // a padding row's cost, transposed (ops/hungarian.py:INVALID_COST)

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// u (R + 1 doubles), the argmin's warp partials, the used-column list (R + 2),
// for R rows searched
__host__ __device__ inline size_t fixed_bytes(int R) {
  return align16(size_t(R + 1) * 8 + kMaxWarps * 8 + kMaxWarps * 4 + size_t(R + 2) * 4);
}

// minv, v (fp64), way, p (int32), used (byte) for columns 0..C searched
__host__ __device__ inline size_t col_bytes(int C) {
  return align16(size_t(C + 1) * (8 + 8 + 4 + 4 + 1));
}

__device__ inline bool before(double a, int ja, double b, int jb) {
  return a < b || (a == b && ja < jb);
}

// The search over the rows of an (nrows, ncols) problem: row i0 and column
// j at cost[(i0 - 1) * rs + (j - 1) * cs], the strides (rs, cs) being (C, 1)
// or, transposed, (1, C).  Returns false if a step found no free column at
// a finite distance.
template <bool kTransposed>
__device__ bool search(const float* __restrict__ cb, const unsigned char* __restrict__ valid, int C,
                       int nrows, int ncols, double* u, double* red_val, int* red_idx, int* used_list,
                       double* minv, double* v, int* way, int* p, unsigned char* used) {
  __shared__ int s_j0, s_nused, s_done;
  __shared__ double s_delta;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t rs = kTransposed ? 1 : size_t(C), cs = kTransposed ? size_t(C) : 1;

  for (int i = 1; i <= nrows; ++i) {
    if (!kTransposed && !valid[i - 1]) continue;  // the same for every thread
    if (tid == 0) {
      p[0] = i;
      s_j0 = 0;
      s_nused = 0;
    }
    bool first = true;
    double pending = 0.0;  // the last step's delta, not yet taken off minv
    for (;;) {
      if (tid == 0) {
        used[s_j0] = 1;
        used_list[s_nused++] = s_j0;
      }
      __syncthreads();
      const int j0 = s_j0;
      const int i0 = p[j0];
      const double ui0 = u[i0];
      const float* crow = cb + size_t(i0 - 1) * rs;
      double best = INFINITY;
      int best_j = INT_MAX;
      // ascending j within a thread, so a strict < keeps the lowest index
#pragma unroll 4
      for (int j = 1 + tid; j <= ncols; j += nt) {
        if (used[j]) continue;
        double m = first ? INFINITY : minv[j] - pending;
        const float c = kTransposed && !valid[j - 1] ? kInvalidCost : crow[size_t(j - 1) * cs];
        const double cur = (double(c) - ui0) - v[j];
        if (cur < m) {
          m = cur;
          way[j] = j0;
        }
        minv[j] = m;
        if (m < best) {
          best = m;
          best_j = j;
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const double ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
        if (before(ov, oj, best, best_j)) {
          best = ov;
          best_j = oj;
        }
      }
      if (lane == 0) {
        red_val[warp] = best;
        red_idx[warp] = best_j;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < nwarps ? red_val[lane] : INFINITY;
        best_j = lane < nwarps ? red_idx[lane] : INT_MAX;
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          const double ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
          if (before(ov, oj, best, best_j)) {
            best = ov;
            best_j = oj;
          }
        }
        if (lane == 0) {
          if (best_j == INT_MAX) {
            s_done = -1;  // no free column at a finite distance
          } else {
            const double delta = best;
            for (int k = 0; k < s_nused; ++k) {
              const int jc = used_list[k];
              u[p[jc]] += delta;
              v[jc] -= delta;
            }
            s_delta = delta;
            s_j0 = best_j;
            s_done = p[best_j] == 0;
          }
        }
      }
      __syncthreads();
      const int done = s_done;
      pending = s_delta;
      first = false;
      if (done < 0) return false;  // the same for every thread
      if (done) break;
    }
    __syncthreads();  // every thread has read s_done before it changes
    if (tid == 0) {
      int j0 = s_j0;
      do {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      } while (j0);
      for (int k = 0; k < s_nused; ++k) used[used_list[k]] = 0;
    }
    __syncthreads();
  }
  return true;
}

template <bool kShared>
__global__ void __launch_bounds__(1024)
hungarian_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_valid,
                 long long* __restrict__ cols, int R, int C, unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = R > C ? R : C;  // the most columns a branch searches
  const float* cb = cost + size_t(b) * R * C;
  const unsigned char* valid = row_valid + size_t(b) * R;
  long long* out = cols + size_t(b) * R;

  double* u = reinterpret_cast<double*>(smem);
  double* red_val = u + (R + 1);
  int* red_idx = reinterpret_cast<int*>(red_val + kMaxWarps);
  int* used_list = red_idx + kMaxWarps;
  unsigned char* col_base = kShared ? smem + fixed_bytes(R) : scratch + size_t(b) * col_bytes(N);
  double* minv = reinterpret_cast<double*>(col_base);
  double* v = minv + (N + 1);
  int* way = reinterpret_cast<int*>(v + (N + 1));
  int* p = way + (N + 1);
  unsigned char* used = reinterpret_cast<unsigned char*>(p + (N + 1));

  int V = 0;  // the valid rows, the same in every thread
  for (int r0 = 0; r0 < R; r0 += nt) V += __syncthreads_count(r0 + tid < R && valid[r0 + tid]);
  const bool transposed = V > C;
  const int nrows = transposed ? C : R, ncols = transposed ? R : C;

  for (int j = tid; j <= ncols; j += nt) {
    v[j] = 0.0;
    p[j] = 0;
    used[j] = 0;
  }
  for (int i = tid; i <= nrows; i += nt) u[i] = 0.0;
  for (int r = tid; r < R; r += nt) out[r] = 0;
  __syncthreads();

  const bool ok = transposed
      ? search<true>(cb, valid, C, nrows, ncols, u, red_val, red_idx, used_list, minv, v, way, p, used)
      : search<false>(cb, valid, C, nrows, ncols, u, red_val, red_idx, used_list, minv, v, way, p, used);
  if (!ok) {
    for (int r = tid; r < R; r += nt) out[r] = -1;
    return;
  }
  for (int j = 1 + tid; j <= ncols; j += nt) {
    if (!p[j]) continue;
    if (transposed) out[j - 1] = p[j] - 1;
    else out[p[j] - 1] = j - 1;
  }
}

// at most R rows and max(R, C) columns searched, whichever the branch
size_t smem_bytes(int R, int C, bool shared) {
  return fixed_bytes(R) + (shared ? col_bytes(R > C ? R : C) : 0);
}

}  // namespace

extern "C" {

// Global scratch bytes an (R, C) problem needs when its columns do not fit
// shared memory (the caller allocates P times this).
long long hungarian_col_bytes(int R, int C) { return (long long)col_bytes(R > C ? R : C); }

// 1 if the kernel keeps the per-column state of an (R, C) problem in shared
// memory (then it takes no scratch), else 0.
int hungarian_uses_shared(int R, int C) { return smem_bytes(R, C, true) <= kMaxSmem ? 1 : 0; }

// cost (P, R, C) fp32, row_valid (P, R) bytes, cols (P, R) int64 out, all
// contiguous on the device; scratch P * hungarian_col_bytes(R, C) bytes, or
// unused where hungarian_uses_shared.
int hungarian_solve(const float* cost, const unsigned char* row_valid, long long* cols, int P, int R,
                    int C, void* scratch, void* stream) {
  if (P <= 0 || R <= 0 || C <= 0) return -1;
  const bool shared = hungarian_uses_shared(R, C);
  const size_t smem = smem_bytes(R, C, shared);
  if (smem > kMaxSmem) return -2;
  if (!shared && scratch == nullptr) return -3;
  const int threads = (R > C ? R : C) > 8192 ? 1024 : 256;
  auto kern = shared ? hungarian_kernel<true> : hungarian_kernel<false>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kern<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, row_valid, cols, R, C, static_cast<unsigned char*>(scratch));
  return int(cudaGetLastError());
}

}  // extern "C"
