// Shift-window grid-query MSDA forward for Hopper (sm_90a): kernel K4.
//
// Replaces codetr_tpu/ops/msda_pallas.py:466 (the pallas_call of
// _pallas_impl, tile body _pair_kernel), the research encoder kernel behind
// the JAX impl="grid_pallas", and computes the same function as its XLA
// twin codetr_tpu/ops/msda_grid.py:msda_grid_shift_qm (impl="grid").  The
// queries are the level-concatenated pixel grid.  For query q on level lq
// and target level lt, the pair (lq, lt) has a window half-width R and
// integer anchors per query row and column; window cell c of an axis is the
// target row (column) anchor + c - (R + 1), c in [0, W - 1], W = 2R + 3.  A
// tap at normalised x has the window coordinate
//   t = (x * Wt - 0.5) - anchor + (R + 1)      (each step rounded in fp32)
// and its two bilinear corners on that axis are the cells floor(t) and
// floor(t) + 1, with hats 1 - frac and frac.  A corner contributes only if
// its cells lie in the window and its target row and column in the level:
// the truncated function the TPU kernel computes.  The host builds the
// anchors (idealised power-of-2 anchors, or the coarse-pair escape's true
// rational ones where a pair's window exceeds max_window) and R per pair;
// the kernel does not know which kind it reads.
//
// What the TPU kernel's design is for, and why this one differs: a TPU
// cannot gather, so _pallas_impl DMAs each target level into VMEM, builds a
// tile's window slab with two 0/1 selection matmuls and sweeps the window
// cells under scalar guards.  Hopper gathers.  This kernel computes the
// same function as a direct gather, with K3's thread layout: one warp per
// (batch, query, head), lanes over the head's d channels (up to four
// channel slices per lane).  Each lane computes the window geometry of one
// tap (its anchors, cells, hats and validity), the warp broadcasts each
// tap's four corner weights, row and corner mask with shuffles, and every
// valid corner reads the head's d contiguous channels.  fp32 accumulation;
// the output is written in the value's dtype.
//
// What bounds it: bytes, the same touched value rows as K3 plus the
// q-minor coordinates and the output (an encoder call at 768x1152 does ~3
// GFLOP on ~0.3 GB), served through the 50 MB L2 as K1 and K3 are.  The
// shift-window formulation pays on this card when a block takes a tile of
// same-level queries and stages the bounded window of target rows they
// share in shared memory (cp.async or TMA), so that each value row is read
// from L2 once per tile and not once per tap; that design is left for a
// later change.
//
// C entry (returns cudaGetLastError() after the launch, or a negative code
// for arguments the kernel does not take; does not synchronise):
//   msda_shift_qm_fwd: value (bs, K, H, D); x, y, w q-minor (bs, H, L, P, K)
//   fp32; anchors int32, pair p = lq * L + lt has R[p] and its row anchors
//   at anchors[off_y[p] ...] (Hq of them), its column anchors at
//   anchors[off_x[p] ...] (Wq); out (bs, K, H * D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SHIFT_MAX_LEVELS 8
#define SHIFT_MAX_SLICES 4  // d <= 32 * SHIFT_MAX_SLICES
#define SHIFT_WARPS_PER_BLOCK 8

struct Pairs {
  int n;  // levels
  int h[SHIFT_MAX_LEVELS];
  int w[SHIFT_MAX_LEVELS];
  long long start[SHIFT_MAX_LEVELS];
  int r[SHIFT_MAX_LEVELS * SHIFT_MAX_LEVELS];
  int off_y[SHIFT_MAX_LEVELS * SHIFT_MAX_LEVELS];
  int off_x[SHIFT_MAX_LEVELS * SHIFT_MAX_LEVELS];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One axis of a tap: the window cells floor(t) and floor(t) + 1, whether
// each lies in the window and its target index in [0, size), the first
// cell's target index and the hat fraction.  Validity is decided on floats,
// so far-out (or non-finite) coordinates never reach an int conversion.
struct Axis {
  bool v0, v1;
  int idx0;
  float frac;
};

__device__ __forceinline__ Axis window_axis(float loc, int size, int anchor, int R) {
  Axis a;
  // rounded multiply, then the subtractions in order (no FMA contraction):
  // the plain version's (loc * size - 0.5) - anchor + (R + 1)
  const float t = (__fmul_rn(loc, (float)size) - 0.5f - (float)anchor) + (float)(R + 1);
  const float f = floorf(t);
  const float last = (float)(2 * R + 2);  // W - 1
  const bool in0 = f >= 0.f && f <= last;
  const bool in1 = f >= -1.f && f <= last - 1.f;
  a.v0 = a.v1 = false;
  a.idx0 = 0;
  a.frac = 0.f;
  if (in0 || in1) {
    const int c = (int)f;  // in [-1, W - 1]
    a.idx0 = anchor + c - (R + 1);
    a.v0 = in0 && a.idx0 >= 0 && a.idx0 < size;
    a.v1 = in1 && a.idx0 + 1 >= 0 && a.idx0 + 1 < size;
    a.frac = t - f;
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(32 * SHIFT_WARPS_PER_BLOCK)
msda_shift_fwd_kernel(const T* __restrict__ value,  // (bs, K, H, D)
                      const float* __restrict__ xs,  // (bs, H, L, P, K)
                      const float* __restrict__ ys,
                      const float* __restrict__ ws,
                      const int* __restrict__ anchors,
                      T* __restrict__ out,  // (bs, K, H, D)
                      Pairs pp, int K, int H, int D, int P, long long n_items) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * SHIFT_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (item >= n_items) return;  // whole warp leaves together

  const int head = (int)(item % H);
  const long long bq = item / H;  // batch * K + query
  const long long b = bq / K;
  const int q = (int)(bq - b * K);
  const int L = pp.n;
  const int LP = L * P;

  // the query's level and its row and column there
  int lq = 0;
  while (lq + 1 < L && q >= pp.start[lq + 1]) ++lq;
  const int iq = q - (int)pp.start[lq];
  const int iy = iq / pp.w[lq];
  const int ix = iq - iy * pp.w[lq];

  // q-minor: tap t of (b, head, q) at ((b * H + head) * LP + t) * K + q
  const long long cbase = (b * H + head) * (long long)LP * K + q;
  const T* vbase = value + (b * K * H + head) * (long long)D;
  const long long row_pitch = (long long)H * D;

  float acc[SHIFT_MAX_SLICES];
#pragma unroll
  for (int s = 0; s < SHIFT_MAX_SLICES; ++s) acc[s] = 0.f;

  for (int t0 = 0; t0 < LP; t0 += 32) {
    const int t = t0 + lane;
    // this lane's tap: its corner weights, first corner's row and which of
    // the four corners (bit 0: 00, 1: 10, 2: 01, 3: 11) it reads
    float w00 = 0.f, w10 = 0.f, w01 = 0.f, w11 = 0.f;
    long long r00 = 0;
    int wt = 0;
    unsigned mask = 0;
    if (t < LP) {
      const long long c = cbase + (long long)t * K;
      const float lx = __ldg(xs + c), ly = __ldg(ys + c), a = __ldg(ws + c);
      const int lt = t / P;
      const int pair = lq * L + lt;
      const int R = pp.r[pair];
      wt = pp.w[lt];
      const Axis ax = window_axis(lx, wt, __ldg(anchors + pp.off_x[pair] + ix), R);
      const Axis ay = window_axis(ly, pp.h[lt], __ldg(anchors + pp.off_y[pair] + iy), R);
      mask = (ax.v0 && ay.v0 ? 1u : 0u) | (ax.v1 && ay.v0 ? 2u : 0u) |
             (ax.v0 && ay.v1 ? 4u : 0u) | (ax.v1 && ay.v1 ? 8u : 0u);
      if (mask) {
        const float fx = ax.frac, fy = ay.frac;
        w00 = (1.f - fx) * (1.f - fy) * a;
        w10 = fx * (1.f - fy) * a;
        w01 = (1.f - fx) * fy * a;
        w11 = fx * fy * a;
        r00 = pp.start[lt] + (long long)ay.idx0 * wt + ax.idx0;
      }
    }
    const int n = min(32, LP - t0);
    for (int i = 0; i < n; ++i) {
      const unsigned m = __shfl_sync(full, mask, i);
      const float c00 = __shfl_sync(full, w00, i);
      const float c10 = __shfl_sync(full, w10, i);
      const float c01 = __shfl_sync(full, w01, i);
      const float c11 = __shfl_sync(full, w11, i);
      const long long r = __shfl_sync(full, r00, i);
      const int wl = __shfl_sync(full, wt, i);
      if (!m) continue;  // the same for every lane
      const T* p00 = vbase + r * row_pitch;
      const T* p10 = p00 + row_pitch;
      const T* p01 = p00 + (long long)wl * row_pitch;
      const T* p11 = p01 + row_pitch;
#pragma unroll
      for (int s = 0; s < SHIFT_MAX_SLICES; ++s) {
        const int ch = lane + 32 * s;
        if (ch < D) {
          float v = 0.f;
          if (m & 1u) v += c00 * load_f32(p00 + ch);
          if (m & 2u) v += c10 * load_f32(p10 + ch);
          if (m & 4u) v += c01 * load_f32(p01 + ch);
          if (m & 8u) v += c11 * load_f32(p11 + ch);
          acc[s] += v;
        }
      }
    }
  }

  T* orow = out + item * (long long)D;  // out is (bs, K, H, D) = item-major
#pragma unroll
  for (int s = 0; s < SHIFT_MAX_SLICES; ++s) {
    const int ch = lane + 32 * s;
    if (ch < D) store_from_f32(orow + ch, acc[s]);
  }
}

// dtype: 0 = float32 value/out, 1 = bfloat16 value/out.  Coordinates fp32.
extern "C" int msda_shift_qm_fwd(const void* value, const void* x, const void* y,
                                 const void* w, const void* anchors, void* out,
                                 int dtype, int bs, int K, int H, int D, int L,
                                 int P, const int* level_h, const int* level_w,
                                 const int* pair_r, const int* pair_off_y,
                                 const int* pair_off_x, void* stream) {
  if (L < 1 || L > SHIFT_MAX_LEVELS) return -1;
  if (D < 1 || D > 32 * SHIFT_MAX_SLICES) return -2;
  Pairs pp;
  pp.n = L;
  long long start = 0;
  for (int i = 0; i < SHIFT_MAX_LEVELS; ++i) {
    pp.h[i] = i < L ? level_h[i] : 0;
    pp.w[i] = i < L ? level_w[i] : 0;
    pp.start[i] = start;
    if (i < L) start += (long long)level_h[i] * level_w[i];
  }
  if (start != K) return -5;
  for (int p = 0; p < SHIFT_MAX_LEVELS * SHIFT_MAX_LEVELS; ++p) {
    const bool used = p < L * L;
    pp.r[p] = used ? pair_r[p] : 0;
    pp.off_y[p] = used ? pair_off_y[p] : 0;
    pp.off_x[p] = used ? pair_off_x[p] : 0;
  }
  const long long n_items = (long long)bs * K * H;
  if (n_items == 0) return 0;
  const long long blocks =
      (n_items + SHIFT_WARPS_PER_BLOCK - 1) / SHIFT_WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return -3;
  const dim3 grid((unsigned)blocks), block(32 * SHIFT_WARPS_PER_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const float* wf = (const float*)w;
  const int* an = (const int*)anchors;
  if (dtype == 0) {
    msda_shift_fwd_kernel<float><<<grid, block, 0, s>>>(
        (const float*)value, xf, yf, wf, an, (float*)out, pp, K, H, D, P, n_items);
  } else if (dtype == 1) {
    msda_shift_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)value, xf, yf, wf, an, (__nv_bfloat16*)out, pp, K, H,
        D, P, n_items);
  } else {
    return -4;
  }
  return (int)cudaGetLastError();
}
