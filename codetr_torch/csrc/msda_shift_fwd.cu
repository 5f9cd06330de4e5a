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
// cells under scalar guards.  Hopper gathers, and a tile of same-level
// queries shares a bounded window of each target level: the anchors are
// monotone in the query row and column, so the cells of a tile's queries
// lie in rows anchor_y(first row) - (R + 1) .. anchor_y(last row) + R + 1
// (likewise for columns), clipped to the level.  This kernel is the
// encoder kernels' tiled forward (msda_tiles.cuh: msda_tile_fwd_kernel, one
// block of 32 warps per (tile, head, batch entry), cp.async window copies
// double-buffered across target levels, one lane per tap for the geometry,
// shuffles to broadcast each tap's corner weights, window pixel and mask)
// with K4's geometry (ShiftGeo): each pair's window is placed around the
// tile's first anchors and sized on the host (ops/msda_grid.py:
// shift_tile_plan) to hold every cell of every tile, so a staged pair
// serves every corner from shared memory and its global branch is never
// taken; a pair whose window does not fit the budget reads its corners
// from global memory under the same truncation.  The coordinates are read
// q-minor (lanes of one point on consecutive keys).  fp32 accumulation;
// the output is written in the value's dtype.
//
// What bounds it: bytes, the same touched value rows as K3 plus the
// q-minor coordinates and the output (an encoder call at 768x1152 does ~3
// GFLOP on ~0.3 GB).  With the windows in shared memory each value pixel
// is read from L2 once per (tile, head); the shuffles, loads and barriers
// per tap then set the pace, as in the encoder kernels (PERF.md).
//
// C entry (returns cudaGetLastError() after the launch, or a negative code
// for arguments the kernel does not take; does not synchronise):
//   msda_shift_qm_fwd: value (bs, K, H, D); x, y, w q-minor (bs, H, L, P, K)
//   fp32; anchors int32, pair p = lq * L + lt has R[p] and its row anchors
//   at anchors[off_y[p] ...] (Hq of them), its column anchors at
//   anchors[off_x[p] ...] (Wq); the tile plan as msda_packed_fwd_levels takes it
//   (shift_tile_plan's windows; halo unused); out (bs, K, H * D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_tiles.cuh"

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

// K4's geometry for msda_tile_fwd_kernel: pair p = lq * TILE_MAX_LEVELS + lt
// has its half-width r[p] and its anchors in the table at off_y[p] (rows)
// and off_x[p] (columns).
struct ShiftGeo {
  const int* anchors;
  int r[TILE_MAX_LEVELS * TILE_MAX_LEVELS];
  int off_y[TILE_MAX_LEVELS * TILE_MAX_LEVELS];
  int off_x[TILE_MAX_LEVELS * TILE_MAX_LEVELS];

  // the tile's first row's (column's) anchor minus R + 1, clamped into the
  // level (shift_tile_plan sizes the window to reach the last anchor + R + 1)
  __device__ __forceinline__ Window window(const TilePlan& tp, const TileCoord& tc, int lt) const {
    const int p = tc.lq * TILE_MAX_LEVELS + lt;
    Window win;
    win.staged = tp.staged[p] != 0;
    win.h = tp.win_h[p];
    win.w = tp.win_w[p];
    win.y0 = min(max(__ldg(anchors + off_y[p] + tc.y0) - (r[p] + 1), 0), tp.h[lt] - win.h);
    win.x0 = min(max(__ldg(anchors + off_x[p] + tc.x0) - (r[p] + 1), 0), tp.w[lt] - win.w);
    return win;
  }

  // Tile-local query j's tap on level lt: the truncated function's corners
  // (bits 0-3: the corner's cells in the window and its pixel in the level)
  // and, for a staged window, which of them lie inside it (bits 4-7).
  __device__ __forceinline__ Tap tap(const TilePlan& tp, const TileCoord& tc, int j, int lt,
                                     float x, float y, const Window& win) const {
    const int p = tc.lq * TILE_MAX_LEVELS + lt;
    const int R = r[p], Ht = tp.h[lt], Wt = tp.w[lt], lstart = tp.start[lt];
    const int row = j / tc.cols;
    const Axis ax = window_axis(x, Wt, __ldg(anchors + off_x[p] + tc.x0 + j - row * tc.cols), R);
    const Axis ay = window_axis(y, Ht, __ldg(anchors + off_y[p] + tc.y0 + row), R);
    Tap g;
    g.tx = ax.frac;
    g.ty = ay.frac;
    g.mask = (ax.v0 && ay.v0 ? 1u : 0u) | (ax.v1 && ay.v0 ? 2u : 0u) |
             (ax.v0 && ay.v1 ? 4u : 0u) | (ax.v1 && ay.v1 ? 8u : 0u);
    g.r00 = lstart + ay.idx0 * Wt + ax.idx0;
    g.s00 = 0;
    if (win.staged) {
      const int cx = ax.idx0 - win.x0, cy = ay.idx0 - win.y0;  // window cell of corner 00
      const bool ix0 = cx >= 0 && cx < win.w, ix1 = cx >= -1 && cx < win.w - 1;
      const bool iy0 = cy >= 0 && cy < win.h, iy1 = cy >= -1 && cy < win.h - 1;
      g.mask |= (g.mask & ((ix0 && iy0 ? 1u : 0u) | (ix1 && iy0 ? 2u : 0u) |
                           (ix0 && iy1 ? 4u : 0u) | (ix1 && iy1 ? 8u : 0u))) << 4;
      g.s00 = cy * win.w + cx;
    }
    return g;
  }
};

// dtype: 0 = float32 value/out, 1 = bfloat16 value/out.  Coordinates fp32.
extern "C" int msda_shift_qm_fwd(const void* value, const void* x, const void* y,
                                 const void* w, const void* anchors, void* out,
                                 int dtype, int bs, int K, int H, int D, int L,
                                 int P, const int* level_h, const int* level_w,
                                 const int* pair_r, const int* pair_off_y,
                                 const int* pair_off_x, const int* tile_h,
                                 const int* tile_w, const int* win_h,
                                 const int* win_w, const int* staged,
                                 const int* off_b, const int* off_acc, int halo,
                                 int smem_bytes, void* stream) {
  if (L < 1 || L > TILE_MAX_LEVELS) return -1;
  ShiftGeo geo = {};
  geo.anchors = (const int*)anchors;
  for (int lq = 0; lq < L; ++lq)
    for (int lt = 0; lt < L; ++lt) {
      const int p = lq * TILE_MAX_LEVELS + lt, i = lq * L + lt;
      if (pair_r[i] < 0) return -6;
      geo.r[p] = pair_r[i];
      geo.off_y[p] = pair_off_y[i];
      geo.off_x[p] = pair_off_x[i];
    }
  const QminorCoords co{(const float*)x, (const float*)y, (const float*)w};
  return tile_fwd_entry(value, co, geo, out, dtype, bs, K, H, D, L, P, level_h, level_w, tile_h,
                        tile_w, win_h, win_w, staged, off_b, off_acc, halo, smem_bytes, stream);
}
