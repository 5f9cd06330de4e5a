// Shared pieces of the tiled encoder MSDA kernels (msda_fwd.cu's and
// msda_bwd.cu's packed entries): the tile plan as the kernels read it, the
// window copy into shared memory, and one tap's geometry.
//
// The plan comes from codetr_torch/ops/msda_tiles.py:encoder_tile_plan.  A
// block takes one tile of same-level queries (query level lq, tile (ty, tx)
// of (th, tw) queries, ragged at the level's edge) for one head of one
// batch entry.  For each target level lt the pair (lq, lt) has a window
// of (win_h, win_w) target pixels whose origin is the tile's projection
// minus the halo, clamped into the level; a staged pair's window is copied
// into shared memory, and a corner inside it is read from there, any other
// corner from global memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_MAX_LEVELS 8
#define TILE_MAX_SMEM 232448  // bytes of shared memory a block can use on an H100
// warps per block at one channel slice (d <= 32); a kernel with S slices a
// lane takes 1/S of them, so that its registers still fit the SM
#define TILE_FWD_WARPS 32
#define TILE_BWD_WARPS 32

struct TilePlan {
  int n;  // levels
  int h[TILE_MAX_LEVELS];
  int w[TILE_MAX_LEVELS];
  int start[TILE_MAX_LEVELS];  // first key of each level
  int th[TILE_MAX_LEVELS];     // query tile of each query level
  int tw[TILE_MAX_LEVELS];
  int ntx[TILE_MAX_LEVELS];                 // tiles across each query level
  int tile_start[TILE_MAX_LEVELS + 1];      // first tile of each query level
  // pair lq * TILE_MAX_LEVELS + lt
  int win_h[TILE_MAX_LEVELS * TILE_MAX_LEVELS];
  int win_w[TILE_MAX_LEVELS * TILE_MAX_LEVELS];
  int staged[TILE_MAX_LEVELS * TILE_MAX_LEVELS];
  int off_b[TILE_MAX_LEVELS];    // bytes: second region (fwd: odd levels; bwd: pixel counts)
  int off_acc[TILE_MAX_LEVELS];  // bytes: third (fwd: fp32 accumulator; bwd: entries, gradient rows)
  int halo;
};

// Builds the plan from the host arrays (pairs at lq * L + lt) and checks that
// every staged window fits its region of smem_bytes: in the forward the even
// target levels' windows at 0, the odd ones' at off_b, the fp32 accumulator
// at off_acc; in the backward the fp32 value window at 0, one int count per
// window pixel at off_b, and at off_acc the entry list, 4 * th * tw * P
// int2s (at least 16: the block's scan borrows it), then the tile's fp32
// upstream gradient rows, th * tw * head_dim floats.  Returns 0, or a
// negative code.
static int make_tile_plan(TilePlan* tp, int L, const int* level_h, const int* level_w,
                          const int* tile_h, const int* tile_w, const int* win_h,
                          const int* win_w, const int* staged, const int* off_b,
                          const int* off_acc, int halo, int head_dim, int P, int elem,
                          bool backward, int smem_bytes, long long K) {
  if (L < 1 || L > TILE_MAX_LEVELS) return -1;
  if (smem_bytes < 0 || smem_bytes > TILE_MAX_SMEM || halo < 0) return -6;
  *tp = TilePlan{};
  tp->n = L;
  tp->halo = halo;
  long long start = 0, tiles = 0;
  for (int i = 0; i < L; ++i) {
    if (level_h[i] < 1 || level_w[i] < 1 || tile_h[i] < 1 || tile_w[i] < 1) return -6;
    tp->h[i] = level_h[i];
    tp->w[i] = level_w[i];
    tp->start[i] = (int)start;
    start += (long long)level_h[i] * level_w[i];
    tp->th[i] = tile_h[i];
    tp->tw[i] = tile_w[i];
    tp->ntx[i] = (level_w[i] + tile_w[i] - 1) / tile_w[i];
    tp->tile_start[i] = (int)tiles;
    tiles += (long long)tp->ntx[i] * ((level_h[i] + tile_h[i] - 1) / tile_h[i]);
  }
  if (start != K || K > 0x7fffffffLL || tiles > 0x7fffffffLL) return -5;
  tp->tile_start[L] = (int)tiles;
  for (int lq = 0; lq < L; ++lq) {
    tp->off_b[lq] = off_b[lq];
    tp->off_acc[lq] = off_acc[lq];
    if (off_b[lq] % 16 || off_acc[lq] % 16 || off_acc[lq] < off_b[lq]) return -6;
    const long long tile_q = (long long)tile_h[lq] * tile_w[lq];
    const long long tail = (backward ? max(4 * tile_q * P, 16LL) * 8 : 0) + tile_q * head_dim * 4;
    if (tail > smem_bytes - off_acc[lq]) return -6;
    for (int lt = 0; lt < L; ++lt) {
      const int p = lq * TILE_MAX_LEVELS + lt, i = lq * L + lt;
      tp->win_h[p] = win_h[i];
      tp->win_w[p] = win_w[i];
      tp->staged[p] = staged[i] ? 1 : 0;
      if (win_h[i] < 1 || win_h[i] > level_h[lt] || win_w[i] < 1 || win_w[i] > level_w[lt])
        return -6;
      if (!staged[i]) continue;
      const long long px = (long long)win_h[i] * win_w[i];
      const long long region =
          backward || lt % 2 == 0 ? off_b[lq] : off_acc[lq] - off_b[lq];
      if (px * head_dim * elem > region) return -6;
      if (backward && px * 4 > off_acc[lq] - off_b[lq]) return -6;
    }
  }
  return 0;
}

// The tile of block index `tile`: its query level, first query row and
// column, and its rows and columns (fewer at the level's edge).
struct TileCoord {
  int lq, y0, x0, rows, cols;
};

__device__ __forceinline__ TileCoord tile_coord(const TilePlan& tp, int tile) {
  TileCoord tc;
  int lq = 0;
  while (lq + 1 < tp.n && tile >= tp.tile_start[lq + 1]) ++lq;
  const int local = tile - tp.tile_start[lq];
  const int ty = local / tp.ntx[lq];
  const int tx = local - ty * tp.ntx[lq];
  tc.lq = lq;
  tc.y0 = ty * tp.th[lq];
  tc.x0 = tx * tp.tw[lq];
  tc.rows = min(tp.th[lq], tp.h[lq] - tc.y0);
  tc.cols = min(tp.tw[lq], tp.w[lq] - tc.x0);
  return tc;
}

// Key of the tile's query j (row-major inside the tile).
__device__ __forceinline__ int tile_query(const TilePlan& tp, const TileCoord& tc, int j) {
  const int r = j / tc.cols;
  return tp.start[tc.lq] + (tc.y0 + r) * tp.w[tc.lq] + tc.x0 + (j - r * tc.cols);
}

// A window's origin on one axis: the tile's first query row (column) t0q
// projected onto the target axis, minus the halo, clamped into the level
// (msda_win.py:175's formula).
__device__ __forceinline__ int window_start(int t0q, int nq, int nt, int halo, int win) {
  return min(max(t0q * nt / nq - halo, 0), nt - win);
}

struct Window {
  bool staged;
  int y0, x0, h, w;
};

__device__ __forceinline__ Window pair_window(const TilePlan& tp, const TileCoord& tc, int lt) {
  const int p = tc.lq * TILE_MAX_LEVELS + lt;
  Window win;
  win.staged = tp.staged[p] != 0;
  win.h = tp.win_h[p];
  win.w = tp.win_w[p];
  win.y0 = window_start(tc.y0, tp.h[tc.lq], tp.h[lt], tp.halo, win.h);
  win.x0 = window_start(tc.x0, tp.w[tc.lq], tp.w[lt], tp.halo, win.w);
  return win;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies one head's channels of a window's pixels into shared memory, pixel
// (r, c) at dst + (r * win.w + c) * D elements.  With vec16 (16-byte aligned
// rows of a multiple of 16 bytes) as cp.async copies of 16 bytes, which the
// caller commits and waits for; otherwise as plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_window(T* dst, const T* vb, long long pitch, int D,
                                             int lstart, int Wt, const Window& win, bool vec16) {
  const int npx = win.h * win.w;
  if (vec16) {
    const int cpp = D * (int)sizeof(T) / 16;  // 16-byte chunks per pixel
    for (int i = threadIdx.x; i < npx * cpp; i += blockDim.x) {
      const int px = i / cpp, sub = i - px * cpp;
      const int r = px / win.w, c = px - r * win.w;
      const T* src = vb + (long long)(lstart + (win.y0 + r) * Wt + win.x0 + c) * pitch;
      cp_async16((char*)dst + (long long)i * 16, (const char*)src + sub * 16);
    }
  } else {
    for (int i = threadIdx.x; i < npx * D; i += blockDim.x) {
      const int px = i / D, ch = i - px * D;
      const int r = px / win.w, c = px - r * win.w;
      dst[i] = vb[(long long)(lstart + (win.y0 + r) * Wt + win.x0 + c) * pitch + ch];
    }
  }
}

// One tap's geometry on target level (Ht, Wt): its bilinear fractions, the
// key of its first corner (row-major: 00, 10 = +1, 01 = +Wt, 11 = +Wt + 1)
// and that corner's window pixel, and a mask: bits 0-3 set for the corners
// (00, 10, 01, 11) inside the level, bits 4-7 for those also inside the
// staged window.  A tap is served from shared memory alone when its two
// nibbles are equal and not 0 (in_window).  The pixel coordinate is the
// plain version's loc * size - 0.5 with the product rounded first (no FMA
// contraction); validity is decided on floats, so far-out or non-finite
// locations never reach an int conversion.
struct Tap {
  float tx, ty;
  int r00, s00;
  unsigned mask;
};

__device__ __forceinline__ Tap tap_geometry(float lx, float ly, int Ht, int Wt, int lstart,
                                            const Window& win) {
  Tap g;
  g.tx = g.ty = 0.f;
  g.r00 = g.s00 = 0;
  g.mask = 0u;
  const float px = __fmul_rn(lx, (float)Wt) - 0.5f;
  const float py = __fmul_rn(ly, (float)Ht) - 0.5f;
  const float fx = floorf(px), fy = floorf(py);
  const bool vx0 = fx >= 0.f && fx <= (float)(Wt - 1);
  const bool vx1 = fx >= -1.f && fx <= (float)(Wt - 2);
  const bool vy0 = fy >= 0.f && fy <= (float)(Ht - 1);
  const bool vy1 = fy >= -1.f && fy <= (float)(Ht - 2);
  if (!((vx0 || vx1) && (vy0 || vy1))) return g;
  g.tx = px - fx;
  g.ty = py - fy;
  const int x0 = (int)fx, y0 = (int)fy;  // in [-1, Wt - 1] x [-1, Ht - 1]
  g.mask = (vx0 && vy0 ? 1u : 0u) | (vx1 && vy0 ? 2u : 0u) | (vx0 && vy1 ? 4u : 0u) |
           (vx1 && vy1 ? 8u : 0u);
  g.r00 = lstart + y0 * Wt + x0;
  if (win.staged) {
    const int cx = x0 - win.x0, cy = y0 - win.y0;  // window cell of corner 00
    const bool ix0 = cx >= 0 && cx < win.w, ix1 = cx >= -1 && cx < win.w - 1;
    const bool iy0 = cy >= 0 && cy < win.h, iy1 = cy >= -1 && cy < win.h - 1;
    // the window lies inside the level, so an in-window corner is a valid one
    g.mask |= ((ix0 && iy0 ? 1u : 0u) | (ix1 && iy0 ? 2u : 0u) | (ix0 && iy1 ? 4u : 0u) |
               (ix1 && iy1 ? 8u : 0u)) << 4;
    g.s00 = cy * win.w + cx;
  }
  return g;
}

__device__ __forceinline__ bool in_window(unsigned mask) {
  return mask != 0u && (mask & 15u) == (mask >> 4);
}

// Window pixel `px` clamped into the window: the fast path reads a corner
// outside the level (whose weight is 0, or whose value is masked) from a
// pixel inside it instead of branching.
__device__ __forceinline__ int clamp_px(int px, int last) { return min(max(px, 0), last); }

// Queries of a block split over its warps: this warp's tile-local queries
// [lo, hi), and the rounds that cover them, whole queries of P taps each
// (32 / P queries a round, one lane per tap).
struct WarpQueries {
  int lo, hi, per_round, rounds;
};

__device__ __forceinline__ WarpQueries warp_queries(const TileCoord& tc, int warps, int P) {
  WarpQueries wq;
  const int nq = tc.rows * tc.cols;
  const int per_warp = (nq + warps - 1) / warps;
  wq.lo = min(nq, (int)(threadIdx.x >> 5) * per_warp);
  wq.hi = min(nq, wq.lo + per_warp);
  wq.per_round = 32 / P;
  wq.rounds = (wq.hi - wq.lo + wq.per_round - 1) / wq.per_round;
  return wq;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
