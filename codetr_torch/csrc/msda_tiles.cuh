// Shared pieces of the tiled grid-query MSDA kernels: the tile plan as the
// kernels read it, the window copy into shared memory, one tap's geometry,
// and the tiled forward kernel itself (msda_tile_fwd_kernel), which
// msda_fwd.cu instantiates for the packed (K1) and q-minor (K3) entries and
// K3's correction entry (CorrectionCoords), and msda_shift_fwd.cu for the
// shift-window function (K4); msda_bwd.cu's
// packed entry (K2) shares the rest.
//
// The plan comes from codetr_torch/ops/msda_tiles.py:encoder_tile_plan (K4:
// ops/msda_grid.py:shift_tile_plan, its own windows).  A
// block takes one tile of same-level queries (query level lq, tile (ty, tx)
// of (th, tw) queries, ragged at the level's edge) for one head of one
// batch entry.  For each target level lt the pair (lq, lt) has a window
// of (win_h, win_w) target pixels whose origin is the tile's projection
// minus the halo, clamped into the level; a staged pair's window is copied
// into shared memory, and a corner inside it is read from there, any other
// corner from global memory.  K4's windows are placed around its anchors
// instead (ShiftGeo in msda_shift_fwd.cu); the kernel reads its windows
// and tap geometry through a policy (Geo) and its coordinates through
// another (Coords), so the loop below exists once.

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
// the correction entry's blocks (CorrectionCoords): it reads a few corners
// and stages nothing, so smaller blocks, four of them resident on an SM
// instead of one, hide its weight loads better (2.1x at 8 warps against 32
// on the card, chip_smoke.py; PERF.md)
#define TILE_CORRECTION_WARPS 8

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
  // block x takes tile x + tile_base: tile_start[lq_begin] for a launch of
  // the query levels [lq_begin, lq_end) (tile_fwd_entry), else 0
  int tile_base;
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

// The tile of block index `block` (tile block + tp.tile_base): its query
// level, first query row and column, and its rows and columns (fewer at the
// level's edge).
struct TileCoord {
  int lq, y0, x0, rows, cols;
};

__device__ __forceinline__ TileCoord tile_coord(const TilePlan& tp, int block) {
  TileCoord tc;
  const int tile = block + tp.tile_base;
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

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Coordinates, policy 1: K1's packed (bs, K, C) [x(HLP) | y(HLP) | w(HLP) |
// pad], HLP = H * L * P in (h, L, P) order.  A lane's taps lie at
// row + key * C + lt * P, row its (batch, head, point) column.  The lane
// keeps a pointer, as K1's own loop did: a 64-bit offset from cpk instead
// measured ~6% slower in fp32 on the card (PERF.md).
struct PackedCoords {
  static constexpr bool kCorrection = false;
  const float* cpk;
  int C, HLP;
  struct Lane {
    const float* row;
  };
  __device__ __forceinline__ Lane lane(long long b, int K, int H, int head, int L, int P,
                                       int lane_p) const {
    return {cpk + b * K * C + head * L * P + lane_p};
  }
  __device__ __forceinline__ void load(const Lane& ln, int key, int lt, int P, int K, float& x,
                                       float& y, float& a) const {
    const float* c = ln.row + (long long)key * C + lt * P;
    x = __ldg(c);
    y = __ldg(c + HLP);
    a = __ldg(c + 2 * HLP);
  }
};

// Coordinates, policy 2: q-minor x, y, w, each (bs, H, L, P, K) (K3, K4).
// A lane's taps lie at off + lt * P * K + key: the lanes of one point in a
// round hold consecutive queries of a tile row, so each load touches a few
// consecutive 32-byte sectors per point.  Scalar loads: no row alignment.
struct QminorCoords {
  static constexpr bool kCorrection = false;
  const float *x, *y, *w;
  struct Lane {
    long long off;
  };
  __device__ __forceinline__ Lane lane(long long b, int K, int H, int head, int L, int P,
                                       int lane_p) const {
    return {((b * H + head) * L * P + lane_p) * (long long)K};
  }
  __device__ __forceinline__ void load(const Lane& ln, int key, int lt, int P, int K, float& xv,
                                       float& yv, float& a) const {
    const long long o = ln.off + (long long)lt * P * K + key;
    xv = __ldg(x + o);
    yv = __ldg(y + o);
    a = __ldg(w + o);
  }
};

// Coordinates, policy 3: the correction entry of K3 (msda_fwd.cu,
// msda_qm_correction_fwd), q-minor as policy 2, its weights zero on every tap
// the window call already summed.  The kernel instantiated with it
// (kCorrection) returns at once when the device count of the taps to
// correct is 0, masks out every tap whose weight is 0 before any corner is
// read (a round with no live tap is skipped whole), and adds its sums into
// the window call's output in place.  A lane reads a tap's x and y only
// when its weight is not 0.
struct CorrectionCoords : QminorCoords {
  static constexpr bool kCorrection = true;
  const long long* count;  // taps outside the window envelope, on the device
  __device__ __forceinline__ bool idle() const { return __ldg(count) == 0; }
  __device__ __forceinline__ void load(const Lane& ln, int key, int lt, int P, int K, float& xv,
                                       float& yv, float& a) const {
    const long long o = ln.off + (long long)lt * P * K + key;
    a = __ldg(w + o);
    xv = yv = 0.f;
    if (a != 0.f) {
      xv = __ldg(x + o);
      yv = __ldg(y + o);
    }
  }
};

// Geometry, policy 1 (K1, K3): the halo windows of the plan and the exact
// bilinear tap.
struct HaloGeo {
  __device__ __forceinline__ Window window(const TilePlan& tp, const TileCoord& tc, int lt) const {
    return pair_window(tp, tc, lt);
  }
  __device__ __forceinline__ Tap tap(const TilePlan& tp, const TileCoord&, int, int lt, float x,
                                     float y, const Window& win) const {
    return tap_geometry(x, y, tp.h[lt], tp.w[lt], tp.start[lt], win);
  }
};

// The tiled forward: one block of kWarps warps per (tile, head, batch
// entry) = (blockIdx.x, blockIdx.y, blockIdx.z); S channel slices a lane (d
// <= 32 * S).  Shared memory: the even target levels' window region at 0,
// the odd ones' at off_b[lq], the fp32 accumulator (tile queries x D) at
// off_acc[lq].  For each target level the block copies the pair's window of
// this head's channels with cp.async (level lt + 1 into the other region
// while it samples level lt).
//
// A warp takes its queries in rounds of 32 / P whole queries, one lane per
// tap, and loads the next round's coordinates before it samples the current
// one.  The warp broadcasts each tap's four corner weights (0 for a corner
// that does not contribute), window pixel and corner mask with shuffles, and
// the lanes run over the head's channels.  A tap whose contributing corners
// all lie in the staged window takes the fast path: four shared-memory loads
// with no branch (a corner that does not contribute reads a clamped pixel
// with weight 0); any other tap reads its four corners from global memory
// the same way, at keys clamped into the level.  Per-query sums go into the
// accumulator, each warp owning its queries' rows; the output is written in
// the value's dtype at the end.
template <typename T, int S, int kWarps, class Coords, class Geo>
__global__ void __launch_bounds__(32 * kWarps)
msda_tile_fwd_kernel(const T* __restrict__ value,  // (bs, K, H, D)
                     const Coords co, const Geo geo,
                     T* __restrict__ out,  // (bs, K, H, D)
                     const TilePlan tp, int K, int H, int D, int P, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned full = 0xffffffffu;
  if constexpr (Coords::kCorrection) {
    if (co.idle()) return;  // the whole block: no tap to correct
  }
  const TileCoord tc = tile_coord(tp, blockIdx.x);
  const long long b = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const WarpQueries wq = warp_queries(tc, kWarps, P);
  const int lane_q = lane / P, lane_p = lane - lane_q * P;  // this lane's tap in a round
  const int L = tp.n;
  const long long pitch = (long long)H * D;  // elements between keys
  float* acc = (float*)(smem + tp.off_acc[tc.lq]);

  const T* vb = value + (b * K * H + head) * D;  // key k's channels at vb + k * pitch
  const typename Coords::Lane cl = co.lane(b, K, H, head, L, P, lane_p);
  // this lane's tap of round r at level lt: its tile-local query j (0 for a
  // lane without one, whose weight is 0), x, y and weight
  auto load_tap = [&](int lt, int r, int& j, float& x, float& y, float& a) {
    x = y = a = 0.f;
    j = 0;
    const int jr = r * wq.per_round + lane_q;
    if (lane_q < wq.per_round && jr < wq.hi - wq.lo) {
      j = wq.lo + jr;
      co.load(cl, tile_query(tp, tc, j), lt, P, K, x, y, a);
    }
  };
  for (int i = wq.lo * D + lane; i < wq.hi * D; i += 32) acc[i] = 0.f;
  {
    const Window w0 = geo.window(tp, tc, 0);
    if (w0.staged) stage_window((T*)smem, vb, pitch, D, tp.start[0], tp.w[0], w0, vec16);
    cp_async_commit();
  }
  int jr;
  float xr, yr, ar;
  load_tap(0, 0, jr, xr, yr, ar);
  for (int lt = 0; lt < L; ++lt) {
    if (lt + 1 < L) {  // the next level's window into the other region
      const Window wn = geo.window(tp, tc, lt + 1);
      T* dst = (T*)(smem + ((lt + 1) % 2 ? tp.off_b[tc.lq] : 0));
      if (wn.staged) stage_window(dst, vb, pitch, D, tp.start[lt + 1], tp.w[lt + 1], wn, vec16);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: level lt's window is in
    __syncthreads();

    const Window win = geo.window(tp, tc, lt);
    const T* ws = (const T*)(smem + (lt % 2 ? tp.off_b[tc.lq] : 0));
    const int last = win.h * win.w - 1;
    const int Ht = tp.h[lt], Wt = tp.w[lt], lstart = tp.start[lt];
    for (int r = 0; r < wq.rounds; ++r) {
      int jn;
      float xn, yn, an;  // the next round's tap, loaded ahead
      if (r + 1 < wq.rounds) load_tap(lt, r + 1, jn, xn, yn, an);
      else load_tap(lt + 1 < L ? lt + 1 : lt, lt + 1 < L ? 0 : wq.rounds, jn, xn, yn, an);
      // this lane's tap: corner weights (0 for a corner that does not
      // contribute), first corner's key and window pixel, corner mask
      if constexpr (Coords::kCorrection) {
        if (__ballot_sync(full, ar != 0.f) == 0u) {  // no tap to correct this round
          jr = jn;
          xr = xn;
          yr = yn;
          ar = an;
          continue;
        }
      }
      Tap g = geo.tap(tp, tc, jr, lt, xr, yr, win);
      if constexpr (Coords::kCorrection) {
        if (ar == 0.f) g.mask = 0u;  // summed by the window call, or no query
      }
      const float w00 = g.mask & 1u ? (1.f - g.tx) * (1.f - g.ty) * ar : 0.f;
      const float w10 = g.mask & 2u ? g.tx * (1.f - g.ty) * ar : 0.f;
      const float w01 = g.mask & 4u ? (1.f - g.tx) * g.ty * ar : 0.f;
      const float w11 = g.mask & 8u ? g.tx * g.ty * ar : 0.f;
      const int nq = min(wq.per_round, wq.hi - wq.lo - r * wq.per_round);
      for (int qi = 0; qi < nq; ++qi) {
        float part[S];
#pragma unroll
        for (int s = 0; s < S; ++s) part[s] = 0.f;
        for (int i = qi * P; i < qi * P + P; ++i) {
          const unsigned m = __shfl_sync(full, g.mask, i);
          const float c00 = __shfl_sync(full, w00, i);
          const float c10 = __shfl_sync(full, w10, i);
          const float c01 = __shfl_sync(full, w01, i);
          const float c11 = __shfl_sync(full, w11, i);
          const int so = __shfl_sync(full, g.s00, i);
          if (in_window(m)) {  // the same for every lane
            const T* q00 = ws + clamp_px(so, last) * D;
            const T* q10 = ws + clamp_px(so + 1, last) * D;
            const T* q01 = ws + clamp_px(so + win.w, last) * D;
            const T* q11 = ws + clamp_px(so + win.w + 1, last) * D;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const int ch = lane + 32 * s;
              if (ch < D)
                part[s] += c00 * to_f32(q00[ch]) + c10 * to_f32(q10[ch]) +
                           c01 * to_f32(q01[ch]) + c11 * to_f32(q11[ch]);
            }
          } else if (m) {
            // all four corners from global memory at once, at keys clamped
            // into the level (a corner that does not contribute has weight 0)
            const int r00 = __shfl_sync(full, g.r00, i);
            const int kend = lstart + Ht * Wt - 1;
            const T* p00 = vb + min(max(r00, lstart), kend) * pitch;
            const T* p10 = vb + min(max(r00 + 1, lstart), kend) * pitch;
            const T* p01 = vb + min(max(r00 + Wt, lstart), kend) * pitch;
            const T* p11 = vb + min(max(r00 + Wt + 1, lstart), kend) * pitch;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const int ch = lane + 32 * s;
              if (ch < D)
                part[s] += c00 * load_f32(p00 + ch) + c10 * load_f32(p10 + ch) +
                           c01 * load_f32(p01 + ch) + c11 * load_f32(p11 + ch);
            }
          }
        }
        float* arow = acc + (wq.lo + r * wq.per_round + qi) * D;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int ch = lane + 32 * s;
          if (ch < D) arow[ch] += part[s];
        }
      }
      jr = jn;
      xr = xn;
      yr = yn;
      ar = an;
    }
    __syncthreads();  // level lt's region is free for level lt + 2
  }

  for (int j = wq.lo; j < wq.hi; ++j) {
    T* orow = out + ((b * K + tile_query(tp, tc, j)) * H + head) * (long long)D;
    for (int ch = lane; ch < D; ch += 32) {
      if constexpr (Coords::kCorrection) {
        // in place, only where a corrected tap added something
        const float a = acc[j * D + ch];
        if (a != 0.f) store_from_f32(orow + ch, to_f32(orow[ch]) + a);
      } else {
        store_from_f32(orow + ch, acc[j * D + ch]);
      }
    }
  }
}

template <typename T, int S, int kWarps, class Coords, class Geo>
static int launch_tile_fwd(dim3 grid, int smem_bytes, cudaStream_t stream, const void* value,
                           const Coords& co, const Geo& geo, void* out, const TilePlan& tp, int K,
                           int H, int D, int P, int vec16) {
  auto kernel = msda_tile_fwd_kernel<T, S, kWarps, Coords, Geo>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 32 * kWarps, smem_bytes, stream>>>((const T*)value, co, geo, (T*)out, tp, K, H,
                                                    D, P, vec16);
  return (int)cudaGetLastError();
}

// The checks and the launch shared by the tiled forward entries: the plan
// (from the host arrays, as make_tile_plan takes them), one instantiation
// per value dtype (0 = float32, 1 = bfloat16) and channel-slice count (1:
// d <= 32, 2: <= 64, 4: <= 128).  The launch covers the tiles of the query
// levels [lq_begin, lq_end) (lq_end -1: all levels): one block per tile
// of the range, offset by tp.tile_base, so only those levels' query rows
// of out are written.  Returns cudaGetLastError() after the launch, or a
// negative code for arguments the kernel does not take.
template <class Coords, class Geo>
static int tile_fwd_entry(const void* value, const Coords& co, const Geo& geo, void* out,
                          int dtype, int bs, int K, int H, int D, int L, int P,
                          const int* level_h, const int* level_w, const int* tile_h,
                          const int* tile_w, const int* win_h, const int* win_w,
                          const int* staged, const int* off_b, const int* off_acc, int halo,
                          int smem_bytes, void* stream, int lq_begin = 0, int lq_end = -1) {
  if (D < 1 || D > 128) return -2;
  if (dtype != 0 && dtype != 1) return -4;
  if (P < 1 || P > 32) return -7;  // a round holds at least one query's taps
  const int elem = dtype == 0 ? 4 : 2;
  TilePlan tp;
  const int err = make_tile_plan(&tp, L, level_h, level_w, tile_h, tile_w, win_h, win_w, staged,
                                 off_b, off_acc, halo, D, P, elem, false, smem_bytes, K);
  if (err) return err;
  if (lq_end < 0) lq_end = L;
  if (lq_begin < 0 || lq_begin >= lq_end || lq_end > L) return -8;
  tp.tile_base = tp.tile_start[lq_begin];
  if (bs == 0 || H == 0) return 0;
  if (bs > 65535 || H > 65535) return -3;
  const int vec16 = (uintptr_t)value % 16 == 0 && (D * elem) % 16 == 0;
  const dim3 grid((unsigned)(tp.tile_start[lq_end] - tp.tile_base), (unsigned)H, (unsigned)bs);
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int W = Coords::kCorrection ? TILE_CORRECTION_WARPS : TILE_FWD_WARPS;
  if (dtype == 0) {
    if (D <= 32)
      return launch_tile_fwd<float, 1, W>(grid, smem_bytes, s, value, co, geo, out, tp, K, H, D, P,
                                          vec16);
    if (D <= 64)
      return launch_tile_fwd<float, 2, W / 2>(grid, smem_bytes, s, value, co, geo, out, tp, K, H, D,
                                              P, vec16);
    return launch_tile_fwd<float, 4, W / 4>(grid, smem_bytes, s, value, co, geo, out, tp, K, H, D,
                                            P, vec16);
  }
  if (D <= 32)
    return launch_tile_fwd<__nv_bfloat16, 1, W>(grid, smem_bytes, s, value, co, geo, out, tp, K, H,
                                                D, P, vec16);
  if (D <= 64)
    return launch_tile_fwd<__nv_bfloat16, 2, W / 2>(grid, smem_bytes, s, value, co, geo, out, tp,
                                                    K, H, D, P, vec16);
  return launch_tile_fwd<__nv_bfloat16, 4, W / 4>(grid, smem_bytes, s, value, co, geo, out, tp, K,
                                                  H, D, P, vec16);
}
