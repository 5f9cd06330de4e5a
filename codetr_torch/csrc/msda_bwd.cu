// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel K2, codetr_tpu/ops/msda_win_bwd.py:
// msda_win_lq_packed_bwd (the windowed read-modify-write backward of the
// encoder kernel, pallas_call at :306), and serves the decoder's
// cross-attention and the q-minor entry (the gradient of K3's counterpart;
// the JAX package differentiates K3 through the XLA pair-gather VJP,
// ops/msda.py:829-835) too.  It is the exact vector-Jacobian product of
// msda_fwd.cu for every tap: given the upstream gradient g of one (batch,
// query, head) row, each tap (level l, point p, weight a, pixel (px, py) =
// (loc_x * W_l - 0.5, loc_y * H_l - 0.5), floor (x0, y0), fractions (tx,
// ty)) gives
//   grad_value[corner] += a * hat_x * hat_y * g          (valid corners only)
//   grad_a  = sum_c g_c * sample_c
//   grad_px = a * sum_c g_c * ((1-ty)(v10 - v00) + ty (v11 - v01))
//   grad_py = a * sum_c g_c * ((1-tx)(v01 - v00) + tx (v11 - v10))
// and the location gradients in normalised units, grad_px * W_l and
// grad_py * H_l.  Corners outside the level read as zero, so they add
// nothing to the value gradient and nothing to the coordinate gradients.
// The derivative of the corner weights is the floor-based lerp's: -1 on
// u = tap - cell in [0, 1), +1 on [-1, 0), one-sided at a grid line (the
// convention of msda_win_bwd.py:196-217 and of autograd through the plain
// version).  The pixel coordinate uses the forward's rounded multiply.
//
// Two designs, as in msda_fwd.cu:
//
// The encoder (msda_packed_bwd): tiles in shared memory, on the forward's
// tile plan (msda_tiles.cuh, ops/msda_tiles.py).  One block of 32 warps per
// (batch, tile, head); it first copies the tile's upstream gradient rows
// into shared memory as fp32.  For each target level whose window is
// staged, the block copies the value window into shared memory as fp32
// (cp.async for fp32 values) and sorts the value gradient of the taps'
// in-window corners by window pixel: it counts each pixel's corners, scans
// the counts into offsets, and lists one (query, a * hat weight) entry per
// corner under its pixel, all with native shared-memory integer adds.
// Each lane works out one tap's geometry; the taps are then taken four at a
// time, 8 lanes a tap and 4 channels a lane, for the weight and coordinate
// gradients (per-tap sums over the tap's 8 lanes, no atomics: the warp owns
// the tap, and the lane that worked out its geometry stores them).  Corners
// outside the window are read from global memory and get their value
// gradient there with global atomics.  At the end of the level each window
// pixel sums its entries' a * hat * g over the channels and adds the sum to
// grad_value with one 16-byte vector atomic add per 4 channels; neighbouring
// tiles' windows overlap, so that add stays atomic (msda_tile_bwd_kernel).
//
// The decoder and the q-minor entry (msda_bwd, msda_qm_bwd): the forward's
// direct-gather layout.  One warp per (batch, query, head), lanes over the
// channels; every lane computes each tap's geometry in turn; grad_value is
// an fp32 atomicAdd scatter into global memory.
//
// Both write grad_value into a zeroed fp32 buffer that the caller allocates
// (and casts to bf16 for a bf16 value).
//
// What bounds it: bytes.  At the 768x1152 encoder shape a call must move
// ~0.5 GB (the value rows, the upstream gradient, the coordinates and
// their gradients, the value gradient), ~0.15 ms on an H100 SXM.  Its
// arithmetic is 12 fp32 operations per tap and channel (the four dot
// products g . v_corner as FMAs, which give the weight and both coordinate
// gradients once combined per tap, and the four scatter products), ~4.5
// GFLOP or ~0.07 ms; the scatter's adds run as atomics, not on the fp32
// pipes.  Neither kernel is near that bound.  The direct gather's ~1.5 G
// global atomics per encoder call contend in L2 where neighbouring queries
// sample the same rows.  The tiled design keeps the in-window ones off L2
// and sums them per pixel instead, since this card has no native fp32 add
// on shared memory (an atomicAdd there is a compare-and-swap loop); the
// per-tap instruction count and the block's barriers between passes, with
// one 1024-thread block an SM, set its pace (PERF.md).  A decoder call is bound
// by writing the whole value gradient.
//
// Three C entry points read three coordinate layouts, like msda_fwd.cu:
//   msda_packed_bwd: the encoder's packed (bs, K, C) [x(HLP) | y(HLP) |
//                    w(HLP) | pad] tensor, plus the tile plan; its gradient
//                    has the same layout (the caller zeroes the pad columns).
//   msda_bwd:        sampling_locations (bs, Q, h, L, P, 2) and
//                    attention_weights (bs, Q, h, L, P), and their
//                    gradients in the same layouts.
//   msda_qm_bwd:     q-minor x, y and w, each (bs, h, L, P, Q), and their
//                    gradients in the same layouts (uncoalesced coordinate
//                    loads and gradient stores, as msda_qm_fwd's).
// All return cudaGetLastError() after the launch (or a negative code for
// arguments the kernel does not take); none synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_tiles.cuh"

#define MSDA_MAX_LEVELS 8
#define MSDA_MAX_SLICES 4  // d <= 32 * MSDA_MAX_SLICES
#define MSDA_WARPS_PER_BLOCK 8

struct Levels {
  int n;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  long long start[MSDA_MAX_LEVELS];
};

// One coordinate stream (x, y or weights) and its gradient, which has the
// same element strides.
struct Stream {
  const float* base;
  float* grad;
  long long b_stride;  // between batch entries
  long long q_stride;  // between queries
  long long h_stride;  // between heads
  long long t_stride;  // between taps (level-major, then point)
};

// Offset of one (batch, query, head) row in a stream.  Only a layout whose
// batch stride is not Q * q_stride (q-minor) splits bq = batch * Q + query:
// the split puts a second 64-bit division in front of the coordinate loads,
// which cost the packed direct gather ~3% on the card (PERF.md).
template <bool kSplitBatch>
__device__ __forceinline__ long long row_offset(const Stream& s, long long bq,
                                                long long b, int Q, int head) {
  const long long r =
      kSplitBatch ? b * s.b_stride + (bq - b * Q) * s.q_stride : bq * s.q_stride;
  return r + head * s.h_stride;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, bool kSplitBatch>
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK)
msda_bwd_kernel(const T* __restrict__ value,     // (bs, K, H, D)
                const T* __restrict__ grad_out,  // (bs, Q, H, D)
                Stream xs, Stream ys, Stream ws,
                float* __restrict__ grad_value,  // (bs, K, H, D), zeroed
                Levels lv, int K, int Q, int H, int D, int P,
                long long n_items) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (item >= n_items) return;  // whole warp leaves together

  const int head = (int)(item % H);
  const long long bq = item / H;  // batch * Q + query
  const long long b = bq / Q;
  const int LP = lv.n * P;

  const long long xoff = row_offset<kSplitBatch>(xs, bq, b, Q, head);
  const long long yoff = row_offset<kSplitBatch>(ys, bq, b, Q, head);
  const long long woff = row_offset<kSplitBatch>(ws, bq, b, Q, head);
  // row k of this (batch, head) starts at base + k * row_pitch
  const long long vrow0 = (b * K * H + head) * (long long)D;
  const T* vbase = value + vrow0;
  float* gvbase = grad_value + vrow0;
  const long long row_pitch = (long long)H * D;

  float g[MSDA_MAX_SLICES];
  const T* grow = grad_out + item * (long long)D;  // item-major, like out
#pragma unroll
  for (int s = 0; s < MSDA_MAX_SLICES; ++s) {
    const int c = lane + 32 * s;
    g[s] = c < D ? load_f32(grow + c) : 0.f;
  }

  for (int t0 = 0; t0 < LP; t0 += 32) {
    const int t = t0 + lane;
    float xr = 0.f, yr = 0.f, wr = 0.f;
    if (t < LP) {
      xr = __ldg(xs.base + xoff + t * xs.t_stride);
      yr = __ldg(ys.base + yoff + t * ys.t_stride);
      wr = __ldg(ws.base + woff + t * ws.t_stride);
    }
    // this lane's tap's gradients, filled in by the iteration i == lane
    float gx = 0.f, gy = 0.f, gw = 0.f;
    const int n = min(32, LP - t0);
    for (int i = 0; i < n; ++i) {
      const float lx = __shfl_sync(full, xr, i);
      const float ly = __shfl_sync(full, yr, i);
      const float a = __shfl_sync(full, wr, i);
      const int l = (t0 + i) / P;
      const int Wl = lv.w[l], Hl = lv.h[l];
      // the forward's rounded multiply, then subtract (no FMA contraction)
      const float px = __fmul_rn(lx, (float)Wl) - 0.5f;
      const float py = __fmul_rn(ly, (float)Hl) - 0.5f;
      const float fx = floorf(px), fy = floorf(py);
      const bool vx0 = fx >= 0.f && fx <= (float)(Wl - 1);
      const bool vx1 = fx >= -1.f && fx <= (float)(Wl - 2);
      const bool vy0 = fy >= 0.f && fy <= (float)(Hl - 1);
      const bool vy1 = fy >= -1.f && fy <= (float)(Hl - 2);
      if (!((vx0 || vx1) && (vy0 || vy1))) continue;  // same for every lane
      const float tx = px - fx, ty = py - fy;
      const int x0 = (int)fx, y0 = (int)fy;  // in [-1, W-1] x [-1, H-1]
      const float h00 = (1.f - tx) * (1.f - ty);
      const float h10 = tx * (1.f - ty);
      const float h01 = (1.f - tx) * ty;
      const float h11 = tx * ty;
      const long long r00 = (lv.start[l] + (long long)y0 * Wl + x0) * row_pitch;
      const long long r10 = r00 + row_pitch;
      const long long r01 = r00 + (long long)Wl * row_pitch;
      const long long r11 = r01 + row_pitch;
      float s_w = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int s = 0; s < MSDA_MAX_SLICES; ++s) {
        const int c = lane + 32 * s;
        if (c < D) {
          const float v00 = (vx0 && vy0) ? load_f32(vbase + r00 + c) : 0.f;
          const float v10 = (vx1 && vy0) ? load_f32(vbase + r10 + c) : 0.f;
          const float v01 = (vx0 && vy1) ? load_f32(vbase + r01 + c) : 0.f;
          const float v11 = (vx1 && vy1) ? load_f32(vbase + r11 + c) : 0.f;
          const float gc = g[s];
          s_w += gc * (h00 * v00 + h10 * v10 + h01 * v01 + h11 * v11);
          s_x += gc * ((1.f - ty) * (v10 - v00) + ty * (v11 - v01));
          s_y += gc * ((1.f - tx) * (v01 - v00) + tx * (v11 - v10));
          const float ag = a * gc;
          if (vx0 && vy0) atomicAdd(gvbase + r00 + c, h00 * ag);
          if (vx1 && vy0) atomicAdd(gvbase + r10 + c, h10 * ag);
          if (vx0 && vy1) atomicAdd(gvbase + r01 + c, h01 * ag);
          if (vx1 && vy1) atomicAdd(gvbase + r11 + c, h11 * ag);
        }
      }
      s_w = warp_sum(s_w);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == i) {
        gw = s_w;
        gx = a * s_x * (float)Wl;
        gy = a * s_y * (float)Hl;
      }
    }
    if (t < LP) {
      xs.grad[xoff + t * xs.t_stride] = gx;
      ys.grad[yoff + t * ys.t_stride] = gy;
      ws.grad[woff + t * ws.t_stride] = gw;
    }
  }
}

static int make_levels(Levels* lv, int L, const int* level_h, const int* level_w) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return -1;
  lv->n = L;
  long long start = 0;
  for (int i = 0; i < MSDA_MAX_LEVELS; ++i) {
    lv->h[i] = i < L ? level_h[i] : 0;
    lv->w[i] = i < L ? level_w[i] : 0;
    lv->start[i] = start;
    if (i < L) start += (long long)level_h[i] * level_w[i];
  }
  return 0;
}

template <typename T>
static void launch_typed(bool split_batch, dim3 grid, dim3 block, cudaStream_t s,
                         const void* value, const void* grad_out, Stream xs,
                         Stream ys, Stream ws, float* grad_value, const Levels& lv,
                         int K, int Q, int H, int D, int P, long long n_items) {
  auto kernel = split_batch ? msda_bwd_kernel<T, true> : msda_bwd_kernel<T, false>;
  kernel<<<grid, block, 0, s>>>((const T*)value, (const T*)grad_out, xs, ys, ws,
                                grad_value, lv, K, Q, H, D, P, n_items);
}

static int launch(int dtype, const void* value, const void* grad_out, Stream xs,
                  Stream ys, Stream ws, float* grad_value, const Levels& lv,
                  int bs, int K, int Q, int H, int D, int P, bool split_batch,
                  void* stream) {
  if (D < 1 || D > 32 * MSDA_MAX_SLICES) return -2;
  const long long n_items = (long long)bs * Q * H;
  if (n_items == 0) return 0;
  const long long blocks =
      (n_items + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return -3;
  const dim3 grid((unsigned)blocks), block(32 * MSDA_WARPS_PER_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_typed<float>(split_batch, grid, block, s, value, grad_out, xs, ys, ws,
                        grad_value, lv, K, Q, H, D, P, n_items);
  } else if (dtype == 1) {
    launch_typed<__nv_bfloat16>(split_batch, grid, block, s, value, grad_out, xs,
                                ys, ws, grad_value, lv, K, Q, H, D, P, n_items);
  } else {
    return -4;
  }
  return (int)cudaGetLastError();
}

// The backward stages its value window in fp32 whatever the value's dtype,
// so the per-tap loop reads it with no conversion: fp32 values with
// cp.async (the caller commits and waits), bf16 values converted on the
// way, 8 channels a 16-byte load where rows allow it.
__device__ __forceinline__ void stage_window_f32(float* dst, const float* vb, long long pitch,
                                                 int D, int lstart, int Wt, const Window& win,
                                                 bool vec16) {
  stage_window(dst, vb, pitch, D, lstart, Wt, win, vec16);
}
__device__ __forceinline__ void stage_window_f32(float* dst, const __nv_bfloat16* vb,
                                                 long long pitch, int D, int lstart, int Wt,
                                                 const Window& win, bool vec16) {
  const int npx = win.h * win.w;
  if (vec16) {
    const int cpp = D / 8;  // 16-byte chunks per pixel
    for (int i = threadIdx.x; i < npx * cpp; i += blockDim.x) {
      const int px = i / cpp, sub = i - px * cpp;
      const int r = px / win.w, c = px - r * win.w;
      const uint4 u = __ldg((const uint4*)(vb + (long long)(lstart + (win.y0 + r) * Wt + win.x0 + c) * pitch) + sub);
      const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
      const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
      const float2 e = __bfloat1622float2(*(const __nv_bfloat162*)&u.z);
      const float2 f = __bfloat1622float2(*(const __nv_bfloat162*)&u.w);
      float4* d4 = (float4*)(dst + (long long)i * 8);
      d4[0] = make_float4(a.x, a.y, b.x, b.y);
      d4[1] = make_float4(e.x, e.y, f.x, f.y);
    }
  } else {
    for (int i = threadIdx.x; i < npx * D; i += blockDim.x) {
      const int px = i / D, ch = i - px * D;
      const int r = px / win.w, c = px - r * win.w;
      dst[i] = __bfloat162float(vb[(long long)(lstart + (win.y0 + r) * Wt + win.x0 + c) * pitch + ch]);
    }
  }
}

// In-place exclusive prefix sum of a[0, n) by the whole block (every thread
// calls it); warp_sums is 32 ints of shared memory that it may overwrite.
__device__ __forceinline__ void block_exclusive_scan(int* a, int n, int* warp_sums) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? a[i] : 0;
    int x = v;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' sums
      int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(full, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    if (i < n) a[i] = carry + (warp ? warp_sums[warp - 1] : 0) + x - v;
    carry += warp_sums[nwarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
}

// The encoder's tiled kernel: one block of kWarps warps per (tile, head,
// batch entry) = (blockIdx.x, blockIdx.y, blockIdx.z); d <= 32 * S.  Shared
// memory: the fp32 value window at 0, the window pixels' entry counts
// (then offsets) at off_b[lq], the entry list at off_acc[lq] (one (tile
// query, weight) int2 per in-window corner, at most 4 a tap), then the
// tile's upstream gradient rows in fp32, copied once at the start.
//
// Per staged target level, four passes of the block:
//   1. count: one lane per tap works out its geometry and adds 1 to the
//      count of each of its in-window corners' window pixels (a native
//      shared-memory integer add);
//   2. scan: the counts become each pixel's first entry;
//   3. taps: rounds of whole queries as in msda_fwd.cu's tiled kernel, one
//      lane per tap for the geometry.  That lane claims a slot in the list
//      of each of its in-window corners' pixels (an integer add that
//      returns the slot) and writes (tile query, a * hat weight) there.  The
//      taps are then taken four at a time for the weight and coordinate
//      gradients: each group of 8 lanes (lane / 8) takes one tap, each lane
//      4 of its channels a slice, so a tap's corner terms are summed over 8
//      lanes (3 shuffle steps) and each tap's geometry is broadcast once
//      per group.  A lane's channels are lane % 8 + 8 ((r + group) % 4),
//      r = 0..3, so the four groups' lanes read four different 8-bank
//      stripes of a pixel and the shared-memory loads do not conflict.  A
//      tap whose valid corners all lie in the staged window reads them from
//      there with no branch; any other tap reads the corners outside the
//      window from global memory and adds their value gradient there with
//      global atomics;
//   4. reduce: each window pixel's entries are summed, a * hat * g with g
//      the entry's query's staged gradient row, 8 lanes a pixel and 4
//      channels a lane (a warp a pixel when d is not a multiple of 4), and
//      added to grad_value with one 16-byte vector atomic add per 4
//      channels (neighbouring tiles' windows overlap, so it stays atomic).
// No floating-point atomic touches shared memory: this card has no native
// fp32 add there, and a compare-and-swap loop per (corner, channel) costs
// more than sorting the corners by pixel (PERF.md).  An unstaged level runs
// pass 3 alone, every corner to global memory.
template <typename T, int S, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
msda_tile_bwd_kernel(const T* __restrict__ value,     // (bs, K, H, D)
                     const float* __restrict__ cpk,   // (bs, K, C)
                     const T* __restrict__ grad_out,  // (bs, K, H, D)
                     float* __restrict__ grad_value,  // (bs, K, H, D), zeroed
                     float* __restrict__ grad_cpk,    // (bs, K, C)
                     const TilePlan tp, int K, int H, int D, int P, int C,
                     int vec16, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned full = 0xffffffffu;
  const TileCoord tc = tile_coord(tp, blockIdx.x);
  const long long b = blockIdx.z;
  const int head = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 3, sub = lane & 7;  // this lane's tap of four, and channel stripe
  const WarpQueries wq = warp_queries(tc, kWarps, P);
  const int lane_q = lane / P, lane_p = lane - lane_q * P;  // this lane's tap in a round
  const int L = tp.n, LP = L * P, HLP = H * LP;
  const long long pitch = (long long)H * D;  // elements between keys
  float* vwin = (float*)smem;  // fp32 whatever T
  int* first = (int*)(smem + tp.off_b[tc.lq]);
  int2* entry = (int2*)(smem + tp.off_acc[tc.lq]);
  // the tile's upstream gradient rows in fp32, tile query j's at + j * D
  float* gtile = (float*)(entry + max(4 * tp.th[tc.lq] * tp.tw[tc.lq] * P, 16));

  const long long hrow = (b * K * H + head) * D;  // key k's channels at + k * pitch
  const T* vb = value + hrow;
  const T* gb = grad_out + hrow;
  float* gvb = grad_value + hrow;
  const long long crow = b * K * C + head * LP + lane_p;  // + key * C + lt * P
  for (int j = warp; j < tc.rows * tc.cols; j += kWarps) {
    const T* src = gb + (long long)tile_query(tp, tc, j) * pitch;
    for (int c = lane; c < D; c += 32) gtile[j * D + c] = load_f32(src + c);
  }
  // this lane's tap of round r at level lt: its query's index in the tile
  // (-1: no tap) and key, x, y and weight
  auto load_tap = [&](int lt, int r, int& jl, int& key, float& x, float& y, float& a) {
    jl = key = -1;
    x = y = a = 0.f;
    const int j = wq.lo + r * wq.per_round + lane_q;
    if (lane_q < wq.per_round && j < wq.hi) {
      jl = j;
      key = tile_query(tp, tc, j);
      const float* c = cpk + crow + (long long)key * C + lt * P;
      x = __ldg(c);
      y = __ldg(c + HLP);
      a = __ldg(c + 2 * HLP);
    }
  };
  for (int lt = 0; lt < L; ++lt) {
    const Window win = pair_window(tp, tc, lt);
    const int Ht = tp.h[lt], Wt = tp.w[lt], lstart = tp.start[lt];
    const int npx = win.h * win.w, last = npx - 1;
    const int corner[4] = {0, 1, win.w, win.w + 1};  // window offsets of corners 00, 10, 01, 11
    if (win.staged) {
      stage_window_f32(vwin, vb, pitch, D, lstart, Wt, win, vec16);
      cp_async_commit();
      for (int i = threadIdx.x; i < npx; i += blockDim.x) first[i] = 0;
      __syncthreads();
      // pass 1: count each window pixel's in-window corners
      for (int r = 0; r < wq.rounds; ++r) {
        int jl, key;
        float x, y, a;
        load_tap(lt, r, jl, key, x, y, a);
        const Tap t = tap_geometry(x, y, Ht, Wt, lstart, win);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (jl >= 0 && (t.mask & (16u << k))) atomicAdd(first + t.s00 + corner[k], 1);
      }
      __syncthreads();
      // pass 2, its scratch in the entry list (unused until pass 3)
      block_exclusive_scan(first, npx, (int*)entry);
      cp_async_wait<0>();
    }
    __syncthreads();

    // pass 3
    int jl, key;
    float xr, yr, ar;
    load_tap(lt, 0, jl, key, xr, yr, ar);
    for (int r = 0; r < wq.rounds; ++r) {
      int jn, kn;
      float xn, yn, an;  // the next round's tap, loaded ahead
      load_tap(lt, r + 1, jn, kn, xn, yn, an);
      const Tap t = tap_geometry(xr, yr, Ht, Wt, lstart, win);
      if (jl >= 0 && (t.mask >> 4)) {  // this tap's in-window corners into their pixels' lists
        const float hat[4] = {(1.f - t.tx) * (1.f - t.ty), t.tx * (1.f - t.ty), (1.f - t.tx) * t.ty,
                              t.tx * t.ty};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (t.mask & (16u << k))
            entry[atomicAdd(first + t.s00 + corner[k], 1)] = make_int2(jl, __float_as_int(hat[k] * ar));
      }
      // this lane's tap's gradients, filled in by the step that sums it
      float gx = 0.f, gy = 0.f, gw = 0.f;
      const int j0 = wq.lo + r * wq.per_round;
      const int n_taps = min(wq.per_round, wq.hi - j0) * P;
      for (int k = 0; 4 * k < n_taps; ++k) {
        const int ti = 4 * k + grp;  // this lane's group's tap in the round
        const bool live = ti < n_taps;
        const int src = live ? ti : 0;
        unsigned m = __shfl_sync(full, t.mask, src);
        const float tx = __shfl_sync(full, t.tx, src);
        const float ty = __shfl_sync(full, t.ty, src);
        const float a = __shfl_sync(full, ar, src);
        const int so = __shfl_sync(full, t.s00, src);
        const int r00 = __shfl_sync(full, t.r00, src);
        const int qj = __shfl_sync(full, jl, src);
        if (!live) m = 0u;
        float s_w = 0.f, s_x = 0.f, s_y = 0.f;
        if (m) {  // the same for the group's lanes
          const float* grow = gtile + qj * D;
          const float h00 = (1.f - tx) * (1.f - ty);
          const float h10 = tx * (1.f - ty);
          const float h01 = (1.f - tx) * ty;
          const float h11 = tx * ty;
          const bool fast = in_window(m);
          // window offsets of the corners (clamped on the fast path)
          const int i00 = (fast ? clamp_px(so, last) : so) * D;
          const int i10 = (fast ? clamp_px(so + 1, last) : so + 1) * D;
          const int i01 = (fast ? clamp_px(so + win.w, last) : so + win.w) * D;
          const int i11 = (fast ? clamp_px(so + win.w + 1, last) : so + win.w + 1) * D;
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = sub + 8 * ((q + grp) & 3) + 32 * s;
              if (c >= D) continue;
              const float gc = grow[c];
              float v00, v10, v01, v11;
              if (fast) {
                v00 = m & 1u ? vwin[i00 + c] : 0.f;
                v10 = m & 2u ? vwin[i10 + c] : 0.f;
                v01 = m & 4u ? vwin[i01 + c] : 0.f;
                v11 = m & 8u ? vwin[i11 + c] : 0.f;
              } else {  // the level keys of the corners, for those outside the window
                const T* p00 = vb + (long long)r00 * pitch + c;
                const T* p10 = p00 + pitch;
                const T* p01 = p00 + (long long)Wt * pitch;
                const T* p11 = p01 + pitch;
                v00 = m & 1u ? (m & 16u ? vwin[i00 + c] : load_f32(p00)) : 0.f;
                v10 = m & 2u ? (m & 32u ? vwin[i10 + c] : load_f32(p10)) : 0.f;
                v01 = m & 4u ? (m & 64u ? vwin[i01 + c] : load_f32(p01)) : 0.f;
                v11 = m & 8u ? (m & 128u ? vwin[i11 + c] : load_f32(p11)) : 0.f;
                // the value gradient of the corners outside the window
                const float ag = a * gc;
                float* q00 = gvb + (long long)r00 * pitch + c;
                float* q10 = q00 + pitch;
                float* q01 = q00 + (long long)Wt * pitch;
                float* q11 = q01 + pitch;
                if ((m & 17u) == 1u) atomicAdd(q00, h00 * ag);
                if ((m & 34u) == 2u) atomicAdd(q10, h10 * ag);
                if ((m & 68u) == 4u) atomicAdd(q01, h01 * ag);
                if ((m & 136u) == 8u) atomicAdd(q11, h11 * ag);
              }
              // the sample and its derivatives along x and y, as lerps
              const float d0 = v10 - v00, d1 = v11 - v01;
              const float top = v00 + tx * d0, bot = v01 + tx * d1;
              const float dy = bot - top;
              s_w += gc * (top + ty * dy);
              s_x += gc * (d0 + ty * (d1 - d0));
              s_y += gc * dy;
            }
          }
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {  // sums over the group's 8 lanes
          s_w += __shfl_xor_sync(full, s_w, off);
          s_x += __shfl_xor_sync(full, s_x, off);
          s_y += __shfl_xor_sync(full, s_y, off);
        }
        // tap 4k + g belongs to lane 4k + g; its sums are in group g
        const float qw = __shfl_sync(full, s_w, 8 * (lane & 3));
        const float qx = __shfl_sync(full, s_x, 8 * (lane & 3));
        const float qy = __shfl_sync(full, s_y, 8 * (lane & 3));
        if ((lane >> 2) == k) {
          gw = qw;
          gx = ar * qx * (float)Wt;
          gy = ar * qy * (float)Ht;
        }
      }
      if (key >= 0) {
        float* gc = grad_cpk + crow + (long long)key * C + lt * P;
        gc[0] = gx;
        gc[HLP] = gy;
        gc[2 * HLP] = gw;
      }
      jl = jn;
      key = kn;
      xr = xn;
      yr = yn;
      ar = an;
    }
    __syncthreads();
    if (!win.staged) continue;

    // pass 4: each window pixel's entries [first[px - 1], first[px]) summed
    // into grad_value (pass 3 moved first[px] to the pixel's end)
    if (vec4) {
      for (int px = warp * 4 + grp; px < npx; px += kWarps * 4) {
        const int e0 = px ? first[px - 1] : 0, e1 = first[px];
        if (e0 == e1) continue;
        const int rr = px / win.w, cc = px - rr * win.w;
        float* dst = gvb + (long long)(lstart + (win.y0 + rr) * Wt + win.x0 + cc) * pitch;
        for (int c = 4 * sub; c < D; c += 32) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int e = e0; e < e1; ++e) {
            const int2 en = entry[e];
            const float we = __int_as_float(en.y);
            const float4 gv = *(const float4*)(gtile + en.x * D + c);
            acc.x += we * gv.x;
            acc.y += we * gv.y;
            acc.z += we * gv.z;
            acc.w += we * gv.w;
          }
          asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst + c), "f"(acc.x),
                       "f"(acc.y), "f"(acc.z), "f"(acc.w)
                       : "memory");
        }
      }
    } else {
      for (int px = warp; px < npx; px += kWarps) {
        const int e0 = px ? first[px - 1] : 0, e1 = first[px];
        if (e0 == e1) continue;
        const int rr = px / win.w, cc = px - rr * win.w;
        float* dst = gvb + (long long)(lstart + (win.y0 + rr) * Wt + win.x0 + cc) * pitch;
        for (int c = lane; c < D; c += 32) {
          float acc = 0.f;
          for (int e = e0; e < e1; ++e) {
            const int2 en = entry[e];
            acc += __int_as_float(en.y) * gtile[en.x * D + c];
          }
          atomicAdd(dst + c, acc);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int S, int kWarps>
static int launch_tile_bwd(dim3 grid, int smem_bytes, cudaStream_t stream, const void* value,
                           const void* cpk, const void* grad_out, void* grad_value,
                           void* grad_cpk, const TilePlan& tp, int K, int H, int D, int P, int C,
                           int vec16, int vec4) {
  auto kernel = msda_tile_bwd_kernel<T, S, kWarps>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 32 * kWarps, smem_bytes, stream>>>(
      (const T*)value, (const float*)cpk, (const T*)grad_out, (float*)grad_value,
      (float*)grad_cpk, tp, K, H, D, P, C, vec16, vec4);
  return (int)cudaGetLastError();
}

// One instantiation per channel-slice count: 1 (d <= 32), 2 (<= 64), 4.
template <typename T>
static int launch_tile_bwd_slices(dim3 grid, int smem_bytes, cudaStream_t stream,
                                  const void* value, const void* cpk, const void* grad_out,
                                  void* grad_value, void* grad_cpk, const TilePlan& tp, int K,
                                  int H, int D, int P, int C, int vec16, int vec4) {
  if (D <= 32)
    return launch_tile_bwd<T, 1, TILE_BWD_WARPS>(grid, smem_bytes, stream, value, cpk, grad_out,
                                                 grad_value, grad_cpk, tp, K, H, D, P, C, vec16,
                                                 vec4);
  if (D <= 64)
    return launch_tile_bwd<T, 2, TILE_BWD_WARPS / 2>(grid, smem_bytes, stream, value, cpk,
                                                     grad_out, grad_value, grad_cpk, tp, K, H, D,
                                                     P, C, vec16, vec4);
  return launch_tile_bwd<T, 4, TILE_BWD_WARPS / 4>(grid, smem_bytes, stream, value, cpk, grad_out,
                                                   grad_value, grad_cpk, tp, K, H, D, P, C, vec16,
                                                   vec4);
}

// dtype: 0 = float32 value/grad_out, 1 = bfloat16 value/grad_out.
// Coordinates, weights and every gradient are fp32.  The tile plan as
// msda_packed_fwd_levels takes it (off_b: the window pixels' counts; off_acc: the
// entry list).
extern "C" int msda_packed_bwd(const void* value, const void* cpk,
                               const void* grad_out, void* grad_value,
                               void* grad_cpk, int dtype, int bs, int K, int H,
                               int D, int L, int P, int C, const int* level_h,
                               const int* level_w, const int* tile_h,
                               const int* tile_w, const int* win_h,
                               const int* win_w, const int* staged,
                               const int* off_b, const int* off_acc, int halo,
                               int smem_bytes, void* stream) {
  if (D < 1 || D > 32 * MSDA_MAX_SLICES) return -2;
  if (dtype != 0 && dtype != 1) return -4;
  if (P < 1 || P > 32) return -7;  // a round holds at least one query's taps
  const int elem = dtype == 0 ? 4 : 2;
  TilePlan tp;
  const int err = make_tile_plan(&tp, L, level_h, level_w, tile_h, tile_w, win_h, win_w,
                                 staged, off_b, off_acc, halo, D, P, 4, true, smem_bytes, K);
  if (err) return err;
  if ((long long)H * L * P * 3 > C) return -5;
  if (bs == 0 || H == 0) return 0;
  if (bs > 65535 || H > 65535) return -3;
  const bool vec16 = (uintptr_t)value % 16 == 0 && (D * elem) % 16 == 0;
  // 4 channels a lane in the reduce: 16-byte atomic adds to grad_value
  const bool vec4 = D % 4 == 0 && (uintptr_t)grad_value % 16 == 0;
  const dim3 grid((unsigned)tp.tile_start[L], (unsigned)H, (unsigned)bs);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_tile_bwd_slices<float>(grid, smem_bytes, s, value, cpk, grad_out, grad_value,
                                         grad_cpk, tp, K, H, D, P, C, vec16, vec4);
  return launch_tile_bwd_slices<__nv_bfloat16>(grid, smem_bytes, s, value, cpk, grad_out,
                                               grad_value, grad_cpk, tp, K, H, D, P, C, vec16,
                                               vec4);
}

extern "C" int msda_bwd(const void* value, const void* loc, const void* attn,
                        const void* grad_out, void* grad_value, void* grad_loc,
                        void* grad_attn, int dtype, int bs, int K, int Q, int H,
                        int D, int L, int P, const int* level_h,
                        const int* level_w, void* stream) {
  Levels lv;
  if (make_levels(&lv, L, level_h, level_w)) return -1;
  const long long LP = (long long)L * P;
  const float* xy = (const float*)loc;
  const float* w = (const float*)attn;
  float* gxy = (float*)grad_loc;
  float* gw = (float*)grad_attn;
  const long long HLP = H * LP;
  Stream xs = {xy, gxy, 2 * HLP * Q, 2 * HLP, 2 * LP, 2};
  Stream ys = {xy + 1, gxy + 1, 2 * HLP * Q, 2 * HLP, 2 * LP, 2};
  Stream ws = {w, gw, HLP * Q, HLP, LP, 1};
  return launch(dtype, value, grad_out, xs, ys, ws, (float*)grad_value, lv, bs,
                K, Q, H, D, P, false, stream);
}

// x, y, w and their gradients: q-minor (bs, H, L, P, Q) fp32 each.
extern "C" int msda_qm_bwd(const void* value, const void* x, const void* y,
                           const void* w, const void* grad_out,
                           void* grad_value, void* grad_x, void* grad_y,
                           void* grad_w, int dtype, int bs, int K, int Q,
                           int H, int D, int L, int P, const int* level_h,
                           const int* level_w, void* stream) {
  Levels lv;
  if (make_levels(&lv, L, level_h, level_w)) return -1;
  const long long LPQ = (long long)L * P * Q;
  Stream xs = {(const float*)x, (float*)grad_x, H * LPQ, 1, LPQ, Q};
  Stream ys = {(const float*)y, (float*)grad_y, H * LPQ, 1, LPQ, Q};
  Stream ws = {(const float*)w, (float*)grad_w, H * LPQ, 1, LPQ, Q};
  return launch(dtype, value, grad_out, xs, ys, ws, (float*)grad_value, lv, bs,
                K, Q, H, D, P, true, stream);
}
