// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces two TPU kernels, codetr_tpu/ops/msda_win.py:msda_win_lq_packed
// (K1, the windowed splat-matmul encoder kernel on packed coordinates,
// pallas_call at :711) and msda_win_lq (K3, the same kernel on q-minor
// coordinates, driven by msda_win_qm, pallas_call at :605), and serves the
// decoder's cross-attention too.  It computes the same function, exact
// MSDA: for each (batch, query, head) the sum over levels x points of
//   attention_weight * bilinear_sample(value[level, head], loc)
// with grid_sample's bilinear / zeros-padding / align_corners=False
// semantics (a location maps to pixel loc * size - 0.5; corners outside the
// level contribute zero).  Unlike the TPU kernels it is exact for every tap,
// so it has no window envelope, no out-of-envelope count (K3's with_count
// would always be 0) and no correction.
//
// Two designs, one per kind of query:
//
// The encoder (msda_packed_fwd, K1's contract): tiles in shared memory.
// The queries are the level-concatenated pixel grid, so a tile of
// same-level queries samples a bounded window of each target level
// (msda_tiles.cuh; the plan is ops/msda_tiles.py's).  One block of 32 warps
// per (batch, tile, head); the tile's queries are split over the warps.
// For each target level the block copies the pair's window of this head's
// channels into shared memory with cp.async, level lt + 1 into the second
// region while it samples level lt.  A warp takes its queries' taps of
// level lt (contiguous in the (h, L, P) packed order) in rounds of whole
// queries, one lane per tap for the geometry (fractions, validity, first
// corner's key and window pixel), and loads the next round's coordinates
// before it samples the current one.  The warp broadcasts each tap's four
// corner weights (0 outside the level), window pixel and corner mask with
// shuffles, and the lanes run over the head's channels (one lane per
// channel, up to four slices for d <= 128).  A tap whose valid corners all
// lie in the staged window reads them with four shared-memory loads and no
// branch; any other tap (outside the window, or of a pair whose window does
// not fit the budget) reads its four corners from global memory the same
// way, at keys clamped into the level, so the function stays exact.
// Per-query partial sums go into an fp32 accumulator in shared memory that
// each warp owns for its queries; the output is written in the value's
// dtype at the end.  In shared memory one pixel's 32 fp32 channels lie in
// 32 banks, and 32 bf16 channels in 16 words that lane pairs share, so the
// corner reads do not conflict.
//
// The decoder and the q-minor entry (msda_fwd, msda_qm_fwd): a direct
// gather.  One warp per (batch, query, head), lanes over channels; the warp
// loads up to 32 taps' coordinates at once, one tap per lane, broadcasts
// them, and every lane computes the same corner geometry; each valid
// corner reads the head's d contiguous channels (one 128-byte row in fp32)
// through L2.  The decoder's 900 box queries have no tile locality.
//
// What bounds it: bytes.  An encoder call at 768x1152 must move ~0.3 GB
// (value, coordinates, output) for ~3 GFLOP, far below the card's FLOP/byte
// ridge.  The direct gather reads each corner as a fresh 128-byte row from
// L2 (~6 GB per encoder call), so L2 bandwidth and the per-tap geometry,
// done 32 times over, set its pace.  The tiled design reads each window
// pixel from L2 once per (tile, head) and serves the corners from shared
// memory; the shuffles, loads and instructions per tap, and enough warps
// in flight to hide their latency, set its pace (PERF.md).
//
// Three C entry points:
//   msda_packed_fwd: the encoder's packed (bs, K, C) [x(HLP) | y(HLP) |
//                    w(HLP) | pad] tensor, HLP = heads*levels*points in
//                    (h, L, P) order (K1's contract), plus the tile plan.
//   msda_fwd:        the reference layout, sampling_locations
//                    (bs, Q, h, L, P, 2) and attention_weights
//                    (bs, Q, h, L, P).
//   msda_qm_fwd:     q-minor x, y and w, each (bs, h, L, P, Q) (K3's
//                    contract).  A warp's one-tap-per-lane coordinate loads
//                    are Q elements apart here, so each touches its own
//                    cache line where the packed layout's touch one; the
//                    neighbouring queries' warps reuse those lines from L2.
// The direct gather reads each layout through a set of element strides
// (Stream).  All return cudaGetLastError() after the launch (or a negative
// code for arguments the kernel does not take); none synchronises.

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

// Element strides of one coordinate stream (x, y or weights).
struct Stream {
  const float* base;
  long long b_stride;  // between batch entries
  long long q_stride;  // between queries
  long long h_stride;  // between heads
  long long t_stride;  // between taps (level-major, then point)
};

// Offset of one (batch, query, head) row in a stream.  Only a layout whose
// batch stride is not Q * q_stride (q-minor) splits bq = batch * Q + query:
// the split puts a second 64-bit division in front of the coordinate loads,
// which cost the packed encoder call ~3% on the card (PERF.md).
template <bool kSplitBatch>
__device__ __forceinline__ long long row_offset(const Stream& s, long long bq,
                                                long long b, int Q, int head) {
  const long long r =
      kSplitBatch ? b * s.b_stride + (bq - b * Q) * s.q_stride : bq * s.q_stride;
  return r + head * s.h_stride;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, bool kSplitBatch>
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK)
msda_fwd_kernel(const T* __restrict__ value,  // (bs, K, H, D)
                Stream xs, Stream ys, Stream ws,
                T* __restrict__ out,  // (bs, Q, H, D)
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

  const float* xrow = xs.base + row_offset<kSplitBatch>(xs, bq, b, Q, head);
  const float* yrow = ys.base + row_offset<kSplitBatch>(ys, bq, b, Q, head);
  const float* wrow = ws.base + row_offset<kSplitBatch>(ws, bq, b, Q, head);
  // row k of this (batch, head) starts at vbase + k * row_pitch
  const T* vbase = value + (b * K * H + head) * (long long)D;
  const long long row_pitch = (long long)H * D;

  float acc[MSDA_MAX_SLICES];
#pragma unroll
  for (int s = 0; s < MSDA_MAX_SLICES; ++s) acc[s] = 0.f;

  for (int t0 = 0; t0 < LP; t0 += 32) {
    const int t = t0 + lane;
    float xr = 0.f, yr = 0.f, wr = 0.f;
    if (t < LP) {
      xr = __ldg(xrow + t * xs.t_stride);
      yr = __ldg(yrow + t * ys.t_stride);
      wr = __ldg(wrow + t * ws.t_stride);
    }
    const int n = min(32, LP - t0);
    for (int i = 0; i < n; ++i) {
      const float lx = __shfl_sync(full, xr, i);
      const float ly = __shfl_sync(full, yr, i);
      const float a = __shfl_sync(full, wr, i);
      const int l = (t0 + i) / P;
      const int Wl = lv.w[l], Hl = lv.h[l];
      // rounded multiply, then subtract (no FMA contraction): the same
      // pixel coordinate as the plain version's loc * size - 0.5, whose
      // rounding at x ~ 288 is worth ~3e-5 px
      const float px = __fmul_rn(lx, (float)Wl) - 0.5f;
      const float py = __fmul_rn(ly, (float)Hl) - 0.5f;
      const float fx = floorf(px), fy = floorf(py);
      // validity decided on floats, so far-out (or non-finite) locations
      // never reach an int conversion; the same for every lane
      const bool vx0 = fx >= 0.f && fx <= (float)(Wl - 1);
      const bool vx1 = fx >= -1.f && fx <= (float)(Wl - 2);
      const bool vy0 = fy >= 0.f && fy <= (float)(Hl - 1);
      const bool vy1 = fy >= -1.f && fy <= (float)(Hl - 2);
      if (!((vx0 || vx1) && (vy0 || vy1))) continue;
      const float tx = px - fx, ty = py - fy;
      const int x0 = (int)fx, y0 = (int)fy;  // in [-1, W-1] x [-1, H-1]
      const float w00 = (1.f - tx) * (1.f - ty) * a;
      const float w10 = tx * (1.f - ty) * a;
      const float w01 = (1.f - tx) * ty * a;
      const float w11 = tx * ty * a;
      const long long r00 = lv.start[l] + (long long)y0 * Wl + x0;
      const T* p00 = vbase + r00 * row_pitch;
      const T* p10 = p00 + row_pitch;
      const T* p01 = p00 + (long long)Wl * row_pitch;
      const T* p11 = p01 + row_pitch;
#pragma unroll
      for (int s = 0; s < MSDA_MAX_SLICES; ++s) {
        const int c = lane + 32 * s;
        if (c < D) {
          float v = 0.f;
          if (vx0 && vy0) v += w00 * load_f32(p00 + c);
          if (vx1 && vy0) v += w10 * load_f32(p10 + c);
          if (vx0 && vy1) v += w01 * load_f32(p01 + c);
          if (vx1 && vy1) v += w11 * load_f32(p11 + c);
          acc[s] += v;
        }
      }
    }
  }

  T* orow = out + item * (long long)D;  // out is (bs, Q, H, D) = item-major
#pragma unroll
  for (int s = 0; s < MSDA_MAX_SLICES; ++s) {
    const int c = lane + 32 * s;
    if (c < D) store_from_f32(orow + c, acc[s]);
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
                         const void* value, Stream xs, Stream ys, Stream ws,
                         void* out, const Levels& lv, int K, int Q, int H, int D,
                         int P, long long n_items) {
  auto kernel = split_batch ? msda_fwd_kernel<T, true> : msda_fwd_kernel<T, false>;
  kernel<<<grid, block, 0, s>>>((const T*)value, xs, ys, ws, (T*)out, lv, K, Q,
                                H, D, P, n_items);
}

static int launch(int dtype, const void* value, Stream xs, Stream ys, Stream ws,
                  void* out, const Levels& lv, int bs, int K, int Q, int H, int D,
                  int P, bool split_batch, void* stream) {
  if (D < 1 || D > 32 * MSDA_MAX_SLICES) return -2;
  const long long n_items = (long long)bs * Q * H;
  if (n_items == 0) return 0;
  const long long blocks =
      (n_items + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return -3;
  const dim3 grid((unsigned)blocks), block(32 * MSDA_WARPS_PER_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_typed<float>(split_batch, grid, block, s, value, xs, ys, ws, out, lv,
                        K, Q, H, D, P, n_items);
  } else if (dtype == 1) {
    launch_typed<__nv_bfloat16>(split_batch, grid, block, s, value, xs, ys, ws,
                                out, lv, K, Q, H, D, P, n_items);
  } else {
    return -4;
  }
  return (int)cudaGetLastError();
}

// The encoder's tiled kernel: one block of kWarps warps per (tile, head,
// batch entry) = (blockIdx.x, blockIdx.y, blockIdx.z); S channel slices a
// lane (d <= 32 * S).  Shared memory: the even target levels' window region
// at 0, the odd ones' at off_b[lq], the fp32 accumulator (tile queries x D)
// at off_acc[lq].
//
// A warp takes its queries in rounds of 32 / P whole queries, one lane per
// tap, and loads the next round's coordinates before it samples the current
// one.  A tap whose valid corners all lie in the staged window takes the
// fast path: four shared-memory loads with no branch (a corner outside the
// level reads a clamped pixel and has weight 0, as in the plain version);
// any other tap reads its four corners from global memory the same way.
template <typename T, int S, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
msda_tile_fwd_kernel(const T* __restrict__ value,  // (bs, K, H, D)
                     const float* __restrict__ cpk,  // (bs, K, C)
                     T* __restrict__ out,  // (bs, K, H, D)
                     const TilePlan tp, int K, int H, int D, int P, int C,
                     int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned full = 0xffffffffu;
  const TileCoord tc = tile_coord(tp, blockIdx.x);
  const long long b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const WarpQueries wq = warp_queries(tc, kWarps, P);
  const int lane_q = lane / P, lane_p = lane - lane_q * P;  // this lane's tap in a round
  const int L = tp.n, LP = L * P, HLP = H * LP;
  const long long pitch = (long long)H * D;  // elements between keys
  float* acc = (float*)(smem + tp.off_acc[tc.lq]);

  const int head = blockIdx.y;
  const T* vb = value + (b * K * H + head) * D;  // key k's channels at vb + k * pitch
  const float* crow = cpk + b * K * C + head * LP + lane_p;  // + key * C + lt * P
  // this lane's tap of round r at level lt: its x, y and weight
  auto load_tap = [&](int lt, int r, float& x, float& y, float& a) {
    x = y = a = 0.f;
    const int j = r * wq.per_round + lane_q;
    if (lane_q < wq.per_round && j < wq.hi - wq.lo) {
      const float* c = crow + (long long)tile_query(tp, tc, wq.lo + j) * C + lt * P;
      x = __ldg(c);
      y = __ldg(c + HLP);
      a = __ldg(c + 2 * HLP);
    }
  };
  for (int i = wq.lo * D + lane; i < wq.hi * D; i += 32) acc[i] = 0.f;
  {
    const Window w0 = pair_window(tp, tc, 0);
    if (w0.staged) stage_window((T*)smem, vb, pitch, D, tp.start[0], tp.w[0], w0, vec16);
    cp_async_commit();
  }
  float xr, yr, ar;
  load_tap(0, 0, xr, yr, ar);
  for (int lt = 0; lt < L; ++lt) {
    if (lt + 1 < L) {  // the next level's window into the other region
      const Window wn = pair_window(tp, tc, lt + 1);
      T* dst = (T*)(smem + ((lt + 1) % 2 ? tp.off_b[tc.lq] : 0));
      if (wn.staged) stage_window(dst, vb, pitch, D, tp.start[lt + 1], tp.w[lt + 1], wn, vec16);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: level lt's window is in
    __syncthreads();

    const Window win = pair_window(tp, tc, lt);
    const T* ws = (const T*)(smem + (lt % 2 ? tp.off_b[tc.lq] : 0));
    const int last = win.h * win.w - 1;
    const int Ht = tp.h[lt], Wt = tp.w[lt], lstart = tp.start[lt];
    for (int r = 0; r < wq.rounds; ++r) {
      float xn, yn, an;  // the next round's tap, loaded ahead
      if (r + 1 < wq.rounds) load_tap(lt, r + 1, xn, yn, an);
      else load_tap(lt + 1 < L ? lt + 1 : lt, lt + 1 < L ? 0 : wq.rounds, xn, yn, an);
      // this lane's tap: corner weights (0 outside the level), first
      // corner's key and window pixel, corner mask
      const Tap g = tap_geometry(xr, yr, Ht, Wt, lstart, win);
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
            // into the level (a corner outside it has weight 0)
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
      xr = xn;
      yr = yn;
      ar = an;
    }
    __syncthreads();  // level lt's region is free for level lt + 2
  }

  for (int j = wq.lo; j < wq.hi; ++j) {
    T* orow = out + ((b * K + tile_query(tp, tc, j)) * H + head) * (long long)D;
    for (int ch = lane; ch < D; ch += 32) store_from_f32(orow + ch, acc[j * D + ch]);
  }
}

template <typename T, int S, int kWarps>
static int launch_tile_fwd(dim3 grid, int smem_bytes, cudaStream_t stream, const void* value,
                           const void* cpk, void* out, const TilePlan& tp, int K, int H, int D,
                           int P, int C, int vec16) {
  auto kernel = msda_tile_fwd_kernel<T, S, kWarps>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 32 * kWarps, smem_bytes, stream>>>((const T*)value, (const float*)cpk, (T*)out,
                                                    tp, K, H, D, P, C, vec16);
  return (int)cudaGetLastError();
}

// One instantiation per channel-slice count: 1 (d <= 32), 2 (<= 64), 4.
template <typename T>
static int launch_tile_fwd_slices(dim3 grid, int smem_bytes, cudaStream_t stream,
                                  const void* value, const void* cpk, void* out,
                                  const TilePlan& tp, int K, int H, int D, int P, int C,
                                  int vec16) {
  if (D <= 32)
    return launch_tile_fwd<T, 1, TILE_FWD_WARPS>(grid, smem_bytes, stream, value, cpk, out, tp,
                                                 K, H, D, P, C, vec16);
  if (D <= 64)
    return launch_tile_fwd<T, 2, TILE_FWD_WARPS / 2>(grid, smem_bytes, stream, value, cpk, out,
                                                     tp, K, H, D, P, C, vec16);
  return launch_tile_fwd<T, 4, TILE_FWD_WARPS / 4>(grid, smem_bytes, stream, value, cpk, out, tp,
                                                   K, H, D, P, C, vec16);
}

// dtype: 0 = float32 value/out, 1 = bfloat16 value/out.  Coordinates fp32.
// The tile plan (ops/msda_tiles.py): per query level its tile (tile_h,
// tile_w) and region offsets (off_b, off_acc, bytes), per pair lq * L + lt
// its window (win_h, win_w) and whether it is staged; halo; smem_bytes of
// dynamic shared memory per block.
extern "C" int msda_packed_fwd(const void* value, const void* cpk, void* out,
                               int dtype, int bs, int K, int H, int D, int L,
                               int P, int C, const int* level_h,
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
                                 staged, off_b, off_acc, halo, D, P, elem, false, smem_bytes, K);
  if (err) return err;
  if ((long long)H * L * P * 3 > C) return -5;
  if (bs == 0 || H == 0) return 0;
  if (bs > 65535 || H > 65535) return -3;
  const bool vec16 = (uintptr_t)value % 16 == 0 && (D * elem) % 16 == 0;
  const dim3 grid((unsigned)tp.tile_start[L], (unsigned)H, (unsigned)bs);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_tile_fwd_slices<float>(grid, smem_bytes, s, value, cpk, out, tp, K, H, D, P,
                                         C, vec16);
  return launch_tile_fwd_slices<__nv_bfloat16>(grid, smem_bytes, s, value, cpk, out, tp, K, H,
                                               D, P, C, vec16);
}

extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, int dtype, int bs, int K, int Q, int H, int D,
                        int L, int P, const int* level_h, const int* level_w,
                        void* stream) {
  Levels lv;
  if (make_levels(&lv, L, level_h, level_w)) return -1;
  const long long LP = (long long)L * P;
  const float* xy = (const float*)loc;
  const float* w = (const float*)attn;
  const long long HLP = H * LP;
  Stream xs = {xy, 2 * HLP * Q, 2 * HLP, 2 * LP, 2};
  Stream ys = {xy + 1, 2 * HLP * Q, 2 * HLP, 2 * LP, 2};
  Stream ws = {w, HLP * Q, HLP, LP, 1};
  return launch(dtype, value, xs, ys, ws, out, lv, bs, K, Q, H, D, P, false, stream);
}

// x, y, w: q-minor (bs, H, L, P, Q) fp32 each.
extern "C" int msda_qm_fwd(const void* value, const void* x, const void* y,
                           const void* w, void* out, int dtype, int bs, int K,
                           int Q, int H, int D, int L, int P,
                           const int* level_h, const int* level_w,
                           void* stream) {
  Levels lv;
  if (make_levels(&lv, L, level_h, level_w)) return -1;
  const long long LPQ = (long long)L * P * Q;
  Stream xs = {(const float*)x, H * LPQ, 1, LPQ, Q};
  Stream ys = {(const float*)y, H * LPQ, 1, LPQ, Q};
  Stream ws = {(const float*)w, H * LPQ, 1, LPQ, Q};
  return launch(dtype, value, xs, ys, ws, out, lv, bs, K, Q, H, D, P, true, stream);
}
