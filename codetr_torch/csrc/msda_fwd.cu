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
// The grid queries (msda_packed_fwd_levels, K1's contract; msda_qm_fwd, K3's):
// tiles in shared memory.  The queries are the level-concatenated pixel
// grid, so a tile of same-level queries samples a bounded window of each
// target level (msda_tiles.cuh holds the kernel, msda_tile_fwd_kernel; the
// plan is ops/msda_tiles.py's, the same for both entries).  One block of 32
// warps per (batch, tile, head); the tile's queries are split over the
// warps.  For each target level the block copies the pair's window of this
// head's channels into shared memory with cp.async, level lt + 1 into the
// second region while it samples level lt.  A warp takes its queries' taps
// of level lt in rounds of whole queries, one lane per tap for the geometry
// (fractions, validity, first corner's key and window pixel), and loads the
// next round's coordinates before it samples the current one: from the
// packed rows (K1) or from the q-minor planes (K3), where the lanes of one
// point hold consecutive keys of a tile row.  The warp broadcasts each
// tap's four corner weights (0 outside the level), window pixel and corner
// mask with shuffles, and the lanes run over the head's channels (one lane
// per channel, up to four slices for d <= 128).  A tap whose valid corners
// all lie in the staged window reads them with four shared-memory loads
// and no branch; any other tap (outside the window, or of a pair whose
// window does not fit the budget) reads its four corners from global
// memory the same way, at keys clamped into the level, so the function
// stays exact.  Per-query partial sums go into an fp32 accumulator in
// shared memory that each warp owns for its queries; the output is written
// in the value's dtype at the end.  In shared memory one pixel's 32 fp32
// channels lie in 32 banks, and 32 bf16 channels in 16 words that lane
// pairs share, so the corner reads do not conflict.
//
// The decoder (msda_fwd): a direct gather.  One warp per (batch, query,
// head), lanes over channels; the warp loads up to 32 taps' coordinates at
// once, one tap per lane, broadcasts them, and every lane computes the
// same corner geometry; each valid corner reads the head's d contiguous
// channels (one 128-byte row in fp32) through L2.  The decoder's 900 box
// queries have no tile locality.
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
// The correction entry (msda_qm_correction_fwd) is K3's loop once more,
// for the grid impls' corrected dispatch (ops/msda.py:msda_grid_qm): the
// shift-window function (K4) is exact only inside its window envelope, so
// the dispatcher masks the taps outside it out of K4's call and this entry
// adds their exact sum into K4's output in place.  It takes the q-minor
// coordinates with those taps' weights (every other weight 0) and the
// device count of the taps outside the envelope, so nothing is decided on
// the host and the call can be captured in a CUDA graph (the JAX package
// decides it under lax.cond).  Its plan stages no window (a few taps in
// ten thousand are out, scattered) and its blocks are of 8 warps, not 32; a
// block returns at once when the count is 0, a warp skips each round in
// which no tap has a weight, a lane reads x and y only under a nonzero
// weight, and only the output elements a corrected tap added to are read
// and written.
//
// Four C entry points:
//   msda_packed_fwd_levels: the encoder's packed (bs, K, C) [x(HLP) |
//                    y(HLP) | w(HLP) | pad] tensor, HLP = heads*levels*points
//                    in (h, L, P) order (K1's contract), plus the tile plan
//                    and a range of query levels: (0, L) for the whole call
//                    (the JAX package's K1 takes one query level a call).
//   msda_qm_fwd:     q-minor x, y and w, each (bs, h, L, P, K) (K3's
//                    contract), plus the same tile plan.
//   msda_qm_correction_fwd: msda_qm_fwd's arguments plus the count (one
//                    int64 on the device); adds into out in place.
//   msda_fwd:        the reference layout, sampling_locations
//                    (bs, Q, h, L, P, 2) and attention_weights
//                    (bs, Q, h, L, P).
// The direct gather reads its layout through a set of element strides
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
  long long q_stride;  // between (batch, query) rows
  long long h_stride;  // between heads
  long long t_stride;  // between taps (level-major, then point)
};

template <typename T>
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

  const float* xrow = xs.base + bq * xs.q_stride + head * xs.h_stride;
  const float* yrow = ys.base + bq * ys.q_stride + head * ys.h_stride;
  const float* wrow = ws.base + bq * ws.q_stride + head * ws.h_stride;
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

static int launch(int dtype, const void* value, Stream xs, Stream ys, Stream ws,
                  void* out, const Levels& lv, int bs, int K, int Q, int H, int D,
                  int P, void* stream) {
  if (D < 1 || D > 32 * MSDA_MAX_SLICES) return -2;
  const long long n_items = (long long)bs * Q * H;
  if (n_items == 0) return 0;
  const long long blocks =
      (n_items + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return -3;
  const dim3 grid((unsigned)blocks), block(32 * MSDA_WARPS_PER_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    msda_fwd_kernel<float><<<grid, block, 0, s>>>((const float*)value, xs, ys, ws, (float*)out,
                                                  lv, K, Q, H, D, P, n_items);
  } else if (dtype == 1) {
    msda_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)value, xs, ys, ws, (__nv_bfloat16*)out, lv, K, Q, H, D, P, n_items);
  } else {
    return -4;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 value/out, 1 = bfloat16 value/out.  Coordinates fp32.
// The tile plan (ops/msda_tiles.py): per query level its tile (tile_h,
// tile_w) and region offsets (off_b, off_acc, bytes), per pair lq * L + lt
// its window (win_h, win_w) and whether it is staged; halo; smem_bytes of
// dynamic shared memory per block.
// msda_packed_fwd_levels: the query levels [lq_begin, lq_end) alone, (0, L)
// for every query (tools/winbench.py times one level a call): the same plan
// and kernel, one block per tile of those levels; out's rows of the other
// levels are not written.
extern "C" int msda_packed_fwd_levels(const void* value, const void* cpk, void* out,
                                      int dtype, int bs, int K, int H, int D, int L,
                                      int P, int C, const int* level_h,
                                      const int* level_w, const int* tile_h,
                                      const int* tile_w, const int* win_h,
                                      const int* win_w, const int* staged,
                                      const int* off_b, const int* off_acc, int halo,
                                      int smem_bytes, int lq_begin, int lq_end,
                                      void* stream) {
  if ((long long)H * L * P * 3 > C) return -5;
  const PackedCoords co{(const float*)cpk, C, H * L * P};
  return tile_fwd_entry(value, co, HaloGeo{}, out, dtype, bs, K, H, D, L, P, level_h, level_w,
                        tile_h, tile_w, win_h, win_w, staged, off_b, off_acc, halo, smem_bytes,
                        stream, lq_begin, lq_end);
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
  Stream xs = {xy, 2 * HLP, 2 * LP, 2};
  Stream ys = {xy + 1, 2 * HLP, 2 * LP, 2};
  Stream ws = {w, HLP, LP, 1};
  return launch(dtype, value, xs, ys, ws, out, lv, bs, K, Q, H, D, P, stream);
}

// x, y, w: q-minor (bs, H, L, P, K) fp32 each, the queries the key grid;
// the tile plan as msda_packed_fwd_levels takes it (the same plan).
extern "C" int msda_qm_fwd(const void* value, const void* x, const void* y,
                           const void* w, void* out, int dtype, int bs, int K,
                           int H, int D, int L, int P, const int* level_h,
                           const int* level_w, const int* tile_h,
                           const int* tile_w, const int* win_h,
                           const int* win_w, const int* staged,
                           const int* off_b, const int* off_acc, int halo,
                           int smem_bytes, void* stream) {
  const QminorCoords co{(const float*)x, (const float*)y, (const float*)w};
  return tile_fwd_entry(value, co, HaloGeo{}, out, dtype, bs, K, H, D, L, P, level_h, level_w,
                        tile_h, tile_w, win_h, win_w, staged, off_b, off_acc, halo, smem_bytes,
                        stream);
}

// The correction: msda_qm_fwd's contract with w the weights of the taps to
// correct (0 elsewhere) and count (int64, on the device) their number; adds
// their exact MSDA into out, which holds the window call's result, in place.
// The plan stages no window (ops/msda_tiles.py:correction_plan).
extern "C" int msda_qm_correction_fwd(const void* value, const void* x, const void* y,
                                      const void* w, const void* count, void* out, int dtype,
                                      int bs, int K, int H, int D, int L, int P,
                                      const int* level_h, const int* level_w,
                                      const int* tile_h, const int* tile_w, const int* win_h,
                                      const int* win_w, const int* staged, const int* off_b,
                                      const int* off_acc, int halo, int smem_bytes,
                                      void* stream) {
  CorrectionCoords co;
  co.x = (const float*)x;
  co.y = (const float*)y;
  co.w = (const float*)w;
  co.count = (const long long*)count;
  return tile_fwd_entry(value, co, HaloGeo{}, out, dtype, bs, K, H, D, L, P, level_h, level_w,
                        tile_h, tile_w, win_h, win_w, staged, off_b, off_acc, halo, smem_bytes,
                        stream);
}
