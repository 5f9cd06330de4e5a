// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces two TPU kernels, codetr_tpu/ops/msda_win.py:msda_win_lq_packed
// (K1, the windowed splat-matmul encoder kernel on packed coordinates) and
// msda_win_lq (K3, the same kernel on q-minor coordinates, driven by
// msda_win_qm), and serves the decoder's cross-attention too.  It computes
// the same function, exact MSDA: for each
// (batch, query, head) the sum over levels x points of
//   attention_weight * bilinear_sample(value[level, head], loc)
// with grid_sample's bilinear / zeros-padding / align_corners=False
// semantics (a location maps to pixel loc * size - 0.5; corners outside the
// level contribute zero).  Unlike the TPU kernels it is exact for every tap,
// so it has no window envelope, no out-of-envelope count (K3's with_count
// would always be 0) and no correction.
//
// Design: a direct gather.  One warp per (batch, query, head); lanes run
// over the head's d channels (d = 32 in the flagship: one lane each; any
// d <= 128 is handled by up to four channel slices per lane).  The warp
// loads up to 32 taps' coordinates and weights at once, one tap per lane,
// and broadcasts them with shuffles; every lane then computes the same
// corner geometry, and each valid corner reads the head's d contiguous
// channels (one 128-byte row in fp32).  Accumulation is fp32 whatever the
// value dtype; the output is written in the value's dtype.
//
// What bounds it: bytes.  An encoder call at 768x1152 moves ~0.3 GB (value,
// coordinates, output) for ~3 GFLOP, far below the card's FLOP/byte ridge.
// The value rows are read up to 4 x L x P times per (query, head); the
// design relies on the 50 MB L2 to serve those repeats (neighbouring
// queries of a level sample neighbouring rows), so device memory sees
// close to one read of each row.
//
// Three C entry points read three coordinate layouts with the same kernel,
// each layout a set of element strides (Stream):
//   msda_packed_fwd: the encoder's packed (bs, K, C) [x(HLP) | y(HLP) |
//                    w(HLP) | pad] tensor, HLP = heads*levels*points in
//                    (h, L, P) order (K1's contract).
//   msda_fwd:        the reference layout, sampling_locations
//                    (bs, Q, h, L, P, 2) and attention_weights
//                    (bs, Q, h, L, P).
//   msda_qm_fwd:     q-minor x, y and w, each (bs, h, L, P, Q) (K3's
//                    contract).  A warp's one-tap-per-lane coordinate loads
//                    are Q elements apart here, so each touches its own
//                    cache line where the packed layout's touch one; the
//                    neighbouring queries' warps reuse those lines from L2.
//                    Staging a tile of queries' coordinates through shared
//                    memory would coalesce them, and is not done yet.
// All return cudaGetLastError() after the launch (or a negative code for
// arguments the kernel does not take); none synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// dtype: 0 = float32 value/out, 1 = bfloat16 value/out.  Coordinates fp32.
extern "C" int msda_packed_fwd(const void* value, const void* cpk, void* out,
                               int dtype, int bs, int K, int H, int D, int L,
                               int P, int C, const int* level_h,
                               const int* level_w, void* stream) {
  Levels lv;
  if (make_levels(&lv, L, level_h, level_w)) return -1;
  const long long HLP = (long long)H * L * P;
  if (C < 3 * HLP) return -5;
  const float* c = (const float*)cpk;
  const long long LP = (long long)L * P;
  const long long row = (long long)K * C;  // one batch entry
  Stream xs = {c, row, C, LP, 1};
  Stream ys = {c + HLP, row, C, LP, 1};
  Stream ws = {c + 2 * HLP, row, C, LP, 1};
  return launch(dtype, value, xs, ys, ws, out, lv, bs, K, K, H, D, P, false, stream);
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
