// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel K2, codetr_tpu/ops/msda_win_bwd.py:
// msda_win_lq_packed_bwd (the windowed read-modify-write backward of the
// encoder kernel), and serves the decoder's cross-attention and the q-minor
// entry (the gradient of K3's counterpart; the JAX package differentiates
// K3 through the XLA pair-gather VJP, ops/msda.py:829-835) too.  It is the
// exact vector-Jacobian product of msda_fwd.cu for every tap: given the
// upstream gradient g of one (batch, query, head) row, each tap (level l,
// point p, weight a, pixel (px, py) = (loc_x * W_l - 0.5, loc_y * H_l - 0.5),
// floor (x0, y0), fractions (tx, ty)) gives
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
// Design: the forward's warp layout.  One warp per (batch, query, head);
// lanes run over the head's d channels (any d <= 128, up to four slices a
// lane), so each corner is one coalesced row.  The warp loads up to 32
// taps' coordinates at once, one tap per lane, and broadcasts them with
// shuffles.  For each tap, grad_a and the two coordinate gradients are
// warp-shuffle sums over the channels; the warp owns the tap, so they need
// no atomics, and the lane that loaded the tap stores them.  grad_value is
// an fp32 atomicAdd scatter into a zeroed fp32 buffer that the caller
// allocates (and casts to bf16 for a bf16 value).
//
// What bounds it: bytes.  At the 768x1152 encoder shape a call must move
// ~0.5 GB (the value rows, the upstream gradient, the coordinates and
// their gradients, the value gradient), ~0.15 ms on an H100 SXM.  Its
// arithmetic is 12 fp32 operations per tap and channel (the four dot
// products g . v_corner as FMAs, which give the weight and both coordinate
// gradients once combined per tap, and the four scatter products), ~4.5
// GFLOP or ~0.07 ms; the scatter's adds run as atomics in L2, not on the
// fp32 pipes.  A decoder call is bound by writing the whole value gradient.
// The kernel is far from the bound: its atomics contend in L2 where
// neighbouring queries sample the same rows, which a shared-memory
// accumulation or a segmented reduce would cut.
//
// Three C entry points read three coordinate layouts with the same kernel,
// like msda_fwd.cu:
//   msda_packed_bwd: the encoder's packed (bs, K, C) [x(HLP) | y(HLP) |
//                    w(HLP) | pad] tensor; its gradient has the same layout
//                    (the caller zeroes the pad columns).
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

// Offset of one (batch, query, head) row in a stream; only the q-minor
// layout splits bq into batch and query (see msda_fwd.cu's row_offset).
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

// dtype: 0 = float32 value/grad_out, 1 = bfloat16 value/grad_out.
// Coordinates, weights and every gradient are fp32.
extern "C" int msda_packed_bwd(const void* value, const void* cpk,
                               const void* grad_out, void* grad_value,
                               void* grad_cpk, int dtype, int bs, int K, int H,
                               int D, int L, int P, int C, const int* level_h,
                               const int* level_w, void* stream) {
  Levels lv;
  if (make_levels(&lv, L, level_h, level_w)) return -1;
  const long long HLP = (long long)H * L * P;
  if (C < 3 * HLP) return -5;
  const float* c = (const float*)cpk;
  float* gc = (float*)grad_cpk;
  const long long LP = (long long)L * P;
  const long long row = (long long)K * C;  // one batch entry
  Stream xs = {c, gc, row, C, LP, 1};
  Stream ys = {c + HLP, gc + HLP, row, C, LP, 1};
  Stream ws = {c + 2 * HLP, gc + 2 * HLP, row, C, LP, 1};
  return launch(dtype, value, grad_out, xs, ys, ws, (float*)grad_value, lv, bs,
                K, K, H, D, P, false, stream);
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
