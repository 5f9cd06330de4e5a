// In-kernel microbenchmarks of gather against plane arithmetic, for Hopper
// (sm_90a): kernel K5.
//
// Replaces tools/gatherbench.py:48 (_call, the pallas_call of five TPU
// microbenchmarks) and asks its question again for this card: what an
// in-core gather costs next to the plane operations (adds, products, fused
// multiply-adds) that the windowed MSDA kernels spend their time on.  On
// the TPU the gather is Mosaic's sublane / lane dynamic_gather inside VMEM;
// here it is a shared-memory gather.
//
// Each op runs R iterations inside the kernel.  Iteration i computes a
// whole plane from inputs perturbed by i, and each element's R results are
// summed in iteration order in fp32; the sums of the plane's first 8 rows
// and first 128 columns are written to the (8, 128) checksum, bit-for-bit
// the TPU kernel's fold (fma1 and splat2 up to their rounding, see below).
// Each thread adds every other element's sum into a register and stores it
// to the sink only if it equals `never`, which the host passes as NaN: the
// store never happens, but the compiler cannot prove it, so it cannot drop
// the work the benchmark times (and no atomics or zeroed sink cost time).
//
//   gb_gather_sub:  g[r, c] = x[(idx[r, c] + i) mod n, c]  (x fp32 or bf16
//                   (n, m)): a block stages a column stripe x[:, c0:c0+32]
//                   in dynamic shared memory (up to 1040 x 32 x 4 B = 133
//                   KB) and gathers along rows, one lane per column.
//   gb_gather_lane: g[r, c] = x[r, (idx[r, c] + i) mod m]  (x fp32): a block
//                   stages 8 whole rows and gathers along columns.
//   gb_idxadd:      (idx[r, c] + i) mod n as fp32: an int add per element.
//   gb_splat2:      s[a, b, q] = (hy[a, q] + i) * hx[b, q], the windowed
//                   kernel's splat unit, a product and an add per element,
//                   the product rounded on its own (no contraction), as the
//                   TPU kernel's two plane ops.
//   gb_fma1:        fmaf(a, b, c + i): is the multiply-add fused?  The
//                   TPU's checksum rounds a * b first, so the two differ by
//                   that rounding.
// The modulo in the gathers is kept incrementally (j = j + 1, wrapping to 0
// at n), which gives (idx + i) mod n for every i once idx is reduced.
//
// What bounds them: the gathers, shared-memory bandwidth (one 4- or 2-byte
// read per element and iteration); the others, the fp32 and int32 pipes
// (one to three operations per element and iteration).  The inputs are
// read from device memory once.
//
// All entries return cudaGetLastError() after the launch, or a negative
// code for arguments the kernels do not take; none synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define GB_THREADS 256
#define GB_STRIPE 32      // gather_sub: columns per block
#define GB_SUB_ROWS 64    // gather_sub: rows per block
#define GB_LANE_ROWS 8    // gather_lane: rows per block (one per warp)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int floor_mod(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// one element's R-iteration sum: to the checksum if it lies in the (8, 128)
// corner, else into the thread's sink register
__device__ __forceinline__ void fold(float* checksum, float& sink, int row, int col, float v) {
  if (row < 8 && col < 128) {
    checksum[row * 128 + col] = v;
  } else {
    sink += v;
  }
}

// the store the compiler has to keep (`never` is NaN at run time)
__device__ __forceinline__ void flush_sink(float* sink, float v, float never) {
  if (v == never) *sink = v;
}

template <typename T>
__global__ void __launch_bounds__(GB_THREADS)
gather_sub_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                  float* __restrict__ checksum, float* __restrict__ sink, int n,
                  int m, int R, float never) {
  extern __shared__ unsigned char smem_raw[];
  T* stripe = reinterpret_cast<T*>(smem_raw);  // (n, GB_STRIPE)
  const int c0 = blockIdx.x * GB_STRIPE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = c0 + lane;
  for (int k = threadIdx.x; k < n * GB_STRIPE; k += GB_THREADS) {
    const int r = k / GB_STRIPE, c = c0 + k % GB_STRIPE;
    stripe[k] = c < m ? x[(long long)r * m + c] : T(0.f);
  }
  __syncthreads();
  float s = 0.f;
  if (col < m) {
    const int r_end = min(n, (blockIdx.y + 1) * GB_SUB_ROWS);
    for (int r = blockIdx.y * GB_SUB_ROWS + warp; r < r_end; r += GB_THREADS / 32) {
      int j = floor_mod(__ldg(idx + (long long)r * m + col), n);
      float v = 0.f;
      for (int i = 0; i < R; ++i) {
        v += to_f32(stripe[j * GB_STRIPE + lane]);
        j = j + 1 == n ? 0 : j + 1;
      }
      fold(checksum, s, r, col, v);
    }
  }
  flush_sink(sink, s, never);
}

__global__ void __launch_bounds__(GB_THREADS)
gather_lane_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ checksum, float* __restrict__ sink, int n,
                   int m, int R, float never) {
  extern __shared__ unsigned char smem_raw[];
  float* rows = reinterpret_cast<float*>(smem_raw);  // (GB_LANE_ROWS, m)
  const int r0 = blockIdx.x * GB_LANE_ROWS;
  for (int k = threadIdx.x; k < GB_LANE_ROWS * m; k += GB_THREADS) {
    const int r = r0 + k / m;
    rows[k] = r < n ? x[(long long)r0 * m + k] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = r0 + warp;
  float s = 0.f;
  if (r < n) {
    const float* row = rows + warp * m;
    for (int col = lane; col < m; col += 32) {
      int j = floor_mod(__ldg(idx + (long long)r * m + col), m);
      float v = 0.f;
      for (int i = 0; i < R; ++i) {
        v += row[j];
        j = j + 1 == m ? 0 : j + 1;
      }
      fold(checksum, s, r, col, v);
    }
  }
  flush_sink(sink, s, never);
}

__global__ void __launch_bounds__(GB_THREADS)
idxadd_kernel(const int* __restrict__ idx, float* __restrict__ checksum,
              float* __restrict__ sink, int n, int m, int R, float never) {
  const long long e = (long long)blockIdx.x * GB_THREADS + threadIdx.x;
  float s = 0.f;
  if (e < (long long)n * m) {
    int j = floor_mod(__ldg(idx + e), n);
    float v = 0.f;
    for (int i = 0; i < R; ++i) {
      v += (float)j;
      j = j + 1 == n ? 0 : j + 1;
    }
    fold(checksum, s, (int)(e / m), (int)(e % m), v);
  }
  flush_sink(sink, s, never);
}

// one thread per (b, q); it loops over the wh rows a of the splat
__global__ void __launch_bounds__(GB_THREADS)
splat2_kernel(const float* __restrict__ hy, const float* __restrict__ hx,
              float* __restrict__ checksum, float* __restrict__ sink, int wh, int ww,
              int nq, int R, float never) {
  const long long e = (long long)blockIdx.x * GB_THREADS + threadIdx.x;
  float s = 0.f;
  if (e < (long long)ww * nq) {
    const int b = (int)(e / nq), q = (int)(e % nq);
    const float x = __ldg(hx + e);
    for (int a = 0; a < wh; ++a) {
      const float y = __ldg(hy + (long long)a * nq + q);
      float v = 0.f;
      for (int i = 0; i < R; ++i) v += __fmul_rn(y + (float)i, x);
      fold(checksum, s, a * ww + b, q, v);  // row of the (wh * ww, nq) plane
    }
  }
  flush_sink(sink, s, never);
}

__global__ void __launch_bounds__(GB_THREADS)
fma1_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, float* __restrict__ checksum,
            float* __restrict__ sink, int n, int m, int R, float never) {
  const long long e = (long long)blockIdx.x * GB_THREADS + threadIdx.x;
  float s = 0.f;
  if (e < (long long)n * m) {
    const float av = __ldg(a + e), bv = __ldg(b + e), cv = __ldg(c + e);
    float v = 0.f;
    for (int i = 0; i < R; ++i) v += fmaf(av, bv, cv + (float)i);
    fold(checksum, s, (int)(e / m), (int)(e % m), v);
  }
  flush_sink(sink, s, never);
}

static const float kNever = __builtin_nanf("");

static unsigned elementwise_blocks(long long count) {
  return (unsigned)((count + GB_THREADS - 1) / GB_THREADS);
}

// dtype: 0 = float32 x, 1 = bfloat16 x.
extern "C" int gb_gather_sub(const void* x, const void* idx, void* checksum, void* sink,
                             int dtype, int n, int m, int R, void* stream) {
  if (n < 1 || m < 1 || R < 0) return -1;
  const size_t elt = dtype == 0 ? 4 : 2;
  const size_t smem = (size_t)n * GB_STRIPE * elt;
  const dim3 grid((m + GB_STRIPE - 1) / GB_STRIPE, (n + GB_SUB_ROWS - 1) / GB_SUB_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    cudaFuncSetAttribute(gather_sub_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    gather_sub_kernel<float><<<grid, GB_THREADS, smem, s>>>(
        (const float*)x, (const int*)idx, (float*)checksum, (float*)sink, n, m, R, kNever);
  } else if (dtype == 1) {
    cudaFuncSetAttribute(gather_sub_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    gather_sub_kernel<__nv_bfloat16><<<grid, GB_THREADS, smem, s>>>(
        (const __nv_bfloat16*)x, (const int*)idx, (float*)checksum, (float*)sink, n,
        m, R, kNever);
  } else {
    return -4;
  }
  return (int)cudaGetLastError();
}

extern "C" int gb_gather_lane(const void* x, const void* idx, void* checksum, void* sink,
                              int n, int m, int R, void* stream) {
  if (n < 1 || m < 1 || R < 0) return -1;
  const size_t smem = (size_t)GB_LANE_ROWS * m * sizeof(float);
  cudaFuncSetAttribute(gather_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  gather_lane_kernel<<<(n + GB_LANE_ROWS - 1) / GB_LANE_ROWS, GB_THREADS, smem,
                       (cudaStream_t)stream>>>((const float*)x, (const int*)idx,
                                               (float*)checksum, (float*)sink, n, m, R,
                                               kNever);
  return (int)cudaGetLastError();
}

extern "C" int gb_idxadd(const void* idx, void* checksum, void* sink, int n, int m, int R,
                         void* stream) {
  if (n < 1 || m < 1 || R < 0) return -1;
  idxadd_kernel<<<elementwise_blocks((long long)n * m), GB_THREADS, 0,
                  (cudaStream_t)stream>>>((const int*)idx, (float*)checksum,
                                          (float*)sink, n, m, R, kNever);
  return (int)cudaGetLastError();
}

extern "C" int gb_splat2(const void* hy, const void* hx, void* checksum, void* sink, int wh,
                         int ww, int nq, int R, void* stream) {
  if (wh < 1 || ww < 1 || nq < 1 || R < 0) return -1;
  splat2_kernel<<<elementwise_blocks((long long)ww * nq), GB_THREADS, 0,
                  (cudaStream_t)stream>>>((const float*)hy, (const float*)hx,
                                          (float*)checksum, (float*)sink, wh, ww, nq, R,
                                          kNever);
  return (int)cudaGetLastError();
}

extern "C" int gb_fma1(const void* a, const void* b, const void* c, void* checksum,
                       void* sink, int n, int m, int R, void* stream) {
  if (n < 1 || m < 1 || R < 0) return -1;
  fma1_kernel<<<elementwise_blocks((long long)n * m), GB_THREADS, 0,
                (cudaStream_t)stream>>>((const float*)a, (const float*)b,
                                        (const float*)c, (float*)checksum, (float*)sink,
                                        n, m, R, kNever);
  return (int)cudaGetLastError();
}
