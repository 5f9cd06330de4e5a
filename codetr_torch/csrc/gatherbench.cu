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
// Each op runs R = 64 iterations inside the kernel.  Iteration i computes a
// whole plane from inputs perturbed by i, and each element's R results are
// summed in iteration order in fp32; the sums of the plane's first 8 rows
// and first 128 columns are written to the (8, 128) checksum, bit-for-bit
// the TPU kernel's fold (fma1 and splat2 up to their rounding, see below).
// Each thread adds every other element's sum into a register and stores it
// to the sink only if it equals `never`, which the host passes as NaN: the
// store never happens, but the compiler cannot prove it, so it cannot drop
// the work the benchmark times (and no atomics or zeroed sink cost time).
// The iteration loops are unrolled, so `i` is an immediate: no loop converts
// an integer to float (a conversion per element and iteration would run at
// 16 a clock per SM, against 128 fp32 adds).
//
//   gb_gather_sub:  g[r, c] = x[(idx[r, c] + i) mod n, c]  (x fp32 or bf16
//                   (n, m)), a gather along rows.
//     Bound: shared-memory wavefronts, one per warp-wide read.  A block
//     holds a column stripe of 128-byte rows (32 fp32 or 64 bf16 columns)
//     and each lane reads its own 4-byte bank whatever the row: lane l owns
//     column l (fp32) or the two halves of word l, columns 2l and 2l + 1
//     (bf16, one 2-byte read per element; the plain 2-byte layout would put
//     lanes 2k and 2k + 1 in one bank on different rows).  The stripe holds
//     n + R - 1 rows, row v being x row v mod n, so (idx + i) mod n is the
//     lane's start row plus i: the modulo lives in the layout and the
//     per-iteration index add in the load's immediate offset, and each read
//     is one LDS and one FADD.  The stripe (up to 227 KB) is what every
//     block of a stripe needs, so a cluster of blocks over the row groups of
//     one stripe fetches it from L2 once: x is a 2-D tensor map of boxes of
//     R - 1 rows by 128 bytes (cuTensorMapEncodeTiled, reached through the
//     runtime's driver entry point, so nothing links libcuda), each block
//     issues every k-th box as a TMA load multicast to the whole cluster,
//     completed on an mbarrier; the copy spends no registers, and 18 boxes
//     fill a 1040-row stripe where a bulk copy would move one row a
//     request.  The boxes start at rows 0, R - 1, ..., the last one ending
//     at row n over its predecessor, and one more puts rows 0..R - 2 at row
//     n; a stripe cut by the plane's edge is zero-filled past it.  Clusters
//     of two (a TPC's SMs), so that one wave holds the grid: the plans need
//     at most 64 clusters, and chip_smoke.py prints how many the card holds
//     at once (gb_gather_sub_max_clusters).
//     16 warps a block; a warp takes its rows one at a time and only rows
//     that exist (the loads of an absent row, predicated off, would still
//     take issue slots), its first row's indices loading while the stripe
//     lands and each next row's while it sums the current one.  Rows that
//     are not 16-byte aligned in device memory, or fewer than R - 1 rows,
//     are copied through registers instead.
//   gb_gather_lane: g[r, c] = x[r, (idx[r, c] + i) mod m]  (x fp32), a
//     gather along columns.  Bound: shared-memory wavefronts, and those are
//     the data's own: a warp reads 32 random columns of one row, so its
//     fullest bank holds about 3.2 distinct words (smem_wavefronts on the
//     host counts them for given indices).  One block per row of m + R - 1
//     words (the modulo in the layout again), one column per lane: up to 64
//     warps an SM, each with one short chain of adds.
//   gb_idxadd:      (idx[r, c] + i) mod n, summed: bound by the integer
//     pipe (half the fp32 rate).  The index is derived by one add per element
//     and iteration, on its mirror d = n - 1 - j: d - 1 wrapping to n - 1 is
//     one VIADDMNMX (add, then unsigned min), and j = n - 1 - d is added to
//     an int32 sum, converted once at the end.  The fp32 in-order sum of
//     these integers equals it exactly while every partial sum is below
//     2^24, which the wrapper checks ((n - 1) * R < 2^24).
//   gb_splat2:      s[a, b, q] = (hy[a, q] + i) * hx[b, q], the windowed
//     kernel's splat unit: one thread per element of the (wh * ww, nq)
//     plane, an add, a product rounded on its own (no contraction, as the
//     TPU kernel's two plane ops) and the fold's add per iteration: bound by
//     the fp32 pipe.
//   gb_fma1:        fmaf(a, b, c + i), one thread per element: the fp32
//     pipe.  The TPU's checksum rounds a * b first, so the two differ by
//     that rounding.
//   gb_null:        an empty kernel at a case's launch geometry: the launch
//     floor that every call above pays.
//
// All entries return cudaGetLastError() after the launch, or a negative
// code for arguments the kernels do not take; none synchronises.

#include <cuda.h>  // the tensor map's types; its encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GB_R 64             // in-kernel iterations
#define GB_THREADS 256      // elementwise ops: threads a block
#define GB_ROW_BYTES 128    // gather_sub: one stripe row in shared memory
#define GB_SMEM_LIMIT 232448
#define GB_SUB_STATIC 16    // gather_sub: its mbarrier, aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// v mod n in [0, n): an index already in range is kept; any other takes a
// division (and its I2F reciprocal estimate) in a call outside the loops
__device__ __noinline__ int floor_mod_slow(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int floor_mod(int v, int n) {
  return (unsigned)v < (unsigned)n ? v : floor_mod_slow(v, n);
}

// a barrier across the cluster, no memory ordering (relaxed arrive)
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// waits for the barrier's phase `parity` to complete; traps after ~1 s of
// clocks rather than hang the card on a copy that never lands
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > 2000000000LL) __trap();
  } while (!done);
}

// box (c0, row) of the tensor map, 63 rows of 128 bytes, into this block's
// shared memory at dst and, with `mask`, the same offset of every block of
// the cluster in it
__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap* map, int c0, int row,
                                        unsigned bar, unsigned short mask) {
  const unsigned long long m = reinterpret_cast<unsigned long long>(map);
  if (mask > 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
        :: "r"(dst), "l"(m), "r"(c0), "r"(row), "r"(bar), "h"(mask) : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];"
        :: "r"(dst), "l"(m), "r"(c0), "r"(row), "r"(bar) : "memory");
  }
}

// a lane's indices on row r (0 where no row or column is)
template <int kPer>
__device__ __forceinline__ void load_row_indices(int (&raw)[kPer], const int* __restrict__ idx,
                                                 int r, int r_end, int col0, int m) {
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    raw[p] = r < r_end && col0 + p < m ? __ldg(idx + (long long)r * m + col0 + p) : 0;
  }
}

// grid (row groups, stripes), clusters of blocks along the row groups of one
// stripe; block: warps x 32 threads; dynamic shared memory (n + R - 1) rows
template <typename T>
__global__ void __launch_bounds__(512)
gather_sub_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
                  const int* __restrict__ idx, float* __restrict__ checksum,
                  float* __restrict__ sink, int n, int m, int rows_per_group, int tma,
                  float never) {
  extern __shared__ __align__(128) unsigned char stripe[];
  __shared__ __align__(8) uint64_t bar;
  constexpr int kCols = GB_ROW_BYTES / sizeof(T);  // 32 fp32, 64 bf16
  constexpr int kPer = kCols / 32;                 // columns a lane owns
  const int c0 = blockIdx.y * kCols;
  const int vrows = n + GB_R - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int col0 = c0 + lane * kPer;  // the lane's first column
  const int r_begin = blockIdx.x * rows_per_group;
  const int r_end = min(n, r_begin + rows_per_group);
  // the first row's indices are on their way while the stripe is
  int raw[kPer];
  load_row_indices<kPer>(raw, idx, r_begin + warp, r_end, col0, m);

  if (tma) {  // uniform over the grid
    unsigned k, rank;
    asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(k));
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
    const unsigned b = smem_addr(&bar);
    // boxes of R - 1 rows: starts 0, R - 1, ... (the last one ending at row
    // n, over its predecessor), then rows 0.. again at row n
    const int boxes = (n + GB_R - 2) / (GB_R - 1);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_barrier();  // every block's barrier is set before any box lands
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(b), "r"((boxes + 1) * (GB_R - 1) * GB_ROW_BYTES) : "memory");
    }
    const unsigned short mask = (unsigned short)((1u << k) - 1);
    const unsigned base = smem_addr(stripe);
    for (int t = rank + k * threadIdx.x; t <= boxes; t += k * blockDim.x) {
      const int start = t < boxes ? min(t * (GB_R - 1), n - (GB_R - 1)) : 0;
      tma_box(base + (t < boxes ? start : n) * GB_ROW_BYTES, &map, c0, start, b, mask);
    }
    mbar_wait(b, 0);
  } else {
    T* s = reinterpret_cast<T*>(stripe);
    for (int e = threadIdx.x; e < vrows * kCols; e += blockDim.x) {
      const int v = e / kCols, c = c0 + e % kCols;
      s[e] = c < m ? x[(long long)floor_mod(v, n) * m + c] : T(0.f);
    }
    __syncthreads();
  }

  // the warp's rows one at a time (only rows that exist issue loads), the
  // next row's indices loading meanwhile
  float sk = 0.f;
  for (int r = r_begin + warp; r < r_end; r += warps) {
    int next[kPer];
    load_row_indices<kPer>(next, idx, r + warps, r_end, col0, m);
    unsigned off[kPer];
    float acc[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      off[p] = floor_mod(raw[p], n) * GB_ROW_BYTES + (lane * kPer + p) * (unsigned)sizeof(T);
      acc[p] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < GB_R; ++i) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        acc[p] += to_f32(*reinterpret_cast<const T*>(stripe + off[p] + i * GB_ROW_BYTES));
      }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (col0 + p < m) fold(checksum, sk, r, col0 + p, acc[p]);
      raw[p] = next[p];
    }
  }
  flush_sink(sink, sk, never);
  cluster_barrier();  // no block leaves while its cluster's copies may be in flight
}

// one block per row, which its warps copy together into dynamic shared
// memory: row_words = m + R - 1 words, word v being x[r, v mod m] (m >= R - 1,
// so the last R - 1 words repeat the first); lane l of warp q gathers
// column 32 q + l (and every 32 * warps further on)
__global__ void __launch_bounds__(1024)
gather_lane_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ checksum, float* __restrict__ sink, int m, float never) {
  extern __shared__ __align__(16) float row[];
  const int r = blockIdx.x;
  const float* src = x + (long long)r * m;
  const int* ridx = idx + (long long)r * m;
  int col = threadIdx.x;
  int raw = col < m ? __ldg(ridx + col) : 0;  // on its way with the row
  for (int v = threadIdx.x; v < m; v += blockDim.x) {
    const float xv = __ldg(src + v);
    row[v] = xv;
    if (v < GB_R - 1) row[m + v] = xv;
  }
  __syncthreads();
  float sk = 0.f;
  for (; col < m; col += blockDim.x) {
    if (col != (int)threadIdx.x) raw = __ldg(ridx + col);
    const int off = floor_mod(raw, m);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < GB_R; ++i) acc += row[off + i];
    fold(checksum, sk, r, col, acc);
  }
  flush_sink(sink, sk, never);
}

// The elementwise ops: grid (ceil(m / GB_THREADS), rows), one thread per
// element, so a block's row is blockIdx.y and no thread divides.

__global__ void __launch_bounds__(GB_THREADS)
idxadd_kernel(const int* __restrict__ idx, float* __restrict__ checksum,
              float* __restrict__ sink, int m, int n, float never) {
  const int row = blockIdx.y, col = blockIdx.x * GB_THREADS + threadIdx.x;
  float sk = 0.f;
  if (col < m) {
    const unsigned last = (unsigned)n - 1u;
    unsigned d = last - (unsigned)floor_mod(__ldg(idx + (long long)row * m + col), n);  // n - 1 - j
    int s = 0;
#pragma unroll
    for (int i = 0; i < GB_R; ++i) {
      s += (int)(last - d);                      // j = (idx + i) mod n
      d = __viaddmin_u32(d, 0xFFFFFFFFu, last);  // j + 1, wrapping to 0
    }
    fold(checksum, sk, row, col, (float)s);
  }
  flush_sink(sink, sk, never);
}

// rows of the (wh * ww, nq) plane: row = a * ww + b
__global__ void __launch_bounds__(GB_THREADS)
splat2_kernel(const float* __restrict__ hy, const float* __restrict__ hx,
              float* __restrict__ checksum, float* __restrict__ sink, int ww, int nq,
              float never) {
  const int row = blockIdx.y, q = blockIdx.x * GB_THREADS + threadIdx.x;
  const int a = row / ww, b = row - a * ww;
  float sk = 0.f;
  if (q < nq) {
    const float y = __ldg(hy + (long long)a * nq + q), xv = __ldg(hx + (long long)b * nq + q);
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < GB_R; ++i) v += __fmul_rn(y + (float)i, xv);
    fold(checksum, sk, row, q, v);
  }
  flush_sink(sink, sk, never);
}

__global__ void __launch_bounds__(GB_THREADS)
fma1_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, float* __restrict__ checksum,
            float* __restrict__ sink, int m, float never) {
  const int row = blockIdx.y, col = blockIdx.x * GB_THREADS + threadIdx.x;
  float sk = 0.f;
  if (col < m) {
    const long long e = (long long)row * m + col;
    const float av = __ldg(a + e), bv = __ldg(b + e), cv = __ldg(c + e);
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < GB_R; ++i) v += fmaf(av, bv, cv + (float)i);
    fold(checksum, sk, row, col, v);
  }
  flush_sink(sink, sk, never);
}

__global__ void null_kernel() {}

static const float kNever = __builtin_nanf("");

// the elementwise ops' grid over a (rows, m) plane
static dim3 elementwise_grid(int rows, int m) {
  return dim3((m + GB_THREADS - 1) / GB_THREADS, rows);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// x (n, m) as a 2-D tensor map of (R - 1)-row boxes of one stripe's 128
// bytes; the driver's encoder through the runtime's entry point (no -lcuda)
template <typename T>
static int encode_stripes(CUtensorMap* map, const void* x, int n, int m) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr) return -5;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)m * sizeof(T)};
  const cuuint32_t box[2] = {GB_ROW_BYTES / (cuuint32_t)sizeof(T), GB_R - 1};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(x), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -6;
}

template <typename T>
static int launch_gather_sub(const void* x, const void* idx, void* checksum, void* sink, int n,
                             int m, int groups, int rows, int cluster, int warps,
                             cudaStream_t s) {
  constexpr int kCols = GB_ROW_BYTES / sizeof(T);
  const size_t smem = (size_t)(n + GB_R - 1) * GB_ROW_BYTES;
  if (smem + GB_SUB_STATIC > GB_SMEM_LIMIT) return -2;
  // the tensor-map copy: 16-byte aligned rows, and boxes inside the rows
  const int tma = (uintptr_t)x % 16 == 0 && (size_t)m * sizeof(T) % 16 == 0 && n >= GB_R - 1;
  CUtensorMap map = {};
  if (tma) {
    const int err = encode_stripes<T>(&map, x, n, m);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      gather_sub_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, (m + kCols - 1) / kCols);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gather_sub_kernel<T>, map, (const T*)x, (const int*)idx,
                           (float*)checksum, (float*)sink, n, m, rows, tma, kNever);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// dtype: 0 = float32 x, 1 = bfloat16 x.  groups, rows, cluster and warps
// are the host's plan (tools/gatherbench.py:gather_sub_plan).
extern "C" int gb_gather_sub(const void* x, const void* idx, void* checksum, void* sink,
                             int dtype, int n, int m, int R, int groups, int rows, int cluster,
                             int warps, void* stream) {
  if (n < 1 || m < 1 || R != GB_R || groups < 1 || rows < 1 || warps < 1 || warps > 16 ||
      cluster < 1 || cluster > 8 || groups % cluster != 0)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_gather_sub<float>(x, idx, checksum, sink, n, m, groups, rows, cluster, warps, s);
  if (dtype == 1)
    return launch_gather_sub<__nv_bfloat16>(x, idx, checksum, sink, n, m, groups, rows, cluster, warps, s);
  return -4;
}

// how many clusters of gather_sub's blocks the card holds at once
extern "C" int gb_gather_sub_max_clusters(int dtype, int n, int m, int groups, int cluster,
                                          int warps) {
  const size_t smem = (size_t)(n + GB_R - 1) * GB_ROW_BYTES;
  const int cols = dtype == 0 ? 32 : 64;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, (m + cols - 1) / cols);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = -1;
  cudaError_t err;
  if (dtype == 0) {
    cudaFuncSetAttribute(gather_sub_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    err = cudaOccupancyMaxActiveClusters(&count, gather_sub_kernel<float>, &cfg);
  } else {
    cudaFuncSetAttribute(gather_sub_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    err = cudaOccupancyMaxActiveClusters(&count, gather_sub_kernel<__nv_bfloat16>, &cfg);
  }
  return err != cudaSuccess ? -(int)err : count;
}

// warps: a block's (one block per row), the host's plan
extern "C" int gb_gather_lane(const void* x, const void* idx, void* checksum, void* sink,
                              int n, int m, int R, int warps, void* stream) {
  if (n < 1 || m < GB_R - 1 || R != GB_R || warps < 1 || warps > 32) return -1;
  const size_t smem = (size_t)(m + GB_R - 1) * sizeof(float);
  if (smem > GB_SMEM_LIMIT) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      gather_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gather_lane_kernel<<<n, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (float*)checksum, (float*)sink, m, kNever);
  return (int)cudaGetLastError();
}

// idx (rows, m), reduced mod n; the int32 sum needs (n - 1) * R < 2^24
extern "C" int gb_idxadd(const void* idx, void* checksum, void* sink, int rows, int m, int n,
                         int R, void* stream) {
  if (rows < 1 || rows > 65535 || m < 1 || n < 1 || R != GB_R ||
      (long long)(n - 1) * R >= (1LL << 24))
    return -1;
  idxadd_kernel<<<elementwise_grid(rows, m), GB_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (float*)checksum, (float*)sink, m, n, kNever);
  return (int)cudaGetLastError();
}

extern "C" int gb_splat2(const void* hy, const void* hx, void* checksum, void* sink, int wh,
                         int ww, int nq, int R, void* stream) {
  if (wh < 1 || ww < 1 || (long long)wh * ww > 65535 || nq < 1 || R != GB_R) return -1;
  splat2_kernel<<<elementwise_grid(wh * ww, nq), GB_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)hy, (const float*)hx, (float*)checksum, (float*)sink, ww, nq, kNever);
  return (int)cudaGetLastError();
}

extern "C" int gb_fma1(const void* a, const void* b, const void* c, void* checksum,
                       void* sink, int n, int m, int R, void* stream) {
  if (n < 1 || n > 65535 || m < 1 || R != GB_R) return -1;
  fma1_kernel<<<elementwise_grid(n, m), GB_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)c, (float*)checksum, (float*)sink, m,
      kNever);
  return (int)cudaGetLastError();
}

// the launch floor: an empty kernel of `blocks` x `threads` with `smem`
// bytes of dynamic shared memory (`like`, `checksum`, `sink` unused)
extern "C" int gb_null(const void* like, void* checksum, void* sink, int blocks, int threads,
                       int smem, void* stream) {
  (void)like; (void)checksum; (void)sink;
  if (blocks < 1 || threads < 1 || threads > 1024 || smem < 0 || smem > GB_SMEM_LIMIT)
    return -1;
  cudaError_t err = cudaFuncSetAttribute(null_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  null_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
