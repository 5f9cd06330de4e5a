// The codetr:: MSDA forward ops registered from C++, for a process that
// runs an exported forward with no Python kernel code: an AOTInductor
// package (runtime/aot.py:save_package) loaded by tools/aoti_run.py, or a
// native runner.  In a Python process the same two schemas are
// torch.library custom ops (ops/msda.py, with the CPU route, the fake
// implementation, the gradient and the launch counters); a process loads
// this library (torch.ops.load_library) or imports that module, never
// both: a second definition of a schema raises.
//
// The schemas' text is ops/msda.py's PACKED_SCHEMA and REFERENCE_SCHEMA
// (tests/test_torch_port_aoti.py holds them equal).  The kernels registered
// for CUDA call the C entry points of csrc/msda_fwd.cu, built into this
// library beside it (ops/_build.py:build_ops): msda_packed_fwd_levels
// (K1's encoder entry, the tiled kernel) on every query level, (0, L), with
// the tile plan the op carries, as ops/msda.py's launch calls it, and
// msda_fwd (the decoder's direct gather).  The plan is built once, in
// Python, by ops/msda_tiles.py:encoder_tile_plan while exporting, and
// travels in the graph as the op's int[] argument: _PLAN_ARRAYS (tile_h,
// tile_w per query level; win_h, win_w, staged per (lq, lt) pair; off_b,
// off_acc per query level) concatenated, then halo and smem_bytes.  Both
// launch on PyTorch's current stream of the value's device, allocate their
// output with at::empty and synchronise nothing, so a CUDA graph can
// capture them.  They check what ops/msda.py's _check and _kernel_checks
// check and raise (TORCH_CHECK) on an argument the kernel does not take or
// on a launch the runtime refused.  Each counts its launches (as
// ops/msda.py's launches counter does), read through
// codetr_msda_ops_launches by a process with no Python counters: the
// native runner (csrc/codetr_aoti_runner.cpp).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <vector>

extern "C" int msda_packed_fwd_levels(const void* value, const void* cpk, void* out, int dtype,
                                      int bs, int K, int H, int D, int L, int P, int C,
                                      const int* level_h, const int* level_w, const int* tile_h,
                                      const int* tile_w, const int* win_h, const int* win_w,
                                      const int* staged, const int* off_b, const int* off_acc,
                                      int halo, int smem_bytes, int lq_begin, int lq_end,
                                      void* stream);
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn, void* out, int dtype,
                        int bs, int K, int Q, int H, int D, int L, int P, const int* level_h,
                        const int* level_w, void* stream);

namespace {

constexpr int64_t kMaxLevels = 8;    // ops/msda.py:_MAX_LEVELS
constexpr int64_t kMaxHeadDim = 128;  // ops/msda.py:_MAX_HEAD_DIM

// launches since the library was loaded: [0] msda_packed, [1] msda_reference
std::atomic<int64_t> g_launches[2];

int dtype_code(const at::Tensor& value) {
  if (value.scalar_type() == at::kFloat) return 0;
  if (value.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK(false, "value dtype must be float32 or bfloat16, got ", value.scalar_type());
  return -1;
}

// The level shapes [h0, w0, h1, w1, ...] as two int arrays; the value's
// checks against them (ops/msda.py:_check, _kernel_checks).
struct Levels {
  std::vector<int> h, w;
};

Levels checked_levels(const at::Tensor& value, at::IntArrayRef spatial_shapes) {
  TORCH_CHECK(value.dim() == 4, "value must be (bs, K, h, d), got ", value.sizes());
  TORCH_CHECK(value.is_cuda(), "value must be on the card, got ", value.device());
  TORCH_CHECK(spatial_shapes.size() % 2 == 0 && !spatial_shapes.empty(),
              "spatial_shapes must be [h0, w0, h1, w1, ...], got ", spatial_shapes);
  const int64_t L = static_cast<int64_t>(spatial_shapes.size()) / 2;
  TORCH_CHECK(L <= kMaxLevels, "the kernel takes at most ", kMaxLevels, " levels");
  TORCH_CHECK(value.size(3) <= kMaxHeadDim, "the kernel takes head dims up to ", kMaxHeadDim);
  TORCH_CHECK(value.is_contiguous(), "the kernel takes contiguous tensors");
  Levels lv;
  int64_t total = 0;
  for (int64_t l = 0; l < L; ++l) {
    lv.h.push_back(static_cast<int>(spatial_shapes[2 * l]));
    lv.w.push_back(static_cast<int>(spatial_shapes[2 * l + 1]));
    total += spatial_shapes[2 * l] * spatial_shapes[2 * l + 1];
  }
  TORCH_CHECK(total == value.size(1), "spatial_shapes cover ", total, " keys, value has ",
              value.size(1));
  return lv;
}

void check_coords(const at::Tensor& value, const at::Tensor& c) {
  TORCH_CHECK(c.scalar_type() == at::kFloat, "coordinates and weights must be float32, got ",
              c.scalar_type());
  TORCH_CHECK(c.device() == value.device(), "tensors on ", c.device(), " and ", value.device());
  TORCH_CHECK(c.is_contiguous(), "the kernel takes contiguous tensors");
}

void check_launch(int err, const char* fn) {
  TORCH_CHECK(err == 0, fn, " failed: code ", err,
              " (negative: bad argument; positive: cudaError_t)");
}

at::Tensor msda_packed_cuda(const at::Tensor& value, const at::Tensor& cpk,
                            at::IntArrayRef spatial_shapes, int64_t num_points,
                            at::IntArrayRef plan) {
  const Levels lv = checked_levels(value, spatial_shapes);
  check_coords(value, cpk);
  const int64_t bs = value.size(0), K = value.size(1), H = value.size(2), D = value.size(3);
  const int64_t L = static_cast<int64_t>(lv.h.size());
  TORCH_CHECK(cpk.dim() == 3 && cpk.size(0) == bs && cpk.size(1) == K &&
                  cpk.size(2) >= 3 * H * L * num_points,
              "cpk must be (", bs, ", ", K, ", >=", 3 * H * L * num_points, "), got ", cpk.sizes());
  // tile_h, tile_w (L), win_h, win_w, staged (L * L), off_b, off_acc (L),
  // then halo and smem_bytes
  const int64_t lengths[7] = {L, L, L * L, L * L, L * L, L, L};
  int64_t want = 2;
  for (int64_t n : lengths) want += n;
  TORCH_CHECK(static_cast<int64_t>(plan.size()) == want, "a plan for ", L, " levels has ", want,
              " ints, got ", plan.size());
  std::vector<int> flat(plan.begin(), plan.end());
  const int* arrays[7];
  int64_t offset = 0;
  for (int i = 0; i < 7; ++i) {
    arrays[i] = flat.data() + offset;
    offset += lengths[i];
  }
  const c10::cuda::CUDAGuard guard(value.device());
  at::Tensor out = at::empty({bs, K, H * D}, value.options());
  const int err = msda_packed_fwd_levels(
      value.data_ptr(), cpk.data_ptr(), out.data_ptr(), dtype_code(value), static_cast<int>(bs),
      static_cast<int>(K), static_cast<int>(H), static_cast<int>(D), static_cast<int>(L),
      static_cast<int>(num_points), static_cast<int>(cpk.size(2)), lv.h.data(), lv.w.data(),
      arrays[0], arrays[1], arrays[2], arrays[3], arrays[4], arrays[5], arrays[6], flat[want - 2],
      flat[want - 1], 0, static_cast<int>(L),
      c10::cuda::getCurrentCUDAStream(value.device().index()).stream());
  check_launch(err, "msda_packed_fwd_levels");
  ++g_launches[0];
  return out;
}

at::Tensor msda_reference_cuda(const at::Tensor& value, const at::Tensor& loc,
                               const at::Tensor& attn, at::IntArrayRef spatial_shapes) {
  const Levels lv = checked_levels(value, spatial_shapes);
  check_coords(value, loc);
  check_coords(value, attn);
  const int64_t bs = value.size(0), K = value.size(1), H = value.size(2), D = value.size(3);
  const int64_t L = static_cast<int64_t>(lv.h.size());
  TORCH_CHECK(loc.dim() == 6 && loc.size(0) == bs && loc.size(2) == H && loc.size(3) == L &&
                  loc.size(5) == 2 && attn.dim() == 5 &&
                  attn.sizes() == loc.sizes().slice(0, 5),
              "sampling_locations ", loc.sizes(), " / attention_weights ", attn.sizes(),
              " do not match value ", value.sizes(), " and ", L, " levels");
  const int64_t Q = loc.size(1), P = loc.size(4);
  const c10::cuda::CUDAGuard guard(value.device());
  at::Tensor out = at::empty({bs, Q, H * D}, value.options());
  const int err = msda_fwd(
      value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(), dtype_code(value),
      static_cast<int>(bs), static_cast<int>(K), static_cast<int>(Q), static_cast<int>(H),
      static_cast<int>(D), static_cast<int>(L), static_cast<int>(P), lv.h.data(), lv.w.data(),
      c10::cuda::getCurrentCUDAStream(value.device().index()).stream());
  check_launch(err, "msda_fwd");
  ++g_launches[1];
  return out;
}

}  // namespace

// Launches of entry 0 (codetr::msda_packed) or 1 (codetr::msda_reference)
// since the library was loaded; -1 for another entry.
extern "C" int64_t codetr_msda_ops_launches(int entry) {
  return entry == 0 || entry == 1 ? g_launches[entry].load() : -1;
}

TORCH_LIBRARY(codetr, m) {
  m.def("msda_packed(Tensor value, Tensor cpk, int[] spatial_shapes, int num_points, int[] plan) -> Tensor");
  m.def("msda_reference(Tensor value, Tensor loc, Tensor attn, int[] spatial_shapes) -> Tensor");
}

TORCH_LIBRARY_IMPL(codetr, CUDA, m) {
  m.impl("msda_packed", &msda_packed_cuda);
  m.impl("msda_reference", &msda_reference_cuda);
}
