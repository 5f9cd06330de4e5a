// codetr_torch native runner: the exported forward, compiled ahead of time
// as an AOTInductor package, run from C++ with no Python in the process.
//
// The counterpart of the JAX package's csrc/codetr_pjrt_runner.cpp, which
// drives a StableHLO module through a PJRT plugin.  Here:
//
//   dlopen(--ops-lib) -> torch::inductor::AOTIModelPackageLoader(--model)
//   -> codetr_preprocess (host library) -> one warm-up run (+ --dump-raw)
//   -> --iterations timed runs, each synchronised -> codetr_batched_nms
//
// --ops-lib is csrc/msda_ops.cpp + csrc/msda_fwd.cu built by
// ops/_build.py:build_ops(); loading it runs its TORCH_LIBRARY
// registrations of the codetr:: MSDA ops, which the package calls by name.
// The package and its meta are runtime/aot.py:save_package's
// <name>.aoti.pt2 and <name>.aoti.pt2.meta.json (magic codetr-torch-aoti-v1,
// device, dtype, in_avals, msda_ops).  The host library is
// csrc/codetr_host.cpp (utils/native.py binds the same functions).
//
// Built by ops/_build.py:build_runner(device) with g++ against libtorch and
// the host library, never against Python: the ops library and the Python
// registrations of ops/msda.py never meet in one process.  It runs on the
// card unless given --device cpu.  Any failure prints a FATAL line and
// exits non-zero (2 for a bad command line); nothing falls back: a package
// that calls codetr:: ops needs --ops-lib, and an op with no kernel for the
// device fails the run.
//
//   codetr_aoti_runner --smoke --device cuda --ops-lib _build/msda_ops-<hash>.so
//   codetr_aoti_runner --model out/swin_l_608.aoti.pt2 --ops-lib ... \
//       --image img.rgb --image-height 480 --image-width 640 \
//       [--iterations 20] [--dump-raw prefix]

#include <ATen/Context.h>
#include <ATen/core/Tensor.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <ATen/detail/CUDAHooksInterface.h>
#include <ATen/ops/from_blob.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <fstream>
#include <iterator>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#ifdef HAVE_OPENCV
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#endif

extern "C" int codetr_preprocess(const uint8_t*, int, int, int, int, const float*, const float*,
                                 int, float*, float*, float*, int*);
extern "C" int codetr_batched_nms(const float*, const float*, const int32_t*, int, float, float,
                                  uint8_t*);

namespace {

constexpr char kMagic[] = "codetr-torch-aoti-v1";  // runtime/aot.py:PACKAGE_MAGIC
// config.py:PreprocessConfig's defaults; --smoke prints them
constexpr float kMean[3] = {123.675f, 116.28f, 103.53f};
constexpr float kStd[3] = {58.395f, 57.12f, 57.375f};
constexpr const char* kOps[2] = {"codetr::msda_packed", "codetr::msda_reference"};

[[noreturn]] void fatal(int code, const std::string& msg) {
  std::fflush(stdout);
  std::fprintf(stderr, "FATAL %s\n", msg.c_str());
  std::exit(code);
}

// ---- a JSON reader for the package's meta ----

struct Json {
  enum Kind { kNull, kBool, kNumber, kString, kArray, kObject } kind = kNull;
  bool boolean = false;
  double number = 0.0;
  std::string str;
  std::vector<Json> items;
  std::map<std::string, Json> fields;

  const Json& at(const std::string& key) const {
    auto it = fields.find(key);
    if (kind != kObject || it == fields.end()) fatal(1, "meta has no \"" + key + "\"");
    return it->second;
  }
  bool has(const std::string& key) const { return kind == kObject && fields.count(key) > 0; }
};

class JsonReader {
 public:
  explicit JsonReader(std::string text) : s_(std::move(text)) {}

  Json read() {
    Json v = value();
    space();
    if (i_ != s_.size()) fail("trailing characters");
    return v;
  }

 private:
  [[noreturn]] void fail(const char* what) {
    fatal(1, std::string("meta is not JSON: ") + what + " at byte " + std::to_string(i_));
  }
  void space() {
    while (i_ < s_.size() && (s_[i_] == ' ' || s_[i_] == '\t' || s_[i_] == '\r' || s_[i_] == '\n')) ++i_;
  }
  bool eat(char c) {
    space();
    if (i_ < s_.size() && s_[i_] == c) return ++i_, true;
    return false;
  }
  void expect(char c) {
    if (!eat(c)) fail("unexpected character");
  }
  bool word(const char* w) {
    const size_t n = std::strlen(w);
    if (s_.compare(i_, n, w) != 0) return false;
    i_ += n;
    return true;
  }
  std::string string() {
    expect('"');
    std::string out;
    while (i_ < s_.size() && s_[i_] != '"') {
      char c = s_[i_++];
      if (c == '\\') {
        if (i_ >= s_.size()) fail("bad escape");
        const char e = s_[i_++];
        const char* from = "\"\\/bfnrt";
        const char* to = "\"\\/\b\f\n\r\t";
        if (const char* p = std::strchr(from, e); p && e) {
          c = to[p - from];
        } else if (e == 'u' && i_ + 4 <= s_.size()) {
          const long code = std::strtol(s_.substr(i_, 4).c_str(), nullptr, 16);
          i_ += 4;
          c = code < 0x80 ? static_cast<char>(code) : '?';
        } else {
          fail("bad escape");
        }
      }
      out += c;
    }
    expect('"');
    return out;
  }
  Json value() {
    space();
    if (i_ >= s_.size()) fail("unexpected end");
    Json v;
    const char c = s_[i_];
    if (c == '{') {
      v.kind = Json::kObject;
      ++i_;
      if (eat('}')) return v;
      do {
        space();
        std::string key = string();
        expect(':');
        v.fields[key] = value();
      } while (eat(','));
      expect('}');
    } else if (c == '[') {
      v.kind = Json::kArray;
      ++i_;
      if (eat(']')) return v;
      do v.items.push_back(value());
      while (eat(','));
      expect(']');
    } else if (c == '"') {
      v.kind = Json::kString;
      v.str = string();
    } else if (word("true")) {
      v.kind = Json::kBool;
      v.boolean = true;
    } else if (word("false")) {
      v.kind = Json::kBool;
    } else if (word("null")) {
      v.kind = Json::kNull;
    } else {
      char* end = nullptr;
      v.kind = Json::kNumber;
      v.number = std::strtod(s_.c_str() + i_, &end);
      if (end == s_.c_str() + i_) fail("unexpected character");
      i_ = static_cast<size_t>(end - s_.c_str());
    }
    return v;
  }

  std::string s_;
  size_t i_ = 0;
};

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) fatal(1, "cannot open " + path);
  return std::string((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
}

// ---- the command line ----

struct Args {
  std::string model, ops_lib, image, dump_raw, device = "cuda";
  int image_h = 0, image_w = 0;
  int height = 0, width = 0;  // 0: the package's (in_avals)
  int iterations = 20;
  float score_threshold = 0.0f;
  float iou_threshold = 0.8f;
  bool smoke = false;
};

void usage(const char* argv0, FILE* to) {
  std::fprintf(to,
               "usage: %s [--device cuda|cpu] [--ops-lib msda_ops.so] [--smoke] "
               "[--model m.aoti.pt2 [--height H --width W] "
               "[--image x.png | --image raw_rgb.bin --image-height H --image-width W] "
               "[--iterations N] [--score-threshold S] [--iou-threshold T] "
               "[--dump-raw prefix]]\n",
               argv0);
}

Args parse(int argc, char** argv) {
  Args a;
  for (int i = 1; i < argc; ++i) {
    const std::string k = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) fatal(2, "missing value for " + k);
      return argv[++i];
    };
    auto number = [&](auto convert) {
      const std::string v = next();
      try {
        size_t used = 0;
        auto out = convert(v, &used);
        if (used == v.size()) return out;
      } catch (const std::exception&) {
      }
      fatal(2, "bad value for " + k + ": " + v);
    };
    auto integer = [&]() {
      return number([](const std::string& v, size_t* n) { return std::stoi(v, n); });
    };
    auto real = [&]() {
      return number([](const std::string& v, size_t* n) { return std::stof(v, n); });
    };
    if (k == "--model") a.model = next();
    else if (k == "--ops-lib") a.ops_lib = next();
    else if (k == "--device") a.device = next();
    else if (k == "--image") a.image = next();
    else if (k == "--image-height") a.image_h = integer();
    else if (k == "--image-width") a.image_w = integer();
    else if (k == "--height") a.height = integer();
    else if (k == "--width") a.width = integer();
    else if (k == "--iterations") a.iterations = integer();
    else if (k == "--score-threshold") a.score_threshold = real();
    else if (k == "--iou-threshold") a.iou_threshold = real();
    else if (k == "--dump-raw") a.dump_raw = next();
    else if (k == "--smoke") a.smoke = true;
    else if (k == "--help" || k == "-h") {
      usage(argv[0], stdout);
      std::exit(0);
    } else {
      usage(argv[0], stderr);
      fatal(2, "unknown argument " + k);
    }
  }
  if (a.device != "cuda" && a.device != "cpu") fatal(2, "--device must be cuda or cpu, got " + a.device);
  if (a.iterations < 1) fatal(2, "--iterations must be at least 1");
  if (!a.smoke && a.model.empty()) fatal(2, "--model is required without --smoke");
  return a;
}

// ---- the package's meta ----

struct Meta {
  at::ScalarType input_dtype = at::kFloat;
  bool fp32 = true;
  int height = 0, width = 0;
  std::vector<std::string> msda_ops;
};

at::ScalarType scalar_type(const std::string& name) {
  if (name == "float32") return at::kFloat;
  if (name == "bfloat16") return at::kBFloat16;
  fatal(1, "the runner takes float32 or bfloat16 inputs, the package wants " + name);
}

// Reads <model>.meta.json as tools/aoti_run.py does and checks it against
// the run: the magic, the device, and two inputs (1, H, W, 3) in the
// meta's dtype (float32 or bfloat16) and a (1, H, W) float32 mask.
Meta read_meta(const Args& a) {
  const std::string path = a.model + ".meta.json";
  const Json meta = JsonReader(read_file(path)).read();
  const std::string magic = meta.has("magic") ? meta.at("magic").str : "";
  if (magic != kMagic)
    fatal(1, path + ": magic \"" + magic + "\", expected \"" + kMagic + "\"");
  const std::string device = meta.at("device").str;
  if (device != a.device) fatal(1, a.model + " was compiled for " + device + ", not " + a.device);
  Meta m;
  const at::ScalarType compute = scalar_type(meta.at("dtype").str);
  m.fp32 = compute == at::kFloat;
  const Json& avals = meta.at("in_avals");
  auto dims = [&](size_t i, size_t rank) {
    if (avals.items.size() != 2 || avals.items[i].items.size() != 2 ||
        avals.items[i].items[0].items.size() != rank)
      fatal(1, path + ": in_avals are not the forward's (image, mask)");
    std::vector<int64_t> out;
    for (const Json& d : avals.items[i].items[0].items) out.push_back(static_cast<int64_t>(d.number));
    return out;
  };
  const std::vector<int64_t> x = dims(0, 4), mask = dims(1, 3);
  if (x[0] != 1 || x[3] != 3 || mask != std::vector<int64_t>{1, x[1], x[2]})
    fatal(1, path + ": the runner takes one image, (1, H, W, 3) and a (1, H, W) mask");
  m.input_dtype = scalar_type(avals.items[0].items[1].str);
  // the image goes in as in_avals says and the precision follows dtype:
  // a package whose two disagree would run in a precision its meta does
  // not say (runtime/aot.py:package_dtype refuses to write one)
  if (m.input_dtype != compute)
    fatal(1, path + ": dtype " + meta.at("dtype").str + " but the image input is " +
                 avals.items[0].items[1].str);
  if (scalar_type(avals.items[1].items[1].str) != at::kFloat) fatal(1, path + ": the mask must be float32");
  m.height = static_cast<int>(x[1]);
  m.width = static_cast<int>(x[2]);
  if ((a.height && a.height != m.height) || (a.width && a.width != m.width))
    fatal(1, "--height/--width " + std::to_string(a.height) + "x" + std::to_string(a.width) +
                 " do not fit the package's input " + std::to_string(m.height) + "x" +
                 std::to_string(m.width));
  if (meta.has("msda_ops"))
    for (const auto& kv : meta.at("msda_ops").fields) m.msda_ops.push_back(kv.first);
  return m;
}

// ---- the image ----

struct Image {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
};

Image read_image(const Args& a) {
  Image im;
  if (a.image_h > 0 && a.image_w > 0) {
    const std::string raw = read_file(a.image);
    if (raw.size() != static_cast<size_t>(a.image_h) * a.image_w * 3)
      fatal(2, a.image + " holds " + std::to_string(raw.size()) + " bytes, not " +
                   std::to_string(a.image_h) + "x" + std::to_string(a.image_w) + "x3");
    im.rgb.assign(raw.begin(), raw.end());
    im.h = a.image_h;
    im.w = a.image_w;
    return im;
  }
#ifdef HAVE_OPENCV
  const cv::Mat bgr = cv::imread(a.image, cv::IMREAD_COLOR);
  if (bgr.empty()) fatal(2, "cv::imread(" + a.image + ") failed");
  cv::Mat rgb;
  cv::cvtColor(bgr, rgb, cv::COLOR_BGR2RGB);
  im.h = rgb.rows;
  im.w = rgb.cols;
  im.rgb.assign(rgb.data, rgb.data + static_cast<size_t>(im.h) * im.w * 3);
  return im;
#else
  fatal(2, "built without OpenCV: pass a raw dump with --image-height/--image-width");
#endif
}

// ---- the device ----

void synchronize(const c10::Device& device) {
  if (device.is_cuda()) at::detail::getCUDAHooks().deviceSynchronize(device.index());
}

// an output on the host as float32 (a bf16 package's too) for the dump and
// the host NMS
std::vector<float> to_host_f32(const at::Tensor& t) {
  const at::Tensor h = t.to(at::kCPU).to(at::kFloat).contiguous();
  return std::vector<float>(h.data_ptr<float>(), h.data_ptr<float>() + h.numel());
}

int run(const Args& a) {
  const c10::Device device(a.device == "cuda" ? c10::Device(c10::DeviceType::CUDA, 0)
                                              : c10::Device(c10::DeviceType::CPU));
  if (device.is_cuda() && !at::globalContext().hasCUDA())
    fatal(1, "--device cuda: no CUDA device (or a runner built without libtorch_cuda)");
  std::printf("device: %s\n", device.str().c_str());

  // the ops library's TORCH_LIBRARY registrations run in dlopen
  using LaunchesFn = int64_t (*)(int);
  LaunchesFn launches = nullptr;
  if (!a.ops_lib.empty()) {
    void* handle = dlopen(a.ops_lib.c_str(), RTLD_NOW | RTLD_GLOBAL);
    if (!handle) fatal(1, std::string("dlopen(") + a.ops_lib + "): " + dlerror());
    launches = reinterpret_cast<LaunchesFn>(dlsym(handle, "codetr_msda_ops_launches"));
    if (!launches) fatal(1, a.ops_lib + " is not the port's op library (no codetr_msda_ops_launches)");
    std::printf("ops library: %s\n", a.ops_lib.c_str());
  }

  if (a.smoke) {
    const c10::DispatchKey key = device.is_cuda() ? c10::DispatchKey::CUDA : c10::DispatchKey::CPU;
    for (const char* name : kOps) {
      const auto op = c10::Dispatcher::singleton().findOp(c10::OperatorName(name, ""));
      if (!op) {
        std::printf("%s: not registered\n", name);
        continue;
      }
      const bool has = op->hasKernelForDispatchKey(key);
      std::string where;
      std::istringstream dump(op->dumpState());
      for (std::string line; std::getline(dump, line);)
        if (line.rfind(std::string(c10::toString(key)) + ":", 0) == 0) where = line;
      std::printf("%s: %s kernel %s%s%s\n", name, c10::toString(key), has ? "yes" : "no",
                  where.empty() ? "" : " -- ", where.c_str());
    }
    std::printf("preprocess mean %g %g %g std %g %g %g\n", kMean[0], kMean[1], kMean[2], kStd[0],
                kStd[1], kStd[2]);
#ifdef HAVE_OPENCV
    std::printf("image files: OpenCV %s\n", CV_VERSION);
#else
    std::printf("image files: none (built without OpenCV; raw RGB dumps only)\n");
#endif
    std::printf("smoke ok\nok\n");
    return 0;
  }

  const Meta meta = read_meta(a);
  if (!meta.msda_ops.empty() && a.ops_lib.empty()) {
    std::string ops;
    for (const std::string& op : meta.msda_ops) ops += " " + op;
    fatal(1, a.model + " calls" + ops + ": pass --ops-lib (csrc/msda_ops.cpp's library)");
  }
  if (meta.fp32) {  // full fp32, as runtime/aot.py:load_package runs it
    at::globalContext().setAllowTF32CuBLAS(false);
    at::globalContext().setAllowTF32CuDNN(false);
  }
  const Image im = a.image.empty() ? Image{} : read_image(a);
  const auto tl0 = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(a.model, "model", false, 1,
                                                 device.is_cuda() ? device.index() : -1);
  const double load_s =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - tl0).count();
  std::printf("model: %s, load: %.3f s, dtype %s, TF32 %s\n", a.model.c_str(), load_s,
              c10::toString(meta.input_dtype), meta.fp32 ? "off" : "at the process's defaults");

  // inputs: the preprocessed image, or zeros
  const int H = meta.height, W = meta.width;
  std::vector<float> input(static_cast<size_t>(H) * W * 3, 0.0f);
  std::vector<float> mask(static_cast<size_t>(H) * W, 0.0f);
  float scale[2] = {1.0f, 1.0f};
  if (!a.image.empty()) {
    int resized[2];
    if (codetr_preprocess(im.rgb.data(), im.h, im.w, H, W, kMean, kStd, /*keep_ratio=*/1,
                          input.data(), mask.data(), scale, resized) != 0)
      fatal(1, "codetr_preprocess failed");
    std::printf("preprocess: %dx%d -> resized %dx%d scale %.4f/%.4f\n", im.w, im.h, resized[1],
                resized[0], scale[0], scale[1]);
  }
  const std::vector<at::Tensor> inputs = {
      at::from_blob(input.data(), {1, H, W, 3}, at::kFloat).to(device, meta.input_dtype),
      at::from_blob(mask.data(), {1, H, W}, at::kFloat).to(device),
  };

  // warm-up (its outputs are the ones dumped and post-processed)
  std::vector<at::Tensor> outs = loader.run(inputs);
  synchronize(device);
  if (outs.size() < 3) fatal(1, "the package returned " + std::to_string(outs.size()) + " outputs, not 3");
  const std::vector<float> boxes = to_host_f32(outs[0]), scores = to_host_f32(outs[1]),
                           labels_f = to_host_f32(outs[2]);
  const int n = static_cast<int>(scores.size());
  if (boxes.size() != 4 * scores.size() || labels_f.size() != scores.size())
    fatal(1, "outputs are not (1, N, 4), (1, N), (1, N)");
  std::printf("outputs: boxes %zu scores %zu labels %zu\n", boxes.size() / 4, scores.size(),
              labels_f.size());
  outs.clear();

  if (!a.dump_raw.empty()) {
    auto dump = [&](const char* suffix, const std::vector<float>& v) {
      const std::string p = a.dump_raw + suffix;
      std::FILE* f = std::fopen(p.c_str(), "wb");
      if (!f) fatal(1, "fopen(" + p + ") failed");
      const size_t wrote = std::fwrite(v.data(), sizeof(float), v.size(), f);
      if (std::fclose(f) != 0 || wrote != v.size()) fatal(1, "writing " + p + " failed");
    };
    dump(".boxes.bin", boxes);
    dump(".scores.bin", scores);
    dump(".labels.bin", labels_f);
    std::printf("raw outputs dumped to %s.{boxes,scores,labels}.bin\n", a.dump_raw.c_str());
  }

  // the timed loop: each run synchronised, as the JAX runner awaits each execute
  std::vector<double> ms;
  for (int i = 0; i < a.iterations; ++i) {
    const auto t0 = std::chrono::steady_clock::now();
    loader.run(inputs);
    synchronize(device);
    ms.push_back(std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0).count());
  }
  double total = 0.0;
  for (double t : ms) total += t;
  std::vector<double> sorted = ms;
  std::sort(sorted.begin(), sorted.end());
  std::printf("latency: %.3f ms/iter over %d iters (p50 %.3f, min %.3f, max %.3f)\n",
              total / a.iterations, a.iterations, sorted[(sorted.size() - 1) / 2], sorted.front(),
              sorted.back());
  if (launches)
    std::printf("msda launches from the ops library: %s %lld, %s %lld over %d forwards\n", kOps[0],
                static_cast<long long>(launches(0)), kOps[1], static_cast<long long>(launches(1)),
                a.iterations + 1);

  // post-process: per-class NMS on the host
  std::vector<int32_t> labels(n);
  for (int i = 0; i < n; ++i) labels[i] = static_cast<int32_t>(labels_f[i]);
  std::vector<uint8_t> keep(n, 0);
  const int kept = codetr_batched_nms(boxes.data(), scores.data(), labels.data(), n,
                                      a.iou_threshold, a.score_threshold, keep.data());
  if (kept < 0) fatal(1, "codetr_batched_nms failed");
  std::printf("detections after NMS: %d\n", kept);
  for (int i = 0, shown = 0; i < n && shown < 5; ++i) {
    if (!keep[i]) continue;
    std::printf("  box [%.1f %.1f %.1f %.1f] score %.3f label %d\n", boxes[i * 4 + 0] / scale[0],
                boxes[i * 4 + 1] / scale[1], boxes[i * 4 + 2] / scale[0],
                boxes[i * 4 + 3] / scale[1], scores[i], labels[i]);
    ++shown;
  }
  std::printf("ok\n");
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const Args args = parse(argc, argv);
  try {
    return run(args);
  } catch (const std::exception& e) {
    fatal(1, e.what());
  }
}
