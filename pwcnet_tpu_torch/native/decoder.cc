// The port's host decoder: FlyingChairs samples (P6 .ppm images and
// Middlebury .flo flow) decoded and fitted to one shape by a std::thread
// pool, without the Python codecs' overhead. It is the port's own copy of
// the JAX package's pwcnet_tpu/native/decoder.cc (the batch entry and what
// it calls), exposed as a plain C symbol for ctypes
// (pwcnet_tpu_torch/native/__init__.py, which builds it with
// g++ -O3 -shared -fPIC -std=c++17 -pthread at first use). A host decoder,
// not a device kernel.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;

// Read a whole file; returns empty on failure.
std::vector<uint8_t> ReadFile(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size > 0) {
    buf.resize(static_cast<size_t>(size));
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) buf.clear();
  }
  std::fclose(f);
  return buf;
}

// ---- .flo ----------------------------------------------------------------

bool FloDims(const uint8_t* buf, size_t len, int* h, int* w) {
  if (len < 12) return false;
  float magic;
  std::memcpy(&magic, buf, 4);
  if (magic < kFloMagic - 0.01f || magic > kFloMagic + 0.01f) return false;
  int32_t iw, ih;
  std::memcpy(&iw, buf + 4, 4);
  std::memcpy(&ih, buf + 8, 4);
  if (iw <= 0 || ih <= 0 || len < 12 + size_t(iw) * ih * 8) return false;
  *w = iw;
  *h = ih;
  return true;
}

bool FloData(const uint8_t* buf, size_t len, float* out) {
  int h, w;
  if (!FloDims(buf, len, &h, &w)) return false;
  std::memcpy(out, buf + 12, size_t(h) * w * 2 * sizeof(float));
  return true;
}

// ---- P6 .ppm -------------------------------------------------------------

// Parse "P6 <ws> W <ws> H <ws> MAXVAL <single-ws>"; handles '#' comments.
const uint8_t* PpmHeader(const uint8_t* p, const uint8_t* end, int* w, int* h,
                         int* maxval) {
  if (end - p < 2 || p[0] != 'P' || p[1] != '6') return nullptr;
  p += 2;
  int vals[3];
  for (int i = 0; i < 3; i++) {
    // skip whitespace and comments
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n' ||
                       *p == '#')) {
      if (*p == '#') {
        while (p < end && *p != '\n') p++;
      } else {
        p++;
      }
    }
    int v = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      p++;
      any = true;
    }
    if (!any) return nullptr;
    vals[i] = v;
  }
  if (p >= end) return nullptr;
  p++;  // single whitespace after maxval
  *w = vals[0];
  *h = vals[1];
  *maxval = vals[2];
  return p;
}

bool PpmDims(const uint8_t* buf, size_t len, int* h, int* w) {
  int maxval;
  return PpmHeader(buf, buf + len, w, h, &maxval) != nullptr;
}

// Decode to float32 RGB in [0, 1].
bool PpmData(const uint8_t* buf, size_t len, float* out) {
  int w, h, maxval;
  const uint8_t* p = PpmHeader(buf, buf + len, &w, &h, &maxval);
  if (!p) return false;
  size_t n = size_t(w) * h * 3;
  if (maxval < 256) {
    if (size_t(buf + len - p) < n) return false;
    const float scale = 1.0f / maxval;
    for (size_t i = 0; i < n; i++) out[i] = p[i] * scale;
  } else {
    if (size_t(buf + len - p) < n * 2) return false;
    const float scale = 1.0f / maxval;
    for (size_t i = 0; i < n; i++) {
      // PPM 16-bit is big-endian.
      out[i] = ((p[2 * i] << 8) | p[2 * i + 1]) * scale;
    }
  }
  return true;
}

// ---- fixed-shape sample assembly ----------------------------------------

// Copy (h, w, c) f32 into (th, tw, c) with center-crop when larger and
// zero-pad (bottom/right) when smaller; matches
// pwcnet_tpu_torch/data/pipeline.py:_fit_to_shape.
void FitToShape(const float* src, int h, int w, int c, float* dst, int th,
                int tw) {
  int y0 = h > th ? (h - th) / 2 : 0;
  int x0 = w > tw ? (w - tw) / 2 : 0;
  int ch = h < th ? h : th;
  int cw = w < tw ? w : tw;
  std::memset(dst, 0, size_t(th) * tw * c * sizeof(float));
  for (int y = 0; y < ch; y++) {
    std::memcpy(dst + size_t(y) * tw * c,
                src + (size_t(y + y0) * w + x0) * c,
                size_t(cw) * c * sizeof(float));
  }
}

enum : int { kOk = 0, kReadError = 1, kDecodeError = 2 };

// Decode one FlyingChairs-style sample (im1.ppm, im2.ppm, flow.flo) into
// fixed-shape slots. valid marks in-bounds (unpadded) pixels.
int DecodeSample(const char* im1_path, const char* im2_path,
                 const char* flow_path, int th, int tw, float* im1_out,
                 float* im2_out, float* flow_out, float* valid_out) {
  auto b1 = ReadFile(im1_path), b2 = ReadFile(im2_path),
       bf = ReadFile(flow_path);
  if (b1.empty() || b2.empty() || bf.empty()) return kReadError;
  int h1, w1, h2, w2, hf, wf;
  if (!PpmDims(b1.data(), b1.size(), &h1, &w1) ||
      !PpmDims(b2.data(), b2.size(), &h2, &w2) ||
      !FloDims(bf.data(), bf.size(), &hf, &wf))
    return kDecodeError;
  std::vector<float> t1(size_t(h1) * w1 * 3), t2(size_t(h2) * w2 * 3),
      tf(size_t(hf) * wf * 2);
  if (!PpmData(b1.data(), b1.size(), t1.data()) ||
      !PpmData(b2.data(), b2.size(), t2.data()) ||
      !FloData(bf.data(), bf.size(), tf.data()))
    return kDecodeError;
  FitToShape(t1.data(), h1, w1, 3, im1_out, th, tw);
  FitToShape(t2.data(), h2, w2, 3, im2_out, th, tw);
  FitToShape(tf.data(), hf, wf, 2, flow_out, th, tw);
  // valid: ones inside (possibly cropped) image extent, zero in padding.
  std::vector<float> ones(size_t(hf) * wf, 1.0f);
  FitToShape(ones.data(), hf, wf, 1, valid_out, th, tw);
  return kOk;
}

}  // namespace

extern "C" {

// Threaded batch loader: decode n FlyingChairs-style samples into
// preallocated (n, th, tw, {3,3,2,1}) f32 buffers. paths are flat arrays of
// n C strings. Returns 0 if all samples decoded, else the first error code.
int pwc_decode_batch(const char** im1_paths, const char** im2_paths,
                     const char** flow_paths, int n, int th, int tw,
                     int num_threads, float* im1_out, float* im2_out,
                     float* flow_out, float* valid_out) {
  if (num_threads < 1) num_threads = 1;
  std::vector<int> status(n, kOk);
  size_t im_stride = size_t(th) * tw * 3;
  size_t fl_stride = size_t(th) * tw * 2;
  size_t va_stride = size_t(th) * tw;
  std::vector<std::thread> workers;
  std::atomic_int next{0};
  for (int t = 0; t < num_threads && t < n; t++) {
    workers.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        status[i] = DecodeSample(
            im1_paths[i], im2_paths[i], flow_paths[i], th, tw,
            im1_out + i * im_stride, im2_out + i * im_stride,
            flow_out + i * fl_stride, valid_out + i * va_stride);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int s : status)
    if (s != kOk) return s;
  return kOk;
}

}  // extern "C"
