// JPEG decode on nvJPEG (the CUDA toolkit's decoder) for hosts without libjpeg,
// with decode.cpp's resample and geometry: the sections marked "copied from
// decode.cpp" are that file's text, unchanged (a test holds them to it).
//
// nvJPEG decodes at full resolution (it has no DCT-domain scaling), to interleaved
// RGB in device memory, on a stream of its own; the image comes back to the host,
// where decode.cpp's PIL-equivalent bicubic resample and center crop make the
// canvas. So `flags` (fractional DCT scaling) has no effect here, and both modes
// give the full decode's canvas. Each decoding thread borrows a decoder (nvJPEG
// state, a non-blocking stream, a device buffer and a host buffer) from a pool
// that lives as long as the process, so no call frees device memory (cudaFree
// would wait for the whole device).
//
// C ABI only, the same as decode.cpp's, bound from Python via ctypes.

#include <algorithm>
#include <atomic>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

// ---- copied from decode.cpp (the resample) ----
// ---------------------------------------------------------------------------
// PIL-equivalent separable resample (bicubic a=-0.5, antialias)
// ---------------------------------------------------------------------------

inline double bicubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}
constexpr double kBicubicSupport = 2.0;

struct AxisCoeffs {
  std::vector<int> bounds_lo;   // first source index per dest pixel
  std::vector<int> counts;      // taps per dest pixel
  std::vector<double> weights;  // taps, row-major [dest][tap]
  int ksize;                    // max taps
};

AxisCoeffs precompute_coeffs(int in_size, int out_size) {
  AxisCoeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = kBicubicSupport * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds_lo.resize(out_size);
  c.counts.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * c.ksize, 0.0);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    const int n = hi - lo;
    double* w = &c.weights[static_cast<size_t>(i) * c.ksize];
    double sum = 0.0;
    for (int k = 0; k < n; ++k) {
      w[k] = bicubic_filter((lo + k - center + 0.5) / filterscale);
      sum += w[k];
    }
    if (sum != 0.0)
      for (int k = 0; k < n; ++k) w[k] /= sum;
    c.bounds_lo[i] = lo;
    c.counts[i] = n;
  }
  return c;
}

inline uint8_t clamp_u8(double v) {
  v += 0.5;  // round half up (PIL adds 0.5 then truncates after clamping)
  if (v < 0.0) return 0;
  if (v > 255.0) return 255;
  return static_cast<uint8_t>(v);
}

// Resize RGB uint8 (h_in, w_in) -> (h_out, w_out). Horizontal pass to a double
// buffer, then vertical pass.
void resize_bicubic(const uint8_t* src, int w_in, int h_in, uint8_t* dst, int w_out,
                    int h_out) {
  const AxisCoeffs cx = precompute_coeffs(w_in, w_out);
  const AxisCoeffs cy = precompute_coeffs(h_in, h_out);
  // horizontal: (h_in, w_out, 3) doubles
  std::vector<double> tmp(static_cast<size_t>(h_in) * w_out * 3);
  for (int y = 0; y < h_in; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w_in * 3;
    double* trow = &tmp[static_cast<size_t>(y) * w_out * 3];
    for (int x = 0; x < w_out; ++x) {
      const double* w = &cx.weights[static_cast<size_t>(x) * cx.ksize];
      const int lo = cx.bounds_lo[x], n = cx.counts[x];
      double r = 0, g = 0, b = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = row + static_cast<size_t>(lo + k) * 3;
        r += w[k] * p[0];
        g += w[k] * p[1];
        b += w[k] * p[2];
      }
      trow[x * 3 + 0] = r;
      trow[x * 3 + 1] = g;
      trow[x * 3 + 2] = b;
    }
  }
  // vertical
  for (int y = 0; y < h_out; ++y) {
    const double* w = &cy.weights[static_cast<size_t>(y) * cy.ksize];
    const int lo = cy.bounds_lo[y], n = cy.counts[y];
    uint8_t* drow = dst + static_cast<size_t>(y) * w_out * 3;
    for (int x = 0; x < w_out; ++x) {
      double r = 0, g = 0, b = 0;
      for (int k = 0; k < n; ++k) {
        const double* p = &tmp[(static_cast<size_t>(lo + k) * w_out + x) * 3];
        r += w[k] * p[0];
        g += w[k] * p[1];
        b += w[k] * p[2];
      }
      drow[x * 3 + 0] = clamp_u8(r);
      drow[x * 3 + 1] = clamp_u8(g);
      drow[x * 3 + 2] = clamp_u8(b);
    }
  }
}

// ---- end of the copy ----

// ---------------------------------------------------------------------------
// nvJPEG: one handle for the process, a pool of per-thread decoders
// ---------------------------------------------------------------------------

struct Decoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dbuf = nullptr;
  size_t dcap = 0;
};

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
std::vector<Decoder*> g_free;
std::atomic<int> g_device(0);  // the card to decode on (the process's own)

// 0 when the handle exists (created once; a failure is returned every time)
int ensure_handle() {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_handle == nullptr && nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return 1;
  }
  return 0;
}

Decoder* acquire() {
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!g_free.empty()) {
      Decoder* d = g_free.back();
      g_free.pop_back();
      return d;
    }
  }
  Decoder* d = new Decoder();
  if (nvjpegJpegStateCreate(g_handle, &d->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking) != cudaSuccess) {
    delete d;  // the handles it made stay with the process
    return nullptr;
  }
  return d;
}

void release(Decoder* d) {
  std::lock_guard<std::mutex> lock(g_mutex);
  g_free.push_back(d);
}

// full-resolution RGB into `raw`; 0 on success, the status codes of decode.cpp's
// decode_one otherwise (2: header, 3: decode, 4: components, 5: CUDA)
int decode_rgb(Decoder* d, const uint8_t* buf, size_t len, std::vector<uint8_t>& raw, int* w_out,
               int* h_out) {
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_handle, buf, len, &ncomp, &css, widths, heights) !=
      NVJPEG_STATUS_SUCCESS)
    return 2;
  if (ncomp != 1 && ncomp != 3) return 4;  // CMYK/YCCK: libjpeg refuses JCS_RGB too
  const int w = widths[0], h = heights[0];
  if (w <= 0 || h <= 0) return 2;
  const size_t bytes = static_cast<size_t>(w) * h * 3;
  if (bytes > d->dcap) {
    uint8_t* grown = nullptr;
    if (cudaMalloc(&grown, bytes) != cudaSuccess) return 5;
    if (d->dbuf != nullptr) {  // wait for this decoder's own work, not the device's
      cudaStreamSynchronize(d->stream);
      cudaFree(d->dbuf);
    }
    d->dbuf = grown;
    d->dcap = bytes;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = d->dbuf;
  img.pitch[0] = static_cast<unsigned int>(w) * 3;
  if (nvjpegDecode(g_handle, d->state, buf, len, NVJPEG_OUTPUT_RGBI, &img, d->stream) !=
      NVJPEG_STATUS_SUCCESS)
    return 3;
  raw.resize(bytes);
  if (cudaMemcpyAsync(raw.data(), d->dbuf, bytes, cudaMemcpyDeviceToHost, d->stream) !=
          cudaSuccess ||
      cudaStreamSynchronize(d->stream) != cudaSuccess)
    return 5;
  *w_out = w;
  *h_out = h;
  return 0;
}

int decode_one(const uint8_t* buf, size_t len, int canvas, uint8_t* out, int /*flags*/) {
  if (cudaSetDevice(g_device.load()) != cudaSuccess || ensure_handle() != 0) return 6;
  Decoder* d = acquire();
  if (d == nullptr) return 6;
  std::vector<uint8_t> raw;
  std::vector<uint8_t> resized;
  int w = 0, h = 0;
  const int rc = decode_rgb(d, buf, len, raw, &w, &h);
  release(d);
  if (rc != 0) return rc;

  // ---- copied from decode.cpp (decode_one's geometry) ----
  // shortest-edge resize (round, matching transform.py::_resize_shortest)
  // NOTE: Python round() is round-half-to-EVEN; nearbyint matches it under the
  // default FE_TONEAREST mode (lround rounds half away and shifts crops by 1px)
  const int short_edge = std::min(w, h);
  int nw = w, nh = h;
  if (short_edge != canvas) {
    const double scale = static_cast<double>(canvas) / short_edge;
    nw = static_cast<int>(std::nearbyint(w * scale));
    nh = static_cast<int>(std::nearbyint(h * scale));
  }
  const uint8_t* rptr = raw.data();
  if (nw != w || nh != h) {
    resized.resize(static_cast<size_t>(nw) * nh * 3);
    resize_bicubic(raw.data(), w, h, resized.data(), nw, nh);
    rptr = resized.data();
  }

  // center crop/pad to canvas x canvas (round offsets like _center_crop_or_pad)
  std::memset(out, 0, static_cast<size_t>(canvas) * canvas * 3);
  const int left = static_cast<int>(std::nearbyint((nw - canvas) / 2.0));
  const int top = static_cast<int>(std::nearbyint((nh - canvas) / 2.0));
  for (int y = 0; y < canvas; ++y) {
    const int sy = y + top;
    if (sy < 0 || sy >= nh) continue;
    const int x0 = std::max(0, -left);
    const int x1 = std::min(canvas, nw - left);
    if (x1 <= x0) continue;
    std::memcpy(out + (static_cast<size_t>(y) * canvas + x0) * 3,
                rptr + (static_cast<size_t>(sy) * nw + (left + x0)) * 3,
                static_cast<size_t>(x1 - x0) * 3);
  }
  return 0;
}
// ---- end of the copy ----

}  // namespace

extern "C" {

// The card that decoding threads use (the runtime's device is per thread).
void oct_set_device(int device) { g_device.store(device); }

// Single image: returns 0 on success.
int oct_decode_resize(const uint8_t* buf, size_t len, int canvas, uint8_t* out,
                      int flags) {
  return decode_one(buf, len, canvas, out, flags);
}

// Batch: bufs[i] has lens[i] bytes; out is (count, canvas, canvas, 3) uint8;
// status[i] gets each image's return code. nthreads<=1 decodes inline.
void oct_decode_batch(const uint8_t** bufs, const size_t* lens, int count, int canvas,
                      uint8_t* out, int* status, int nthreads, int flags) {
  const size_t stride = static_cast<size_t>(canvas) * canvas * 3;
  if (nthreads <= 1 || count <= 1) {
    for (int i = 0; i < count; ++i)
      status[i] = decode_one(bufs[i], lens[i], canvas, out + stride * i, flags);
    return;
  }
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= count) return;
      status[i] = decode_one(bufs[i], lens[i], canvas, out + stride * i, flags);
    }
  };
  std::vector<std::thread> pool;
  const int n = std::min(nthreads, count);
  pool.reserve(n);
  for (int t = 0; t < n; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

// Raw resample entry: src (h_in, w_in, 3) uint8.
void oct_resize(const uint8_t* src, int w_in, int h_in, uint8_t* dst, int w_out,
                int h_out) {
  resize_bicubic(src, w_in, h_in, dst, w_out, h_out);
}

// (width, height) from the JPEG header; 0 on success.
int oct_jpeg_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  if (cudaSetDevice(g_device.load()) != cudaSuccess || ensure_handle() != 0) return 6;
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_handle, buf, len, &ncomp, &css, widths, heights) !=
      NVJPEG_STATUS_SUCCESS)
    return 2;
  *w = widths[0];
  *h = heights[0];
  return 0;
}

}  // extern "C"
