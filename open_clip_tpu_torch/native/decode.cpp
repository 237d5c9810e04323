// Native host-stage image decode for the TPU input pipeline.
//
// The reference feeds its GPUs from torchvision/PIL Python workers
// (open_clip_train data.py:694-948). Our device-preprocess tier moved the
// float work (RRC + normalize) onto the TPU, which leaves JPEG decode +
// shortest-edge resize + center crop as the host bottleneck (~500 img/s/core
// through PIL). This library does that stage in C++ on libjpeg with
// DCT-domain scaled decode (the same trick as PIL's draft mode) and a
// PIL-equivalent antialiased separable resample, with an in-library thread
// pool for batch decode.
//
// Geometry contract (must match transform.py::_Uint8CanvasTransform):
//   scale = canvas / min(w, h); nw = round(w*scale), nh = round(h*scale)
//   center crop: left = round((nw-canvas)/2), top = round((nh-canvas)/2)
//   (pad symmetrically with fill=0 when smaller — only possible via rounding)
// Resampling: PIL "bicubic" convolution (a = -0.5) with antialias support
// scaling, float accumulation, round-half-away + clamp to uint8.
//
// C ABI only — bound from Python via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cfenv>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------------------
// libjpeg error handling: convert ERREXIT into longjmp so bad bytes return an
// error code instead of calling exit()
// ---------------------------------------------------------------------------

struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jerr_exit(j_common_ptr cinfo) {
  JerrMgr* err = reinterpret_cast<JerrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jerr_emit(j_common_ptr, int) {}  // swallow warnings (partial files decode fine)

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

// ---------------------------------------------------------------------------
// decode one JPEG -> canvas x canvas x 3 uint8 (shortest-edge resize + center
// crop/pad). Returns 0 on success, nonzero on failure (caller falls back).
// ---------------------------------------------------------------------------

// flags bit 0: allow fractional M/8 DCT-domain scaling (libjpeg-turbo; decodes
// closest to the target size, cutting IDCT + resample work — the DALI/production
// trick). Without it only 1/2^k scales are used, matching PIL draft exactly.
int decode_one(const uint8_t* buf, size_t len, int canvas, uint8_t* out,
               int flags = 0) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  // Declared BEFORE setjmp: a longjmp from mid-decode lands inside their
  // lifetime, so the error-path return runs their destructors (declaring them
  // after setjmp would skip destructors — leak + formally UB).
  std::vector<uint8_t> raw;
  std::vector<uint8_t> resized;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.emit_message = jerr_emit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr convert; CMYK errors out

  const unsigned short_in = std::min(cinfo.image_width, cinfo.image_height);
  if (flags & 1) {
    // fractional M/8 scaled decode: smallest M with ceil(short*M/8) >= canvas
    int M = 8;
    for (int m = 1; m <= 8; ++m) {
      if ((short_in * static_cast<unsigned>(m) + 7u) / 8u >=
          static_cast<unsigned>(canvas)) {
        M = m;
        break;
      }
    }
    cinfo.scale_num = M;
    cinfo.scale_denom = 8;
  } else {
    // PIL-draft-equivalent: largest 1/2^k with shortest edge still >= canvas
    int denom = 1;
    while (denom < 8) {
      const int next = denom * 2;
      if (short_in / next >= static_cast<unsigned>(canvas))
        denom = next;
      else
        break;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  cinfo.dct_method = JDCT_ISLOW;

  if (!jpeg_start_decompress(&cinfo)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  const int w = cinfo.output_width, h = cinfo.output_height;
  raw.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = raw.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

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

}  // namespace

extern "C" {

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

// Raw resample entry (testing + non-JPEG callers): src (h_in, w_in, 3) uint8.
void oct_resize(const uint8_t* src, int w_in, int h_in, uint8_t* dst, int w_out,
                int h_out) {
  resize_bicubic(src, w_in, h_in, dst, w_out, h_out);
}

// Probe helper so Python can report the decoded dims without a full pipeline.
int oct_jpeg_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.emit_message = jerr_emit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
