// Full-resolution JPEG decode on libjpeg, for the NaFlex pipeline, which resizes
// each image to its own aspect-preserving patch grid (data/naflex.py) rather than
// to decode.cpp's square canvas. Linked into the libjpeg build beside decode.cpp.
//
// The decode is decode.cpp's without DCT scaling: RGB output (grayscale and YCbCr
// convert; CMYK errors out), the accurate integer IDCT (JDCT_ISLOW), libjpeg's
// default fancy upsampling.
//
// C ABI only, bound from Python via ctypes.

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct FullJerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void full_jerr_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<FullJerrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void full_jerr_emit(j_common_ptr, int) {}  // warnings: a truncated file still decodes

// Decode into `out` (at least cap bytes) as (h, w, 3) uint8; *w_out and *h_out get
// the size. 0 on success, 7 when cap is too small (the size is set), else
// decode.cpp's codes (1: libjpeg error, 2: header, 3: start, 4: components).
int decode_full(const uint8_t* buf, size_t len, uint8_t* out, size_t cap, int* w_out,
                int* h_out) {
  jpeg_decompress_struct cinfo;
  FullJerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = full_jerr_exit;
  jerr.pub.emit_message = full_jerr_emit;
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
  cinfo.out_color_space = JCS_RGB;
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
  *w_out = w;
  *h_out = h;
  if (static_cast<size_t>(w) * h * 3 > cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 7;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Batch: image i into outs[i] (caps[i] bytes, sized from oct_jpeg_dims); status[i]
// gets its return code. nthreads <= 1 decodes inline.
void oct_decode_full_batch(const uint8_t** bufs, const size_t* lens, int count, uint8_t** outs,
                           const size_t* caps, int* status, int nthreads) {
  auto one = [&](int i) {
    int w = 0, h = 0;
    status[i] = decode_full(bufs[i], lens[i], outs[i], caps[i], &w, &h);
  };
  if (nthreads <= 1 || count <= 1) {
    for (int i = 0; i < count; ++i) one(i);
    return;
  }
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= count) return;
      one(i);
    }
  };
  std::vector<std::thread> pool;
  const int n = std::min(nthreads, count);
  pool.reserve(n);
  for (int t = 0; t < n; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // extern "C"
