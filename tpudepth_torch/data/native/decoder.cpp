// Multithreaded JPEG/PNG batch decoder of tpudepth_torch's data feed.
//
// The port's own copy of the JAX package's native decoder, with the same C
// entries (tpudepth_probe, tpudepth_decode_batch, tpudepth_decode_batch_raw,
// tpudepth_decode_batch_raw_scaled). It decodes a whole batch in parallel
// with libjpeg/libpng straight into one preallocated NHWC array, outside the
// Python interpreter lock.
//
// Semantics match the reference ToTensor (src/data.py:124-155):
//   - 8-bit images (JPEG RGB / PNG gray) -> float32 / 255
//   - 16-bit PNG depth -> raw float32 values (no division)
// The raw entries keep the integer pixels (uint8, or uint16 for 16-bit PNG).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 decoder.cpp -ljpeg -lpng -lz
// (tpudepth_torch/data/native/__init__.py, at first use, into
// tpudepth_torch/_build/). Interface: plain C ABI through ctypes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG into out[h*w*c] float32 (value/255). Returns 0 on success.
int decode_jpeg_one(const uint8_t* buf, size_t size, float* out, int h, int w,
                    int c) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      static_cast<int>(cinfo.output_components) != c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  std::vector<uint8_t> row(static_cast<size_t>(w) * c);
  uint8_t* rowp = row.data();
  constexpr float kInv255 = 1.0f / 255.0f;
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out + static_cast<size_t>(y) * w * c;
    for (int i = 0; i < w * c; ++i) dst[i] = row[i] * kInv255;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t offset;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->offset + n > s->size) {
    png_error(png, "read past end");
    return;
  }
  std::memcpy(out, s->data + s->offset, n);
  s->offset += n;
}

// Decode one PNG (gray 8/16-bit or RGB 8-bit). 8-bit -> /255, 16-bit -> raw.
int decode_png_one(const uint8_t* buf, size_t size, float* out, int h, int w,
                   int c) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState state{buf, size, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  int width = png_get_image_width(png, info);
  int height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (height != h || width != w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  if (channels != c) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }

  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> row(rowbytes);
  constexpr float kInv255 = 1.0f / 255.0f;
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + static_cast<size_t>(y) * w * c;
    if (bit_depth == 16) {
      // PNG stores 16-bit big-endian; raw values, no division
      for (int i = 0; i < w * c; ++i) {
        dst[i] = static_cast<float>((row[2 * i] << 8) | row[2 * i + 1]);
      }
    } else {
      for (int i = 0; i < w * c; ++i) dst[i] = row[i] * kInv255;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

bool is_jpeg(const uint8_t* buf, size_t size) {
  return size >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

// ---------------------------------------------------------------------------
// Raw (integer) decode variants. The float conversion above costs 4x the
// memory traffic of the pixels themselves; at TPU train rates with a single
// host core (this machine), moving /255 onto the device is the difference
// between a host-bound and a device-bound pipeline. These write the decoded
// bytes verbatim: uint8 for 8-bit sources, uint16 for 16-bit PNG depth.
// ---------------------------------------------------------------------------

// `scale_denom` (1/2/4/8) engages libjpeg DCT scaling: the file is decoded
// directly at 1/scale size for ~scale^2 less IDCT + color work — the
// single-core host's only lever for feeding reduced-resolution training
// configs (240x320 from the NYU 480x640 JPEGs) at device rate.
int decode_jpeg_one_u8(const uint8_t* buf, size_t size, uint8_t* out, int h,
                       int w, int c, int scale_denom = 1) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      static_cast<int>(cinfo.output_components) != c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out + static_cast<size_t>(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &dst, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// 8-bit sources -> uint8 out; 16-bit PNG -> uint16 out (host-endian values).
// `want_bits` must match the file's decoded bit depth. `scale_denom` > 1
// box-averages scale x scale pixel blocks into each output pixel (the exact
// equivalent of align_corners=False bilinear 1/2-downscale when scale=2),
// rounding to nearest integer — PNG has no DCT shortcut, but the averaging
// happens on the decode row buffer with integer math.
int decode_png_one_raw(const uint8_t* buf, size_t size, void* out, int h,
                       int w, int c, int want_bits, int scale_denom = 1) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState state{buf, size, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  int width = png_get_image_width(png, info);
  int height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  const int s = scale_denom < 1 ? 1 : scale_denom;
  if (height != h * s || width != w * s) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  bit_depth = png_get_bit_depth(png, info);

  int channels = png_get_channels(png, info);
  if (channels != c || bit_depth != want_bits) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }

  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> row(rowbytes);
  const int fw = w * s;  // file width
  const uint32_t half = static_cast<uint32_t>(s) * s / 2;

  // rowacc[fw*c]: elementwise sum of s file rows (vectorizable), then a
  // horizontal s-fold reduce per output pixel.
  std::vector<uint32_t> rowacc;
  if (s > 1) rowacc.resize(static_cast<size_t>(fw) * c);

  if (bit_depth == 16) {
    uint16_t* out16 = static_cast<uint16_t*>(out);
    for (int y = 0; y < h; ++y) {
      if (s == 1) {
        png_read_row(png, row.data(), nullptr);
        uint16_t* dst = out16 + static_cast<size_t>(y) * w * c;
        for (int i = 0; i < w * c; ++i) {
          dst[i] = static_cast<uint16_t>((row[2 * i] << 8) | row[2 * i + 1]);
        }
      } else {
        std::fill(rowacc.begin(), rowacc.end(), 0u);
        for (int sy = 0; sy < s; ++sy) {
          png_read_row(png, row.data(), nullptr);
          for (int i = 0; i < fw * c; ++i)
            rowacc[i] += static_cast<uint32_t>((row[2 * i] << 8) |
                                               row[2 * i + 1]);
        }
        uint16_t* dst = out16 + static_cast<size_t>(y) * w * c;
        for (int x = 0; x < w; ++x) {
          for (int ch = 0; ch < c; ++ch) {
            uint32_t sum = 0;
            for (int k = 0; k < s; ++k) sum += rowacc[(x * s + k) * c + ch];
            dst[x * c + ch] = static_cast<uint16_t>((sum + half) / (s * s));
          }
        }
      }
    }
  } else {
    uint8_t* out8 = static_cast<uint8_t*>(out);
    for (int y = 0; y < h; ++y) {
      if (s == 1) {
        png_read_row(png, out8 + static_cast<size_t>(y) * w * c, nullptr);
      } else {
        std::fill(rowacc.begin(), rowacc.end(), 0u);
        for (int sy = 0; sy < s; ++sy) {
          png_read_row(png, row.data(), nullptr);
          for (int i = 0; i < fw * c; ++i) rowacc[i] += row[i];
        }
        uint8_t* dst = out8 + static_cast<size_t>(y) * w * c;
        for (int x = 0; x < w; ++x) {
          for (int ch = 0; ch < c; ++ch) {
            uint32_t sum = 0;
            for (int k = 0; k < s; ++k) sum += rowacc[(x * s + k) * c + ch];
            dst[x * c + ch] = static_cast<uint8_t>((sum + half) / (s * s));
          }
        }
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

}  // namespace

extern "C" {

// Decode n encoded images (JPEG or PNG, sniffed per item) into a preallocated
// float32 [n, h, w, c] tensor, using `nthreads` worker threads.
// Returns 0 on success, else the first nonzero per-item error code.
int tpudepth_decode_batch(const uint8_t** bufs, const size_t* sizes, int n,
                          float* out, int h, int w, int c, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0);
  std::atomic<int> status(0);
  const size_t stride = static_cast<size_t>(h) * w * c;

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc;
      if (is_jpeg(bufs[i], sizes[i])) {
        rc = decode_jpeg_one(bufs[i], sizes[i], out + i * stride, h, w, c);
      } else {
        rc = decode_png_one(bufs[i], sizes[i], out + i * stride, h, w, c);
      }
      if (rc != 0) {
        int expected = 0;
        status.compare_exchange_strong(expected, rc);
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return status.load();
}

// Raw integer batch decode: bit_depth 8 -> out is uint8 [n, h, w, c],
// bit_depth 16 -> out is uint16 [n, h, w, c] (PNG only). No float conversion;
// normalization (/255 etc.) happens on the accelerator. (h, w) are OUTPUT
// dims: with scale_denom > 1 (1/2/4/8) the files must be (h*s, w*s) —
// JPEGs decode directly at 1/s via DCT scaling, PNGs box-average s x s.
int tpudepth_decode_batch_raw_scaled(const uint8_t** bufs, const size_t* sizes,
                                     int n, void* out, int h, int w, int c,
                                     int bit_depth, int scale_denom,
                                     int nthreads) {
  if (bit_depth != 8 && bit_depth != 16) return 3;
  if (scale_denom != 1 && scale_denom != 2 && scale_denom != 4 &&
      scale_denom != 8)
    return 3;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0);
  std::atomic<int> status(0);
  const size_t stride = static_cast<size_t>(h) * w * c;

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc;
      if (is_jpeg(bufs[i], sizes[i])) {
        rc = (bit_depth == 8)
                 ? decode_jpeg_one_u8(bufs[i], sizes[i],
                                      static_cast<uint8_t*>(out) + i * stride,
                                      h, w, c, scale_denom)
                 : 3;
      } else {
        void* dst = (bit_depth == 16)
                        ? static_cast<void*>(static_cast<uint16_t*>(out) +
                                             i * stride)
                        : static_cast<void*>(static_cast<uint8_t*>(out) +
                                             i * stride);
        rc = decode_png_one_raw(bufs[i], sizes[i], dst, h, w, c, bit_depth,
                                scale_denom);
      }
      if (rc != 0) {
        int expected = 0;
        status.compare_exchange_strong(expected, rc);
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return status.load();
}

int tpudepth_decode_batch_raw(const uint8_t** bufs, const size_t* sizes, int n,
                              void* out, int h, int w, int c, int bit_depth,
                              int nthreads) {
  return tpudepth_decode_batch_raw_scaled(bufs, sizes, n, out, h, w, c,
                                          bit_depth, 1, nthreads);
}

// Probe an encoded image's dimensions: fills h, w, channels, bit_depth.
int tpudepth_probe(const uint8_t* buf, size_t size, int* h, int* w, int* c,
                   int* bit_depth) {
  if (is_jpeg(buf, size)) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
      jpeg_destroy_decompress(&cinfo);
      return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
                 static_cast<unsigned long>(size));
    jpeg_read_header(&cinfo, TRUE);
    *h = cinfo.image_height;
    *w = cinfo.image_width;
    *c = cinfo.num_components;
    *bit_depth = 8;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState state{buf, size, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);
  *h = png_get_image_height(png, info);
  *w = png_get_image_width(png, info);
  *c = png_get_channels(png, info);
  *bit_depth = png_get_bit_depth(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

}  // extern "C"
