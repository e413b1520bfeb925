// Native OCT volume ingestion: threaded PNG stack decoding.
//
// The port's copy of octcubem_tpu/native/volume_loader.cpp.  Replaces
// the reference's hot host-side data path
// (OCTCube/util/PatientDataset.py:524-588: per-frame PIL decode in
// num_workers=24 torch DataLoader processes).  Decodes all frames of a
// volume in parallel with std::thread (libpng releases no GIL to fight),
// applies the grayscale conversion, optional 1024->512 box downsample,
// and /255 normalization in one pass, writing straight into a
// caller-provided float32 buffer (zero-copy into numpy via ctypes).
//
// Built at first use by octcubem_tpu_torch/native/__init__.py:
// g++ -O3 -shared -fPIC -std=c++17 -pthread ... -lpng -lz.

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> gray;  // H*W grayscale
  uint32_t h = 0, w = 0;
  bool ok = false;
};

bool decode_png_gray(const char* path, Frame* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const uint32_t w = png_get_image_width(png, info);
  const uint32_t h = png_get_image_height(png, info);
  const int ctype = png_get_color_type(png, info);
  const int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (ctype == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (ctype == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // luminance conversion for RGB inputs (PIL 'L' uses ITU-R 601-2; libpng
  // rgb_to_gray defaults are close; use 0.299/0.587/0.114 to match PIL)
  if (ctype & PNG_COLOR_MASK_COLOR)
    png_set_rgb_to_gray(png, PNG_ERROR_ACTION_NONE, 0.299, 0.587);
  if (ctype & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->h = h;
  out->w = w;
  out->gray.resize(size_t(h) * w);
  std::vector<png_bytep> rows(h);
  const size_t stride = png_get_rowbytes(png, info);
  std::vector<uint8_t> buf(stride * h);
  for (uint32_t r = 0; r < h; ++r) rows[r] = buf.data() + r * stride;
  png_read_image(png, rows.data());
  // stride may exceed w for multi-channel leftovers; take first byte/px
  const size_t px_bytes = stride / w;
  for (uint32_t r = 0; r < h; ++r)
    for (uint32_t c = 0; c < w; ++c)
      out->gray[size_t(r) * w + c] = buf[r * stride + c * px_bytes];
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out->ok = true;
  return true;
}

// PIL bicubic kernel (Catmull-Rom, a = -0.5)
inline double pil_bicubic(double t) {
  t = t < 0 ? -t : t;
  if (t < 1.0) return 1.5 * t * t * t - 2.5 * t * t + 1.0;
  if (t < 2.0) return -0.5 * (t * t * t - 5.0 * t * t + 8.0 * t - 4.0);
  return 0.0;
}

// PIL-equivalent antialiased 2x reduction along one axis, on 0..255
// floats, followed by PIL's uint8 quantization (round-half-away).
// Matches Image.resize((w/2, h)) / ((w, h/2)) with the default BICUBIC
// filter to within uint8 rounding.
void pil_halve_axis(std::vector<float>& v, uint32_t& h, uint32_t& w,
                    bool height_axis) {
  const double scale = 2.0, support = 2.0 * scale;  // bicubic support 2
  const uint32_t in_n = height_axis ? h : w;
  const uint32_t out_n = in_n / 2;
  // precompute weights per output index (border windows differ)
  std::vector<std::vector<double>> wt(out_n);
  std::vector<int> xmin(out_n);
  for (uint32_t o = 0; o < out_n; ++o) {
    const double center = (o + 0.5) * scale;
    int lo = int(center - support + 0.5);
    int hi = int(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > int(in_n)) hi = int(in_n);
    double total = 0.0;
    wt[o].resize(hi - lo);
    for (int x = lo; x < hi; ++x) {
      const double ww = pil_bicubic((x - center + 0.5) / scale);
      wt[o][x - lo] = ww;
      total += ww;
    }
    for (auto& ww : wt[o]) ww /= total;
    xmin[o] = lo;
  }
  auto quant = [](double acc) {
    double r = acc < 0 ? 0 : (acc > 255 ? 255 : acc);
    return float(uint8_t(r + 0.5));
  };
  if (height_axis) {
    std::vector<float> out(size_t(out_n) * w);
    for (uint32_t o = 0; o < out_n; ++o)
      for (uint32_t c = 0; c < w; ++c) {
        double acc = 0;
        for (size_t k = 0; k < wt[o].size(); ++k)
          acc += wt[o][k] * v[size_t(xmin[o] + k) * w + c];
        out[size_t(o) * w + c] = quant(acc);
      }
    v.swap(out);
    h = out_n;
  } else {
    std::vector<float> out(size_t(h) * out_n);
    for (uint32_t r = 0; r < h; ++r)
      for (uint32_t o = 0; o < out_n; ++o) {
        double acc = 0;
        for (size_t k = 0; k < wt[o].size(); ++k)
          acc += wt[o][k] * v[size_t(r) * w + xmin[o] + k];
        out[size_t(r) * out_n + o] = quant(acc);
      }
    v.swap(out);
    w = out_n;
  }
}

}  // namespace

extern "C" {

// Probe frame dimensions after the reference's 1024->512 downsample rule.
int octcubem_png_dims(const char* path, int downsample_width, int* h, int* w) {
  Frame f;
  if (!decode_png_gray(path, &f)) return -1;
  uint32_t hh = f.h, ww = f.w;
  if (downsample_width) {
    if (ww == 1024) ww = 512;
    if (hh == 1024) hh = 512;
  }
  *h = int(hh);
  *w = int(ww);
  return 0;
}

// Decode n_frames PNGs in parallel into out[n_frames, h, w] float32 in
// [0,1].  Frames whose post-downsample size mismatches (h, w) are
// rejected.  Returns 0 on success, else the index of the first bad frame
// + 1 (negated).
int octcubem_load_png_stack(const char** paths, int n_frames, int h, int w,
                            int downsample_width, int n_threads, float* out) {
  std::atomic<int> next{0};
  std::atomic<int> bad{0};
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n_frames) n_threads = n_frames;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n_frames || bad.load()) return;
      Frame f;
      if (!decode_png_gray(paths[i], &f)) {
        bad.store(i + 1);
        return;
      }
      // keep 0..255 scale through the (quantizing) resample, /255 at the end
      std::vector<float> v(f.gray.size());
      for (size_t j = 0; j < f.gray.size(); ++j) v[j] = float(f.gray[j]);
      uint32_t hh = f.h, ww = f.w;
      if (downsample_width) {
        if (ww == 1024) pil_halve_axis(v, hh, ww, false);
        if (hh == 1024) pil_halve_axis(v, hh, ww, true);
      }
      if (int(hh) != h || int(ww) != w) {
        bad.store(i + 1);
        return;
      }
      float* dst = out + size_t(i) * h * w;
      for (size_t j = 0; j < v.size(); ++j) dst[j] = v[j] / 255.0f;
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return bad.load() ? -bad.load() : 0;
}

}  // extern "C"
