// Batch image preprocessing on the host, in C++ (the port's own copy of
// the JAX package's llavamod_tpu/native/image_prep.cpp, same algorithm).
//
// The reference preprocesses each image in Python in its torch DataLoader
// workers (PIL decode + HF CLIPImageProcessor resize/normalize; reference
// data/dataset.py:89-93, dataloader_num_workers 8).  Here the pixel
// pipeline of a whole batch is one call into C++, the images spread over
// up to `num_threads` std::threads, with no interpreter lock held:
//
//   uint8 HWC -> [optional centered pad-to-square with background color]
//             -> PIL-compatible separable bicubic resize with antialias
//                (shortest edge = out_size)
//             -> center crop out_size x out_size
//             -> (x/255 - mean) / std, channels-first float32 output.
//
// The resampler reproduces PIL's convolution resampling (cubic a = -0.5,
// support 2, filter widened by the scale factor when downscaling, window
// weights normalized) in float precision; outputs match PIL within ~1/255
// (PIL rounds each pass to uint8, this code keeps floats).
//
// Build: g++ -O3 -march=native -funroll-loops -shared -fPIC -std=c++17
// -pthread image_prep.cpp -o ... (driven by llavamod_tpu_torch/native/
// __init__.py at first use; no external dependencies).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline double bicubic_filter(double x) {
  // PIL's bicubic kernel (a = -0.5, support = 2)
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  std::vector<int> xmin;   // first source index per output pixel
  std::vector<int> xsize;  // window length per output pixel
  std::vector<double> k;   // ksize coefficients per output pixel
  int ksize = 0;
};

// PIL precompute_coeffs (Resample.c): window positions + normalized weights.
Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs c;
  const double support_base = 2.0;  // bicubic support
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support_base * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.xmin.resize(out_size);
  c.xsize.resize(out_size);
  c.k.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(
        std::min(static_cast<double>(in_size), std::ceil(center + support)));
    int n = xmax - xmin;
    double* k = &c.k[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < n; ++x) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < n; ++x) k[x] /= ww;
    }
    c.xmin[xx] = xmin;
    c.xsize[xx] = n;
  }
  return c;
}

// Resize [h, w, 3] float -> [out_h, out_w, 3] float, separable bicubic.
void resize_bicubic(const float* src, int h, int w, int out_h, int out_w,
                    std::vector<float>* dst) {
  Coeffs ch = precompute_coeffs(w, out_w);
  // horizontal pass: [h, out_w, 3]
  std::vector<float> tmp(static_cast<size_t>(h) * out_w * 3);
  for (int y = 0; y < h; ++y) {
    const float* row = src + static_cast<size_t>(y) * w * 3;
    float* orow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const double* k = &ch.k[static_cast<size_t>(xx) * ch.ksize];
      int x0 = ch.xmin[xx], n = ch.xsize[xx];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < n; ++i) {
        const float* p = row + static_cast<size_t>(x0 + i) * 3;
        acc0 += k[i] * p[0];
        acc1 += k[i] * p[1];
        acc2 += k[i] * p[2];
      }
      // PIL clips each pass's uint8 intermediate: clamp here too so
      // bicubic overshoot does not leak into the vertical pass
      orow[xx * 3 + 0] = std::min(1.0f, std::max(0.0f, static_cast<float>(acc0)));
      orow[xx * 3 + 1] = std::min(1.0f, std::max(0.0f, static_cast<float>(acc1)));
      orow[xx * 3 + 2] = std::min(1.0f, std::max(0.0f, static_cast<float>(acc2)));
    }
  }
  // vertical pass: [out_h, out_w, 3]
  Coeffs cv = precompute_coeffs(h, out_h);
  dst->assign(static_cast<size_t>(out_h) * out_w * 3, 0.0f);
  for (int yy = 0; yy < out_h; ++yy) {
    const double* k = &cv.k[static_cast<size_t>(yy) * cv.ksize];
    int y0 = cv.xmin[yy], n = cv.xsize[yy];
    float* orow = dst->data() + static_cast<size_t>(yy) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      double acc = 0;
      for (int i = 0; i < n; ++i) {
        acc += k[i] * tmp[static_cast<size_t>(y0 + i) * out_w * 3 + x];
      }
      orow[x] = static_cast<float>(acc);
    }
  }
}

void preprocess_one(const uint8_t* img, int h, int w, int out_size,
                    int pad_square, const uint8_t* bg, const float* mean,
                    const float* stdv, float* out) {
  // 1) optional centered pad-to-square (mm_utils.expand2square semantics)
  std::vector<float> square;
  int sh = h, sw = w;
  const float inv255 = 1.0f / 255.0f;
  if (pad_square && h != w) {
    int side = std::max(h, w);
    square.assign(static_cast<size_t>(side) * side * 3, 0.0f);
    for (int i = 0; i < side * side; ++i) {
      square[i * 3 + 0] = bg[0] * inv255;
      square[i * 3 + 1] = bg[1] * inv255;
      square[i * 3 + 2] = bg[2] * inv255;
    }
    int top = (side - h) / 2, left = (side - w) / 2;
    for (int y = 0; y < h; ++y) {
      float* drow = square.data() +
                    (static_cast<size_t>(top + y) * side + left) * 3;
      const uint8_t* srow = img + static_cast<size_t>(y) * w * 3;
      for (int x = 0; x < w * 3; ++x) drow[x] = srow[x] * inv255;
    }
    sh = sw = side;
  } else {
    square.resize(static_cast<size_t>(h) * w * 3);
    for (size_t i = 0; i < square.size(); ++i) square[i] = img[i] * inv255;
  }

  // 2) shortest edge -> out_size (round like the python path)
  double scale = static_cast<double>(out_size) / std::min(sh, sw);
  int new_h = static_cast<int>(std::lround(sh * scale));
  int new_w = static_cast<int>(std::lround(sw * scale));
  std::vector<float> resized;
  resize_bicubic(square.data(), sh, sw, new_h, new_w, &resized);

  // 3) center crop + normalize to CHW
  int top = (new_h - out_size) / 2, left = (new_w - out_size) / 2;
  for (int ch = 0; ch < 3; ++ch) {
    float m = mean[ch], s = 1.0f / stdv[ch];
    float* oplane = out + static_cast<size_t>(ch) * out_size * out_size;
    for (int y = 0; y < out_size; ++y) {
      const float* srow = resized.data() +
          (static_cast<size_t>(top + y) * new_w + left) * 3;
      for (int x = 0; x < out_size; ++x) {
        float v = std::min(1.0f, std::max(0.0f, srow[x * 3 + ch]));
        oplane[y * out_size + x] = (v - m) * s;
      }
    }
  }
}

}  // namespace

extern "C" {

// imgs: n pointers to uint8 HWC buffers; out: [n, 3, out_size, out_size].
int llm_preprocess_batch(const uint8_t** imgs, const int* hs, const int* ws,
                         int n, int out_size, int pad_square,
                         const uint8_t* bg, const float* mean,
                         const float* stdv, float* out, int num_threads) {
  if (n <= 0 || out_size <= 0) return -1;
  const size_t per = static_cast<size_t>(3) * out_size * out_size;
  int workers = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  std::vector<int> status(n, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += workers) {
      if (hs[i] <= 0 || ws[i] <= 0) {
        status[i] = -1;
        continue;
      }
      preprocess_one(imgs[i], hs[i], ws[i], out_size, pad_square, bg, mean,
                     stdv, out + per * i);
    }
  };
  for (int t = 0; t < workers; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
  for (int s : status)
    if (s != 0) return -2;
  return 0;
}

int llm_image_prep_abi_version() { return 1; }

}  // extern "C"
