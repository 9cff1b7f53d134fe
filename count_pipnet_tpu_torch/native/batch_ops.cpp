// Native host-side batch assembly for the port's input pipeline.
//
// The port's own copy of count_pipnet_tpu/native/batch_ops.cpp. The
// per-image decode/augment stays in PIL threads (PIL releases the GIL), but
// the per-BATCH hot loop -- u8 -> f32 conversion, ImageNet normalization,
// HWC gather into one contiguous NHWC block -- runs here: one pass, no
// intermediate numpy temporaries, multithreaded across images.
//
// Exposed via a plain C ABI and loaded with ctypes
// (count_pipnet_tpu_torch/native/__init__.py), which builds it at first use
// into native/_build/.
//
// Build: c++ -O3 -march=native -shared -fPIC -o libbatch_ops.so batch_ops.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Normalize a batch of uint8 HWC images into float32 NHWC with per-channel
// mean/std: out[n,h,w,c] = (in[n,h,w,c]/255 - mean[c]) / std[c].
// imgs: n_images pointers to h*w*3 uint8 buffers.
void normalize_batch_u8(const uint8_t** imgs, int n_images, int h, int w,
                        const float* mean, const float* std_,
                        float* out, int n_threads) {
  const int64_t px = static_cast<int64_t>(h) * w;
  const float inv255 = 1.0f / 255.0f;
  float scale[3], bias[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = inv255 / std_[c];
    bias[c] = -mean[c] / std_[c];
  }
  auto work = [&](int start, int end) {
    for (int n = start; n < end; ++n) {
      const uint8_t* src = imgs[n];
      float* dst = out + n * px * 3;
      for (int64_t i = 0; i < px; ++i) {
        dst[i * 3 + 0] = src[i * 3 + 0] * scale[0] + bias[0];
        dst[i * 3 + 1] = src[i * 3 + 1] * scale[1] + bias[1];
        dst[i * 3 + 2] = src[i * 3 + 2] * scale[2] + bias[2];
      }
    }
  };
  if (n_threads <= 1 || n_images <= 1) {
    work(0, n_images);
    return;
  }
  n_threads = n_threads > n_images ? n_images : n_threads;
  std::vector<std::thread> threads;
  int chunk = (n_images + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int s = t * chunk;
    int e = s + chunk > n_images ? n_images : s + chunk;
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

// Stack already-float32 HWC arrays into one contiguous NHWC batch.
void stack_batch_f32(const float** imgs, int n_images, int64_t elems,
                     float* out, int n_threads) {
  auto work = [&](int start, int end) {
    for (int n = start; n < end; ++n) {
      std::memcpy(out + n * elems, imgs[n], elems * sizeof(float));
    }
  };
  if (n_threads <= 1 || n_images <= 1) {
    work(0, n_images);
    return;
  }
  n_threads = n_threads > n_images ? n_images : n_threads;
  std::vector<std::thread> threads;
  int chunk = (n_images + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int s = t * chunk;
    int e = s + chunk > n_images ? n_images : s + chunk;
    if (s >= e) break;
    threads.emplace_back(work, s, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
