// Native host runtime for spectralae: hot host-side frame path.
//
// The equivalent of the reference's C++ host layer: the per-frame
// image<->tensor repacking the reference does with nested std::vectors
// (netlib.cpp:37-77) and cv::resize (autoencoder.cpp:124).  These run on the
// host every frame at video rate and feed jax.device_put; flat buffers +
// tight loops keep the producer ahead of the device.
//
// C ABI (ctypes-bound from spectralae/data/native.py):
//   sae_frame_to_tensor : uint8 [H,W,3] BGR -> float32 [3,W,H]   (0..255)
//   sae_tensor_to_frame : float32 [3,W,H] -> uint8 [H,W,3], round+clamp
//   sae_resize_nn       : uint8 [H,W,3] -> uint8 [oh,ow,3] nearest-neighbor
//   sae_batch_to_tensor : resize+convert a whole batch, one thread/frame
//   sae_yuv_to_bgr      : planar YUV (sub-sampled chroma) -> uint8 BGR HWC,
//                         BT.601 limited range, rows fanned over threads
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// uint8 HWC (BGR) frame -> channel-major float tensor [3][W][H].
// Matches ImageToSpin_C (netlib.cpp:37-51): spin[c][i][j] = img(j, i)[c],
// i over columns, values kept in 0..255.
void sae_frame_to_tensor(const uint8_t* img, float* out, int h, int w) {
  const int64_t plane = (int64_t)w * h;
  for (int j = 0; j < h; ++j) {
    const uint8_t* row = img + (int64_t)j * w * 3;
    for (int i = 0; i < w; ++i) {
      const int64_t t = (int64_t)i * h + j;
      out[0 * plane + t] = (float)row[i * 3 + 0];
      out[1 * plane + t] = (float)row[i * 3 + 1];
      out[2 * plane + t] = (float)row[i * 3 + 2];
    }
  }
}

// float tensor [3][W][H] -> uint8 HWC frame with round + clamp [0,255].
// Matches SpinToImage_C (netlib.cpp:54-77).
void sae_tensor_to_frame(const float* spin, uint8_t* img, int h, int w) {
  const int64_t plane = (int64_t)w * h;
  for (int j = 0; j < h; ++j) {
    uint8_t* row = img + (int64_t)j * w * 3;
    for (int i = 0; i < w; ++i) {
      const int64_t t = (int64_t)i * h + j;
      for (int c = 0; c < 3; ++c) {
        float v = std::nearbyint(spin[c * plane + t]);
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        row[i * 3 + c] = (uint8_t)v;
      }
    }
  }
}

// Nearest-neighbor resize of an HWC uint8 frame (floor index mapping,
// matching spectralae.data.pipeline.resize_nn).
void sae_resize_nn(const uint8_t* img, uint8_t* out, int h, int w,
                   int oh, int ow) {
  for (int j = 0; j < oh; ++j) {
    const int sj = (int)((int64_t)j * h / oh);
    const uint8_t* srow = img + (int64_t)sj * w * 3;
    uint8_t* drow = out + (int64_t)j * ow * 3;
    for (int i = 0; i < ow; ++i) {
      const int si = (int)((int64_t)i * w / ow);
      std::memcpy(drow + i * 3, srow + si * 3, 3);
    }
  }
}

// Fused resize+convert for one frame: uint8 [h,w,3] -> float32 [3,ow,oh]
// at the target resolution, without materializing the resized uint8 frame.
static void frame_resize_to_tensor(const uint8_t* img, float* out,
                                   int h, int w, int oh, int ow) {
  const int64_t plane = (int64_t)ow * oh;
  for (int j = 0; j < oh; ++j) {
    const int sj = (int)((int64_t)j * h / oh);
    const uint8_t* srow = img + (int64_t)sj * w * 3;
    for (int i = 0; i < ow; ++i) {
      const int si = (int)((int64_t)i * w / ow);
      const uint8_t* px = srow + si * 3;
      const int64_t t = (int64_t)i * oh + j;
      out[0 * plane + t] = (float)px[0];
      out[1 * plane + t] = (float)px[1];
      out[2 * plane + t] = (float)px[2];
    }
  }
}

// Batch pipeline stage: n frames (contiguous uint8 [n,h,w,3]) ->
// float32 [n,3,ow,oh], fusing NN resize with the layout transform and
// fanning frames out over worker threads.  This is the producer-side hot
// loop that keeps a batched DevicePrefetcher ahead of the device at video
// rate (the reference converts one frame per display tick on the main
// thread, autoencoder.cpp:123-125).
void sae_batch_to_tensor(const uint8_t* imgs, float* out, int n,
                         int h, int w, int oh, int ow, int n_threads) {
  const int64_t in_stride = (int64_t)h * w * 3;
  const int64_t out_stride = (int64_t)3 * ow * oh;
  if (n_threads <= 1 || n <= 1) {
    for (int k = 0; k < n; ++k)
      frame_resize_to_tensor(imgs + k * in_stride, out + k * out_stride,
                             h, w, oh, ow);
    return;
  }
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int k = t; k < n; k += n_threads)
        frame_resize_to_tensor(imgs + k * in_stride, out + k * out_stride,
                               h, w, oh, ow);
    });
  }
  for (auto& th : workers) th.join();
}

// One output row of BT.601 limited-range YUV -> BGR.  Same float32
// operation order as the numpy path in data/pipeline.py::y4m_video so the
// two implementations agree to the rounding boundary.
static void yuv_row_to_bgr(const uint8_t* y, const uint8_t* u,
                           const uint8_t* v, uint8_t* out, int w,
                           int cw, int sx) {
  for (int i = 0; i < w; ++i) {
    const int ci = i / sx < cw ? i / sx : cw - 1;
    const float yf = 1.164f * ((float)y[i] - 16.0f);
    const float uf = (float)u[ci] - 128.0f;
    const float vf = (float)v[ci] - 128.0f;
    const float r = yf + 1.596f * vf;
    const float g = yf - 0.813f * vf - 0.391f * uf;
    const float b = yf + 2.018f * uf;
    const float px[3] = {b, g, r};
    for (int c = 0; c < 3; ++c) {
      // lrintf: one cvtss2si in the current (half-to-even) rounding mode —
      // same result as numpy's np.round, far cheaper than nearbyint(double)
      long q = lrintf(px[c]);
      q = q < 0 ? 0 : (q > 255 ? 255 : q);
      out[i * 3 + c] = (uint8_t)q;
    }
  }
}

// Planar YUV frame -> uint8 BGR HWC.  y is [h,w]; u and v are
// [ceil-free h/sy, w/sx] chroma planes (sy/sx = 1 or 2, covering C420,
// C422 and C444), upsampled nearest-neighbor.  This is the per-frame hot
// loop of the Y4M file source (a video-rate host decode stage the
// reference delegates to OpenCV, autoencoder.cpp:54).
void sae_yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                    uint8_t* out, int h, int w, int sy, int sx,
                    int n_threads) {
  const int cw = w / sx;
  const int chh = h / sy;
  auto rows = [=](int j0, int step) {
    for (int j = j0; j < h; j += step) {
      int cj = j / sy;
      if (cj >= chh) cj = chh - 1;
      yuv_row_to_bgr(y + (int64_t)j * w, u + (int64_t)cj * cw,
                     v + (int64_t)cj * cw, out + (int64_t)j * w * 3,
                     w, cw, sx);
    }
  };
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > h) n_threads = h;
  if (n_threads <= 1) {
    rows(0, 1);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t)
    workers.emplace_back([=]() { rows(t, n_threads); });
  for (auto& th : workers) th.join();
}

// PNG scanline unfiltering (RFC 2083 filters 0-4).  raw is h rows of
// [1 filter byte + w_bytes filtered data]; out is h*w_bytes recovered
// bytes.  The predictors are sequential per byte (sub/average/paeth
// depend on the already-reconstructed left neighbor), which is why this
// lives in C — feeding image-directory datasets at video rate
// (spectralae.viz.png.read_png; Python fallback loops per byte).
// Returns 0 on success, the bad filter type on failure.
int sae_png_unfilter(const uint8_t* raw, uint8_t* out, int h, int w_bytes,
                     int ch) {
  for (int r = 0; r < h; ++r) {
    const uint8_t ft = raw[(int64_t)r * (w_bytes + 1)];
    const uint8_t* src = raw + (int64_t)r * (w_bytes + 1) + 1;
    uint8_t* dst = out + (int64_t)r * w_bytes;
    const uint8_t* up = r ? out + (int64_t)(r - 1) * w_bytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(dst, src, w_bytes);
        break;
      case 1:  // sub
        for (int i = 0; i < w_bytes; ++i)
          dst[i] = (uint8_t)(src[i] + (i >= ch ? dst[i - ch] : 0));
        break;
      case 2:  // up
        for (int i = 0; i < w_bytes; ++i)
          dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:  // average
        for (int i = 0; i < w_bytes; ++i) {
          const int a = i >= ch ? dst[i - ch] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // paeth
        for (int i = 0; i < w_bytes; ++i) {
          const int a = i >= ch ? dst[i - ch] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= ch) ? up[i - ch] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return ft;
    }
  }
  return 0;
}

}  // extern "C"
