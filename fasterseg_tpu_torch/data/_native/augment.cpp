// Native host-side augmentation kernels for the train data loader.
//
// A copy of the JAX package's data/_native/augment.cpp, so that both
// packages augment alike. The reference's preprocessing leans on OpenCV's
// C++ kernels (tools/utils/img_utils.py; cv2.resize/flip/copyMakeBorder).
// These are first-party equivalents of the hot per-sample ops —
// bilinear/nearest resize, horizontal mirror, crop+pad, and fused
// uint8->normalized-float conversion — implemented in C++ with OpenMP-free
// portable loops (the loader runs them in a prefetch thread), exposed via
// a C ABI consumed through ctypes (data/native.py).
//
// Semantics match OpenCV exactly (pinned by tests/test_torch_train_data.py):
//   INTER_LINEAR : src = (dst + 0.5) * (in/out) - 0.5, clamped, 2-tap lerp
//   INTER_NEAREST: src = floor(dst * in/out)
//
// Build: data/native.py runs g++ -O3 -shared -fPIC at first use, into
// fasterseg_tpu_torch/build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Bilinear resize, uint8 HWC -> uint8 HWC (cv2 INTER_LINEAR semantics).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
    const double fy = static_cast<double>(sh) / dh;
    const double fx = static_cast<double>(sw) / dw;
    // precompute x taps
    int* x0s = new int[dw];
    int* x1s = new int[dw];
    float* txs = new float[dw];
    for (int x = 0; x < dw; ++x) {
        double sx = (x + 0.5) * fx - 0.5;
        if (sx < 0) sx = 0;
        int x0 = static_cast<int>(sx);
        if (x0 > sw - 1) x0 = sw - 1;
        int x1 = std::min(x0 + 1, sw - 1);
        x0s[x] = x0; x1s[x] = x1; txs[x] = static_cast<float>(sx - x0);
    }
    for (int y = 0; y < dh; ++y) {
        double sy = (y + 0.5) * fy - 0.5;
        if (sy < 0) sy = 0;
        int y0 = static_cast<int>(sy);
        if (y0 > sh - 1) y0 = sh - 1;
        int y1 = std::min(y0 + 1, sh - 1);
        float ty = static_cast<float>(sy - y0);
        const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * c;
        const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * c;
        uint8_t* out = dst + static_cast<size_t>(y) * dw * c;
        for (int x = 0; x < dw; ++x) {
            const int x0 = x0s[x] * c, x1 = x1s[x] * c;
            const float tx = txs[x];
            for (int k = 0; k < c; ++k) {
                float a = r0[x0 + k] * (1 - tx) + r0[x1 + k] * tx;
                float b = r1[x0 + k] * (1 - tx) + r1[x1 + k] * tx;
                float v = a * (1 - ty) + b * ty;
                out[x * c + k] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
    delete[] x0s; delete[] x1s; delete[] txs;
}

// Nearest resize for label maps (cv2 INTER_NEAREST semantics).
void resize_nearest_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
    const double fy = static_cast<double>(sh) / dh;
    const double fx = static_cast<double>(sw) / dw;
    int* xs = new int[dw];
    for (int x = 0; x < dw; ++x)
        xs[x] = std::min(static_cast<int>(x * fx), sw - 1);
    for (int y = 0; y < dh; ++y) {
        int sy = std::min(static_cast<int>(y * fy), sh - 1);
        const uint8_t* row = src + static_cast<size_t>(sy) * sw * c;
        uint8_t* out = dst + static_cast<size_t>(y) * dw * c;
        for (int x = 0; x < dw; ++x)
            std::memcpy(out + static_cast<size_t>(x) * c,
                        row + static_cast<size_t>(xs[x]) * c, c);
    }
    delete[] xs;
}

// Horizontal mirror in place semantics via copy (HWC uint8).
void mirror_u8(const uint8_t* src, int h, int w, int c, uint8_t* dst) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * w * c;
        uint8_t* out = dst + static_cast<size_t>(y) * w * c;
        for (int x = 0; x < w; ++x)
            std::memcpy(out + static_cast<size_t>(x) * c,
                        row + static_cast<size_t>(w - 1 - x) * c, c);
    }
}

// Fused crop + center-pad + /255 + mean/std normalize:
// uint8 HWC -> float32 HWC of shape (ch, cw). Pad value = 0 after
// normalization of a zero pixel is handled by pad_norm flag:
//   pad_norm=0: padded area is exactly 0.0f (reference pads the *image*
//   with 0 before normalize? No — reference normalizes first, then pads
//   with 0 (search/dataloader.py:19-23), so padding is 0 in normalized
//   space. pad_norm=0 reproduces that.)
void crop_pad_normalize(const uint8_t* src, int h, int w, int c,
                        int pos_y, int pos_x, int ch, int cw,
                        const float* mean, const float* stdv,
                        float* dst) {
    const int crop_h = std::min(ch, h - pos_y);
    const int crop_w = std::min(cw, w - pos_x);
    const int pad_top = (ch - crop_h) / 2;
    const int pad_left = (cw - crop_w) / 2;
    std::memset(dst, 0, static_cast<size_t>(ch) * cw * c * sizeof(float));
    for (int y = 0; y < crop_h; ++y) {
        const uint8_t* row =
            src + (static_cast<size_t>(pos_y + y) * w + pos_x) * c;
        float* out =
            dst + (static_cast<size_t>(pad_top + y) * cw + pad_left) * c;
        for (int x = 0; x < crop_w; ++x)
            for (int k = 0; k < c; ++k)
                out[x * c + k] =
                    (row[x * c + k] * (1.0f / 255.0f) - mean[k]) / stdv[k];
    }
}

// Crop + center-pad for label maps with a constant pad value (e.g. 255).
void crop_pad_u8(const uint8_t* src, int h, int w,
                 int pos_y, int pos_x, int ch, int cw, uint8_t pad,
                 uint8_t* dst) {
    const int crop_h = std::min(ch, h - pos_y);
    const int crop_w = std::min(cw, w - pos_x);
    const int pad_top = (ch - crop_h) / 2;
    const int pad_left = (cw - crop_w) / 2;
    std::memset(dst, pad, static_cast<size_t>(ch) * cw);
    for (int y = 0; y < crop_h; ++y)
        std::memcpy(dst + static_cast<size_t>(pad_top + y) * cw + pad_left,
                    src + static_cast<size_t>(pos_y + y) * w + pos_x,
                    crop_w);
}

}  // extern "C"
