// Bilinear resize of one decoded uint8 image, fused with the decode-side
// transform: /255 normalisation (images) or a threshold (masks), to float32
// or, rounded to nearest, to uint8. The same function as the JAX package's
// native runtime, for machines without OpenCV: half-pixel source centres,
// src = (dst + 0.5) * (src_size / dst_size) - 0.5, edges clamped (OpenCV's
// INTER_LINEAR geometry), every product and sum in float32 in the order
// written below. It is built with -ffp-contract=off, so no host compiler
// fuses a multiply-add and the numpy version in native/__init__.py
// (_resize_numpy) gives the same bytes.
//
// Callers parallelise over samples (the pipeline's decode threads), so one
// call is serial.
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// src: [sh, sw, ch] uint8, C-contiguous; dst: [dh, dw, ch] OutT. With
// binarize != 0 an output is 1 where the interpolated value is > thresh,
// else 0; otherwise it is the interpolated value times scale. kRound rounds
// to nearest (floor(o + 0.5)) for the uint8 output.
template <typename OutT, bool kRound>
void resize_one(const uint8_t* src, int sh, int sw, int ch, OutT* dst, int dh,
                int dw, float scale, int binarize, float thresh) {
  const float ry = static_cast<float>(sh) / static_cast<float>(dh);
  const float rx = static_cast<float>(sw) / static_cast<float>(dw);

  // Column coefficients depend only on x: computed once for every row.
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> wxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (static_cast<float>(x) + 0.5f) * rx - 0.5f;
    fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
    x0s[x] = static_cast<int>(fx);
    x1s[x] = std::min(x0s[x] + 1, sw - 1);
    wxs[x] = fx - static_cast<float>(x0s[x]);
  }

  for (int y = 0; y < dh; ++y) {
    float fy = (static_cast<float>(y) + 0.5f) * ry - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - static_cast<float>(y0);
    const float omwy = 1.0f - wy;
    OutT* out_row = dst + static_cast<size_t>(y) * dw * ch;
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * ch;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * ch;
    for (int x = 0; x < dw; ++x) {
      const int x0 = x0s[x] * ch;
      const int x1 = x1s[x] * ch;
      const float wx = wxs[x];
      const float w00 = omwy * (1.0f - wx);
      const float w01 = omwy * wx;
      const float w10 = wy * (1.0f - wx);
      const float w11 = wy * wx;
      for (int c = 0; c < ch; ++c) {
        const float v = w00 * row0[x0 + c] + w01 * row0[x1 + c] +
                        w10 * row1[x0 + c] + w11 * row1[x1 + c];
        const float o = binarize ? (v > thresh ? 1.0f : 0.0f) : v * scale;
        out_row[x * ch + c] =
            kRound ? static_cast<OutT>(o + 0.5f) : static_cast<OutT>(o);
      }
    }
  }
}

}  // namespace

extern "C" void fedcrack_torch_resize_f32(const uint8_t* src, int sh, int sw,
                                          int ch, float* dst, int dh, int dw,
                                          float scale, int binarize,
                                          float thresh) {
  resize_one<float, false>(src, sh, sw, ch, dst, dh, dw, scale, binarize,
                           thresh);
}

extern "C" void fedcrack_torch_resize_u8(const uint8_t* src, int sh, int sw,
                                         int ch, uint8_t* dst, int dh, int dw,
                                         int binarize, float thresh) {
  resize_one<uint8_t, true>(src, sh, sw, ch, dst, dh, dw, 1.0f, binarize,
                            thresh);
}
