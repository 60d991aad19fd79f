// The VP8L pieces both sides of the port's lossless WebP codec use
// (`webp_decode.cpp`, `webp_encode.cpp`): the lossless specification's
// tables (the code-length code order, section 3.7.2.1.2; the 2-D distance
// map, section 4.2.2) and the pixel arithmetic of its transforms
// (section 4.1: the 14 predictors, per-channel addition and subtraction
// mod 256).
#pragma once

#include <cstdint>
#include <cstdlib>

namespace vp8l {

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
  37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
  87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
  102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
  100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
  79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

inline uint32_t Average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) | (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t SubPixels(uint32_t a, uint32_t b) {
  return (((a | 0x00ff00ffu) - (b & 0xff00ff00u)) & 0xff00ff00u) | (((a | 0xff00ff00u) - (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline int Clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline int Sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  const int d = Sub3(a >> 24, b >> 24, c >> 24) + Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + Sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t AddSubFull(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(Clip255(static_cast<int>((a >> s) & 0xff) + static_cast<int>((b >> s) & 0xff) -
                                         static_cast<int>((c >> s) & 0xff))) << s;
  return out;
}
inline uint32_t AddSubHalf(uint32_t ave, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c >> s) & 0xff;
    out |= static_cast<uint32_t>(Clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

// predictor `mode` at x > 0 of a row y > 0 (`top` the row above `cur`)
inline uint32_t Predict(int mode, const uint32_t* cur, long x, const uint32_t* top) {
  const uint32_t L = cur[x - 1], T = top[x], TR = top[x + 1], TL = top[x - 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return Average2(Average2(L, TR), T);
    case 6: return Average2(L, TL);
    case 7: return Average2(L, T);
    case 8: return Average2(TL, T);
    case 9: return Average2(T, TR);
    case 10: return Average2(Average2(L, TL), Average2(T, TR));
    case 11: return Select(T, L, TL);
    case 12: return AddSubFull(L, T, TL);
    case 13: return AddSubHalf(Average2(L, T), TL);
    default: return 0xff000000u;
  }
}

}  // namespace vp8l
