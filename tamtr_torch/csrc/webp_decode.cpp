// WebP decoding on the host, for the port's image reader
// (`tamtr_torch/data/image_io.py:decode_webp`), bitwise as libwebp decodes
// with `WebPDecodeBGR` (which cv2.imread calls): the lossy VP8 key frame
// (RFC 6386) and the lossless VP8L image (the WebP lossless bitstream
// specification). The RIFF container is parsed in Python; each entry point
// takes one VP8 or VP8L chunk's payload and writes h x w x 3 BGR bytes.
//
// VP8: the boolean decoder, segments and their quantizers and filter
// levels, the token partitions, DC-only and full inverse WHT and DCT,
// every 16x16, 8x8 and 4x4 intra mode with libwebp's edge samples (127
// above, 129 left), the simple and normal loop filters, then libwebp's
// "fancy" chroma upsampling and its 14-bit fixed-point YUV -> RGB.
// VP8L: the four transforms (predictor, cross-colour, subtract-green,
// colour indexing with pixel packing), the colour cache, meta prefix
// codes, LZ77 backward references with the 2-D distance map.
//
// The probability, quantizer and distance tables are those of RFC 6386
// (sections 13.4, 13.5, 11.5 and 14.1) and of the lossless specification
// (section 5.2.2), in libwebp's order of the 4x4 intra modes.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8l.h"

namespace {

using namespace vp8l;

static const uint8_t kCoeffsProba0[4][8][3][11] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[10][10][9] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// ---------------------------------------------------------------- VP8 lossy

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// 4x4 intra modes in libwebp's order
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

struct BoolReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t value = 0;
  int range = 255;
  int bit_count = 0;
  BoolReader(const uint8_t* s, const uint8_t* e) : p(s), end(e) {
    value = (Next() << 8);
    value |= Next();
  }
  uint32_t Next() { return p < end ? *p++ : 0; }
  int Bit(int prob) {  // RFC 6386 section 7.3
    const int split = 1 + (((range - 1) * prob) >> 8);
    const uint32_t big = static_cast<uint32_t>(split) << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= Next();
      }
    }
    return bit;
  }
  int Value(int bits) {
    int v = 0;
    while (bits-- > 0) v |= Bit(0x80) << bits;
    return v;
  }
  int Signed(int bits) {
    const int v = Value(bits);
    return Bit(0x80) ? -v : v;
  }
};

inline int Clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t Clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }

struct Quant {
  int y1[2], y2[2], uv[2];
};
struct FInfo {
  int limit, ilevel, hev, inner;
};

using Probas = uint8_t[4][8][3][11];

int LargeValue(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.Bit(p[3])) {
    if (!br.Bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.Bit(p[5]);
    }
  } else {
    if (!br.Bit(p[6])) {
      if (!br.Bit(p[7])) {
        v = 5 + br.Bit(159);
      } else {
        v = 7 + 2 * br.Bit(165);
        v += br.Bit(145);
      }
    } else {
      const int bit1 = br.Bit(p[8]);
      const int bit0 = br.Bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.Bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// the coefficients of one 4x4 block from position n, dequantized into
// out (natural order); returns the position after the last non-zero one
int Coeffs(BoolReader& br, const uint8_t (*band)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = band[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.Bit(p[0])) return n;
    while (!br.Bit(p[1])) {
      if (++n == 16) return 16;
      p = band[kBands[n]][0];
    }
    int v;
    if (!br.Bit(p[2])) {
      v = 1;
      p = band[kBands[n + 1]][1];
    } else {
      v = LargeValue(br, p);
      p = band[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = static_cast<int16_t>((br.Bit(0x80) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of `in` added to the 4x4 block at dst (row stride bps)
void TransformOne(const int16_t* in, uint8_t* dst, int bps) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = Mul2(in[4]) - Mul1(in[12]);
    const int d = Mul1(in[4]) + Mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = Mul2(tmp[4]) - Mul1(tmp[12]);
    const int d = Mul1(tmp[4]) + Mul2(tmp[12]);
    dst[0] = Clip8(dst[0] + ((a + d) >> 3));
    dst[1] = Clip8(dst[1] + ((b + c) >> 3));
    dst[2] = Clip8(dst[2] + ((b - c) >> 3));
    dst[3] = Clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += bps;
  }
}

#define AVG3(a, b, c) static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) static_cast<uint8_t>(((a) + (b) + 1) >> 1)

// Intra prediction into a work block: dst points at the block's top-left
// pixel inside a buffer whose row -1 and column -1 hold the edge samples.
void TrueMotion(uint8_t* dst, int bps, int size) {
  const uint8_t* top = dst - bps;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = Clip8(top[x] + l - tl);
    dst += bps;
  }
}

void Pred4(int mode, uint8_t* dst, int bps) {
  const uint8_t* top = dst - bps;
#define DST(x, y) dst[(x) + (y) * bps]
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * bps];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * bps, dc, 4);
      break;
    }
    case B_TM: TrueMotion(dst, bps, 4); break;
    case B_VE: {
      const uint8_t v[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                            AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * bps, v, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - bps], B = dst[-1], C = dst[-1 + bps], D = dst[-1 + 2 * bps], E = dst[-1 + 3 * bps];
      std::memset(dst + 0 * bps, AVG3(A, B, C), 4);
      std::memset(dst + 1 * bps, AVG3(B, C, D), 4);
      std::memset(dst + 2 * bps, AVG3(C, D, E), 4);
      std::memset(dst + 3 * bps, AVG3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps], X = dst[-1 - bps];
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], X = dst[-1 - bps];
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD: {
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps], X = dst[-1 - bps];
      const int A = top[0], B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    case B_HU: {
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
    }
  }
#undef DST
}

// 16x16 (size 16) or 8x8 chroma (size 8) prediction; mode is B_DC, B_TM,
// B_VE or B_HE; the DC mode drops the missing edges at the frame's border
void PredBlock(int mode, uint8_t* dst, int bps, int size, bool has_top, bool has_left) {
  const uint8_t* top = dst - bps;
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc;
      if (has_top && has_left) {
        dc = size;
        for (int i = 0; i < size; ++i) dc += top[i] + dst[-1 + i * bps];
        dc >>= shift + 1;
      } else if (has_left) {
        dc = size >> 1;
        for (int i = 0; i < size; ++i) dc += dst[-1 + i * bps];
        dc >>= shift;
      } else if (has_top) {
        dc = size >> 1;
        for (int i = 0; i < size; ++i) dc += top[i];
        dc >>= shift;
      } else {
        dc = 0x80;
      }
      for (int y = 0; y < size; ++y) std::memset(dst + y * bps, dc, size);
      break;
    }
    case B_TM: TrueMotion(dst, bps, size); break;
    case B_VE:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * bps, top, size);
      break;
    case B_HE:
      for (int y = 0; y < size; ++y) std::memset(dst + y * bps, dst[-1 + y * bps], size);
      break;
  }
}

// ------------------------------------------------------------ loop filters

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020] -> [-128, 127]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112] -> [-16, 15]

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = Clip8(p0 + a2);
  p[0] = Clip8(q0 - a1);
}

inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = Clip8(p1 + a3);
  p[-step] = Clip8(p0 + a2);
  p[0] = Clip8(q0 - a1);
  p[step] = Clip8(q1 - a3);
}

inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = Clip8(p2 + a3);
  p[-2 * step] = Clip8(p1 + a2);
  p[-step] = Clip8(p0 + a1);
  p[0] = Clip8(q0 - a1);
  p[step] = Clip8(q1 - a2);
  p[2 * step] = Clip8(q2 - a3);
}

inline int Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `size` pixels along an edge; hstride crosses the edge, vstride runs along it
void SimpleFilter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (NeedsFilter(p, hstride, thresh2)) DoFilter2(p, hstride);
}

void FilterLoop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh,
                bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!NeedsFilter2(p, hstride, thresh2, ithresh)) continue;
    if (Hev(p, hstride, hev_thresh)) {
      DoFilter2(p, hstride);
    } else if (edge) {
      DoFilter6(p, hstride);
    } else {
      DoFilter4(p, hstride);
    }
  }
}

// ------------------------------------------------------------- YUV -> BGR

inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int YuvClip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void YuvToBgr(int y, int u, int v, uint8_t* bgr) {
  bgr[0] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(u, 33050) - 17685));
  bgr[1] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708));
  bgr[2] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(v, 26149) - 14234));
}

// libwebp's fancy upsampler for one pair of output rows (bottom_y may be null)
void UpsamplePair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                  const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](const uint8_t* u, const uint8_t* v, int x) {
    return static_cast<uint32_t>(u[x]) | (static_cast<uint32_t>(v[x]) << 16);
  };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u, top_v, 0);
  uint32_t l_uv = load(cur_u, cur_v, 0);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    YuvToBgr(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    YuvToBgr(bottom_y[0], uv0 & 0xff, (uv0 >> 16), bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u, top_v, x);
    const uint32_t uv = load(cur_u, cur_v, x);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      YuvToBgr(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, top_dst + (2 * x - 1) * 3);
      YuvToBgr(top_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      YuvToBgr(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, bottom_dst + (2 * x - 1) * 3);
      YuvToBgr(bottom_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      YuvToBgr(top_y[len - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      YuvToBgr(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (len - 1) * 3);
    }
  }
}

struct MBInfo {
  int segment = 0, skip = 0, is_i4x4 = 0;
  uint8_t imodes[16];
  int uvmode = 0;
};

}  // namespace

// One VP8 key frame (the chunk payload) into h x w x 3 BGR. Returns 0, or
// -1 for a frame that is not a key frame or is cut short, -2 for a size that
// disagrees with (w, h).
extern "C" int webp_vp8_decode(const uint8_t* data, long n, int w, int h, uint8_t* bgr) {
  if (n < 10) return -1;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  const uint32_t part0_size = bits >> 5;
  if (!key_frame || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return -1;
  const int width = (data[6] | (data[7] << 8)) & 0x3fff;
  const int height = (data[8] | (data[9] << 8)) & 0x3fff;
  if (width != w || height != h) return -2;
  const uint8_t* p = data + 10;
  const uint8_t* end = data + n;
  if (p + part0_size > end) return -1;
  BoolReader br(p, p + part0_size);
  br.Value(1);  // colour space
  br.Value(1);  // clamping type
  // segment header
  int use_segment = br.Value(1), update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int seg_proba[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.Value(1);
    if (br.Value(1)) {
      absolute_delta = br.Value(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.Value(1) ? br.Signed(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.Value(1) ? br.Signed(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.Value(1) ? br.Value(8) : 255;
  }
  // filter header
  const int simple = br.Value(1);
  const int level = br.Value(6);
  const int sharpness = br.Value(3);
  const int use_lf_delta = br.Value(1);
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.Value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.Value(1)) ref_lf_delta[i] = br.Signed(6);
    for (int i = 0; i < 4; ++i)
      if (br.Value(1)) mode_lf_delta[i] = br.Signed(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // token partitions
  const int num_parts = 1 << br.Value(2);
  const uint8_t* sizes = p + part0_size;
  const uint8_t* part_start = sizes + 3 * (num_parts - 1);
  if (part_start > end) return -1;
  std::vector<BoolReader> parts;
  for (int i = 0; i < num_parts; ++i) {
    const uint8_t* pe = end;
    if (i < num_parts - 1) {
      const long sz = sizes[3 * i] | (sizes[3 * i + 1] << 8) | (sizes[3 * i + 2] << 16);
      pe = part_start + sz > end ? end : part_start + sz;
    }
    parts.emplace_back(part_start, pe);
    part_start = pe;
  }
  // quantizers
  const int base_q0 = br.Value(7);
  const int dqy1_dc = br.Value(1) ? br.Signed(4) : 0;
  const int dqy2_dc = br.Value(1) ? br.Signed(4) : 0;
  const int dqy2_ac = br.Value(1) ? br.Signed(4) : 0;
  const int dquv_dc = br.Value(1) ? br.Signed(4) : 0;
  const int dquv_ac = br.Value(1) ? br.Signed(4) : 0;
  Quant dqm[4];
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      q = base_q0;
    }
    Quant& m = dqm[i];
    m.y1[0] = kDcTable[Clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[Clip(q, 127)];
    m.y2[0] = kDcTable[Clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[Clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[Clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[Clip(q + dquv_ac, 127)];
  }
  br.Value(1);  // refresh entropy probabilities: no later frame reads them
  Probas proba;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int i = 0; i < 11; ++i)
          proba[t][b][c][i] = br.Bit(kCoeffsUpdateProba[t][b][c][i]) ? br.Value(8) : kCoeffsProba0[t][b][c][i];
  const int use_skip_proba = br.Value(1);
  const int skip_p = use_skip_proba ? br.Value(8) : 0;
  // filter strengths per segment and 4x4-ness
  FInfo fstrengths[4][2];
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lev = base_level;
      if (use_lf_delta) {
        lev += ref_lf_delta[0];
        if (i4x4) lev += mode_lf_delta[0];
      }
      lev = lev < 0 ? 0 : lev > 63 ? 63 : lev;
      if (lev > 0) {
        int ilevel = lev;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lev + ilevel;
        info.hev = lev >= 40 ? 2 : lev >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
        info.ilevel = 0;
        info.hev = 0;
      }
      info.inner = i4x4;
    }
  }

  const int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
  // planes with a border of one row above and one column left for the edge
  // samples (127 above the frame, 129 left of it), plus 4 columns right for
  // the top-right samples of the last macroblock
  const int ys = mb_w * 16 + 1 + 4, uvs = mb_w * 8 + 1;
  std::vector<uint8_t> Y((mb_h * 16 + 1) * ys), U((mb_h * 8 + 1) * uvs), V((mb_h * 8 + 1) * uvs);
  uint8_t* y0 = Y.data() + ys + 1;
  uint8_t* u0 = U.data() + uvs + 1;
  uint8_t* v0 = V.data() + uvs + 1;
  std::vector<FInfo> finfo(mb_w * mb_h);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<uint8_t> nz_top(mb_w * 9, 0);  // per column: 4 Y, 2 U, 2 V, Y2
  std::vector<int16_t> coeffs(384);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    uint8_t nz_left[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    BoolReader& tbr = parts[mb_y & (num_parts - 1)];
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBInfo mb;
      // intra modes (first partition)
      if (update_map) mb.segment = !br.Bit(seg_proba[0]) ? br.Bit(seg_proba[1]) : br.Bit(seg_proba[2]) + 2;
      if (use_skip_proba) mb.skip = br.Bit(skip_p);
      mb.is_i4x4 = !br.Bit(145);
      uint8_t* top = &intra_t[4 * mb_x];
      if (!mb.is_i4x4) {
        const int ymode = br.Bit(156) ? (br.Bit(128) ? B_TM : B_HE) : (br.Bit(163) ? B_VE : B_DC);
        mb.imodes[0] = static_cast<uint8_t>(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ymode];
            int i = kYModesIntra4[br.Bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.Bit(prob[i])];
            ymode = -i;
            top[x] = static_cast<uint8_t>(ymode);
            mb.imodes[4 * y + x] = static_cast<uint8_t>(ymode);
          }
          intra_l[y] = static_cast<uint8_t>(ymode);
        }
      }
      mb.uvmode = !br.Bit(142) ? B_DC : !br.Bit(114) ? B_VE : br.Bit(183) ? B_TM : B_HE;

      // residuals (token partition)
      std::fill(coeffs.begin(), coeffs.end(), 0);
      uint8_t* tnz = &nz_top[9 * mb_x];
      bool any_nz = false;
      if (!mb.skip) {
        const Quant& q = dqm[mb.segment];
        int first;
        const uint8_t (*ac)[3][11];
        if (!mb.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = tnz[8] + nz_left[8];
          const int nz = Coeffs(tbr, proba[1], ctx, q.y2, 0, dc);
          tnz[8] = nz_left[8] = nz > 0;
          if (nz > 1) {
            TransformWHT(dc, coeffs.data());
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) coeffs[i] = static_cast<int16_t>(dc0);
          }
          first = 1;
          ac = proba[0];
        } else {
          first = 0;
          ac = proba[3];
        }
        for (int y = 0; y < 4; ++y) {
          for (int x = 0; x < 4; ++x) {
            int16_t* blk = &coeffs[16 * (4 * y + x)];
            const int ctx = tnz[x] + nz_left[y];
            const int nz = Coeffs(tbr, ac, ctx, q.y1, first, blk);
            tnz[x] = nz_left[y] = nz > first;
            for (int k = 0; k < 16; ++k) any_nz |= blk[k] != 0;
          }
        }
        for (int ch = 0; ch < 2; ++ch) {
          for (int y = 0; y < 2; ++y) {
            for (int x = 0; x < 2; ++x) {
              int16_t* blk = &coeffs[256 + 64 * ch + 16 * (2 * y + x)];
              const int ctx = tnz[4 + 2 * ch + x] + nz_left[4 + 2 * ch + y];
              const int nz = Coeffs(tbr, proba[2], ctx, q.uv, 0, blk);
              tnz[4 + 2 * ch + x] = nz_left[4 + 2 * ch + y] = nz > 0;
              for (int k = 0; k < 16; ++k) any_nz |= blk[k] != 0;
            }
          }
        }
      } else {
        for (int k = 0; k < 8; ++k) tnz[k] = nz_left[k] = 0;
        if (!mb.is_i4x4) tnz[8] = nz_left[8] = 0;
      }
      const bool skip = mb.skip || !any_nz;
      if (filter_type > 0) {
        FInfo f = fstrengths[mb.segment][mb.is_i4x4];
        f.inner |= !skip;
        finfo[mb_y * mb_w + mb_x] = f;
      }

      // reconstruction: edge samples, then prediction and residuals
      uint8_t* yd = y0 + mb_y * 16 * ys + mb_x * 16;
      uint8_t* ud = u0 + mb_y * 8 * uvs + mb_x * 8;
      uint8_t* vd = v0 + mb_y * 8 * uvs + mb_x * 8;
      if (mb_x == 0) {
        for (int j = 0; j < 16; ++j) yd[j * ys - 1] = 129;
        for (int j = 0; j < 8; ++j) ud[j * uvs - 1] = vd[j * uvs - 1] = 129;
      }
      if (mb_y == 0) {
        std::memset(yd - ys - 1, 127, 16 + 4 + 1);
        std::memset(ud - uvs - 1, 127, 8 + 1);
        std::memset(vd - uvs - 1, 127, 8 + 1);
      } else if (mb_x == 0) {
        yd[-1 - ys] = ud[-1 - uvs] = vd[-1 - uvs] = 129;
      }
      if (mb.is_i4x4) {
        // the 4 samples above and right of the macroblock, repeated at the
        // right of rows 3, 7 and 11 for the right column's subblocks
        uint8_t tr[4];
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            std::memset(tr, yd[-ys + 15], 4);
          } else {
            std::memcpy(tr, yd - ys + 16, 4);
          }
        } else {
          std::memset(tr, 127, 4);
        }
        // the macroblock's right neighbour is not decoded yet: save and
        // restore what the replicated samples overwrite
        uint8_t saved[3][4];
        for (int r = 0; r < 3; ++r) {
          std::memcpy(saved[r], yd + (4 * r + 3) * ys + 16, 4);
          std::memcpy(yd + (4 * r + 3) * ys + 16, tr, 4);
        }
        std::memcpy(yd - ys + 16, tr, 4);
        for (int k = 0; k < 16; ++k) {
          uint8_t* dst = yd + (k >> 2) * 4 * ys + (k & 3) * 4;
          Pred4(mb.imodes[k], dst, ys);
          TransformOne(&coeffs[16 * k], dst, ys);
        }
        for (int r = 0; r < 3; ++r) std::memcpy(yd + (4 * r + 3) * ys + 16, saved[r], 4);
      } else {
        PredBlock(mb.imodes[0], yd, ys, 16, mb_y > 0, mb_x > 0);
        for (int k = 0; k < 16; ++k) TransformOne(&coeffs[16 * k], yd + (k >> 2) * 4 * ys + (k & 3) * 4, ys);
      }
      PredBlock(mb.uvmode, ud, uvs, 8, mb_y > 0, mb_x > 0);
      PredBlock(mb.uvmode, vd, uvs, 8, mb_y > 0, mb_x > 0);
      for (int k = 0; k < 4; ++k) {
        TransformOne(&coeffs[256 + 16 * k], ud + (k >> 1) * 4 * uvs + (k & 1) * 4, uvs);
        TransformOne(&coeffs[320 + 16 * k], vd + (k >> 1) * 4 * uvs + (k & 1) * 4, uvs);
      }
    }
  }
  if (br.p > br.end) return -1;

  // the loop filter, in macroblock order over the unfiltered frame
  if (filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[mb_y * mb_w + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* yd = y0 + mb_y * 16 * ys + mb_x * 16;
        if (filter_type == 1) {
          if (mb_x > 0) SimpleFilter(yd, 1, ys, 16, limit + 4);
          if (f.inner)
            for (int k = 1; k < 4; ++k) SimpleFilter(yd + 4 * k, 1, ys, 16, limit);
          if (mb_y > 0) SimpleFilter(yd, ys, 1, 16, limit + 4);
          if (f.inner)
            for (int k = 1; k < 4; ++k) SimpleFilter(yd + 4 * k * ys, ys, 1, 16, limit);
        } else {
          uint8_t* ud = u0 + mb_y * 8 * uvs + mb_x * 8;
          uint8_t* vd = v0 + mb_y * 8 * uvs + mb_x * 8;
          const int il = f.ilevel, hev = f.hev;
          if (mb_x > 0) {
            FilterLoop(yd, 1, ys, 16, limit + 4, il, hev, true);
            FilterLoop(ud, 1, uvs, 8, limit + 4, il, hev, true);
            FilterLoop(vd, 1, uvs, 8, limit + 4, il, hev, true);
          }
          if (f.inner) {
            for (int k = 1; k < 4; ++k) FilterLoop(yd + 4 * k, 1, ys, 16, limit, il, hev, false);
            FilterLoop(ud + 4, 1, uvs, 8, limit, il, hev, false);
            FilterLoop(vd + 4, 1, uvs, 8, limit, il, hev, false);
          }
          if (mb_y > 0) {
            FilterLoop(yd, ys, 1, 16, limit + 4, il, hev, true);
            FilterLoop(ud, uvs, 1, 8, limit + 4, il, hev, true);
            FilterLoop(vd, uvs, 1, 8, limit + 4, il, hev, true);
          }
          if (f.inner) {
            for (int k = 1; k < 4; ++k) FilterLoop(yd + 4 * k * ys, ys, 1, 16, limit, il, hev, false);
            FilterLoop(ud + 4 * uvs, uvs, 1, 8, limit, il, hev, false);
            FilterLoop(vd + 4 * uvs, uvs, 1, 8, limit, il, hev, false);
          }
        }
      }
    }
  }

  // fancy upsampling to BGR
  const long out_stride = 3L * w;
  UpsamplePair(y0, nullptr, u0, v0, u0, v0, bgr, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const uint8_t* tu = u0 + (y >> 1) * uvs;
    const uint8_t* tv = v0 + (y >> 1) * uvs;
    UpsamplePair(y0 + (y + 1) * ys, y0 + (y + 2) * ys, tu, tv, tu + uvs, tv + uvs, bgr + (y + 1) * out_stride,
                 bgr + (y + 2) * out_stride, w);
  }
  if (!(h & 1) && h > 1) {
    const uint8_t* cu = u0 + (y >> 1) * uvs;
    const uint8_t* cv = v0 + (y >> 1) * uvs;
    UpsamplePair(y0 + (h - 1) * ys, nullptr, cu, cv, cu, cv, bgr + (h - 1) * out_stride, nullptr, w);
  }
  return 0;
}

// ------------------------------------------------------------ VP8L lossless

namespace {


struct BitReader {  // LSB first
  const uint8_t* p;
  long n;
  long pos = 0;  // in bits
  bool eos = false;
  BitReader(const uint8_t* d, long len) : p(d), n(len) {}
  uint32_t Read(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i, ++pos) {
      const long byte = pos >> 3;
      if (byte >= n) {
        eos = true;
        continue;
      }
      v |= static_cast<uint32_t>((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
};

// a canonical prefix code, decoded one bit at a time (the first bit read is
// the code's most significant); a code of one symbol takes no bits
struct Huffman {
  std::vector<int> count, symbol;
  int single = -1;
  bool Build(const std::vector<int>& lengths) {
    count.assign(16, 0);
    int used = 0, last = -1;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) {
        ++count[lengths[s]];
        ++used;
        last = static_cast<int>(s);
      }
    if (used == 0) return false;
    if (used == 1) {
      single = last;
      return true;
    }
    std::vector<int> offs(16, 0);
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    symbol.assign(used, 0);
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) symbol[offs[lengths[s]]++] = static_cast<int>(s);
    // a complete code only
    long left = 1;
    for (int l = 1; l < 16; ++l) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;
    }
    return left == 0;
  }
  int Read(BitReader& br) const {
    if (single >= 0) return single;
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= static_cast<int>(br.Read(1));
      const int c = count[len];
      if (code - c < first) return symbol[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }
};

bool ReadCode(BitReader& br, int alphabet, Huffman& h) {
  std::vector<int> lengths(alphabet, 0);
  if (br.Read(1)) {  // simple code: one or two symbols
    const int num = br.Read(1) + 1;
    const int first_bits = br.Read(1) ? 8 : 1;
    const int s0 = br.Read(first_bits);
    if (s0 >= alphabet) return false;
    lengths[s0] = 1;
    if (num == 2) {
      const int s1 = br.Read(8);
      if (s1 >= alphabet) return false;
      lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl_lengths(19, 0);
    const int num_codes = br.Read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.Read(3);
    Huffman cl;
    if (!cl.Build(cl_lengths)) return false;
    int max_symbol;
    if (br.Read(1)) {
      const int length_nbits = 2 + 2 * br.Read(3);
      max_symbol = 2 + br.Read(length_nbits);
      if (max_symbol > alphabet) return false;
    } else {
      max_symbol = alphabet;
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int code = cl.Read(br);
      if (code < 0) return false;
      if (code < 16) {
        lengths[symbol++] = code;
        if (code) prev = code;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = code - 16;
        const int repeat = br.Read(kExtra[slot]) + kOffset[slot];
        if (symbol + repeat > alphabet) return false;
        const int len = code == 16 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[symbol++] = len;
      }
    }
  }
  return h.Build(lengths) && !br.eos;
}

inline int CopyDistance(int sym, BitReader& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + br.Read(extra) + 1;
}

inline int PlaneToDistance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

struct Group {
  Huffman h[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

bool DecodeStream(BitReader& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out);

// the entropy-coded pixels of one image (level 0 may carry meta codes)
bool DecodePixels(BitReader& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
  int cache_bits = 0;
  if (br.Read(1)) {
    cache_bits = br.Read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  int huff_bits = 0;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  int meta_w = 0;
  if (level0 && br.Read(1)) {
    huff_bits = br.Read(3) + 2;
    meta_w = (xsize + (1 << huff_bits) - 1) >> huff_bits;
    const int meta_h = (ysize + (1 << huff_bits) - 1) >> huff_bits;
    if (!DecodeStream(br, meta_w, meta_h, false, meta)) return false;
    for (auto& m : meta) {
      m = (m >> 8) & 0xffff;
      if (static_cast<int>(m) + 1 > num_groups) num_groups = m + 1;
    }
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<Group> groups(num_groups);
  for (auto& g : groups) {
    const int sizes[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    for (int i = 0; i < 5; ++i)
      if (!ReadCode(br, sizes[i], g.h[i])) return false;
  }
  std::vector<uint32_t> cache(cache_size, 0);
  const long total = static_cast<long>(xsize) * ysize;
  out.assign(total, 0);
  long pos = 0, cached = 0;
  auto group_at = [&](long p) -> const Group& {
    if (!huff_bits) return groups[0];
    const int x = static_cast<int>(p % xsize), y = static_cast<int>(p / xsize);
    return groups[meta[(y >> huff_bits) * meta_w + (x >> huff_bits)]];
  };
  auto insert_cache = [&]() {
    if (!cache_size) return;
    for (; cached < pos; ++cached) {
      const uint32_t argb = out[cached];
      cache[(argb * 0x1e35a7bdu) >> (32 - cache_bits)] = argb;
    }
  };
  while (pos < total) {
    const Group& g = group_at(pos);
    const int code = g.h[0].Read(br);
    if (code < 0 || br.eos) return false;
    if (code < 256) {
      const uint32_t red = g.h[1].Read(br), blue = g.h[2].Read(br), alpha = g.h[3].Read(br);
      out[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
    } else if (code < 256 + 24) {
      const int length = CopyDistance(code - 256, br);
      const int dist_sym = g.h[4].Read(br);
      if (dist_sym < 0) return false;
      const long dist = PlaneToDistance(xsize, CopyDistance(dist_sym, br));
      if (dist > pos || pos + length > total) return false;
      for (int i = 0; i < length; ++i, ++pos) out[pos] = out[pos - dist];
    } else {
      const int key = code - 280;
      if (key >= cache_size) return false;
      insert_cache();
      out[pos++] = cache[key];
    }
    insert_cache();
  }
  return !br.eos;
}

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

bool DecodeStream(BitReader& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
  std::vector<Transform> transforms;
  int tx = xsize;
  if (level0) {
    int seen = 0;
    while (br.Read(1)) {
      Transform t;
      t.type = br.Read(2);
      if (seen & (1 << t.type)) return false;
      seen |= 1 << t.type;
      t.xsize = tx;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = br.Read(3) + 2;
        const int bw = (tx + (1 << t.bits) - 1) >> t.bits, bh = (ysize + (1 << t.bits) - 1) >> t.bits;
        if (!DecodeStream(br, bw, bh, false, t.data)) return false;
      } else if (t.type == 3) {
        const int num_colors = br.Read(8) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        std::vector<uint32_t> pal;
        if (!DecodeStream(br, num_colors, 1, false, pal)) return false;
        t.data.assign(256, 0);  // indices past the palette read 0
        t.data[0] = pal[0];
        for (int i = 1; i < num_colors; ++i) t.data[i] = AddPixels(pal[i], t.data[i - 1]);
        tx = (tx + (1 << t.bits) - 1) >> t.bits;
      }
      transforms.push_back(std::move(t));
    }
  }
  std::vector<uint32_t> px;
  if (!DecodePixels(br, tx, ysize, level0, px)) return false;
  // the inverse transforms, last read first
  for (int k = static_cast<int>(transforms.size()) - 1; k >= 0; --k) {
    const Transform& t = transforms[k];
    const int w = t.xsize;
    if (t.type == 2) {  // subtract green
      for (auto& p : px) {
        const uint32_t g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
    } else if (t.type == 0) {  // predictor
      const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
      std::vector<uint32_t> res(px.size());
      for (int y = 0; y < ysize; ++y) {
        const uint32_t* in = &px[static_cast<long>(y) * w];
        uint32_t* cur = &res[static_cast<long>(y) * w];
        const uint32_t* top = cur - w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : cur[x - 1];
          } else if (x == 0) {
            pred = top[0];
          } else {
            const int mode = (t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf;
            pred = Predict(mode, cur, x, top);
          }
          cur[x] = AddPixels(in[x], pred);
        }
      }
      px.swap(res);
    } else if (t.type == 1) {  // cross colour
      const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
      for (int y = 0; y < ysize; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff),
                       r2b = static_cast<int8_t>((m >> 16) & 0xff);
          uint32_t& p = px[static_cast<long>(y) * w + x];
          const int8_t green = static_cast<int8_t>(p >> 8);
          int red = (p >> 16) & 0xff, blue = p & 0xff;
          red += (static_cast<int>(g2r) * green) >> 5;
          red &= 0xff;
          blue += (static_cast<int>(g2b) * green) >> 5;
          blue += (static_cast<int>(r2b) * static_cast<int8_t>(red)) >> 5;
          blue &= 0xff;
          p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
        }
      }
    } else {  // colour indexing, pixels packed 1 << bits to a byte
      const int packed_w = (w + (1 << t.bits) - 1) >> t.bits;
      const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
      std::vector<uint32_t> res(static_cast<long>(w) * ysize);
      for (int y = 0; y < ysize; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t g = (px[static_cast<long>(y) * packed_w + x / per] >> 8) & 0xff;
          res[static_cast<long>(y) * w + x] = t.data[(g >> ((x % per) * bpp)) & mask];
        }
      px.swap(res);
    }
  }
  out.swap(px);
  return true;
}

}  // namespace

// One VP8L image (the chunk payload) into h x w x 3 BGR. Returns 0, -1 for
// a corrupt stream, -2 for a size that disagrees with (w, h).
extern "C" int webp_vp8l_decode(const uint8_t* data, long n, int w, int h, uint8_t* bgr) {
  if (n < 5 || data[0] != 0x2f) return -1;
  BitReader br(data + 1, n - 1);
  const int width = br.Read(14) + 1, height = br.Read(14) + 1;
  br.Read(1);  // alpha is used
  if (br.Read(3) != 0) return -1;
  if (width != w || height != h) return -2;
  std::vector<uint32_t> px;
  if (!DecodeStream(br, width, height, true, px)) return -1;
  for (long i = 0; i < static_cast<long>(w) * h; ++i) {
    bgr[3 * i] = px[i] & 0xff;
    bgr[3 * i + 1] = (px[i] >> 8) & 0xff;
    bgr[3 * i + 2] = (px[i] >> 16) & 0xff;
  }
  return 0;
}
