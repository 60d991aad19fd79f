// MPEG-4 Part 2 video decoding on the host, for the port's video reader
// (`tamtr_torch/data/video_io.py:VideoReader`), bitwise as FFmpeg's
// `mpeg4` decoder (which cv2.VideoCapture runs) decodes the streams
// FFmpeg's own encoder writes: Simple-profile I- and P-VOPs.
//
// Headers: visual object sequence, visual object, video object layer (in
// the stream or in the container's decoder configuration), user data (the
// encoder's name), group of VOPs, VOP. Macroblocks: intra with DC
// prediction and, where the macroblock asks, AC prediction (rescaled
// across quantizers as FFmpeg does); inter with one motion vector, its
// median prediction, half-pel compensation with the VOP's rounding type
// over edges replicated past the macroblock-aligned picture (unrestricted
// vectors, FFmpeg's h_edge_pos and v_edge_pos); skipped
// macroblocks; dquant; TCOEF escapes 1 to 3; H.263 inverse quantisation;
// FFmpeg's simple IDCT. A width or height that is not a multiple of 16
// decodes whole macroblocks and is cropped.
//
// What FFmpeg's encoder does not write is refused with a message naming
// it (return -2): B- and S-VOPs, not-coded VOPs, interlace, quarter-pel,
// four motion vectors, MPEG quantisation, data partitioning, reversible
// VLCs, resync markers, shapes other than rectangular, sprites, newpred,
// reduced resolution, scalability, complexity estimation, an intra DC
// threshold, more than 8 bits, and streams of XviD or DivX encoders (FFmpeg
// switches to other IDCTs or bug workarounds for them).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "mpeg4.h"

namespace {

using mpeg4::Decoder;
using mpeg4::Frame;
using mpeg4::YuvToBgr;

void Message(char* msg, int len, const std::string& s) {
  if (msg && len > 0) std::snprintf(msg, static_cast<size_t>(len), "%s", s.c_str());
}

}  // namespace

extern "C" void* mpeg4_dec_new(uint32_t fourcc) { return new Decoder(fourcc); }

extern "C" void mpeg4_dec_free(void* h) { delete static_cast<Decoder*>(h); }

// decode one packet (or a container's decoder configuration): 1 = a frame
// was decoded, 0 = headers only, -1 = corrupt data, -2 = a tool the
// decoder refuses (msg says which)
extern "C" int mpeg4_dec_decode(void* h, const uint8_t* data, long n, char* msg, int msglen) {
  Decoder* dec = static_cast<Decoder*>(h);
  try {
    return dec->Decode(data, n);
  } catch (const mpeg4::Unsupported& e) {
    Message(msg, msglen, e.what);
    return -2;
  } catch (const mpeg4::Corrupt& e) {
    Message(msg, msglen, e.what);
    return -1;
  }
}

// width and height of the video object layer (0 before one was read)
extern "C" void mpeg4_dec_size(void* h, int* wh) {
  const Decoder* dec = static_cast<Decoder*>(h);
  wh[0] = dec->width;
  wh[1] = dec->height;
}

// the last decoded frame: BGR (h x w x 3), and each plane cropped where
// the pointer is not null (luma h x w, chroma (h + 1) / 2 x (w + 1) / 2)
extern "C" int mpeg4_dec_output(void* h, uint8_t* bgr, uint8_t* y, uint8_t* u, uint8_t* v) {
  const Decoder* dec = static_cast<Decoder*>(h);
  if (!dec->have_frame) return -1;
  const Frame& f = dec->ref;
  const int w = dec->width, hh = dec->height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  if (bgr) {
    static const YuvToBgr conv;
    conv.Convert(f.y.data(), f.w, f.u.data(), f.v.data(), f.w / 2, w, hh, bgr);
  }
  for (int j = 0; y && j < hh; ++j) std::memcpy(y + static_cast<long>(j) * w, f.y.data() + static_cast<long>(j) * f.w, w);
  for (int j = 0; u && j < ch; ++j) std::memcpy(u + static_cast<long>(j) * cw, f.u.data() + static_cast<long>(j) * (f.w / 2), cw);
  for (int j = 0; v && j < ch; ++j) std::memcpy(v + static_cast<long>(j) * cw, f.v.data() + static_cast<long>(j) * (f.w / 2), cw);
  return 0;
}

// the stream's counters (see Stat): VOPs, macroblock kinds and tools used
extern "C" int mpeg4_dec_stats(void* h, long* out, int n) {
  const Decoder* dec = static_cast<Decoder*>(h);
  for (int i = 0; i < n && i < mpeg4::kStatCount; ++i) out[i] = dec->stats[i];
  return mpeg4::kStatCount;
}
