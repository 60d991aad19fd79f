"""Video files for the port's predict and track sources and its annotated
output (the reading and writing halves of `cv2.VideoCapture` and
`cv2.VideoWriter` as the JAX package uses them, `tamtr_tpu/data/loaders.py`
and `tamtr_tpu/engine/results.py:AnnotatedVideoWriter`).

Reading: `VideoReader(path)` demuxes ISO BMFF (`.mp4`, `.m4v`, `.mov`:
`moov/trak/mdia/minf/stbl` with `stsd`, `stts`, `stsc`, `stsz`,
`stco`/`co64`) and RIFF AVI (`.avi`: `hdrl/strl` and the `movi` chunks, in
`idx1`'s order where there is one) and decodes

- MPEG-4 Part 2 (`mp4v` with its `esds` decoder configuration; `XVID`,
  `DIVX`, `FMP4`, `DX50`, `MP4V` in AVI) with `csrc/mpeg4_decode.cpp`:
  bitwise FFmpeg's `mpeg4` decoder on the Simple-profile I/P streams
  FFmpeg's encoder writes, then YUV 4:2:0 to BGR bitwise as cv2's FFmpeg
  backend converts a frame of even height (swscale's x86 converter);
- Motion JPEG (`MJPG` in AVI, `jpeg` in MOV) with `image_io.decode_jpeg`:
  bitwise `cv2.imdecode` of each packet (FFmpeg's own MJPEG decoder, which
  `cv2.VideoCapture` runs, differs from that by its IDCT and chroma
  upsampling).

`fps` is what cv2 reports as `CAP_PROP_FPS` (the stream's average frame
rate: `stts` for ISO BMFF, `dwRate / dwScale` for AVI), 30.0 where the file
gives none, as the JAX engine falls back. Other containers (Matroska, WebM,
WMV, MPEG-PS), other codecs (H.264, HEVC, ...) and the MPEG-4 tools
FFmpeg's encoder does not write raise NotImplementedError naming the file
and what is missing.

Writing: `VideoWriter(path, fps, (w, h))` encodes BGR frames as MPEG-4 Part
2 (`csrc/mpeg4_encode.cpp`: an I-VOP every 12 frames, P-VOPs between,
half-pel motion search, AC prediction and a quantizer moved by
macroblock) into an ISO BMFF file with an `mp4v` sample entry, which
`cv2.VideoCapture` and `VideoReader` read. An odd last column or row is
dropped, as cv2.VideoWriter drops it.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MPEG4_AVI_TAGS = {b"XVID", b"xvid", b"DIVX", b"divx", b"DX50", b"dx50", b"FMP4", b"fmp4", b"MP4V", b"mp4v",
                  b"M4S2", b"m4s2"}
MJPEG_AVI_TAGS = {b"MJPG", b"mjpg", b"AVRn", b"jpeg", b"JPEG"}
ISO_SUFFIXES = {".mp4", ".m4v", ".mov"}
READ_SUFFIXES = ISO_SUFFIXES | {".avi"}  # the containers VideoReader demuxes
GOP = 12  # FFmpeg's default keyframe interval, as cv2's writer leaves it
QUALITY = 3  # the VOPs' quantizer: what FFmpeg's rate control settles on for cv2's writer on small frames


class UnsupportedVideo(NotImplementedError):
    """A container, codec or coding tool the port's video reader lacks."""


# ------------------------------------------------------------ ISO BMFF

def _boxes(data: bytes, start: int, end: int, name: str) -> Iterator[Tuple[bytes, int, int]]:
    """(type, payload start, payload end) of each box in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"{name}: box {kind!r} runs past its parent")
        yield kind, pos + head, pos + size
        pos += size


def _child(data: bytes, start: int, end: int, kind: bytes, name: str) -> Optional[Tuple[int, int]]:
    for k, s, e in _boxes(data, start, end, name):
        if k == kind:
            return s, e
    return None


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, payload start, payload end) of an MPEG-4 systems descriptor."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def _esds_config(data: bytes, start: int, end: int, name: str) -> Tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an `esds` box."""
    tag, s, e = _descriptor(data, start + 4)  # past version and flags
    if tag != 0x03:
        raise ValueError(f"{name}: esds without an ES descriptor")
    flags = data[s + 2]
    p = s + 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + data[p]
    if flags & 0x20:
        p += 2
    while p < e:
        tag, ds, de = _descriptor(data, p)
        if tag == 0x04:
            oti = data[ds]
            q = ds + 13
            while q < de:
                t2, s2, e2 = _descriptor(data, q)
                if t2 == 0x05:
                    return oti, bytes(data[s2:e2])
                q = e2
            return oti, b""
        p = de
    raise ValueError(f"{name}: esds without a decoder configuration")


def _parse_iso(data: bytes, name: str) -> Dict:
    moov = _child(data, 0, len(data), b"moov", name)
    if moov is None:
        raise ValueError(f"{name}: no moov box")
    for kind, ts, te in _boxes(data, *moov, name):
        if kind != b"trak":
            continue
        mdia = _child(data, ts, te, b"mdia", name)
        if mdia is None:
            continue
        hdlr = _child(data, *mdia, b"hdlr", name)
        if hdlr is None or data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        mdhd = _child(data, *mdia, b"mdhd", name)
        version = data[mdhd[0]]
        timescale = struct.unpack(">I", data[mdhd[0] + (20 if version == 1 else 12):][:4])[0]
        minf = _child(data, *mdia, b"minf", name)
        stbl = _child(data, *minf, b"stbl", name) if minf else None
        if stbl is None:
            raise ValueError(f"{name}: video track without a sample table")
        return _parse_stbl(data, stbl, timescale, name)
    raise UnsupportedVideo(f"{name}: no video track")


def _parse_stbl(data: bytes, stbl: Tuple[int, int], timescale: int, name: str) -> Dict:
    box = {k: (s, e) for k, s, e in _boxes(data, *stbl, name)}
    for need in (b"stsd", b"stsz", b"stsc"):
        if need not in box:
            raise ValueError(f"{name}: sample table without {need.decode()}")
    s, _ = box[b"stsd"]
    entry = next(_boxes(data, s + 8, box[b"stsd"][1], name))
    fmt, es, ee = entry
    w, h = struct.unpack(">HH", data[es + 24:es + 28])
    extradata = b""
    if fmt == b"mp4v":
        esds = _child(data, es + 78, ee, b"esds", name)
        if esds is None:
            raise ValueError(f"{name}: mp4v sample entry without esds")
        oti, extradata = _esds_config(data, *esds, name)
        if oti == 0x20:
            codec = "mpeg4"
        elif oti in (0x6C, 0x6D):
            codec, extradata = "mjpeg", b""
        else:
            raise UnsupportedVideo(f"{name}: mp4v stream of object type 0x{oti:02x}, not MPEG-4 Part 2 video")
    elif fmt in (b"jpeg", b"mjpa"):
        codec = "mjpeg"
    else:
        raise UnsupportedVideo(f"{name}: video codec {fmt.decode('latin-1')!r} is not decoded (MPEG-4 Part 2 and "
                               f"Motion JPEG are)")
    # sample sizes
    s, _ = box[b"stsz"]
    fixed, count = struct.unpack(">II", data[s + 4:s + 12])
    sizes = [fixed] * count if fixed else list(struct.unpack(f">{count}I", data[s + 12:s + 12 + 4 * count]))
    # chunk offsets
    if b"stco" in box:
        s, _ = box[b"stco"]
        n = struct.unpack(">I", data[s + 4:s + 8])[0]
        chunks = list(struct.unpack(f">{n}I", data[s + 8:s + 8 + 4 * n]))
    elif b"co64" in box:
        s, _ = box[b"co64"]
        n = struct.unpack(">I", data[s + 4:s + 8])[0]
        chunks = list(struct.unpack(f">{n}Q", data[s + 8:s + 8 + 8 * n]))
    else:
        raise ValueError(f"{name}: sample table without chunk offsets")
    s, _ = box[b"stsc"]
    n = struct.unpack(">I", data[s + 4:s + 8])[0]
    runs = [struct.unpack(">III", data[s + 8 + 12 * i:s + 20 + 12 * i]) for i in range(n)]
    offsets: List[int] = []
    k = 0
    for i, (first, per, _desc) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else len(chunks)
        for c in range(first - 1, last):
            off = chunks[c]
            for _ in range(per):
                if k >= count:
                    break
                offsets.append(off)
                off += sizes[k]
                k += 1
    if len(offsets) != count:
        raise ValueError(f"{name}: sample-to-chunk table covers {len(offsets)} of {count} samples")
    # frame rate: FFmpeg's average rate from the time-to-sample table
    fps = 0.0
    if b"stts" in box and timescale:
        s, _ = box[b"stts"]
        n = struct.unpack(">I", data[s + 4:s + 8])[0]
        entries = [struct.unpack(">II", data[s + 8 + 8 * i:s + 16 + 8 * i]) for i in range(n)]
        if len(entries) == 1 or (len(entries) == 2 and entries[1][0] == 1):
            fps = timescale / entries[0][1] if entries[0][1] else 0.0
        else:
            duration = sum(c * d for c, d in entries)
            fps = count * timescale / duration if duration else 0.0
    return {"codec": codec, "fourcc": fmt, "extradata": extradata, "packets": list(zip(offsets, sizes)),
            "fps": fps, "size": (w, h)}


# ------------------------------------------------------------ RIFF AVI

def _riff_chunks(data: bytes, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    pos = start
    while pos + 8 <= end:
        kind, size = struct.unpack("<4sI", data[pos:pos + 8])
        yield kind, pos + 8, min(pos + 8 + size, end)
        pos += 8 + size + (size & 1)


def _parse_avi(data: bytes, name: str) -> Dict:
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{name}: not a RIFF AVI file")
    stream = None
    movi: List[Tuple[int, int]] = []
    idx1 = None
    top = list(_riff_chunks(data, 12, struct.unpack("<I", data[4:8])[0] + 8))
    # OpenDML files continue in further RIFF 'AVIX' lists after the first
    pos = struct.unpack("<I", data[4:8])[0] + 8
    while pos + 12 <= len(data) and data[pos:pos + 4] == b"RIFF" and data[pos + 8:pos + 12] == b"AVIX":
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        top += list(_riff_chunks(data, pos + 12, min(pos + 8 + size, len(data))))
        pos += 8 + size + (size & 1)
    for kind, s, e in top:
        if kind == b"LIST" and data[s:s + 4] == b"hdrl":
            index = 0
            for k2, s2, e2 in _riff_chunks(data, s + 4, e):
                if k2 != b"LIST" or data[s2:s2 + 4] != b"strl":
                    continue
                strl = {k3: (s3, e3) for k3, s3, e3 in _riff_chunks(data, s2 + 4, e2)}
                if b"strh" in strl and data[strl[b"strh"][0]:strl[b"strh"][0] + 4] == b"vids" and stream is None:
                    hs = strl[b"strh"][0]
                    scale, rate = struct.unpack("<II", data[hs + 20:hs + 28])
                    fs, fe = strl[b"strf"]
                    w, h = struct.unpack("<ii", data[fs + 4:fs + 12])
                    tag = data[fs + 16:fs + 20]
                    stream = {"index": index, "scale": scale, "rate": rate, "size": (w, abs(h)), "tag": tag,
                              "extradata": bytes(data[fs + 40:fe]) if fe - fs > 40 else b""}
                index += 1
        elif kind == b"LIST" and data[s:s + 4] == b"movi":
            movi.append((s, e))
        elif kind == b"idx1":
            idx1 = (s, e)
    if stream is None:
        raise UnsupportedVideo(f"{name}: no video stream")
    tag = stream["tag"]
    if tag in MPEG4_AVI_TAGS:
        codec = "mpeg4"
    elif tag in MJPEG_AVI_TAGS:
        codec = "mjpeg"
    else:
        raise UnsupportedVideo(f"{name}: video codec {tag.decode('latin-1')!r} is not decoded (MPEG-4 Part 2 and "
                               f"Motion JPEG are)")
    ids = {b"%02ddc" % stream["index"], b"%02ddb" % stream["index"]}
    packets: List[Tuple[int, int]] = []
    if idx1 is not None and movi:
        entries = [struct.unpack("<4sIII", data[p:p + 16]) for p in range(idx1[0], idx1[1] - 15, 16)]
        video = [(off, size) for ck, _flags, off, size in entries if ck in ids]
        if video:
            # offsets count from the 'movi' fourcc, or from the file's start
            base = movi[0][0] if data[movi[0][0] + video[0][0]:][:4] in ids else 0
            packets = [(base + off + 8, size) for off, size in video]
    if not packets:
        def walk(s: int, e: int) -> None:
            for k, cs, ce in _riff_chunks(data, s, e):
                if k == b"LIST" and data[cs:cs + 4] == b"rec ":
                    walk(cs + 4, ce)
                elif k in ids:
                    packets.append((cs, ce - cs))
        for s, e in movi:
            walk(s + 4, e)
    packets = [(o, n) for o, n in packets if n > 0]
    fps = stream["rate"] / stream["scale"] if stream["scale"] and stream["rate"] else 0.0
    return {"codec": codec, "fourcc": tag, "extradata": stream["extradata"], "packets": packets, "fps": fps,
            "size": stream["size"]}


# ------------------------------------------------------------ decoding

def _mpeg4_lib() -> ctypes.CDLL:
    from tamtr_torch.kernels import _build

    lib = _build.load("mpeg4_decode")
    lib.mpeg4_dec_new.restype = ctypes.c_void_p
    lib.mpeg4_dec_new.argtypes = [ctypes.c_uint32]
    lib.mpeg4_dec_free.argtypes = [ctypes.c_void_p]
    lib.mpeg4_dec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
    lib.mpeg4_dec_decode.restype = ctypes.c_int
    lib.mpeg4_dec_size.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mpeg4_dec_output.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.mpeg4_dec_output.restype = ctypes.c_int
    lib.mpeg4_dec_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.mpeg4_dec_stats.restype = ctypes.c_int
    return lib


MPEG4_STATS = ("i_vops", "p_vops", "intra_mbs", "intra_mbs_in_p", "inter_mbs", "skipped_mbs", "ac_pred",
               "dquant", "escape1", "escape2", "escape3", "half_pel", "mv_outside", "rounding1",
               "not_coded_blocks", "ac_rescaled")


class Mpeg4Decoder:
    """One MPEG-4 Part 2 stream's decoder state (`csrc/mpeg4_decode.cpp`)."""

    def __init__(self, fourcc: bytes = b"mp4v", name: str = "<stream>"):
        self.name = name
        self._lib = _mpeg4_lib()
        tag = struct.unpack("<I", (fourcc + b"    ")[:4])[0]
        self._h = self._lib.mpeg4_dec_new(tag)
        self._msg = ctypes.create_string_buffer(256)

    def decode(self, packet: bytes) -> bool:
        """Feed one packet (or a decoder configuration); True if it held a frame."""
        rc = self._lib.mpeg4_dec_decode(self._h, packet, len(packet), self._msg, len(self._msg))
        if rc == -2:
            raise UnsupportedVideo(f"{self.name}: MPEG-4 Part 2 {self._msg.value.decode()} is not decoded")
        if rc < 0:
            raise ValueError(f"{self.name}: corrupt MPEG-4 Part 2 stream ({self._msg.value.decode()})")
        return rc == 1

    @property
    def size(self) -> Tuple[int, int]:
        wh = (ctypes.c_int * 2)()
        self._lib.mpeg4_dec_size(self._h, wh)
        return wh[0], wh[1]

    def bgr(self) -> np.ndarray:
        w, h = self.size
        out = np.empty((h, w, 3), np.uint8)
        self._lib.mpeg4_dec_output(self._h, out.ctypes.data, None, None, None)
        return out

    def planes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last frame's Y, U and V planes, cropped to the picture."""
        w, h = self.size
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.mpeg4_dec_output(self._h, None, y.ctypes.data, u.ctypes.data, v.ctypes.data)
        return y, u, v

    def stats(self) -> Dict[str, int]:
        """How often the stream used each tool (see MPEG4_STATS)."""
        out = (ctypes.c_long * len(MPEG4_STATS))()
        self._lib.mpeg4_dec_stats(self._h, out, len(MPEG4_STATS))
        return dict(zip(MPEG4_STATS, out))

    def close(self) -> None:
        if self._h:
            self._lib.mpeg4_dec_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


class VideoReader:
    """Frames of an MP4 / MOV / M4V / AVI file as BGR uint8 arrays.

    `fps`, `frame_count`, `size` ((w, h)), `codec` ("mpeg4" or "mjpeg");
    iterating yields each frame in order; `packets()` the stream's coded
    packets as the container stores them; `close()` releases the file."""

    def __init__(self, path):
        self.path = Path(path)
        name = str(path)
        suffix = self.path.suffix.lower()
        if suffix not in READ_SUFFIXES:
            raise UnsupportedVideo(f"{name}: the {suffix or 'suffixless'} container is not read (MP4, MOV, M4V and "
                                   f"AVI are)")
        with open(self.path, "rb") as f:  # mapped, not read: a video may be larger than memory
            if os.fstat(f.fileno()).st_size == 0:
                raise ValueError(f"{name}: empty file")
            self._data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        info = _parse_avi(self._data, name) if suffix == ".avi" else _parse_iso(self._data, name)
        self.codec: str = info["codec"]
        self.fourcc: bytes = info["fourcc"]
        self.extradata: bytes = info["extradata"]
        self._packets: List[Tuple[int, int]] = info["packets"]
        self.fps: float = float(info["fps"]) if info["fps"] and info["fps"] > 0 else 30.0
        self.frame_count: int = len(self._packets)
        self.size: Tuple[int, int] = tuple(info["size"])
        self._decoder: Optional[Mpeg4Decoder] = None

    def packets(self) -> Iterator[bytes]:
        for off, n in self._packets:
            yield bytes(self._data[off:off + n])

    def decoder(self) -> Mpeg4Decoder:
        """A fresh MPEG-4 decoder primed with the container's configuration."""
        dec = Mpeg4Decoder(self.fourcc, str(self.path))
        if self.extradata:
            dec.decode(self.extradata)
        return dec

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.codec == "mjpeg":
            from tamtr_torch.data.image_io import decode_jpeg

            for i, pkt in enumerate(self.packets()):
                if _jpeg_fields(pkt) > 1:
                    raise UnsupportedVideo(f"{self.path}: interlaced (two-field) Motion JPEG is not decoded")
                yield decode_jpeg(pkt, f"{self.path}#{i}")
            return
        self._decoder = dec = self.decoder()
        for pkt in self.packets():
            if dec.decode(pkt):
                yield dec.bgr()

    def close(self) -> None:
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None
        if self._data is not None:
            self._data.close()
            self._data = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jpeg_fields(pkt: bytes) -> int:
    """The number of JPEG images (SOI markers at image starts) in a packet:
    2 for an interlaced Motion-JPEG frame stored as two fields."""
    n, pos = 0, 0
    while True:
        pos = pkt.find(b"\xff\xd8\xff", pos)
        if pos < 0:
            return n
        n += 1
        end = pkt.find(b"\xff\xd9", pos)
        if end < 0:
            return n
        pos = end + 2


def video_fps(path) -> float:
    """What cv2 reports as CAP_PROP_FPS for `path`, 30.0 where it gives none."""
    reader = VideoReader(path)
    fps = reader.fps
    reader.close()
    return fps


# ------------------------------------------------------------ writing

def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor_bytes(tag: int, body: bytes) -> bytes:
    n, size = len(body), b""
    size = bytes([n & 0x7F])
    n >>= 7
    while n:
        size = bytes([0x80 | (n & 0x7F)]) + size
        n >>= 7
    return bytes([tag]) + size + body


def _rate(fps: float) -> Tuple[int, int]:
    """(vop_time_increment_resolution, ticks a frame) for `fps`, the
    rational cv2.VideoWriter gives FFmpeg: round(fps * 10^k) / 10^k for the
    first k within 0.001 of fps (so 25 / 3 is written as 8.333 and 30000 /
    1001 as 29.97), reduced."""
    from math import gcd

    fps = float(fps)
    num, den = int(fps + 0.5), 1
    while abs(num / den - fps) > 0.001:
        den *= 10
        num = int(fps * den + 0.5)
    g = gcd(num, den)
    num, den = num // g, den // g
    while num > 65535:  # the VOL's 16-bit resolution
        num, den = (num + 5) // 10, max(den // 10, 1)
    return num, den


class VideoWriter:
    """BGR frames of one size, (w, h), into an MPEG-4 Part 2 `.mp4` (the
    `mp4v` sample entry cv2.VideoWriter writes for fourcc "mp4v"):
    `write(frame)`, `close()`; the VOPs at quantizer QUALITY, an I-VOP every
    GOP frames. As cv2.VideoWriter, an odd width or height loses its last
    column or row: `size` is what is encoded, (w & ~1, h & ~1)."""

    def __init__(self, path, fps: float, size: Tuple[int, int]):
        from tamtr_torch.kernels import _build

        self.path = Path(path)
        self.frame_size = (int(size[0]), int(size[1]))
        self.size = (self.frame_size[0] & ~1, self.frame_size[1] & ~1)
        self.fps = float(fps) if fps and fps > 0 else 30.0
        self.res, self.inc = _rate(self.fps)
        lib = _build.load("mpeg4_encode")
        lib.mpeg4_enc_new.restype = ctypes.c_void_p
        lib.mpeg4_enc_new.argtypes = [ctypes.c_int] * 6
        lib.mpeg4_enc_free.argtypes = [ctypes.c_void_p]
        lib.mpeg4_enc_config.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.mpeg4_enc_config.restype = ctypes.c_long
        lib.mpeg4_enc_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                        ctypes.c_void_p]
        lib.mpeg4_enc_frame.restype = ctypes.c_long
        lib.mpeg4_enc_recon.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mpeg4_enc_recon.restype = ctypes.c_int
        self._lib = lib
        w, h = self.size
        self._h = lib.mpeg4_enc_new(w, h, self.res, self.inc, QUALITY, GOP)
        if not self._h:
            raise ValueError(f"{path}: cannot encode {w}x{h} frames at {self.fps} fps")
        cfg = np.empty(256, np.uint8)
        n = lib.mpeg4_enc_config(self._h, cfg.ctypes.data, cfg.size)
        self.config = cfg[:n].tobytes()
        self._buf = np.empty(w * h * 6 + 65536, np.uint8)
        self._sizes: List[int] = []
        self._keys: List[int] = []
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._f.write(_box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2mp41"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4s", 8, b"mdat"))

    def write(self, frame: np.ndarray) -> None:
        (fw, fh), (w, h) = self.frame_size, self.size
        if np.shape(frame) != (fh, fw, 3):
            raise ValueError(f"{self.path}: frame of shape {np.shape(frame)}, the writer takes ({fh}, {fw}, 3)")
        frame = np.ascontiguousarray(frame[:h, :w], np.uint8)
        key = ctypes.c_int(0)
        n = self._lib.mpeg4_enc_frame(self._h, frame.ctypes.data, self._buf.ctypes.data, self._buf.size,
                                      ctypes.byref(key))
        if n <= 0:
            raise RuntimeError(f"{self.path}: the MPEG-4 encoder failed on frame {len(self._sizes)}")
        self._f.write(self._buf[:n].tobytes())
        self._sizes.append(int(n))
        self._keys.append(int(key.value))

    def reconstruction(self) -> np.ndarray:
        """The last frame as a decoder reads it back (h x w x 3 BGR)."""
        w, h = self.size
        out = np.empty((h, w, 3), np.uint8)
        self._lib.mpeg4_enc_recon(self._h, out.ctypes.data)
        return out

    def _moov(self, offsets: List[int]) -> bytes:
        w, h = self.size
        n = len(self._sizes)
        duration = n * self.inc
        movie_ms = int(round(duration * 1000 / self.res))
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie_ms), struct.pack(">IH", 0x10000, 0x100),
                         bytes(10), matrix, bytes(24), struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8),
                         struct.pack(">hhhH", 0, 0, 0, 0), matrix, struct.pack(">II", w << 16, h << 16))
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.res, duration), struct.pack(">HH", 0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide"), bytes(12), b"VideoHandler\x00")
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1), _full_box(b"url ", 0, 1)))
        peak = max(self._sizes) if self._sizes else 0
        bitrate = int(sum(self._sizes) * 8 * self.res / max(duration, 1))
        dec_cfg = _descriptor_bytes(0x04, bytes([0x20, 0x11]) + peak.to_bytes(3, "big") +
                                    struct.pack(">II", bitrate, bitrate) + _descriptor_bytes(0x05, self.config))
        esds = _full_box(b"esds", 0, 0, _descriptor_bytes(0x03, struct.pack(">HB", 1, 0) + dec_cfg +
                                                          _descriptor_bytes(0x06, b"\x02")))
        name = b"Lavc".ljust(0, b"\x00")
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16), struct.pack(">HH", w, h),
                     struct.pack(">IIIH", 0x480000, 0x480000, 0, 1), bytes([len(name)]) + name.ljust(31, b"\x00"),
                     struct.pack(">Hh", 0x18, -1), esds)
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, self.inc))
        keys = [i + 1 for i, k in enumerate(self._keys) if k]
        stss = _full_box(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys), *keys))
        stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self._sizes))
        if offsets and offsets[-1] >= 1 << 32:
            stco = _full_box(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *offsets))
        else:
            stco = _full_box(b"stco", 0, 0, struct.pack(f">I{n}I", n, *offsets))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)

    def close(self) -> None:
        if self._f is None:
            return
        end = self._f.tell()
        offsets, pos = [], self._mdat + 8
        for s in self._sizes:
            offsets.append(pos)
            pos += s
        self._f.write(self._moov(offsets))
        self._f.seek(self._mdat)
        self._f.write(struct.pack(">I", end - self._mdat))
        self._f.close()
        self._f = None
        self._lib.mpeg4_enc_free(self._h)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
