"""The port's video files (`tamtr_torch/data/video_io.py`, `data/loaders.py`,
`engine/results.py:AnnotatedVideoWriter`, `Engine.predict` / `track` on a
video) against cv2 and the JAX package on the CPU.

- The demuxers give cv2's packets byte for byte (CAP_PROP_FORMAT -1), its
  CAP_PROP_FPS, frame count and size, on every fixture of
  `tests/torch_data/video/` (`tools/make_video_fixtures_torch.py`).
- MPEG-4 Part 2: the luma plane equals cv2's (CAP_PROP_CONVERT_RGB 0) and
  the BGR frame cv2's, bitwise, on every frame of every `mp4v` / `XVID` /
  `DIVX` fixture, the 94x70 one included; every tool the decoder accepts is
  used by one of these streams or by the port's own writer's, which cv2
  decodes to the same bytes.
- Motion JPEG: each frame equals `cv2.imdecode` of its packet; against
  `cv2.VideoCapture`'s own frames the differences are the recorded ones.
- The writer: cv2 opens its `.mp4` (frame count, size, fps) and decodes it
  to the port reader's frames and to the encoder's reconstruction; its PSNR
  is within 1 dB of cv2.VideoWriter's and its bytes at most 2x.
- `load_inference_source` and `load_screenshots` give JAX's names and
  frames; `Engine.predict` / `track` on a video give JAX's names, boxes
  and scores at 1e-3 and track ids; save=True writes JAX's `.mp4` path.
- What the port does not read raises NotImplementedError naming the file
  and what is missing.
"""

import hashlib
import importlib.util
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from tamtr_torch.data import video_io
from tamtr_torch.data.video_io import MPEG4_STATS, Mpeg4Decoder, VideoReader, VideoWriter

from torch_engine_data import IMG, NAMES, NC, jax_nano_session, one_thread, unit_text  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
VIDEO = REPO / "tests" / "torch_data" / "video"
EXPECTED = json.loads((VIDEO / "expected.json").read_text())
CLIPS = sorted(k for k, v in EXPECTED.items() if isinstance(v, dict) and "fps" in v)
MPEG4_CLIPS = [k for k in CLIPS if "luma_sha256" in EXPECTED[k]]
MJPEG_CLIPS = [k for k in CLIPS if "imdecode_sha256" in EXPECTED[k]]

_spec = importlib.util.spec_from_file_location("make_video_fixtures_torch",
                                               REPO / "tools" / "make_video_fixtures_torch.py")
fixtures_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures_tool)


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def cv2_frames(path, *args):
    cap = cv2.VideoCapture(str(path), *args)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    cap.release()
    return out


def test_clip_generator_is_the_fixtures():
    assert sha(np.stack(fixtures_tool.clip_frames(*fixtures_tool.CLIP)).tobytes()) == EXPECTED["source_sha256"]
    assert sha(np.stack(fixtures_tool.clip_frames(*fixtures_tool.ODD)).tobytes()) == EXPECTED["odd_source_sha256"]


@pytest.mark.parametrize("name", CLIPS)
def test_demuxer_gives_cv2_packets_fps_count_and_size(name):
    want = EXPECTED[name]
    with VideoReader(VIDEO / name) as r:
        packets = list(r.packets())
        assert [{"size": len(p), "sha256": sha(p)} for p in packets] == want["packets"]
        assert r.fps == want["fps"] and r.frame_count == want["frame_count"] and list(r.size) == want["size"]


@pytest.mark.parametrize("name", MPEG4_CLIPS)
def test_mpeg4_decode_is_bitwise_cv2(name):
    """Luma (the decoder) and BGR (the decoder and the colour conversion)
    of every frame against cv2's digests; P-VOPs and cropped edge
    macroblocks included."""
    want = EXPECTED[name]
    with VideoReader(VIDEO / name) as r:
        dec = r.decoder()
        luma, bgr = [], []
        for p in r.packets():
            if dec.decode(p):
                luma.append(sha(dec.planes()[0].tobytes()))
                bgr.append(sha(dec.bgr().tobytes()))
        assert luma == want["luma_sha256"]
        assert bgr == want["bgr_sha256"]
        assert [sha(f.tobytes()) for f in r] == want["bgr_sha256"]  # the reader's own iteration
        stats = dec.stats()
    assert stats["i_vops"] == 3 and stats["p_vops"] == want["frame_count"] - 3


@pytest.mark.parametrize("name", MJPEG_CLIPS)
def test_mjpeg_frames_are_imdecode_of_their_packets(name):
    want = EXPECTED[name]
    with VideoReader(VIDEO / name) as r:
        assert r.codec == "mjpeg"
        frames = list(r)
        packets = list(r.packets())
    assert [sha(f.tobytes()) for f in frames] == want["imdecode_sha256"]
    for f, p in zip(frames[:3], packets):
        np.testing.assert_array_equal(f, cv2.imdecode(np.frombuffer(p, np.uint8), cv2.IMREAD_COLOR))
    # FFmpeg's own MJPEG decoder and swscale (cv2.VideoCapture) differ from libjpeg's decode by these
    cap = cv2_frames(VIDEO / name)
    diff = np.stack([np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(frames, cap)])
    assert int(diff.max()) == want["videocapture_vs_imdecode"]["max"] == 85
    assert float(diff.mean()) == pytest.approx(want["videocapture_vs_imdecode"]["mean"], abs=1e-9)


def psnr(a, b) -> float:
    mse = np.mean((np.stack(a).astype(np.float64) - np.stack(b).astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def test_writer_is_read_by_cv2_and_the_port(tmp_path):
    src = fixtures_tool.clip_frames(*fixtures_tool.CLIP)
    path = tmp_path / "clip.mp4"
    recon = []
    with VideoWriter(path, 25.0, (128, 96)) as w:
        for f in src:
            w.write(f)
            recon.append(w.reconstruction())
    cap = cv2.VideoCapture(str(path))
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0 and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(src)
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (128, 96)
    cap.release()
    theirs = cv2_frames(path)
    with VideoReader(path) as r:
        mine = list(r)
        assert r.fps == 25.0
    assert len(theirs) == len(mine) == len(src)
    for a, b, c in zip(mine, theirs, recon):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert psnr(mine, src) >= EXPECTED["cv2_writer"]["psnr"] - 1.0
    assert path.stat().st_size <= 2 * EXPECTED["cv2_writer"]["bytes"]


def test_every_decoder_tool_is_held_against_cv2(tmp_path):
    """Each counter of the decoder is used by a stream decoded bitwise as cv2
    decodes it: cv2's fixtures (intra macroblocks in P-VOPs, skips, the
    three escapes, half-pel and outside vectors, rounding 1) and the
    port's writer (AC prediction, dquant, AC prediction rescaled across
    quantizers)."""
    total = dict.fromkeys(MPEG4_STATS, 0)
    streams = [VIDEO / n for n in MPEG4_CLIPS]
    path = tmp_path / "port.mp4"
    with VideoWriter(path, 25.0, (128, 96)) as w:
        for f in fixtures_tool.clip_frames(*fixtures_tool.CLIP):
            w.write(f)
    streams.append(path)
    for s in streams:
        with VideoReader(s) as r:
            dec = r.decoder()
            frames = []
            for p in r.packets():
                if dec.decode(p):
                    frames.append(dec.bgr())
        if s == path:
            for a, b in zip(frames, cv2_frames(s)):
                np.testing.assert_array_equal(a, b)
        for k, v in dec.stats().items():
            total[k] += v
    assert all(v > 0 for v in total.values()), total


def test_writer_at_other_rates_and_an_odd_size(tmp_path):
    """12.5 fps (25 / a vid_stride of 2), 25 / 3, 30000/1001 and a 94x70
    frame: cv2 reads the rate cv2.VideoWriter's own file of that rate gives
    and decodes the frames to the port's."""
    src = fixtures_tool.clip_frames(*fixtures_tool.ODD)[:14]
    for fps in (12.5, 25 / 3, 30000 / 1001):
        path, theirs = tmp_path / f"odd_{fps:.3f}.mp4", tmp_path / f"cv2_{fps:.3f}.mp4"
        with VideoWriter(path, fps, (94, 70)) as w:
            for f in src:
                w.write(f)
        writer = cv2.VideoWriter(str(theirs), cv2.VideoWriter_fourcc(*"mp4v"), fps, (94, 70))
        writer.write(src[0])
        writer.release()
        cap, ref = cv2.VideoCapture(str(path)), cv2.VideoCapture(str(theirs))
        want = ref.get(cv2.CAP_PROP_FPS)
        assert cap.get(cv2.CAP_PROP_FPS) == want == pytest.approx(fps, abs=1e-3)
        cap.release()
        ref.release()
        with VideoReader(path) as r:
            assert r.fps == want and r.size == (94, 70)
            for a, b in zip(r, cv2_frames(path)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w,h", [(95, 71), (96, 71), (95, 70)])
def test_writer_drops_an_odd_last_column_and_row_as_cv2(tmp_path, w, h):
    """cv2.VideoWriter encodes frame[:h & ~1, :w & ~1] of an odd-sized
    frame; the port's writer encodes the same size, and cv2 decodes its
    file to the port reader's frames (so a 1360x765 plot becomes a
    1360x764 video in both packages)."""
    src = [f[:h, :w] for f in fixtures_tool.clip_frames(96, 72, 6)]
    mine, theirs = tmp_path / "port.mp4", tmp_path / "cv2.mp4"
    with VideoWriter(mine, 25.0, (w, h)) as writer:
        for f in src:
            writer.write(f)
        assert writer.size == (w & ~1, h & ~1)
    cvw = cv2.VideoWriter(str(theirs), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
    for f in src:
        cvw.write(np.ascontiguousarray(f))
    cvw.release()
    want = cv2_frames(theirs)
    got = cv2_frames(mine)
    assert got[0].shape == want[0].shape == (h & ~1, w & ~1, 3)
    with VideoReader(mine) as r:
        for a, b in zip(r, got):
            np.testing.assert_array_equal(a, b)
    assert psnr(got, [f[:h & ~1, :w & ~1] for f in src]) > 20
    with VideoWriter(tmp_path / "x.mp4", 25.0, (w, h)) as bad, pytest.raises(ValueError, match="the writer takes"):
        bad.write(src[0][:, :-2])


# ------------------------------------------------------------ refusals

class Bits:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def start(self, code):
        self.stuff()
        return self.put(0x000001, 24).put(code, 8)

    def stuff(self):
        if len(self.bits) % 8:
            self.put(0, 1)
            while len(self.bits) % 8:
                self.put(1, 1)
        return self

    def bytes(self):
        self.stuff()
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2) for i in range(0, len(self.bits), 8))


def vol(ver=1, shape=0, interlaced=0, sprite=0, not8=0, mpeg_quant=0, qpel=0, complexity=1, resync=1, partitioned=0,
        newpred=0, reduced=0, scalability=0, w=32, h=32, res=25):
    b = Bits().start(0x20).put(0, 1).put(1, 8)
    if ver == 1:
        b.put(0, 1)
    else:
        b.put(1, 1).put(ver, 4).put(1, 3)
    b.put(1, 4).put(1, 1).put(1, 2).put(1, 1).put(0, 1).put(shape, 2).put(1, 1).put(res, 16).put(1, 1).put(0, 1)
    b.put(1, 1).put(w, 13).put(1, 1).put(h, 13).put(1, 1).put(interlaced, 1).put(1, 1)
    b.put(sprite, 1 if ver == 1 else 2).put(not8, 1).put(mpeg_quant, 1)
    if ver != 1:
        b.put(qpel, 1)
    b.put(complexity, 1).put(resync, 1).put(partitioned, 1)
    if ver != 1:
        b.put(newpred, 1).put(reduced, 1)
    return b.put(scalability, 1).bytes()


def vop(kind=0, coded=1, dc_thr=0, q=4, extra=()):
    b = Bits().start(0xB6).put(kind, 2).put(0, 1).put(1, 1).put(0, 5).put(1, 1).put(coded, 1)
    if kind == 1:
        b.put(0, 1)
    b.put(dc_thr, 3).put(q, 5)
    if kind == 1:
        b.put(1, 3)
    for v, n in extra:
        b.put(v, n)
    return b.bytes()


def user_data(text):
    return b"\x00\x00\x01\xb2" + text


def intra_vop():
    """One 32x32 I-VOP of the port's writer with its VOL, for streams that
    need a reference before the VOP under test."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "one.mp4"
        with VideoWriter(p, 25.0, (32, 32)) as w:
            w.write(np.full((32, 32, 3), 90, np.uint8))
        with VideoReader(p) as r:
            return r.extradata, next(r.packets())


@pytest.mark.parametrize("stream,what,tag", [
    (lambda: vol(interlaced=1), "interlaced video", b"mp4v"),
    (lambda: vol(shape=1), "shape other than rectangular", b"mp4v"),
    (lambda: vol(sprite=1), "sprites", b"mp4v"),
    (lambda: vol(not8=1), "more than 8 bits", b"mp4v"),
    (lambda: vol(mpeg_quant=1), "MPEG quantisation", b"mp4v"),
    (lambda: vol(ver=2, qpel=1), "quarter-pel", b"mp4v"),
    (lambda: vol(complexity=0), "complexity estimation", b"mp4v"),
    (lambda: vol(resync=0), "resync markers", b"mp4v"),
    (lambda: vol(partitioned=1), "data partitioning", b"mp4v"),
    (lambda: vol(ver=2, newpred=1), "newpred", b"mp4v"),
    (lambda: vol(ver=2, reduced=1), "reduced-resolution", b"mp4v"),
    (lambda: vol(scalability=1), "scalability", b"mp4v"),
    (lambda: vol() + user_data(b"Lavc") + vop(kind=2), "B-VOPs", b"mp4v"),
    (lambda: vol() + user_data(b"Lavc") + vop(kind=3), "S-VOPs", b"mp4v"),
    (lambda: vol() + user_data(b"Lavc") + vop(coded=0), "not-coded VOPs", b"mp4v"),
    (lambda: vol() + user_data(b"Lavc") + vop(dc_thr=1), "intra DC VLC threshold", b"mp4v"),
    (lambda: vol() + user_data(b"XviD0050") + vop(), "XviD-encoded", b"mp4v"),
    (lambda: vol() + user_data(b"DivX503Build1000p") + vop(), "DivX-encoded", b"mp4v"),
    (lambda: (vol(), vop()), "XVID-tagged stream with no encoder name", b"XVID"),
    (lambda: (*intra_vop(), vop(kind=1, extra=[(0, 1), (0b010, 3)])), "four motion vectors", b"mp4v"),
])
def test_refused_tools_name_the_stream_and_the_tool(stream, what, tag):
    packets = stream()
    packets = packets if isinstance(packets, tuple) else (packets,)
    dec = Mpeg4Decoder(tag, "cam/clip.avi")
    with pytest.raises(NotImplementedError) as e:
        for p in packets:
            dec.decode(p)
    assert "cam/clip.avi" in str(e.value) and what in str(e.value)


def avi(path: Path, tag: bytes, packets, w=128, h=96):
    """A minimal RIFF AVI: one video stream of `tag`, `packets` as 00dc chunks."""
    def chunk(kind, body):
        return struct.pack("<4sI", kind, len(body)) + body + b"\x00" * (len(body) & 1)

    def lst(kind, *parts):
        body = kind + b"".join(parts)
        return struct.pack("<4sI", b"LIST", len(body)) + body

    avih = chunk(b"avih", struct.pack("<14I", 40000, 0, 0, 0, len(packets), 0, 1, 0, w, h, 0, 0, 0, 0))
    strh = chunk(b"strh", b"vids" + tag + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, 25, 0, len(packets), 0,
                                                       0xFFFFFFFF, 0, 0, 0, w, h))
    strf = chunk(b"strf", struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, tag, w * h * 3, 0, 0, 0, 0))
    movi = lst(b"movi", *[chunk(b"00dc", p) for p in packets])
    body = b"AVI " + lst(b"hdrl", avih, lst(b"strl", strh, strf)) + movi
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def test_refused_files_name_the_file_and_what_is_missing(tmp_path):
    cases = []
    mkv = tmp_path / "clip.mkv"
    mkv.write_bytes(b"\x1a\x45\xdf\xa3")
    cases.append((mkv, ".mkv container"))
    data = (VIDEO / "clip.mp4").read_bytes()
    h264 = tmp_path / "h264.mp4"
    h264.write_bytes(data.replace(b"mp4v", b"avc1"))
    cases.append((h264, "codec 'avc1'"))
    with VideoReader(VIDEO / "clip_mjpg.avi") as r:
        jpegs = list(r.packets())[:2]
    avi(tmp_path / "h264.avi", b"H264", jpegs)
    cases.append((tmp_path / "h264.avi", "codec 'H264'"))
    avi(tmp_path / "fields.avi", b"MJPG", [jpegs[0] + jpegs[1]])
    cases.append((tmp_path / "fields.avi", "interlaced (two-field) Motion JPEG"))
    # a B-VOP in the second packet of an mp4v file
    with VideoReader(VIDEO / "clip.mp4") as r:
        second = next(p for i, p in enumerate(r.packets()) if i == 1)
    k = data.index(second) + second.index(b"\x00\x00\x01\xb6") + 4
    bvop = tmp_path / "bvop.mp4"
    bvop.write_bytes(data[:k] + bytes([(data[k] & 0x3F) | 0x80]) + data[k + 1:])
    cases.append((bvop, "B-VOPs"))
    for path, what in cases:
        with pytest.raises(NotImplementedError) as e:
            list(VideoReader(path))
        assert str(path) in str(e.value) and what in str(e.value), str(e.value)


# ------------------------------------------------------------ sources

def test_load_inference_source_on_videos_matches_jax(tmp_path):
    from tamtr_tpu.data.loaders import load_inference_source as jax_source

    from tamtr_torch.data.loaders import load_inference_source

    d = tmp_path / "dir"
    d.mkdir()
    for n in ("clip.mp4", "clip_xvid.avi"):
        (d / n).write_bytes((VIDEO / n).read_bytes())
    cv2.imwrite(str(d / "a.png"), np.zeros((20, 30, 3), np.uint8))
    for src, stride in ((str(VIDEO / "clip.mp4"), 1), (str(VIDEO / "odd.mp4"), 3), (str(d), 3),
                        (str(VIDEO / "clip_mjpg.avi"), 3)):
        got, want = list(load_inference_source(src, stride)), list(jax_source(src, stride))
        assert [n for n, _ in got] == [n for n, _ in want] and len(got) > 3
        for (n, g), (_, w) in zip(got, want):
            if "mjpg" in n:  # cv2's VideoCapture runs FFmpeg's MJPEG decoder: the recorded bound
                assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 85
            else:
                np.testing.assert_array_equal(g, w)
    for bad, what in ((0, "webcam"), ("0", "webcam"), ("rtsp://host/stream", "network streams"),
                      ("clip.webm", ".webm container")):
        with pytest.raises(NotImplementedError, match=what):
            list(load_inference_source(bad))


def test_load_screenshots_matches_jax():
    from tamtr_tpu.data.loaders import load_screenshots as jax_screens

    from tamtr_torch.data.loaders import load_inference_source, load_screenshots

    def grab(m):
        rng = np.random.default_rng(m["left"] + 7 * m["top"] + m["width"])
        return rng.integers(0, 256, (m["height"], m["width"], 4), dtype=np.uint8)

    for src in ("screen", "screen 1", "screen 10 20 64 48", "screen 2 5 6 40 30"):
        got = list(load_screenshots(src, vid_stride=2, max_frames=5, grab=grab))
        want = list(jax_screens(src, vid_stride=2, max_frames=5, grab=grab))
        assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 3
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ImportError, match="mss"):
        list(load_inference_source("screen"))


# ------------------------------------------------------------ predict and track

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    from tamtr_torch.api import TAMTR

    jmodel, params, batch_stats = jax_nano_session(tmp_path_factory)
    je = JaxEngine("tamtr-nano.yaml")
    je.model = jmodel
    je.state = InferenceState(params, batch_stats)
    je.set_classes(NAMES, unit_text())
    det = TAMTR("tamtr-nano.yaml", nc=NC, device="cpu", imgsz=IMG).load_jax_variables(params, batch_stats)
    det.set_classes(NAMES, unit_text())
    return je, det


def assert_same_detections(got, want, atol=1e-3):
    assert [r.path for r in got] == [r.path for r in want]
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape and g.orig_img is not None
        rg = np.concatenate([g.boxes.xyxy, g.boxes.conf[:, None], g.boxes.cls[:, None]], 1)
        rw = np.concatenate([w.boxes.xyxy, w.boxes.conf[:, None], w.boxes.cls[:, None]], 1)
        assert rg.shape == rw.shape
        if len(rg):
            dist = np.abs(rg[:, None] - rw[None]).max(-1)
            r, c = linear_sum_assignment(dist)
            assert dist[r, c].max() < atol


@pytest.mark.parametrize("stride", [1, 3])
def test_predict_on_a_video_matches_jax(engines, tmp_path, stride):
    je, det = engines
    clip = str(VIDEO / "clip.mp4")
    want = je.predict(clip, imgsz=IMG, conf=0.05, vid_stride=stride, save=True, project=str(tmp_path / "jax"),
                      name="v")
    got = det.predict(clip, conf=0.05, vid_stride=stride, save=True, project=str(tmp_path / "port"), name="v")
    assert len(got) == -(-28 // stride) and got[1].path == f"{clip}#{stride}"
    assert sum(len(r) for r in want) > 0
    assert_same_detections(got, want)
    theirs, mine = tmp_path / "jax" / "v" / "clip.mp4", tmp_path / "port" / "v" / "clip.mp4"
    assert theirs.exists() and mine.exists()
    a, b = cv2.VideoCapture(str(theirs)), cv2.VideoCapture(str(mine))
    for prop in (cv2.CAP_PROP_FPS, cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FRAME_WIDTH, cv2.CAP_PROP_FRAME_HEIGHT):
        assert a.get(prop) == pytest.approx(b.get(prop), rel=1e-9), prop
    assert b.get(cv2.CAP_PROP_FPS) == pytest.approx(25.0 / stride, abs=1e-3)


def test_track_on_a_video_matches_jax(engines, tmp_path):
    from tamtr_tpu.trackers.byte_tracker import Track as JaxTrack

    from tamtr_torch.trackers.byte_tracker import Track

    je, det = engines
    clip = str(VIDEO / "clip_divx.avi")
    JaxTrack._count = 0
    want = je.track(clip, imgsz=IMG, conf=0.05, save=True, project=str(tmp_path / "jax"))
    Track.reset_id()
    got = det.track(clip, conf=0.05, save=True, project=str(tmp_path / "port"))
    assert sum(len(r.track_ids) for r in want) > 28
    assert_same_detections(got, want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.track_ids, w.track_ids)
    with VideoReader(tmp_path / "port" / "predict" / "clip_divx.mp4") as r:
        assert r.frame_count == 28 and r.size == (128, 96) and r.fps == 25.0
    assert (tmp_path / "jax" / "predict" / "clip_divx.mp4").exists()


def test_predict_and_track_refuse_what_they_cannot_read(engines):
    _, det = engines
    for bad, what in (("clip.mkv", ".mkv container"), (0, "webcam"), ("http://host/v.mp4", "network streams")):
        with pytest.raises(NotImplementedError, match=what):
            det.predict(bad) if not isinstance(bad, int) else det.track(bad)
    assert video_io.UnsupportedVideo.__mro__[1] is NotImplementedError
