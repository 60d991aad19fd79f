"""Write the video fixtures of the port's video tests (`tests/torch_data/video/`).

The same panned clip (vertical and horizontal stripes beside blurred noise,
a black and a white box and a red disc that move; 28 frames, so three
I-VOPs at FFmpeg's keyframe interval of 12) is written by cv2.VideoWriter as
`mp4v` in `.mp4`, `.mov` and `.m4v`, as `XVID` and `DIVX` in `.avi` and as
`MJPG` in `.avi` and `.mov`; one clip is 94x70 (not a multiple of 16) at
30000/1001 fps. `expected.json` holds what cv2 reads from each file:
CAP_PROP_FPS, the frame count and size, every packet's size and sha256
(CAP_PROP_FORMAT -1), every decoded frame's BGR sha256 and, for MPEG-4, its
luma plane's (CAP_PROP_CONVERT_RGB 0); for Motion JPEG the sha256 of
`cv2.imdecode` of each packet and how far `cv2.VideoCapture`'s own frames
are from it (FFmpeg's MJPEG decoder and swscale). It also holds cv2's
writer on the clip: the bytes of its `.mp4` and its PSNR against the source
frames. Needs cv2 (so it runs here, not on the card's machine); rerunning
it rewrites the same files.

    python tools/make_video_fixtures_torch.py

`clip_frames` (numpy only) is imported by `tests/test_torch_video.py`.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "torch_data" / "video"
CLIP = (128, 96, 28)
ODD = (94, 70, 28)
FILES = [  # name, fourcc, size, fps
    ("clip.mp4", "mp4v", CLIP, 25.0),
    ("clip.mov", "mp4v", CLIP, 25.0),
    ("clip.m4v", "mp4v", CLIP, 25.0),
    ("clip_xvid.avi", "XVID", CLIP, 25.0),
    ("clip_divx.avi", "DIVX", CLIP, 25.0),
    ("clip_mjpg.avi", "MJPG", CLIP, 25.0),
    ("clip_mjpg.mov", "MJPG", CLIP, 25.0),
    ("odd.mp4", "mp4v", ODD, 30000 / 1001),
]


def clip_frames(w: int = 128, h: int = 96, n: int = 28, seed: int = 0) -> list:
    """The fixture clip's BGR frames, made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    hh, ww = h + 64, w + 96
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    bg = np.empty((hh, ww, 3), np.float32)
    bg[..., 0] = 128 + 90 * np.cos(xx * 2 * np.pi / 12)
    bg[..., 1] = 128 + 90 * np.cos(yy * 2 * np.pi / 10)
    bg[..., 2] = 128 + 60 * np.cos((xx + yy) * 2 * np.pi / 40)
    noise = rng.integers(0, 256, (hh, ww, 3)).astype(np.float32)
    noise = (noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1) + np.roll(noise, (1, 1), (0, 1))) / 4
    bg = np.where((xx > ww * 0.6)[..., None], noise, bg)
    bg = np.clip(np.rint(bg), 0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        f = bg[t:t + h, 2 * t:2 * t + w].copy()
        f[10:35, 6 + 3 * t:31 + 3 * t] = 0
        f[h - 40 + t // 2:h - 19 + t // 2, max(w - 30 - 2 * t, 0):max(w - 9 - 2 * t, 0)] = 255
        disc = (yy[:h, :w] - (h // 2 + t % 7)) ** 2 + (xx[:h, :w] - w // 2) ** 2 <= 81
        f[disc] = (0, 0, 255)
        frames.append(f)
    return frames


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def read_all(cv2, path: Path, *args):
    cap = cv2.VideoCapture(str(path), *args)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.copy())
    cap.release()
    return out


def main() -> None:
    import cv2

    OUT.mkdir(parents=True, exist_ok=True)
    expected = {}
    for name, fourcc, (w, h, n), fps in FILES:
        path = OUT / name
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
        for f in clip_frames(w, h, n):
            writer.write(f)
        writer.release()
        cap = cv2.VideoCapture(str(path))
        info = {"fps": cap.get(cv2.CAP_PROP_FPS), "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                "size": [int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))]}
        cap.release()
        cap = cv2.VideoCapture(str(path))
        cap.set(cv2.CAP_PROP_FORMAT, -1)
        packets = []
        while True:
            ok, p = cap.read()
            if not ok:
                break
            packets.append(bytes(p.ravel()))
        cap.release()
        info["packets"] = [{"size": len(p), "sha256": sha(p)} for p in packets]
        frames = read_all(cv2, path)
        info["bgr_sha256"] = [sha(f.tobytes()) for f in frames]
        if fourcc == "MJPG":
            dec = [cv2.imdecode(np.frombuffer(p, np.uint8), cv2.IMREAD_COLOR) for p in packets]
            info["imdecode_sha256"] = [sha(d.tobytes()) for d in dec]
            diff = np.stack([np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(dec, frames)])
            info["videocapture_vs_imdecode"] = {"max": int(diff.max()), "mean": float(diff.mean())}
        else:
            luma = read_all(cv2, path, cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])
            info["luma_sha256"] = [sha(f.tobytes()) for f in luma]
        expected[name] = info
    src = clip_frames(*CLIP)
    expected["source_sha256"] = sha(np.stack(src).tobytes())
    expected["odd_source_sha256"] = sha(np.stack(clip_frames(*ODD)).tobytes())
    mp4 = OUT / "clip.mp4"
    frames = read_all(cv2, mp4)
    mse = np.mean((np.stack(frames).astype(np.float64) - np.stack(src).astype(np.float64)) ** 2)
    expected["cv2_writer"] = {"file": "clip.mp4", "bytes": mp4.stat().st_size,
                              "psnr": float(10 * np.log10(255.0 ** 2 / mse))}
    (OUT / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(FILES)} clips and expected.json to {OUT} ({total} bytes)")


if __name__ == "__main__":
    sys.exit(main())
