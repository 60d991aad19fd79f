"""Inference sources for predict and track (a port of the JAX package's
`tamtr_tpu/data/loaders.py`: `load_inference_source`, `load_screenshots`).

`load_inference_source` yields (name, frame_bgr) pairs from an array, a list
or tuple of sources, a directory (its images and videos, sorted, at any
depth), a glob pattern, one image file (`data/image_io.py:imread`), one video
file (`data/video_io.py:VideoReader`: MP4, MOV, M4V and AVI holding MPEG-4
Part 2 or Motion JPEG; frames named "path#i", every `vid_stride`-th) or a
"screen ..." source (`load_screenshots`). Webcam indices and stream URLs
need a capture device or the network, and the other video containers
(Matroska, WebM, WMV, MPEG-PS) a demuxer the port lacks: they raise
NotImplementedError.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Any, Generator, Optional, Tuple

import numpy as np

from tamtr_torch.data.image_io import imread
from tamtr_torch.data.video_io import READ_SUFFIXES, VideoReader

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
VID_EXTS = {".avi", ".mp4", ".mkv", ".mov", ".wmv", ".m4v", ".mpg", ".mpeg", ".webm"}


def is_video(source: Any) -> bool:
    """True for a path with a video file's suffix (VID_EXTS)."""
    return isinstance(source, (str, Path)) and Path(source).suffix.lower() in VID_EXTS


def unsupported_source(source: Any) -> Optional[str]:
    """Why `source` cannot be read by the port (a webcam index or a stream
    URL: a capture device or the network; a video container `VideoReader`
    does not demux), or None for a source it reads."""
    if isinstance(source, int) or (isinstance(source, str) and source.isdigit()):
        return f"source {source!r}: webcam sources need a capture device, which tamtr_torch does not read"
    if isinstance(source, str) and "://" in source:
        return f"source {source!r}: network streams are not read by tamtr_torch (no network client, and such " \
               f"streams carry H.264)"
    if is_video(source) and Path(source).suffix.lower() not in READ_SUFFIXES:
        return f"{source}: the {Path(source).suffix.lower()} container is not read by tamtr_torch (MP4, MOV, M4V " \
               f"and AVI are)"
    return None


def load_inference_source(source: Any, vid_stride: int = 1,
                          stream_buffer: bool = True) -> Generator[Tuple[str, np.ndarray], None, None]:
    """Yield (name, frame_bgr) for arrays, lists of sources, directories,
    glob patterns, image files, video files (every `vid_stride`-th frame,
    named "path#i") and "screen ..." sources. `stream_buffer` belongs to the
    webcam and stream sources, which raise."""
    if isinstance(source, np.ndarray):
        yield "array", source
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from load_inference_source(s, vid_stride, stream_buffer)
        return
    why = unsupported_source(source)
    if why:
        raise NotImplementedError(why)
    if isinstance(source, str) and source.split()[0:1] == ["screen"]:
        yield from load_screenshots(source, vid_stride=vid_stride)
        return
    p = Path(source)
    if p.is_dir():
        for f in sorted(p.rglob("*")):
            if f.suffix.lower() in IMG_EXTS:
                img = imread(f)
                if img is not None:
                    yield str(f), img
            elif f.suffix.lower() in VID_EXTS:
                yield from load_inference_source(str(f), vid_stride)
        return
    if is_video(p):
        with VideoReader(p) as reader:
            for i, frame in enumerate(reader):
                if i % vid_stride == 0:
                    yield f"{p}#{i}", frame
        return
    if not p.exists() and any(ch in str(source) for ch in "*?["):
        for f in sorted(glob.glob(str(source), recursive=True)):
            if Path(f).suffix.lower() in IMG_EXTS:
                yield from load_inference_source(f, vid_stride)
        return
    img = imread(p)
    if img is None:
        raise FileNotFoundError(f"cannot read source {source}")
    yield str(p), img


def load_screenshots(source: str = "screen", vid_stride: int = 1, max_frames: Optional[int] = None,
                     grab: Any = None) -> Generator[Tuple[str, np.ndarray], None, None]:
    """Screen-capture frames (the JAX package's `load_screenshots`).

    `source` = "screen [n] [left top width height]": a screen number and/or
    a capture box in pixels. Needs the `mss` package unless `grab`, a
    callable (monitor_dict) -> H x W x 4 BGRA array, is given (a 640 x 640
    monitor then). Frames are named "screen{n}_{i}", every `vid_stride`-th.
    """
    parts = str(source).split()
    assert parts and parts[0] == "screen", f"not a screen source: {source!r}"
    params = [int(x) for x in parts[1:]]
    screen, box = 0, None
    if len(params) == 1:
        screen = params[0]
    elif len(params) == 4:
        box = params
    elif len(params) == 5:
        screen, box = params[0], params[1:]
    if grab is None:
        try:
            import mss  # type: ignore
        except ImportError as e:
            raise ImportError("screenshot source needs the `mss` package (pip install mss)") from e
        sct = mss.mss()
        mon = sct.monitors[screen]
        grab = lambda m: np.asarray(sct.grab(m))  # noqa: E731
    else:
        mon = {"left": 0, "top": 0, "width": 640, "height": 640}
    if box is not None:
        left, top, width, height = box
        monitor = {"left": mon["left"] + left, "top": mon["top"] + top, "width": width, "height": height}
    else:
        monitor = {k: mon[k] for k in ("left", "top", "width", "height")}
    frame = 0
    while max_frames is None or frame < max_frames:
        if frame % vid_stride == 0:
            im = np.asarray(grab(monitor))[..., :3]  # BGRA -> BGR
            yield f"screen{screen}_{frame}", np.ascontiguousarray(im)
        frame += 1
