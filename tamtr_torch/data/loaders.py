"""Inference sources for predict (a port of the JAX package's
`tamtr_tpu/data/loaders.py:load_inference_source`, images only).

`load_inference_source` yields (name, frame_bgr) pairs from an array, a list
or tuple of sources, a directory (its images, sorted, at any depth), a glob
pattern or one image file, read by `data/image_io.py:imread`. Webcam,
stream, video and screen sources need a video decoder or a screen grabber,
which the port does not have: they raise NotImplementedError.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Any, Generator, Optional, Tuple

import numpy as np

from tamtr_torch.data.image_io import imread

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
VID_EXTS = {".avi", ".mp4", ".mkv", ".mov", ".wmv", ".m4v", ".mpg", ".mpeg", ".webm"}


def unsupported_source(source: Any) -> Optional[str]:
    """Why `source` cannot be read by the port (a webcam index, a stream
    URL, a screen or a video file: each needs a decoder or a grabber the
    port does not have), or None for an image source."""
    if isinstance(source, int) or (isinstance(source, str) and (source.isdigit() or "://" in source)):
        return f"source {source!r}: webcam and stream sources need a video decoder, which tamtr_torch does not have"
    if isinstance(source, str) and source.split()[0:1] == ["screen"]:
        return f"source {source!r}: screen capture is not ported"
    if isinstance(source, (str, Path)) and Path(source).suffix.lower() in VID_EXTS:
        return f"{source}: video sources need a video decoder, which tamtr_torch does not have"
    return None


def load_inference_source(source: Any, vid_stride: int = 1,
                          stream_buffer: bool = True) -> Generator[Tuple[str, np.ndarray], None, None]:
    """Yield (name, frame_bgr) for arrays, lists of sources, directories,
    glob patterns and image files. `vid_stride` and `stream_buffer` belong
    to the video and stream sources, which raise here."""
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
    if not p.exists() and any(ch in str(source) for ch in "*?["):
        for f in sorted(glob.glob(str(source), recursive=True)):
            if Path(f).suffix.lower() in IMG_EXTS:
                yield from load_inference_source(f, vid_stride)
        return
    img = imread(p)
    if img is None:
        raise FileNotFoundError(f"cannot read source {source}")
    yield str(p), img
