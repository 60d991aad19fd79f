"""Annotated-image output in numpy (a port of the JAX package's
`tamtr_tpu/utils/plotting.py`: `_palette`, `annotate_image`,
`save_annotated`; the training-curve and batch plots need matplotlib and
cv2 and are not ported).

The palette, the line width and the label-box geometry are the JAX
package's. cv2's anti-aliased lines and its text engine are not reproduced:
each box edge is a solid band `lw` pixels thick, the label box is filled
solid, and the label is drawn in white in the small 8x10 bitmap font below
(sampled from a rendering of cv2's FONT_HERSHEY_SIMPLEX), scaled by an
integer factor. The label box's width comes from per-glyph advances of
that font (px at scale 1) rather than from OpenCV 5's text engine, which
rounds each glyph at the drawn size. So a plot equals the JAX package's
outside bands of `lw + 2` px around each box edge and each label box
(`tests/test_torch_predict.py`).
"""

from __future__ import annotations

import colorsys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

_GLYPHS = bytes.fromhex(
    "0000000000000000000000404040404040000000007070000000000000000000287c287c7800000000307860384c78300000"
    "00646c681c2a6e00000000307878745c7c000000004040000000000000001030202020202010000020301010101010300000"
    "0020706000000000000000000030783030000000000000000000404000000000000070000000000000000000000040000000"
    "001010302060404000000030785c4c6c78000000003070701010780000000030780818307800000000787830380c78000000"
    "0018383858fc1800000000787870784c7800000000103078784c780000000078781810303000000000306868784c78000000"
    "0030784c78383000000000000040000040000000000000400000404000000000103040601000000000000078007800000000"
    "000040601030400000000030781830203000000000003c5a6a6e5c76000000103838687c4c00000000786c6c7c4c7c000000"
    "00387c44404c7c00000000787c4c4c4c78000000007878607840780000000078784078404000000000387c405c4c7c000000"
    "0044446c7c44440000000040404040404000000000787c0c0c48780000000048587070785800000000404040404078000000"
    "0046666e7e5e4600000000446c7c7c5c4c00000000387c4c4c4c7800000000787c4c78604000000000387c4c4c4c7c0c0000"
    "00787c4c78784c00000000307860384c780000000078783030303000000000444c4c4c6c7c00000000444c68683830000000"
    "0042465e7e7c6c000000004c683830786c00000000446c783030300000000078781830607800000000604040404040606000"
    "004040202030101800000060202020202060600000600000000000000000000000000000007c000000600000000000000000"
    "0000007818787800000000404078484878000000000000784840780000000008087848487800000000000078587878000000"
    "003060f06060600000000000007848487848780000404078484848000000004000404040400000000040004040404040c000"
    "00404058707058000000004040404040400000000000007e5b4b4b0000000000007848484800000000000078484878000000"
    "00000078484878404000000000784848780808000000007060404000000000000070603878000000006060f0606070000000"
    "00000048484878000000000000485870300000000000005a5e7e2c0000000000005870305800000000000048587030202000"
    "0000007830607800000000306040c04060603000404040404040404040000060202030202060400000000000781000000000"
)
# px per glyph at scale 1, ASCII 32-126: the advances of cv2's FONT_HERSHEY_SIMPLEX
_ADVANCE = (
    7.45, 7.05, 10.78, 20.12, 17.83, 21.97, 20.06, 6.27, 17.86, 17.86, 12.86, 17.95, 7.19, 13.99, 7.25,
    13.9, 17.86, 17.86, 17.86, 17.86, 17.86, 17.86, 17.86, 17.86, 17.86, 17.86, 7.4, 7.83, 14.19, 16.44,
    14.16, 15.35, 24.02, 19.34, 19.31, 19.25, 19.88, 17.51, 16.88, 19.65, 20.61, 7.86, 18.29, 17.37,
    16.24, 22.95, 20.06, 19.57, 18.55, 19.57, 18.93, 17.98, 16.7, 20.26, 18.9, 23.12, 18.29, 18.67,
    17.34, 9.39, 13.9, 9.39, 12.45, 21.59, 9.74, 15.95, 17.2, 15.95, 17.2, 16.18, 11.1, 17.22, 17.57,
    6.96, 7.34, 14.91, 7.02, 25.7, 17.49, 16.56, 17.22, 17.22, 10.95, 14.74, 11.3, 17.37, 15.98, 23.15,
    15.58, 15.92, 14.68, 10.63, 6.7, 10.63, 16.18,
)


def _palette(n: int) -> List[tuple]:
    return [
        tuple(int(c * 255) for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.8, 0.95))
        for i in range(n)
    ]


def text_size(label: str, scale: float, thickness: int) -> tuple:
    """(w, h) of a label's box at a font scale, as cv2.getTextSize's: the
    font's height 27 px at scale 1; the width from the glyph advances."""
    adv = sum(_ADVANCE[ord(ch) - 32] if 32 <= ord(ch) < 127 else _ADVANCE[31] for ch in label)
    return int(round(adv * scale)) + thickness, int(round(27 * scale))


def _fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """Fill [x0, x1] x [y0, y1] (inclusive, either order), clipped to img."""
    h, w = img.shape[:2]
    xa, xb = sorted((x0, x1))
    ya, yb = sorted((y0, y1))
    xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, w - 1), min(yb, h - 1)
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = color


def _text(img: np.ndarray, label: str, x: int, y_top: int, k: int, clip) -> None:
    """`label` in white, glyph cells 8 x 10 scaled by k, from (x, y_top),
    clipped to the box `clip` = (x0, y0, x1, y1) and to the image."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = clip
    for i, ch in enumerate(label):
        c = ord(ch) - 32 if 32 <= ord(ch) < 127 else 31
        bits = np.unpackbits(np.frombuffer(_GLYPHS[10 * c:10 * c + 10], np.uint8)).reshape(10, 8).astype(bool)
        if k > 1:
            bits = bits.repeat(k, 0).repeat(k, 1)
        gx, gy = x + i * 7 * k, y_top
        ys, xs = np.nonzero(bits)
        ys, xs = ys + gy, xs + gx
        keep = (xs >= max(x0, 0)) & (xs <= min(x1, w - 1)) & (ys >= max(y0, 0)) & (ys <= min(y1, h - 1))
        img[ys[keep], xs[keep]] = 255


def annotate_image(
    img_bgr: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    names: Sequence[str],
    line_width: Optional[int] = None,
) -> np.ndarray:
    """A copy of the BGR image with each box drawn in its class colour and
    a filled label box ("name 0.87") at its top-left corner."""
    out = img_bgr.copy()
    lw = line_width or max(round(sum(out.shape[:2]) / 2 * 0.003), 2)
    colors = _palette(max(len(names), 1))
    half = lw // 2
    for b, s, l in zip(boxes, scores, labels):
        c = colors[int(l) % len(colors)]
        (x1, y1), (x2, y2) = (int(b[0]), int(b[1])), (int(b[2]), int(b[3]))
        _fill(out, x1 - half, y1 - half, x2 + half, y1 + half, c)  # top, bottom, left, right edges
        _fill(out, x1 - half, y2 - half, x2 + half, y2 + half, c)
        _fill(out, x1 - half, y1 - half, x1 + half, y2 + half, c)
        _fill(out, x2 - half, y1 - half, x2 + half, y2 + half, c)
        name = names[int(l)] if int(l) < len(names) else str(int(l))
        label = f"{name} {float(s):.2f}"
        tf = max(lw - 1, 1)
        w, h = text_size(label, lw / 3, tf)
        box = (x1, y1 - h - 3, x1 + w, y1)
        _fill(out, *box, c)
        k = max(1, (h + 3) // 12)
        _text(out, label, x1 + 1, y1 - h - 2, k, box)
    return out


def save_annotated(results: List[Dict], save_dir: str | Path) -> None:
    """Each result ("path", "boxes", "scores", "labels", "names") annotated
    over its image, written under `save_dir` with the source's name, in the
    format its suffix names (`data/image_io.py:imwrite`)."""
    from tamtr_torch.data.image_io import imread, imwrite

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    for r in results:
        out = annotate_image(imread(r["path"]), r["boxes"], r["scores"], r["labels"], r["names"])
        imwrite(save_dir / Path(r["path"]).name, out)
