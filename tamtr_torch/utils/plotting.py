"""Plots in numpy (a port of `tamtr_tpu/utils/plotting.py`, which draws
with cv2 and matplotlib): `annotate_image` and `save_annotated` (predict's
plots), `plot_images` (the training-batch mosaic), `plot_results` (the
training curves), `feature_visualization` (feature-map channel grids) and
`plot_confusion_matrix` (`ConfusionMatrix.plot`). Each file is written
through `data/image_io.py:imwrite`.

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

# cv2.applyColorMap's COLORMAP_VIRIDIS and matplotlib's Blues, 256 BGR entries each
_VIRIDIS_BGR = bytes.fromhex(
    "5401445602445704455905455a07465c08465d0a465e0b46600d47610e476310476411476513476714486816486917486a18"
    "486c1a486d1b486e1c486f1d48701f487120487321487423487524487625487726487828487929487a2a477a2c477b2d477c"
    "2e477d2f477e30467e32467f3346803446813545813745823845833944833a44843b44843d43853e43853f42864042864142"
    "87424187444188454088464088473f89483f89493e894a3e8a4c3e8a4d3d8a4e3d8a4f3c8b503c8b513b8b523b8b533a8c54"
    "3a8c55398c56398c58388c59388c5a378d5b378d5c368d5d368d5e358d5f358d60348d61348d62338d63338e64328e65328e"
    "66318e67318e68318e69308e6a308e6b2f8e6c2f8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c8e722c8e732c8e742b8e752b"
    "8e762a8e772a8e782a8e79298e7a298e7b298e7c288e7d288e7e278e7f278e80278e81268e82268e82268e83258e84258e85"
    "258e86248e87248e88238e89238d8a238d8b228d8c228d8d228d8e218d8f218d90218c91218c92208c92208c93208c941f8b"
    "951f8b961f8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f88a01f88a11f87a11f87a21f86a32086a420"
    "85a52185a62185a72284a82283a92383aa2482ab2582ac2581ad2681ad2780ae287faf297fb02a7eb12c7db22d7cb32e7cb4"
    "2f7bb5317ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d73bc3f72bd4071be4270bf446fc0466ec1486dc14a6c"
    "c24c6bc34e6ac45069c55268c55467c65665c75864c85a63c85c62c95e60ca605fcb635ecb655ccc675bcd695acd6c58ce6e"
    "57cf7056d07354d07553d17751d17a50d27c4ed37f4dd3814bd48449d58648d58946d68b45d68e43d79041d79340d8953ed8"
    "983cd99b3bd99d39daa037daa236dba534dba832dcaa30dcad2fddb02dddb22bdeb529deb828deba26dfbd25dfc023dfc221"
    "e0c520e0c81fe1ca1de1cd1ce1d01be2d21ae2d519e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1ce5ef"
    "1de5f11ee6f420e6f621e6f823e7fb25e7fd"
)
_BLUES_BGR = bytes.fromhex(
    "fffbf7fffaf6fefaf5fef9f5fef9f4fef8f3fdf8f2fdf7f2fdf7f1fdf6f0fcf6effcf5eefcf5eefcf4edfbf4ecfbf3ebfbf3"
    "eafbf2eafaf2e9faf1e8faf1e7faf0e7f9f0e6f9efe5f9efe4f9eee3f8eee3f8ede2f8ede1f8ece0f7ecdff7ebdff7ebdef7"
    "eaddf6eadcf6e9dcf6e9dbf6e8daf5e8d9f5e7d9f5e7d8f5e6d7f4e6d6f4e5d6f4e5d5f4e4d4f3e4d3f3e3d3f3e3d2f3e2d1"
    "f2e2d0f2e1d0f2e1cff2e0cef1e0cdf1dfcdf1dfccf1decbf0decaf0ddcaf0ddc9f0dcc8efdcc7efdbc7efdbc6eedac4eeda"
    "c3eed9c2edd9c1edd8bfecd8beecd7bdebd7bcebd6baead6b9ead5b8ead4b7e9d4b5e9d3b4e8d3b3e8d2b2e7d2b0e7d1afe7"
    "d1aee6d0ade6d0abe5cfaae5cfa9e4cea8e4cea6e3cda5e3cca4e3cca3e2cba1e2cba0e1ca9fe1ca9de1c99ce0c89ae0c799"
    "dfc697dfc595dfc494dec492dec391dec28fddc18dddc08cddbf8adcbe89dcbd87dcbc85dbbc84dbbb82dbba81dab97fdab8"
    "7ddab77cd9b67ad9b579d9b577d8b475d8b374d8b272d7b171d7b06fd7af6dd6ae6cd6ae6ad5ad69d5ac68d4ab66d4aa65d3"
    "a964d3a863d2a761d2a760d1a65fd1a55dd0a45cd0a35bcfa25acfa158cea057cea056cd9f54cd9e53cc9d52cc9c51cb9b4f"
    "cb9a4eca994dca984bc9984ac99749c89648c89546c79445c79344c69242c69141c59040c58f3fc48e3ec48d3dc38c3cc28b"
    "3bc28a3ac18939c18838c08737c08636bf8535bf8434be8333be8232bd8131bd8030bc7f2fbc7e2ebb7d2dba7c2cba7b2bb9"
    "7a2ab97929b87727b87626b77525b77424b67323b67222b57121b47020b46f20b36e1fb26d1eb16c1db06b1cb06a1caf691b"
    "ae681aad6719ad6619ac6518ab6417aa6316a96215a96115a86014a75f13a65e12a65d12a55c11a45b10a35a0fa2590ea258"
    "0ea1570da0560c9f550b9e540a9e530a9d52099c51089b5008994f08984e08964d08954c08934b08914a089049088e48088d"
    "47088b46088a4508884408874308854208844108824008813e087f3d087d3c087c3b087a3a08793908773808763708743608"
    "7335087134087033086e32086d31086b3008"
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


def _text(img: np.ndarray, label: str, x: int, y_top: int, k: int, clip=None, color=(255, 255, 255)) -> None:
    """`label` in `color`, glyph cells 8 x 10 scaled by k, advancing 7k,
    from (x, y_top), clipped to the box `clip` = (x0, y0, x1, y1) and to
    the image."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = clip if clip is not None else (0, 0, w - 1, h - 1)
    for i, ch in enumerate(label):
        c = ord(ch) - 32 if 32 <= ord(ch) < 127 else 31
        bits = np.unpackbits(np.frombuffer(_GLYPHS[10 * c:10 * c + 10], np.uint8)).reshape(10, 8).astype(bool)
        if k > 1:
            bits = bits.repeat(k, 0).repeat(k, 1)
        gx, gy = x + i * 7 * k, y_top
        ys, xs = np.nonzero(bits)
        ys, xs = ys + gy, xs + gx
        keep = (xs >= max(x0, 0)) & (xs <= min(x1, w - 1)) & (ys >= max(y0, 0)) & (ys <= min(y1, h - 1))
        img[ys[keep], xs[keep]] = color


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
    format its suffix names (`data/image_io.py:imwrite`: JPEG, PNG, BMP,
    TIFF or lossless WebP)."""
    from tamtr_torch.data.image_io import imread, imwrite

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    for r in results:
        out = annotate_image(imread(r["path"]), r["boxes"], r["scores"], r["labels"], r["names"])
        imwrite(save_dir / Path(r["path"]).name, out)


def batch_label_box(label: str, x1: int, y1: int) -> tuple:
    """(x0, y0, x1, y1) inclusive that `plot_images` draws a box's label in:
    scale-1 glyphs whose baseline sits where cv2.putText's does, at
    (x1, max(y1 - 2, 8))."""
    base = max(y1 - 2, 8)
    return x1, base - 8, x1 + 7 * len(label), base + 1


def plot_images(images: np.ndarray, batch_idx: np.ndarray, cls: np.ndarray, bboxes: np.ndarray,
                names: Optional[List[str]] = None, save_path=None, max_subplots: int = 16) -> np.ndarray:
    """The training-batch mosaic (`tamtr_tpu/utils/plotting.py:86-128`).

    images (B, H, W, 3) RGB, float in [0, 1] or uint8; bboxes normalized
    cxcywh; batch_idx maps each box to its image. Up to `max_subplots`
    images on a square grid over white, each BGR, its boxes drawn 1 px wide
    in the class colour and labelled with the class name in the same colour
    (the bitmap font, where JAX's cv2 draws FONT_HERSHEY_SIMPLEX at 0.3).
    Returns the BGR mosaic, and writes it to `save_path` if given."""
    bs = min(len(images), max_subplots)
    ns = int(np.ceil(bs ** 0.5))
    h, w = images.shape[1:3]
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    cls, bboxes = np.asarray(cls), np.asarray(bboxes)
    pal = _palette(int(cls.max()) + 1 if len(cls) else 1)
    for i in range(bs):
        im = np.asarray(images[i])
        if im.dtype != np.uint8:
            im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        tile = np.ascontiguousarray(im[..., ::-1])
        sel = np.asarray(batch_idx) == i
        for c, (cx, cy, bw, bh) in zip(cls[sel], bboxes[sel]):
            x1, y1 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
            x2, y2 = int((cx + bw / 2) * w), int((cy + bh / 2) * h)
            color = pal[int(c) % len(pal)]
            for e in ((x1, y1, x2, y1), (x1, y2, x2, y2), (x1, y1, x1, y2), (x2, y1, x2, y2)):
                _fill(tile, *e, color)
            label = names[int(c)] if names and int(c) < len(names) else str(int(c))
            box = batch_label_box(label, x1, y1)
            _text(tile, label, box[0], box[1], 1, box, color)
        y0, x0 = (i // ns) * h, (i % ns) * w
        mosaic[y0:y0 + h, x0:x0 + w] = tile
    if save_path is not None:
        from tamtr_torch.data.image_io import imwrite

        imwrite(save_path, mosaic)
    return mosaic


# plot_results' canvas: a panel per column, four to a row, each 480 x 360
# px (JAX's matplotlib figure: 4 x 3 inches a panel at 120 dpi); the axes
# box inside a panel, (x0, y0, x1, y1) inclusive
PANEL_W, PANEL_H, PANEL_COLS = 480, 360, 4
AXES = (70, 40, 465, 320)
CURVE_BGR = (180, 119, 31)  # matplotlib's first line colour, #1f77b4


def _limits(v: np.ndarray) -> tuple:
    lo, hi = float(v.min()), float(v.max())
    pad = 0.05 * (hi - lo) if hi > lo else max(abs(lo), 1.0) * 0.05
    return lo - pad, hi + pad


def panel_xy(i: int, x, y, xlim: tuple, ylim: tuple):
    """Pixel (column, row) of data point (x, y) in panel i of
    `plot_results`, whose axes span xlim and ylim."""
    ox, oy = (i % PANEL_COLS) * PANEL_W, (i // PANEL_COLS) * PANEL_H
    ax0, ay0, ax1, ay1 = AXES
    px = ox + ax0 + np.round((np.asarray(x, np.float64) - xlim[0]) / (xlim[1] - xlim[0]) * (ax1 - ax0))
    py = oy + ay1 - np.round((np.asarray(y, np.float64) - ylim[0]) / (ylim[1] - ylim[0]) * (ay1 - ay0))
    return px.astype(int), py.astype(int)


def _line(img: np.ndarray, xa: int, ya: int, xb: int, yb: int, color, half: int = 1) -> None:
    """A line 2 * half + 1 px wide from (xa, ya) to (xb, yb)."""
    n = max(abs(xb - xa), abs(yb - ya), 1)
    t = np.linspace(0.0, 1.0, n + 1)
    for x, y in zip(np.round(xa + t * (xb - xa)).astype(int), np.round(ya + t * (yb - ya)).astype(int)):
        _fill(img, x - half, y - half, x + half, y + half, color)


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def results_series(csv_path) -> Dict[str, np.ndarray]:
    """Each results.csv column as floats, an empty cell 0 (as JAX reads
    it), "epoch" first."""
    import csv

    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    return {k: np.array([float(r[k] or 0) for r in rows]) for k in rows[0]}


def plot_results(csv_path, save_path=None) -> Optional[np.ndarray]:
    """The training curves of a results.csv (`tamtr_tpu/utils/plotting.py:
    60-84`): one panel per column but "epoch", four to a row, each its
    column's values over the epochs as a line with a dot at each epoch,
    titled with the column's name, with the first and last epoch and the
    smallest and largest value written on the axes. Written to `save_path`
    (`results.png` beside the CSV by default) and returned; None for a CSV
    without rows."""
    from tamtr_torch.data.image_io import imwrite

    series = results_series(csv_path)
    if not series:
        return None
    epochs = series.pop("epoch")
    rows = (len(series) + PANEL_COLS - 1) // PANEL_COLS
    img = np.full((max(rows, 1) * PANEL_H, PANEL_COLS * PANEL_W, 3), 255, np.uint8)
    xlim = _limits(epochs)
    ax0, ay0, ax1, ay1 = AXES
    for i, (k, v) in enumerate(series.items()):
        ox, oy = (i % PANEL_COLS) * PANEL_W, (i // PANEL_COLS) * PANEL_H
        ylim = _limits(v)
        for e in ((ax0, ay0, ax1, ay0), (ax0, ay1, ax1, ay1), (ax0, ay0, ax0, ay1), (ax1, ay0, ax1, ay1)):
            _fill(img, ox + e[0], oy + e[1], ox + e[2], oy + e[3], (0, 0, 0))
        _text(img, k, ox + (ax0 + ax1 - 14 * len(k)) // 2, oy + 8, 2, color=(0, 0, 0))
        _text(img, _fmt(v.max()), ox + 4, oy + ay0 + 2, 1, color=(0, 0, 0))
        _text(img, _fmt(v.min()), ox + 4, oy + ay1 - 10, 1, color=(0, 0, 0))
        _text(img, _fmt(epochs[0]), ox + ax0, oy + ay1 + 6, 1, color=(0, 0, 0))
        last = _fmt(epochs[-1])
        _text(img, last, ox + ax1 - 7 * len(last), oy + ay1 + 6, 1, color=(0, 0, 0))
        px, py = panel_xy(i, epochs, v, xlim, ylim)
        for j in range(len(px) - 1):
            _line(img, px[j], py[j], px[j + 1], py[j + 1], CURVE_BGR)
        for x, y in zip(px, py):
            _fill(img, x - 2, y - 2, x + 2, y + 2, CURVE_BGR)
    imwrite(save_path or Path(csv_path).with_name("results.png"), img)
    return img


def feature_visualization(feats, save_dir, stage: str = "", max_channels: int = 32) -> List[Path]:
    """Per-level feature-map channel grids (`tamtr_tpu/utils/plotting.py:
    131-157`): `feats` a list of (B, H, W, C) arrays; of the first image, up
    to `max_channels` channels, each scaled to [0, 1], on a square grid,
    through the VIRIDIS map as `cv2.applyColorMap` gives it; one
    `features[_<stage>]_level<i>.png` per level under `save_dir`."""
    from tamtr_torch.data.image_io import imwrite

    lut = np.frombuffer(_VIRIDIS_BGR, np.uint8).reshape(256, 3)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    out_paths = []
    for li, f in enumerate(feats):
        f = np.asarray(f)[0]
        n = min(max_channels, f.shape[-1])
        ns = int(np.ceil(n ** 0.5))
        h, w = f.shape[:2]
        grid = np.zeros((ns * h, ns * w), np.float32)
        for c in range(n):
            ch = f[..., c]
            lo, hi = ch.min(), ch.max()
            grid[(c // ns) * h:(c // ns + 1) * h, (c % ns) * w:(c % ns + 1) * w] = (ch - lo) / (hi - lo + 1e-9)
        p = save_dir / f"features{('_' + stage) if stage else ''}_level{li}.png"
        imwrite(p, lut[(grid * 255).astype(np.uint8)])
        out_paths.append(p)
    return out_paths


def _label_image(label: str, k: int = 1) -> np.ndarray:
    """`label` in black on white, as its own small image."""
    img = np.full((10 * k, 7 * k * len(label) + k, 3), 255, np.uint8)
    _text(img, label, 0, 0, k, color=(0, 0, 0))
    return img


def _paste(canvas: np.ndarray, img: np.ndarray, x: int, y: int) -> None:
    h, w = img.shape[:2]
    canvas[y:y + h, x:x + w] = img


def plot_confusion_matrix(matrix: np.ndarray, save_path=None, names: Sequence[str] = (),
                          background: bool = True) -> np.ndarray:
    """A confusion matrix [predicted, true] as JAX's `ConfusionMatrix.plot`
    draws it (`tamtr_tpu/utils/metrics.py:277-301`): each column divided by
    its sum, a Blues heat map over [0, 1] (matplotlib's map), the class
    names (and "background") along both axes when they match its size, the
    true classes across ("True") and the predicted down ("Predicted"), and
    a colour bar. Returned (BGR), and written to `save_path` if given."""
    n = matrix.shape[0]
    norm = matrix / np.maximum(matrix.sum(0, keepdims=True), 1)
    blues = np.frombuffer(_BLUES_BGR, np.uint8).reshape(256, 3)
    cell = max(12, min(48, 576 // n))
    labels = list(names) + (["background"] if background else [])
    if len(labels) != n:
        labels = []
    lab = max((len(s) for s in labels), default=0) * 7 + 8
    left, top = 30 + lab, 20
    size = n * cell
    canvas = np.full((top + size + lab + 30, left + size + 90, 3), 255, np.uint8)
    idx = np.clip((norm * 256).astype(int), 0, 255)
    heat = blues[idx].repeat(cell, 0).repeat(cell, 1)
    _paste(canvas, heat, left, top)
    for i, s in enumerate(labels):
        li = _label_image(s)
        _paste(canvas, li, left - 4 - li.shape[1], top + i * cell + (cell - 10) // 2)  # predicted, down
        lv = np.rot90(li)  # true, across, read bottom to top
        _paste(canvas, lv, left + i * cell + (cell - lv.shape[1]) // 2, top + size + 4)
    true_t = _label_image("True")
    _paste(canvas, true_t, left + (size - true_t.shape[1]) // 2, canvas.shape[0] - 16)
    pred_t = np.rot90(_label_image("Predicted"))
    _paste(canvas, pred_t, 6, top + max((size - pred_t.shape[0]) // 2, 0))
    bar = blues[::-1][np.linspace(0, 255, size).astype(int)][:, None].repeat(16, 1)
    bx = left + size + 16
    _paste(canvas, bar, bx, top)
    _paste(canvas, _label_image("1.0"), bx + 20, top)
    _paste(canvas, _label_image("0.0"), bx + 20, top + size - 10)
    if save_path is not None:
        from tamtr_torch.data.image_io import imwrite

        imwrite(save_path, canvas)
    return canvas
