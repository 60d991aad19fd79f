"""The port's TIFF and WebP writers (`tamtr_torch/data/image_io.py:encode_tiff`,
`encode_webp`; `csrc/tiff_encode.cpp`, `csrc/webp_encode.cpp`) against cv2,
as the JAX package writes images (`tamtr_tpu/utils/patches.py:imwrite`), on
the CPU.

- TIFF: `imencode(".tif" | ".tiff")` is byte-equal to `cv2.imencode` (libtiff
  through OpenCV), which writes one little-endian page, LZW with the
  horizontal predictor, in strips of `max(1, min(H, 8192 // (W * C)))` rows.
  The cases reach each branch of libtiff's LZW coder: noise fills the code
  table inside an 8 KB strip (a Clear code mid-strip), a 3500-px row passes
  the compression-ratio checkpoint (10000 input bytes) once, and a 7000-px
  row, flat then noisy, passes it twice and is cleared there because the
  ratio fell. The layout facts are checked on cv2's own files.
- WebP: `imencode(".webp")` writes lossless VP8L, as cv2 does with no
  parameters; cv2 and `decode_webp` decode it to the input exactly, in at
  most 1.5x cv2's bytes.
- The refusals: lossy WebP, a side above 16383, float or 4-channel input.
- `TAMTR.predict(save=True)` over `.webp`, `.tif` and `.tiff` sources writes
  each plot under the source's name: the TIFF bytes those of
  `cv2.imencode` of the plot, the WebP decoding to it.
"""

import importlib.util
import shutil
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tamtr_torch.data import image_io

from torch_engine_data import IMG, NAMES, NC, one_thread, spread_tamtr, unit_text  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
RATIO = 1.5  # WebP bytes at most this many times cv2's


def tool():
    """`tools/make_image_fixtures_torch.py` as a module (`scene`)."""
    path = REPO / "tools" / "make_image_fixtures_torch.py"
    spec = importlib.util.spec_from_file_location("make_image_fixtures_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ratio_row(w: int, seed: int) -> np.ndarray:
    """(2, w, 3): a flat left half, then values in {0, 60, 120, 180}."""
    img = np.zeros((2, w, 3), np.uint8)
    img[:, w // 2:] = np.random.default_rng(seed).integers(0, 4, (2, w - w // 2, 3)) * 60
    return img


def tiff_case(name: str) -> np.ndarray:
    t, rng = tool(), np.random.default_rng(7)
    return {
        "1x1": lambda: rng.integers(0, 256, (1, 1, 3), np.uint8),
        "1x1_gray": lambda: rng.integers(0, 256, (1, 1), np.uint8),
        "odd": lambda: t.scene(31, 33, 1),
        "gray": lambda: t.scene(40, 61, 2)[..., 0],
        "one_strip": lambda: t.scene(32, 40, 3),
        "many_strips": lambda: t.scene(200, 300, 4),
        "noise_table_full": lambda: rng.integers(0, 256, (64, 96, 3), np.uint8),
        "smooth": lambda: cv2.GaussianBlur(rng.integers(0, 256, (120, 160, 3), np.uint8), (0, 0), 5),
        "checkpoint_3500": lambda: t.scene(2, 3500, 5),
        "ratio_clear_7000": lambda: ratio_row(7000, 8),
        "short_counts": lambda: t.scene(40, 691, 6),
        "short_counts_inline": lambda: t.scene(2, 2000, 7),
    }[name]()


TIFF_CASES = ["1x1", "1x1_gray", "odd", "gray", "one_strip", "many_strips", "noise_table_full", "smooth",
              "checkpoint_3500", "ratio_clear_7000", "short_counts", "short_counts_inline"]


@pytest.mark.parametrize("ext", [".tif", ".tiff"])
@pytest.mark.parametrize("case", TIFF_CASES)
def test_tiff_bytes_equal_cv2(case, ext):
    img = tiff_case(case)
    want = cv2.imencode(ext, img)[1].tobytes()
    assert want == cv2.imencode(".tif", img)[1].tobytes()  # either suffix, the same file
    assert image_io.imencode(ext, img) == want
    assert image_io.encode_tiff(img) == want


def _ifd(data: bytes):
    """[(tag, type, count, value or offset)] of a little-endian TIFF's IFD."""
    (at,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, at)
    return at, [struct.unpack_from("<HHII", data, at + 2 + 12 * k) for k in range(n)]


@pytest.mark.parametrize("shape,rows,strips", [((32, 40, 3), 32, 1), ((765, 1360, 3), 2, 383),
                                               ((765, 1360), 6, 128), ((640, 640, 3), 4, 160)])
def test_cv2_tiff_layout(shape, rows, strips):
    """What `encode_tiff` reproduces, read off cv2's file: "II", 12 tags in
    order, LZW (5) with Predictor 2, RGB (2) for BGR input and MinIsBlack
    (1) for gray, chunky, unsigned; strips from byte 8, then the IFD, then
    BitsPerSample, StripByteCounts, StripOffsets and SampleFormat."""
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    data = cv2.imencode(".tif", img)[1].tobytes()
    assert data[:4] == b"II*\0"
    at, entries = _ifd(data)
    tags = {t: (ty, n, v) for t, ty, n, v in entries}
    assert [t for t, *_ in entries] == [256, 257, 258, 259, 262, 273, 277, 278, 279, 284, 317, 339]
    c = 3 if len(shape) == 3 else 1
    assert tags[259][2] == 5 and tags[317][2] == 2 and tags[284][2] == 1 and tags[262][2] == (2 if c == 3 else 1)
    assert tags[278][2] == rows == max(1, min(shape[0], 8192 // (shape[1] * c))) and tags[273][1] == strips
    first_strip = tags[273][2] if strips == 1 else struct.unpack_from("<I", data, tags[273][2])[0]
    assert first_strip == 8 and at > 8
    out_of_line = [tags[t][2] for t in (258, 279, 273, 339) if tags[t][1] * (2 if tags[t][0] == 3 else 4) > 4]
    assert out_of_line == sorted(out_of_line) and out_of_line[0] == at + 2 + 12 * 12 + 4
    assert image_io.encode_tiff(img) == data


@pytest.mark.parametrize("case", ["odd", "ratio_clear_7000"])
def test_tiff_equals_jax_imwrite(case, tmp_path):
    """The file the JAX package's `patches.imwrite` writes, read back."""
    from tamtr_tpu.utils.patches import imwrite as jax_imwrite

    img = tiff_case(case)
    assert jax_imwrite(str(tmp_path / "jax.tif"), img)
    assert image_io.imwrite(tmp_path / "port.tif", img)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()


def plot_on_flat() -> np.ndarray:
    """A flat-colour frame with boxes and labels drawn by `annotate_image`."""
    from tamtr_torch.utils.plotting import annotate_image

    img = np.full((120, 160, 3), (40, 90, 160), np.uint8)
    boxes = np.array([[10, 20, 70, 90], [60, 40, 150, 110], [100, 5, 140, 30]], np.float32)
    return annotate_image(img, boxes, np.array([0.91, 0.5, 0.33], np.float32), np.array([0, 1, 2]), NAMES)


def webp_case(name: str) -> np.ndarray:
    t, rng = tool(), np.random.default_rng(9)
    return {
        "1x1": lambda: rng.integers(0, 256, (1, 1, 3), np.uint8),
        "odd": lambda: t.scene(31, 33, 1),
        "gray": lambda: t.scene(40, 61, 2)[..., 0],
        "noise": lambda: rng.integers(0, 256, (64, 96, 3), np.uint8),
        "flat_plot": plot_on_flat,
        "scene": lambda: t.scene(120, 160, 3),
    }[name]()


@pytest.mark.parametrize("case", ["1x1", "odd", "gray", "noise", "flat_plot", "scene"])
def test_webp_decodes_to_the_input(case):
    img = webp_case(case)
    bgr = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)  # gray is written as BGR
    data = image_io.imencode(".webp", img)
    assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8L" and struct.unpack_from("<I", data, 4)[0] == len(data) - 8
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), bgr)
    np.testing.assert_array_equal(image_io.decode_webp(data), bgr)
    want = cv2.imencode(".webp", img)[1]
    assert len(data) <= RATIO * want.size, (len(data), want.size)


def test_random_webp_round_trips():
    """Random sizes and kinds (noise, blur, few colours, flat, stripes with
    specks) decode back exactly through cv2 and `decode_webp`."""
    rng = np.random.default_rng(3)
    for i in range(24):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        kind = i % 6
        if kind == 0:
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
        elif kind == 1:
            img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (0, 0), 2)
        elif kind == 2:
            k = int(rng.choice([1, 2, 3, 5, 17, 256, 257]))
            img = rng.integers(0, 256, (k, 3), np.uint8)[rng.integers(0, k, (h, w))]
        elif kind == 3:
            img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        elif kind == 4:
            img = np.repeat(rng.integers(0, 256, (1, w, 3), np.uint8), h, 0)
            img[rng.random((h, w)) < 0.05] = 255
        else:
            img = rng.integers(0, 256, (h, w), np.uint8)
        bgr = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
        data = image_io.encode_webp(img)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), bgr)
        np.testing.assert_array_equal(image_io.decode_webp(data), bgr)


def test_cv2_webp_modes():
    """What `encode_webp` follows, read off cv2: no parameters and quality
    above 100 write VP8L, 1-100 lossy VP8; a side of 16384 fails."""
    img = tool().scene(20, 30, 0)
    assert cv2.imencode(".webp", img)[1].tobytes()[12:16] == b"VP8L"
    for q, tag in ((1, b"VP8 "), (100, b"VP8 "), (101, b"VP8L")):
        assert cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])[1].tobytes()[12:16] == tag
    assert cv2.imencode(".webp", np.zeros((1, 16383, 3), np.uint8))[0]
    try:
        ok = cv2.imencode(".webp", np.zeros((1, 16384, 3), np.uint8))[0]
    except cv2.error:
        ok = False
    assert not ok


def test_refusals_name_the_file(tmp_path):
    img = tool().scene(12, 16, 0)
    path = tmp_path / "lossy.webp"
    for q in (1, 80, 100):
        with pytest.raises(NotImplementedError, match="lossy") as e:
            image_io.imwrite(path, img, webp_quality=q)
        assert str(path) in str(e.value)
    assert not path.exists()
    assert image_io.imwrite(path, img, webp_quality=101)  # above 100: lossless, as cv2
    np.testing.assert_array_equal(image_io.imread(path), img)
    big = tmp_path / "big.webp"
    with pytest.raises(ValueError, match="16383") as e:
        image_io.imwrite(big, np.zeros((1, 16384, 3), np.uint8))
    assert str(big) in str(e.value) and not big.exists()
    for bad in (img.astype(np.float32), np.zeros((4, 4, 4), np.uint8)):
        for ext in (".tif", ".tiff", ".webp"):
            with pytest.raises(ValueError):
                image_io.imencode(ext, bad)


def test_predict_save_writes_tiff_and_webp(tmp_path):
    """`TAMTR.predict(paths, save=True)` on the nano model at 64 px over a
    `.webp`, a `.tif` and a `.tiff` source (written by cv2, as
    `test_dataset_of_tif_and_webp_matches_jax` writes them): each plot
    under the source's name, the TIFF bytes those of cv2.imencode of
    `Results.plot()`, the WebP decoding to it. The sources go as a list:
    a directory's predict takes .jpg, .jpeg, .png, .bmp and .webp files
    only, as the JAX engine's does (`tamtr_tpu/engine/model.py:984`)."""
    from tamtr_torch.api import TAMTR

    t = tool()
    src = tmp_path / "src"
    src.mkdir()
    for i, ext in enumerate([".webp", ".tif", ".tiff"]):
        cv2.imwrite(str(src / f"{i}{ext}"), t.scene(48 + 8 * i, 64 - 4 * i, i),
                    [cv2.IMWRITE_WEBP_QUALITY, 101] if ext == ".webp" else [])
    det = TAMTR("tamtr-nano.yaml", nc=NC, device="cpu", imgsz=IMG)
    spread_tamtr(det.model)
    det.set_classes(NAMES, unit_text())
    paths = sorted(str(p) for p in src.iterdir())
    res = det.predict(paths, save=True, project=str(tmp_path), name="pred", conf=0.01)
    assert len(res) == 3 and sum(len(r) for r in res) > 0
    out = tmp_path / "pred"
    assert sorted(p.name for p in out.iterdir()) == ["0.webp", "1.tif", "2.tiff"]
    for r in res:
        name = Path(r.path).name
        plot = r.plot()
        data = (out / name).read_bytes()
        if name.endswith(".webp"):
            np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), plot)
            np.testing.assert_array_equal(image_io.imread(out / name), plot)
        else:
            assert data == cv2.imencode(Path(name).suffix, plot)[1].tobytes()
    shutil.rmtree(out)
