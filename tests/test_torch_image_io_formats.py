"""The port's WebP and TIFF readers (`tamtr_torch/data/image_io.py`,
`csrc/webp_decode.cpp`, `csrc/tiff_decode.cpp`) against cv2 as the JAX
package reads images (`tamtr_tpu.utils.patches.imread`), on the CPU.

The fixtures (`tests/torch_data/webp/`, `tests/torch_data/tiff/`, written by
`tools/make_image_fixtures_torch.py`) decode bitwise to cv2's and to the
digest in each folder's `expected.json`; `image_shape` reads their size
from the header. Random lossy and lossless WebP files of random sizes
decode bitwise too. Modes the readers leave out raise NotImplementedError
naming the file and the mode, and a small `.tif` / `.webp` dataset gives
the JAX dataset's images.
"""

import hashlib
import importlib.util
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tamtr_torch.data import image_io

DATA = Path(__file__).parent / "torch_data"
FIXTURES = [(fmt, name) for fmt in ("webp", "tiff")
            for name in sorted(json.loads((DATA / fmt / "expected.json").read_text()))]


def tool():
    """`tools/make_image_fixtures_torch.py` as a module (its TIFF writer)."""
    path = Path(__file__).resolve().parent.parent / "tools" / "make_image_fixtures_torch.py"
    spec = importlib.util.spec_from_file_location("make_image_fixtures_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fmt,name", FIXTURES)
def test_fixture_matches_cv2(fmt, name):
    from tamtr_tpu.utils.patches import imread as jax_imread

    path = DATA / fmt / name
    want = jax_imread(str(path))
    got = image_io.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    exp = json.loads((DATA / fmt / "expected.json").read_text())[name]
    assert list(got.shape) == exp["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == exp["sha256"]
    assert image_io.image_shape(path) == got.shape[:2]


@pytest.mark.parametrize("lossless", [False, True])
def test_random_webp_matches_cv2(lossless):
    rng = np.random.default_rng(int(lossless))
    for i in range(12):
        h, w = (int(v) for v in rng.integers(1, 120, 2))
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        if i % 3 == 1:
            img = cv2.GaussianBlur(img, (0, 0), 3)
        if i % 3 == 2:
            img = np.array([[0, 0, 255], [0, 200, 0], [255, 0, 0], [30, 30, 30]], np.uint8)[rng.integers(0, 4, (h, w))]
        if i % 4 == 0:
            img = np.dstack([img, rng.integers(0, 256, (h, w), np.uint8)])
        q = 101 if lossless else int(rng.choice([1, 20, 50, 75, 90, 100]))
        ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])
        np.testing.assert_array_equal(image_io.decode_webp(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_COLOR))


def test_left_out_modes_raise_naming_the_file(tmp_path):
    """Other TIFF compressions, CMYK, float samples and BigTIFF, and animated
    WebP, raise NotImplementedError naming the file and the mode; a TIFF
    turned by 90 degrees (Orientation 5-8) reads as cv2.imdecode turns it."""
    from tamtr_tpu.utils.patches import imread as jax_imread

    t = tool()
    img = t.scene(12, 16, 0)
    cases = {
        "jpeg.tif": (t.tiff_file(img, compression=7), "compression 7"),
        "cmyk.tif": (t.tiff_file(np.dstack([img, img[..., :1]]), photometric=5), "photometric interpretation 5"),
        "float.tif": (t.tiff_file(img.astype(np.uint16), bits=32), "bits per sample"),
        "big.tif": (b"II+\0" + struct.pack("<HHQ", 8, 0, 16) + bytes(16), "BigTIFF"),
    }
    anim = b"VP8X" + struct.pack("<I", 10) + bytes([0x02, 0, 0, 0]) + bytes(6)
    anim += b"ANIM" + struct.pack("<I", 6) + bytes(6)
    cases["anim.webp"] = (b"RIFF" + struct.pack("<I", 4 + len(anim)) + b"WEBP" + anim, "animated WebP")
    for name, (data, mode) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(NotImplementedError, match=mode) as e:
            image_io.imread(path)
        assert name in str(e.value)
    for o in range(5, 9):
        path = tmp_path / f"orient{o}.tif"
        path.write_bytes(t.tiff_file(img, orientation=o, rows_per_strip=5))
        np.testing.assert_array_equal(image_io.imread(path), jax_imread(str(path)))
        assert image_io.image_shape(path) == (16, 12)


def test_dataset_of_tif_and_webp_matches_jax(tmp_path):
    """A `.tif` and `.webp` (lossy and lossless) dataset through both
    packages' DetectionDataset: the val samples' images equal JAX's."""
    from tamtr_tpu.data import dataset as JD

    from tamtr_torch.data import dataset as PD

    rng = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    t = tool()
    for i, (ext, params) in enumerate([(".tif", []), (".webp", [cv2.IMWRITE_WEBP_QUALITY, 80]),
                                       (".tiff", [cv2.IMWRITE_TIFF_COMPRESSION, 32946]),
                                       (".webp", [cv2.IMWRITE_WEBP_QUALITY, 101])]):
        img = t.scene(48 + 8 * i, 64 - 4 * i, i)
        cv2.imwrite(str(tmp_path / "images" / f"{i}{ext}"), img, params)
        (tmp_path / "labels" / f"{i}.txt").write_text(
            f"{rng.integers(0, 3)} 0.5 0.5 {rng.uniform(.1, .4):.4f} {rng.uniform(.1, .4):.4f}")
    jds = JD.DetectionDataset(tmp_path / "images", imgsz=64, cache_labels=False)
    pds = PD.DetectionDataset(tmp_path / "images", imgsz=64, cache_labels=False)
    assert len(pds) == len(jds) == 4
    for i in range(4):
        ji, _, jhw, _ = jds.get_val(i)
        pi, _, phw, _ = pds.get_val(i)
        assert phw == jhw
        np.testing.assert_array_equal(pi, ji)


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_webp_exif_orientation_as_cv2(orientation):
    """A WebP's EXIF orientation is applied where cv2 applies it: the VP8X
    EXIF flag set and the chunk a bare TIFF header; not behind an
    "Exif\\0\\0" prefix, nor without the flag."""
    t = tool()
    for q in (101, 70):
        ok, buf = cv2.imencode(".webp", t.scene(20, 30, orientation), [cv2.IMWRITE_WEBP_QUALITY, q])
        data = t.with_exif(buf.tobytes(), orientation)
        at = data.index(b"EXIF")
        (n,) = struct.unpack_from("<I", data, at + 4)
        payload = b"Exif\0\0" + data[at + 8:at + 8 + n]
        prefixed = data[:at] + b"EXIF" + struct.pack("<I", len(payload)) + payload
        prefixed = prefixed[:4] + struct.pack("<I", len(prefixed) - 8) + prefixed[8:]
        unflagged = data[:20] + bytes([0]) + data[21:]
        for v in (data, prefixed, unflagged):
            want = cv2.imdecode(np.frombuffer(v, np.uint8), cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(image_io.decode_webp(v), want)
        assert image_io.decode_webp(data).shape[:2] == ((30, 20) if orientation > 4 else (20, 30))
        assert image_io.decode_webp(prefixed).shape[:2] == (20, 30)
