"""The port's JPEG codec and BMP reader (`tamtr_torch/data/image_io.py`,
`csrc/jpeg_decode.cpp`, `csrc/jpeg_encode.cpp`) against cv2, bitwise:
`decode_jpeg` equals `cv2.imdecode(buf, cv2.IMREAD_COLOR)` at qualities 50,
75 and 95, in the 4:4:4, 4:2:2, 4:2:0 and 4:4:0 chroma modes, in gray, with
restart intervals, at 1x1, 17x33 and 1361x767, with each EXIF orientation
1-8 spliced in, and progressive (the same modes, sizes and restarts); a
progressive file whose scans stop before every coefficient is whole (which
libjpeg smooths) raises NotImplementedError naming the file; `jpeg_shape`
equals the decoded shape; the committed fixtures decode to their cv2
digests. `encode_jpeg` / `imencode(".jpg")` equal `cv2.imencode`'s bytes on
the fixtures' decodes, at odd sizes, in gray and at qualities 75, 90 and
95, and on each fixture give the digest cv2 gave. The images are smooth
gradients with edges and noise, from numpy seeds."""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from tamtr_torch.data.image_io import decode_bmp, decode_jpeg, encode_jpeg, imencode, imread, jpeg_shape

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_data" / "jpeg"
sys.path.insert(0, str(REPO / "tools"))
from make_jpeg_fixtures_torch import exif_app1, scene, splice_after_app0  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(1, 1), (17, 33), (767, 1361)]


def encode(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def cv2_decode(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def assert_bitwise(data: bytes):
    got, want = decode_jpeg(data), cv2_decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want)
    assert np.array_equal(got, want), f"{int((diff > 0).sum())} samples differ, max {diff.max()}"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("q", [50, 75, 95])
def test_colour_jpeg_matches_cv2(q, sampling, size):
    img = scene(*size, seed=q + size[1])
    assert_bitwise(encode(img, cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("q", [50, 75, 95])
def test_gray_jpeg_matches_cv2(q, size):
    """A one-component file: the gray samples repeated into 3 channels."""
    assert_bitwise(encode(scene(*size, seed=q)[..., 2], cv2.IMWRITE_JPEG_QUALITY, q))


@pytest.mark.parametrize("sampling,rst", [("420", 1), ("444", 3), ("422", 7), ("440", 2)])
def test_restart_intervals_match_cv2(sampling, rst):
    img = scene(131, 197, seed=rst)
    data = encode(img, cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    assert b"\xff\xd0" in data
    assert_bitwise(data)
    assert_bitwise(encode(img[..., 0], cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, rst))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(orientation, tmp_path):
    """An APP1 segment with the orientation tag spliced in after APP0 (big-
    and little-endian TIFF headers): the decode turned as cv2 turns it, and
    `jpeg_shape` (headers only) equal to the decoded shape."""
    base = encode(scene(23, 41, seed=orientation), cv2.IMWRITE_JPEG_QUALITY, 90)
    for big in (False, True):
        data = splice_after_app0(base, exif_app1(orientation, big_endian=big))
        assert_bitwise(data)
        path = tmp_path / f"o{orientation}{big}.jpg"
        path.write_bytes(data)
        assert jpeg_shape(path) == cv2_decode(data).shape[:2] == imread(path).shape[:2]
        assert np.array_equal(imread(path), cv2.imread(str(path), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
@pytest.mark.parametrize("q", [50, 95])
def test_progressive_jpeg_matches_cv2(q, sampling, size):
    """cv2's progressive script (DC first and refinement scans, AC spectral
    bands with successive approximation, EOB runs) in every chroma mode and
    in gray; `jpeg_shape` reads the SOF2 header."""
    img = scene(*size, seed=2 * q + size[0])
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if sampling == "gray":
        img = img[..., 1]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    data = encode(img, *params)
    assert b"\xff\xc2" in data
    assert_bitwise(data)


@pytest.mark.parametrize("sampling,rst", [("420", 1), ("444", 3), ("gray", 5)])
def test_progressive_restart_intervals_match_cv2(sampling, rst):
    img = scene(75, 131, seed=rst)
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling == "gray":
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    data = encode(img, *params)
    assert b"\xff\xd0" in data
    assert_bitwise(data)


def test_progressive_jpeg_raises_naming_the_file(tmp_path):
    """A progressive file cut after any of its scans but the last (EOI
    after it): libjpeg smooths the blocks whose first coefficients still
    miss bits, which the decoder does not do, so it raises naming the file
    and the mode; the header still gives the shape."""
    data = encode(scene(40, 48, seed=1), cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(scans) == 10
    for k in (1, 5, 9):
        path = tmp_path / f"prog{k}.jpg"
        path.write_bytes(data[:scans[k]] + b"\xff\xd9")
        with pytest.raises(NotImplementedError, match=rf"prog{k}\.jpg.*progressive"):
            imread(path)
        assert jpeg_shape(path) == (40, 48)


def test_fixtures_decode_to_their_cv2_digests():
    """The committed fixtures (`tools/make_jpeg_fixtures_torch.py`): the
    sha256 of each decode equals the one cv2 gave when they were written,
    and cv2's own decode here; `jpeg_shape` equals the decoded shape."""
    expected = json.loads((FIXTURES / "expected.json").read_text())
    assert len(expected) == 12 and sum(p.stat().st_size for p in FIXTURES.iterdir()) < 2 * 2**20
    for name, want in expected.items():
        img = imread(FIXTURES / name)
        assert list(img.shape) == want["shape"] and tuple(jpeg_shape(FIXTURES / name)) == img.shape[:2]
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], name
        assert np.array_equal(img, cv2.imread(str(FIXTURES / name), cv2.IMREAD_COLOR)), name


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 18)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_bmp_matches_cv2(size, tmp_path):
    """Uncompressed 24-bit BMP (cv2's writer for colour images), rows padded
    to 4 bytes; a WebP of the same image reads as cv2 reads it (the WebP
    reader's own cases are in `tests/test_torch_image_io_formats.py`)."""
    img = scene(*size, seed=size[1])
    path = tmp_path / "a.bmp"
    cv2.imwrite(str(path), img)
    assert np.array_equal(imread(path), cv2.imread(str(path), cv2.IMREAD_COLOR))
    assert np.array_equal(decode_bmp(path.read_bytes()), img)
    webp = tmp_path / "a.webp"
    cv2.imwrite(str(webp), img)
    assert np.array_equal(imread(webp), cv2.imread(str(webp), cv2.IMREAD_COLOR))


def assert_same_bytes(got: bytes, want: bytes):
    """Equal bytes, or the first differing offset and the decodes' largest
    pixel difference."""
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        diff = np.abs(cv2_decode(got).astype(int) - cv2_decode(want)).max() if len(got) > first else None
        raise AssertionError(f"{len(got)} vs {len(want)} bytes, first difference at {first}, pixels off by {diff}")


@pytest.mark.parametrize("name", sorted(json.loads((FIXTURES / "expected.json").read_text())))
def test_encode_jpeg_fixtures_match_cv2(name):
    """Each fixture's decode encoded at the default quality 95: cv2's bytes,
    and the digest `expected.json` records for the card's machine."""
    img = imread(FIXTURES / name)
    got = encode_jpeg(img)
    assert_same_bytes(got, cv2.imencode(".jpg", img)[1].tobytes())
    assert hashlib.sha256(got).hexdigest() == json.loads((FIXTURES / "expected.json").read_text())[name][
        "imencode_sha256"]


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (33, 65), (9, 17), (16, 16)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("q", [75, 90, 95])
def test_encode_jpeg_matches_cv2(q, size, gray):
    """Odd sizes (edge replication, dummy blocks of the 4:2:0 MCU) and gray
    input (one component), through `imencode` and each JPEG suffix."""
    img = scene(*size, seed=q + 3 * size[0])
    if gray:
        img = np.ascontiguousarray(img[..., 2])
    want = encode(img, cv2.IMWRITE_JPEG_QUALITY, q)
    assert_same_bytes(encode_jpeg(img, q), want)
    for ext in (".jpg", ".JPEG", ".jpe"):
        assert imencode(ext, img, q) == want
