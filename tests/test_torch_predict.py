"""The port's predict from files (`Engine.predict`, `TAMTR.predict(source)`,
`engine/results.py`, `utils/plotting.py`, `data/loaders.py`) against the
JAX package's on the CPU: the JAX nano model (spread head weights, from
`tests/torch_engine_data.py`) bridged into the port by
`load_jax_variables`, the same class texts, a directory of JPEG and PNG
images of several sizes at imgsz 64.

- Detections, without and with TTA, equal JAX's as a set at 1e-3 (each
  image's rows of normalized box, score and label paired by a min-cost
  assignment, as `test_whole_model_eval_matches_jax` pairs them).
- For the same detections, `save_txt` and `tojson` are byte-equal to
  JAX's, and `plot` is equal to JAX's outside bands of `lw + 2` px around
  each box edge and each label box (JAX's and the port's).
- `load_inference_source` yields JAX's names and frames; webcam indices
  and the containers the port does not read raise, a screen without `mss`
  raises JAX's ImportError.
- `save` writes the name and the format JAX's writes for the same path:
  `.jpg`/`.jpeg`/`.bmp` bytes equal `cv2.imencode` of the port's own plot,
  `.png` reads back as the plot.
- `Engine.track` over a directory of JPEG frames: track ids equal JAX's and
  boxes at 1e-3, with `bytetrack` and with `botsort` (GMC "none", ReID).
"""

import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from tamtr_torch.api import TAMTR
from tamtr_torch.engine.results import Results

from torch_engine_data import HD, IMG, NAMES, NC, jax_nano_session, one_thread, unit_text  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_data" / "jpeg"


@pytest.fixture(scope="module")
def jax_nano(tmp_path_factory):
    return jax_nano_session(tmp_path_factory)


@pytest.fixture(scope="module")
def txt():
    return unit_text()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """3 committed JPEG fixtures (4:2:0, gray, EXIF-rotated) and 2 PNGs of
    other sizes, one in a subdirectory."""
    root = tmp_path_factory.mktemp("predict_src")
    for name in ("s420_q75.jpg", "gray_q85.jpg", "exif6_q90.jpg"):
        shutil.copy(FIXTURES / name, root / name)
    (root / "sub").mkdir()
    rng = np.random.default_rng(11)
    cv2.imwrite(str(root / "a.png"), rng.integers(0, 256, (48, 80, 3), dtype=np.uint8))
    cv2.imwrite(str(root / "sub" / "b.png"), rng.integers(0, 256, (70, 50, 3), dtype=np.uint8))
    return root


@pytest.fixture(scope="module")
def engines(jax_nano, txt):
    from tamtr_tpu.engine.checkpoint import InferenceState
    from tamtr_tpu.engine.model import Engine as JaxEngine

    jmodel, params, batch_stats = jax_nano
    je = JaxEngine("tamtr-nano.yaml")
    je.model = jmodel
    je.state = InferenceState(params, batch_stats)
    je.set_classes(NAMES, txt)
    det = TAMTR("tamtr-nano.yaml", nc=NC, device="cpu", imgsz=IMG).load_jax_variables(params, batch_stats)
    det.set_classes(NAMES, txt)
    return je, det


def _rows(r):
    oh, ow = r.orig_shape
    b = r.boxes.xyxy / np.array([ow, oh, ow, oh], np.float32)
    return np.concatenate([b, r.boxes.conf[:, None], r.boxes.cls[:, None].astype(np.float32)], 1)


@pytest.mark.parametrize("augment", [False, True])
def test_predict_matches_jax(engines, source, augment):
    je, det = engines
    want = je.predict(str(source), imgsz=IMG, augment=augment)
    got = det.predict(str(source), augment=augment)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 5
    assert sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape and len(g) == len(w), g.path
        if not len(w):
            continue
        gr, wr = _rows(g), _rows(w)
        dist = np.abs(gr[:, None] - wr[None]).max(-1)
        r, c = linear_sum_assignment(dist)
        assert dist[r, c].max() < 1e-3, (g.path, dist[r, c].max())
        np.testing.assert_array_equal(gr[r, 5], wr[c, 5])


def test_predict_save_writes_the_source_name_and_format(engines, source, tmp_path):
    """save=True writes each plot under project/name with the source's own
    name, in its format (JPEG bytes those of cv2.imencode, as the JAX
    engine writes them); without it nothing is written."""
    from tamtr_torch.data.image_io import imread

    _, det = engines
    res = det.predict(str(source), save=True, project=str(tmp_path), name="pred")
    out = sorted(p.name for p in (tmp_path / "pred").iterdir())
    assert out == sorted(Path(r.path).name for r in res)
    a = next(r for r in res if r.path.endswith("a.png"))
    np.testing.assert_array_equal(imread(tmp_path / "pred" / "a.png"), a.plot())
    g = next(r for r in res if r.path.endswith("gray_q85.jpg"))
    assert (tmp_path / "pred" / "gray_q85.jpg").read_bytes() == cv2.imencode(".jpg", g.plot())[1].tobytes()
    det.predict(str(source / "a.png"), project=str(tmp_path), name="nosave")
    assert not (tmp_path / "nosave").exists()


def _same_detections(engines, source):
    """A port `Results` and a JAX `Results` of the JAX engine's detections
    on the EXIF-rotated fixture."""
    from tamtr_tpu.engine.results import Results as JaxResults

    je, _ = engines
    w = je.predict(str(source / "exif6_q90.jpg"), imgsz=IMG, conf=0.1)[0]
    args = (w.path, w.boxes.xyxy, w.boxes.conf, w.boxes.cls, NAMES)
    return Results(*args, orig_shape=w.orig_shape), JaxResults(*args, orig_shape=w.orig_shape)


def test_save_annotated_writes_each_plot(engines, source, tmp_path):
    """`save_annotated` writes each result's plot under the source's name,
    in its format (here JPEG: cv2.imencode's bytes of the plot)."""
    from tamtr_torch.utils.plotting import save_annotated

    port, _ = _same_detections(engines, source)
    save_annotated([{k: port[k] for k in ("path", "boxes", "scores", "labels", "names")}], tmp_path)
    assert (tmp_path / "exif6_q90.jpg").read_bytes() == cv2.imencode(".jpg", port.plot())[1].tobytes()


@pytest.mark.parametrize("suffix", [".jpg", ".jpeg", ".png", ".bmp"])
def test_results_save_writes_what_jax_writes(engines, source, tmp_path, suffix):
    """`Results.save(path)` writes at `path`, as the JAX package's does, in
    the same format; the JPEG and BMP bytes are cv2.imencode's of the
    port's plot, the PNG reads back as the plot."""
    from tamtr_torch.data.image_io import imread

    port, jax_r = _same_detections(engines, source)
    got = port.save(tmp_path / "port" / f"x{suffix}")
    jax_r.save(tmp_path / "jax" / f"x{suffix}")
    assert got == tmp_path / "port" / f"x{suffix}"
    assert [p.name for p in (tmp_path / "port").iterdir()] == [p.name for p in (tmp_path / "jax").iterdir()]
    magic = {".jpg": b"\xff\xd8", ".jpeg": b"\xff\xd8", ".png": b"\x89PNG", ".bmp": b"BM"}[suffix]
    assert got.read_bytes()[:len(magic)] == (tmp_path / "jax" / f"x{suffix}").read_bytes()[:len(magic)] == magic
    plot = port.plot()
    if suffix == ".png":
        np.testing.assert_array_equal(imread(got), plot)
        np.testing.assert_array_equal(cv2.imread(str(got)), plot)
    else:
        assert got.read_bytes() == cv2.imencode(suffix, plot)[1].tobytes()


def test_text_outputs_byte_equal_to_jax(engines, source, tmp_path):
    port, jax_r = _same_detections(engines, source)
    assert len(port) > 2
    assert port.tojson() == jax_r.tojson()
    for conf in (False, True):
        port.save_txt(tmp_path / "p.txt", save_conf=conf)
        jax_r.save_txt(tmp_path / "j.txt", save_conf=conf)
        assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert port["scores"] is port.boxes.conf and "names" in port and "masks" not in port
    assert json.loads(port.tojson())[0]["name"] in NAMES


def test_plot_equals_jax_outside_the_bands(engines, source):
    """Outside bands of lw + 2 px around each box edge and each label box
    (JAX's, from cv2.getTextSize, and the port's), the port's plot is
    bitwise JAX's: the image itself; inside, the palette colour fills the
    port's label box."""
    from tamtr_torch.utils.plotting import _palette, text_size

    port, jax_r = _same_detections(engines, source)
    got, want = port.plot(), jax_r.plot()
    assert got.shape == want.shape
    h, w = got.shape[:2]
    lw = max(round((h + w) / 2 * 0.003), 2)
    band = lw + 2
    mask = np.zeros((h, w), bool)

    def exclude(x0, y0, x1, y1):
        xa, xb = sorted((x0, x1))
        ya, yb = sorted((y0, y1))
        mask[max(ya - band, 0):max(yb + band + 1, 0), max(xa - band, 0):max(xb + band + 1, 0)] = True

    for b, s, l in zip(port.boxes.xyxy, port.boxes.conf, port.boxes.cls):
        x1, y1, x2, y2 = (int(v) for v in b)
        for e in ((x1, y1, x2, y1), (x1, y2, x2, y2), (x1, y1, x1, y2), (x2, y1, x2, y2)):
            exclude(*e)
        label = f"{NAMES[int(l)]} {float(s):.2f}"
        tf = max(lw - 1, 1)
        for tw, th in (cv2.getTextSize(label, 0, lw / 3, tf)[0], text_size(label, lw / 3, tf)):
            exclude(x1, y1 - th - 3, x1 + tw, y1)
    assert 0.2 < mask.mean() < 0.95
    np.testing.assert_array_equal(got[~mask], want[~mask])
    b, l = port.boxes.xyxy[0], int(port.boxes.cls[0])
    assert tuple(got[int(b[1]) - 2, int(b[0]) + 1 + 1]) in (_palette(len(NAMES))[l], (255, 255, 255))


def test_load_inference_source_matches_jax(source):
    from tamtr_tpu.data.loaders import load_inference_source as jax_source

    from tamtr_torch.data.loaders import load_inference_source

    arr = np.zeros((5, 6, 3), np.uint8)
    for src in (str(source), [str(source / "a.png"), str(source / "gray_q85.jpg")], str(source / "exif6_q90.jpg"),
                arr):
        got, want = list(load_inference_source(src)), list(jax_source(src))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert [n for n, _ in load_inference_source(str(source / "*.jpg"))] == sorted(str(p) for p in source.glob("*.jpg"))
    for bad in (0, "0", "clip.mkv"):
        with pytest.raises(NotImplementedError):
            list(load_inference_source(bad))
    with pytest.raises(ImportError, match="mss"):  # a screen needs the mss package, as JAX's
        list(load_inference_source("screen"))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """8 frames of 96x128: 3 coloured boxes moving across noise, written as
    JPEG by the port's encoder (cv2's bytes)."""
    from tamtr_torch.data.image_io import imwrite

    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(12)
    start = np.array([[8, 10], [80, 30], [40, 60]])
    vel = np.array([[6, 2], [-5, 1], [3, -3]])
    colours = rng.integers(60, 256, (3, 3))
    for f in range(8):
        frame = rng.integers(0, 50, (96, 128, 3), dtype=np.uint8)
        for (x, y), c in zip(start + vel * f, colours):
            frame[y:y + 24, x:x + 30] = c
        imwrite(root / f"{f:03d}.jpg", frame)
    return root


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort"])
def test_track_matches_jax(engines, frames, tracker):
    """`TAMTR.track` over the frame directory against the JAX engine's
    `track` (both id counters reset): the same frames, track ids equal,
    tracked boxes at 1e-3, scores and classes equal at 1e-3."""
    from tamtr_tpu.trackers.byte_tracker import Track as JaxTrack

    from tamtr_torch.trackers.byte_tracker import Track

    je, det = engines
    kw = {"gmc_method": "none", "with_reid": True} if tracker == "botsort" else {}
    JaxTrack._count = 0
    want = je.track(str(frames), tracker=tracker, imgsz=IMG, conf=0.1, **dict(kw))
    Track.reset_id()
    got = det.track(str(frames), tracker=tracker, conf=0.1, **kw)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 8
    assert sum(len(r.track_ids) for r in want) > 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.track_ids, w.track_ids)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        assert g.orig_img is not None and g.orig_shape == w.orig_shape == (96, 128)
    assert set(det._engine.timing) == {"read_ms", "model_ms", "tracker_ms"}
