"""The port's data path against the JAX package's, on the CPU: PNG reading
and writing against cv2, each augmentation against JAX's on the same sample
and generator, the loader's batches against `build_loader`'s, val samples,
text embeddings, configs and dataset files.

Images: resize and HSV give cv2's bytes, flips are slices; the affine and
perspective warps sample in float32 where cv2 5 does too, and differ from
cv2's by one level on a few pixels in 10^4 (measured max 1 level, at most
0.2% of pixels; bounded here at max 1 and 0.5%). Through a whole train
pipeline (warp, then HSV on the warped bytes) a one-level difference can
grow: measured max 2 levels, at most 0.02% of pixels off by more than 1;
bounded at max 3 and 99% within one level.
"""

import collections
import json
import struct
import zlib

import cv2
import numpy as np
import pytest
import yaml

from tamtr_tpu import config as jcfg
from tamtr_tpu.data import augment as JA
from tamtr_tpu.data import dataset as JD
from tamtr_tpu.data import text as JT

from tamtr_torch import config as pcfg
from tamtr_torch.data import augment as PA
from tamtr_torch.data import dataset as PD
from tamtr_torch.data import imgproc
from tamtr_torch.data import text as PT
from tamtr_torch.data.image_io import imread, imwrite, png_shape


def _png_filters(path):
    data = open(path, "rb").read()
    p, idat, hdr = 8, b"", None
    while p < len(data):
        (n,) = struct.unpack(">I", data[p:p + 4])
        tag, body = data[p + 4:p + 8], data[p + 8:p + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        p += 12 + n
    w, h, _, ctype = hdr
    raw = zlib.decompress(idat)
    stride = w * {0: 1, 2: 3, 6: 4}[ctype] + 1
    return {raw[r * stride] for r in range(h)}


def _test_images(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    yy, xx = np.mgrid[0:h, 0:w]
    return {
        "noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "gradient": np.stack([(xx * 2) % 256, (yy * 3) % 256, (xx + yy) % 256], -1).astype(np.uint8),
        "gray": ((xx * yy) % 256).astype(np.uint8),
        "rgba": np.concatenate([rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                                ((xx + yy) % 256)[..., None].astype(np.uint8)], -1),
    }


def test_png_decodes_as_cv2(tmp_path):
    """cv2-written PNGs (gray, RGB, RGBA; odd sizes; every compression level
    and strategy) decode bitwise as `cv2.imread` reads them, and together
    use all five row filters."""
    seen = collections.Counter()
    for h, w in ((1, 1), (7, 13), (97, 131), (64, 200)):
        for kind, img in _test_images(h, w).items():
            for level, strategy in ((1, 0), (3, 1), (9, 0), (6, 2), (0, 4)):
                p = tmp_path / f"{kind}_{h}x{w}_{level}_{strategy}.png"
                cv2.imwrite(str(p), img, [cv2.IMWRITE_PNG_COMPRESSION, level, cv2.IMWRITE_PNG_STRATEGY, strategy])
                seen.update(_png_filters(p))
                got = imread(p)
                assert got.dtype == np.uint8 and got.shape == (h, w, 3)
                np.testing.assert_array_equal(got, cv2.imread(str(p)))
                assert png_shape(p) == (h, w)
    assert set(seen) == {0, 1, 2, 3, 4}, seen


def test_png_writer_reads_back_through_cv2(tmp_path):
    for kind, img in _test_images(33, 65).items():
        if kind == "rgba":
            continue
        p = tmp_path / f"{kind}.png"
        imwrite(p, img)
        np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(imread(p), cv2.imread(str(p)))


def test_image_io_edges(tmp_path):
    assert imread(tmp_path / "missing.png") is None
    (tmp_path / "empty.png").write_bytes(b"")
    assert imread(tmp_path / "empty.png") is None
    assert imread(tmp_path / "a.jpg") is None  # a missing JPEG, as any missing file
    # a JPEG mode the reader does not take: SOI, then a lossless frame header (SOF3)
    (tmp_path / "a.jpg").write_bytes(bytes.fromhex("ffd8ffc3001108001000100301220002110103110100"))
    with pytest.raises(NotImplementedError, match="JPEG"):
        imread(tmp_path / "a.jpg")
    arr = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(imread(tmp_path / "a.npy"), arr)
    with pytest.raises(ValueError):
        imwrite(tmp_path / "f.png", np.zeros((4, 4, 3), np.float32))


def _sample(rng, h=96, w=128, n=6, texts=None):
    xy = rng.uniform(0, [w * 0.7, h * 0.7], (n, 2))
    wh = rng.uniform(4, [w * 0.3, h * 0.3], (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    cls = rng.integers(0, 5, n).astype(np.int32)
    return JA.Sample(img, boxes, cls, texts=texts), PA.Sample(img.copy(), boxes.copy(), cls.copy(), texts=texts)


def _assert_labels(p, j, tol=1e-4):
    np.testing.assert_array_equal(p.cls, j.cls)
    np.testing.assert_allclose(p.boxes, j.boxes, rtol=0, atol=tol)


def _img_diff(p, j):
    d = np.abs(p.astype(np.int64) - j)
    return int(d.max()), float(d.mean()), float((d > 0).mean())


@pytest.mark.parametrize("size", [64, 160])
def test_resize_letterbox_and_flip_equal_jax(size):
    """stretch_resize and letterbox (cv2.resize INTER_LINEAR): bitwise
    (measured max 0); random_flip: bitwise; labels at 1e-4 px."""
    rng = np.random.default_rng(size)
    js, ps = _sample(rng)
    j, p = JA.stretch_resize(js, size), PA.stretch_resize(ps, size)
    _assert_labels(p, j)
    np.testing.assert_array_equal(p.img, j.img)
    (j, jr, jp), (p, pr, pp) = JA.letterbox(js, size), PA.letterbox(ps, size)
    _assert_labels(p, j)
    np.testing.assert_array_equal(p.img, j.img)
    assert (pr, pp) == (jr, jp)
    for seed in range(4):
        j = JA.random_flip(js, np.random.default_rng(seed), 0.5, 0.5)
        p = PA.random_flip(ps, np.random.default_rng(seed), 0.5, 0.5)
        _assert_labels(p, j)
        np.testing.assert_array_equal(p.img, j.img)


@pytest.mark.parametrize("seed", range(3))
def test_hsv_equals_jax(seed):
    """random_hsv (cvtColor BGR<->HSV + LUT): bitwise (measured max 0)."""
    js, ps = _sample(np.random.default_rng(seed), h=70, w=100 + seed * 47)
    j = JA.random_hsv(js, np.random.default_rng(seed))
    p = PA.random_hsv(ps, np.random.default_rng(seed))
    np.testing.assert_array_equal(p.img, j.img)
    _assert_labels(p, j, 0)


@pytest.mark.parametrize("kw", [
    dict(scale=0.9, translate=0.1),
    dict(degrees=10.0, scale=0.5, shear=3.0, translate=0.2),
    dict(perspective=0.0005, degrees=5.0, scale=0.3),
    dict(scale=0.9, translate=0.1, border=(-48, -48)),
])
def test_random_perspective_matches_jax(kw):
    """Boxes and classes at 1e-4 px; the warped image within one level of
    cv2's (measured: max 1, at most 0.2% of pixels differ)."""
    for seed in range(3):
        js, ps = _sample(np.random.default_rng(seed), h=192, w=192, n=10)
        j = JA.random_perspective(js, np.random.default_rng(seed), **kw)
        p = PA.random_perspective(ps, np.random.default_rng(seed), **kw)
        _assert_labels(p, j)
        assert p.img.shape == j.img.shape
        mx, _, frac = _img_diff(p.img, j.img)
        assert mx <= 1 and frac <= 0.005, (mx, frac)


def test_mosaics_mixup_and_labels_match_jax():
    """mosaic4, mosaic9 and mixup copy and blend bytes: bitwise; labels at
    1e-4 px; copy_paste is a no-op for box-only labels in both; the text
    sampling and the box helpers equal JAX's."""
    rng = np.random.default_rng(7)
    pairs = [_sample(rng, h=int(rng.integers(40, 90)), w=int(rng.integers(40, 90))) for _ in range(9)]
    for fn in ("mosaic4", "mosaic9"):
        j = getattr(JA, fn)([a for a, _ in pairs], 64, np.random.default_rng(1))
        p = getattr(PA, fn)([b for _, b in pairs], 64, np.random.default_rng(1))
        _assert_labels(p, j)
        np.testing.assert_array_equal(p.img, j.img)
    (j1, p1), (j2, p2) = _sample(rng), _sample(rng)
    j, p = JA.mixup(j1, j2, np.random.default_rng(2)), PA.mixup(p1, p2, np.random.default_rng(2))
    _assert_labels(p, j)
    np.testing.assert_array_equal(p.img, j.img)
    r = np.random.default_rng(3)
    assert PA.copy_paste(p1, r, 0.3) is p1 and JA.copy_paste(j1, np.random.default_rng(3), 0.3) is j1
    assert r.random() == np.random.default_rng(3).random()  # copy_paste drew nothing
    names = [["a", "aa"], ["b"], ["c", "cc", "ccc"], ["d"], ["e"]]
    for seed in range(4):
        a = JA.random_load_text(j1.cls, names, np.random.default_rng(seed), max_samples=5)
        b = PA.random_load_text(p1.cls, names, np.random.default_rng(seed), max_samples=5)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    np.testing.assert_allclose(PA.bbox_ioa(p1.boxes, p2.boxes), JA.bbox_ioa(j1.boxes, j2.boxes), atol=1e-12)
    np.testing.assert_array_equal(PA._box_candidates(p1.boxes.T, p2.boxes.T), JA._box_candidates(j1.boxes.T, j2.boxes.T))
    assert PA.albumentations_transform(p1, np.random.default_rng(0)) is p1


def test_imgproc_against_cv2():
    """The numpy cv2 operations on their own: resize bitwise for up- and
    downscales and one-pixel images; HSV bitwise on widths around its
    32-pixel blocks; getRotationMatrix2D at 1e-12."""
    rng = np.random.default_rng(0)
    for (h, w), (nw, nh) in (((97, 131), (64, 64)), ((64, 64), (131, 97)), ((1, 1), (5, 3)), ((33, 47), (33, 47))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(imgproc.resize_linear(img, (nw, nh)),
                                      cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR))
    for w in (1, 31, 32, 33, 100):
        img = rng.integers(0, 256, (9, w, 3), dtype=np.uint8)
        hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
        np.testing.assert_array_equal(imgproc.bgr2hsv(img), hsv)
        np.testing.assert_array_equal(imgproc.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    np.testing.assert_allclose(imgproc.rotation_matrix(7.5, (3.0, -2.0), 1.3),
                               cv2.getRotationMatrix2D((3.0, -2.0), 7.5, 1.3), atol=1e-12)


def _write_dataset(root, n=8, seed=0):
    """PNG images of a few sizes with YOLO labels, written by cv2."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = [(64, 64), (48, 80), (90, 60), (64, 96)][i % 4]
        cv2.imwrite(str(root / "images" / f"{i}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
        k = int(rng.integers(0 if i == 3 else 1, 12))
        lines = [f"{rng.integers(0, 3)} {rng.uniform(.25, .75):.4f} {rng.uniform(.25, .75):.4f} "
                 f"{rng.uniform(.1, .4):.4f} {rng.uniform(.1, .4):.4f}" for _ in range(k)]
        (root / "labels" / f"{i}.txt").write_text("\n".join(lines))
    return root / "images"


NAMES = [["red"], ["green", "lime"], ["blue"]]


@pytest.mark.parametrize("aug", [{}, dict(mosaic=1.0, mixup=0.5)], ids=["recipe", "mosaic-mixup"])
def test_loader_batches_match_jax(tmp_path, aug):
    """The port's Loader against JAX's build_loader, two epochs, workers 0
    and 2: cls, mask and texts equal, bboxes at 1e-5, images within the
    bounds in the module docstring."""
    images = _write_dataset(tmp_path)
    jds = JD.DetectionDataset(images, imgsz=64, augment=True, aug=JD.AugConfig(**aug), class_texts=NAMES,
                              random_text=True)
    jl = JD.build_loader(jds, 3, max_gt=6, seed=5, workers=2)
    worst = []
    for workers in (0, 2):
        pds = PD.DetectionDataset(images, imgsz=64, augment=True, aug=PD.AugConfig(**aug), class_texts=NAMES,
                                  random_text=True)
        pl = PD.Loader(pds, 3, max_gt=6, seed=5, workers=workers)
        assert len(pl) == len(jl) == 2
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            n = 0
            for jb, pb in zip(jl, pl):
                n += 1
                np.testing.assert_array_equal(pb["cls"].numpy(), jb["cls"])
                np.testing.assert_array_equal(pb["mask"].numpy(), jb["mask"])
                assert pb["texts"] == jb["texts"]
                np.testing.assert_allclose(pb["bboxes"].numpy(), jb["bboxes"], rtol=0, atol=1e-5)
                d = np.abs(pb["img"].numpy().astype(np.int64) - jb["img"])
                worst.append((int(d.max()), float((d > 1).mean())))
            assert n == 2
    assert max(w[0] for w in worst) <= 3 and max(w[1] for w in worst) <= 0.01, worst


def test_val_samples_match_jax(tmp_path):
    """get_val square and rect (after set_rectangle): image, shape and
    letterbox tuple equal JAX's; labels and truncating collate too."""
    images = _write_dataset(tmp_path)
    for rect in (False, True):
        jds = JD.DetectionDataset(images, imgsz=96, cache_labels=False)
        pds = PD.DetectionDataset(images, imgsz=96, cache_labels=False)
        if rect:
            jds.set_rectangle(3)
            pds.set_rectangle(3)
            np.testing.assert_array_equal(pds.batch_shapes, jds.batch_shapes)
            assert pds.im_files == jds.im_files
        for i in range(len(jds)):
            ji, jraw, jhw, jlb = jds.get_val(i)
            pi, praw, phw, plb = pds.get_val(i)
            assert pi.shape == ji.shape and phw == jhw and plb == jlb
            np.testing.assert_array_equal(pi, ji)
            _assert_labels(praw, jraw, 0)
    samples = [pds.get(i) for i in range(4)]
    jb = JD.collate([JA.Sample(s.img, s.boxes, s.cls) for s in samples], 3, 96)
    pb = PD.collate(samples, 3, 96)
    for k in ("img", "cls", "bboxes", "mask"):
        np.testing.assert_array_equal(pb[k], jb[k])
    assert pb["mask"].sum(1).max() == 3  # truncated, largest boxes first


def test_dataset_labels_caches_and_filters_match_jax(tmp_path):
    images = _write_dataset(tmp_path)
    for kw in ({}, dict(classes=[0, 2]), dict(single_cls=True), dict(classes=[1], single_cls=True)):
        j = JD.DetectionDataset(images, imgsz=64, **kw)
        p = PD.DetectionDataset(images, imgsz=64, **kw)  # reads the label cache JAX wrote
        for a, b in zip(p.labels, j.labels):
            np.testing.assert_array_equal(a["cls"], b["cls"])
            np.testing.assert_array_equal(a["xywhn"], b["xywhn"])
    assert list(images.parent.joinpath("labels").glob(".tamtr_labels_*.npz"))
    plain = PD.DetectionDataset(images, imgsz=64, augment=True, cache_labels=False)
    for cache in ("ram", "disk"):
        cached = PD.DetectionDataset(images, imgsz=64, augment=True, cache=cache, cache_labels=False)
        for i in range(3):
            for _ in range(2):  # a cache hit the second time
                a, b = cached.get(i, np.random.default_rng(i)), plain.get(i, np.random.default_rng(i))
                np.testing.assert_array_equal(a.img, b.img)
    assert list(images.glob("*.npy"))
    ds = PD.DetectionDataset(images, imgsz=64, augment=True, aug=PD.AugConfig(mosaic=1.0))
    ds.close_mosaic()
    a, b = ds.get(0, np.random.default_rng(0)), PA.stretch_resize(ds._read(0), 64)
    assert a.img.shape == b.img.shape == (64, 64, 3)
    assert len(a.cls) <= len(b.cls)


def test_text_embeddings_match_jax(tmp_path):
    names = ["person/pedestrian", "car", "van", ""]
    np.testing.assert_array_equal(PT.class_text_embeddings(names), JT.class_text_embeddings(names))
    rows = [["car", "a b", ""], ["van", "car", "x"]]
    np.testing.assert_array_equal(PT.TextEmbedder()(rows), JT.TextEmbedder()(rows))
    table = np.random.default_rng(0).standard_normal((2, 512)).astype(np.float32)
    np.savez(tmp_path / "t.npz", texts=np.array(["car", "van"], dtype=object), embeddings=table)
    np.savez(tmp_path / "p.npz", embeddings=table)
    for f in ("t.npz", "p.npz"):
        np.testing.assert_array_equal(PT.encode_texts(["car", "van", "bus"], tmp_path / f),
                                      JT.encode_texts(["car", "van", "bus"], tmp_path / f))
    assert PT.class_text_embeddings(["car"], dim=128).shape == (1, 128)
    with pytest.raises(ValueError, match="512-d"):
        PT.encode_texts(["car"], tmp_path / "t.npz", dim=128)


def test_config_matches_jax(tmp_path):
    assert pcfg.Config().asdict() == jcfg.Config().asdict()
    over = dict(epochs=3, lr0=0.01, classes=[0, 2], cache="ram")
    assert pcfg.get_cfg(overrides=over).asdict() == jcfg.get_cfg(overrides=over).asdict()
    body = dict(batch=2, imgsz=320, hsv_h=0.5, close_mosaic=10, fliplr=0.0, name="x y", freeze=[1, 2])
    (tmp_path / "c.json").write_text(json.dumps(body))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(body) + "# a comment\n")
    for f in ("c.json", "c.yaml"):
        assert pcfg.get_cfg(tmp_path / f, dict(epochs=2)).asdict() == jcfg.get_cfg(tmp_path / f, dict(epochs=2)).asdict()
        assert pcfg.get_cfg(overrides=dict(cfg=str(tmp_path / f))).asdict() == \
            jcfg.get_cfg(overrides=dict(cfg=str(tmp_path / f))).asdict()
    for mod in (pcfg, jcfg):
        with pytest.raises(KeyError, match="did you mean 'epochs'"):
            mod.get_cfg(overrides=dict(epoch=3))
    (tmp_path / "val").mkdir()
    files = {
        "d.json": json.dumps({"path": str(tmp_path), "train": "tr", "val": "val", "nc": 2, "names": {"0": "a", "1": "b"}}),
        "d.yaml": yaml.safe_dump({"path": str(tmp_path), "train": "tr", "validation": "val",
                                  "names": {0: "person/ped", 1: "car"}}),
        "e.yaml": f"path: {tmp_path}  # root\ntrain: tr\nval: val\nnc: 2\nnames:\n  - a\n  - 'b c'\n",
        "f.yaml": f"train: {tmp_path}/tr\nval: val\nnc: 3\n",
        "g.yaml": "train: tr\nval: nowhere\nnames: [x, y]\n",
        "h.yaml": "train: tr\nval: val\nnc: 3\nnames: [x, y]\n",
        "i.yaml": "train: tr\nnames: [x]\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
        want = got = None
        try:
            want = jcfg.load_data_yaml(tmp_path / name)
        except (SyntaxError, FileNotFoundError) as e:
            with pytest.raises(type(e)):
                pcfg.load_data_yaml(tmp_path / name)
            continue
        got = pcfg.load_data_yaml(tmp_path / name)
        assert got == want, name
