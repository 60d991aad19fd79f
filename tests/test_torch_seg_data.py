"""The port's data path for the segment and pose tasks against cv2 and the
JAX package, on the CPU: `imgproc.fill_poly` against `cv2.fillPoly` (and
`cv2.drawContours(..., FILLED)`), the float32 `resize_linear_f32` against
`cv2.resize`, `utils/instance.py` against JAX's, the three label-row forms,
the augmentations carrying polygons and keypoints, `collate`'s masks and
keypoints, and the loader's batches at 0 and 2 workers.

Bounds: the fill bitwise; the float resize bitwise against cv2 with IPP
off (OpenCV's own float path, which the port copies), and thresholded at
0.5 against cv2 as the JAX engine calls it (IPP on), counting the pixels
that differ; polygons, keypoints and boxes at 1e-4 px; images as
`tests/test_torch_data.py` bounds them (bitwise where only bytes move, the
warp within one level on at most 0.5% of pixels, the loader's within 3
levels and 99% within one level).
"""

import cv2
import numpy as np
import pytest

from tamtr_tpu.data import augment as JA
from tamtr_tpu.data import dataset as JD

from tamtr_torch.data import augment as PA
from tamtr_torch.data import dataset as PD
from tamtr_torch.data.imgproc import fill_poly, resize_linear_f32

from torch_engine_data import one_thread  # noqa: F401


def _polygons(kind: str, n_cases: int, seed: int):
    """(canvas (h, w), int32 polygon) cases of one kind."""
    rng = np.random.default_rng(seed)
    for _ in range(n_cases):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        n = int(rng.integers(3, 201)) if kind == "many_points" else int(rng.integers(3, 13))
        a = np.sort(rng.uniform(0, 2 * np.pi, n))
        c = rng.uniform(0, [w, h])
        if kind == "convex":
            r = rng.uniform(2, 40)
            p = np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)], 1)
        elif kind in ("concave", "many_points"):
            r = rng.uniform(2, 40, n)
            p = np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)], 1)
        elif kind == "self_touching":  # a vertex visited twice, and crossing edges
            p = rng.uniform(0, [w, h], (n, 2))
            p = np.concatenate([p, p[:1], rng.uniform(0, [w, h], (3, 2))])
        else:  # "outside": vertices far off the canvas on every side
            p = rng.uniform(-3 * max(h, w), 4 * max(h, w), (n, 2))
        yield (h, w), p.astype(np.int32)


@pytest.mark.parametrize("kind", ["convex", "concave", "self_touching", "outside", "many_points"])
def test_fill_poly_equals_cv2(kind):
    """`fill_poly` bitwise `cv2.fillPoly(img, [poly], value)` on a float32
    mask (collate, val's gt) and `cv2.drawContours(img, [poly], -1, value,
    FILLED)` on a uint8 image (copy_paste), 300 polygons of each kind."""
    for (h, w), p in _polygons(kind, 300, ["convex", "concave", "self_touching", "outside"].index(kind)
                               if kind != "many_points" else 9):
        want = np.zeros((h, w), np.float32)
        cv2.fillPoly(want, [p], 1.0)
        np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.float32), p, 1.0), want, err_msg=str(p))
        want3 = np.zeros((h, w, 3), np.uint8)
        cv2.drawContours(want3, [p], -1, (1, 1, 1), cv2.FILLED)
        got3 = fill_poly(np.zeros((h, w, 3), np.uint8), p, 1)
        np.testing.assert_array_equal(got3, want3, err_msg=str(p))


def test_resize_linear_f32_equals_cv2():
    """The float32 resize of 0/1 polygon masks from native sizes to the
    protos' sizes (val's ground truth) and of mask probabilities from the
    protos' size up to the image (`Results.plot`): bitwise cv2's own float
    path (IPP off); against cv2 as the JAX engine runs it (IPP on, which
    rounds its own way), the masks thresholded at 0.5 differ nowhere."""
    rng = np.random.default_rng(3)
    masks = []
    for (h, w), p in _polygons("concave", 60, 4):
        native = fill_poly(np.zeros((h * 4, w * 4), np.float32), p * 4, 1.0)
        masks.append((native, (16, 16)))
        masks.append((native, (int(rng.integers(8, 40)), int(rng.integers(8, 40)))))
        probs = 1 / (1 + np.exp(-rng.standard_normal((16, 16)) * 3)).astype(np.float32)
        masks.append((probs.astype(np.float32), (w * 4, h * 4)))
    use_ipp = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        for m, size in masks:
            np.testing.assert_array_equal(resize_linear_f32(m, size), cv2.resize(m, size))
    finally:
        cv2.ipp.setUseIPP(use_ipp)
    flips = sum(int(((resize_linear_f32(m, size) > 0.5) != (cv2.resize(m, size) > 0.5)).sum()) for m, size in masks)
    print(f"thresholded pixels that differ from cv2 with IPP: {flips} of {sum(s[0] * s[1] for _, s in masks)}")
    assert flips == 0


def test_instances_match_jax():
    """`Bboxes` and `Instances` of `tamtr_torch/utils/instance.py` against
    JAX's: conversions, areas, scale, padding, flips, clip, zero-area
    removal, indexing and concatenation, with segments and keypoints."""
    from tamtr_tpu.utils import instance as JI

    from tamtr_torch.utils import instance as PI

    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (5, 2)), rng.uniform(0.05, 0.3, (5, 2))], 1).astype(np.float32)
    boxes[2, 2:] = 0.0  # a zero-area box
    segs = [rng.uniform(0, 1, (int(rng.integers(3, 9)), 2)).astype(np.float32) for _ in range(5)]
    kpts = rng.uniform(0, 1, (5, 17, 3)).astype(np.float32)

    def run(mod):
        out = []
        b = mod.Bboxes(boxes.copy(), "xywh")
        for fmt in ("ltwh", "xyxy", "xywh"):
            b.convert(fmt)
            out.append(b.bboxes.copy())
        out.append(b.areas())
        b.mul((2.0, 3.0, 2.0, 3.0))
        b.add(1.5)
        out += [b.bboxes, b[1:3].bboxes, mod.Bboxes.concatenate([b, b[0]]).bboxes]
        inst = mod.Instances(boxes.copy(), [s.copy() for s in segs], kpts.copy(), "xywh", True)
        inst.denormalize(64, 48)
        inst.add_padding(3, 5)
        inst.fliplr(70)
        inst.flipud(60)
        inst.clip(64, 48)
        out += [inst.bboxes.copy(), inst.bbox_areas, inst.keypoints.copy(), *inst.segments]
        out.append(inst.remove_zero_area_boxes())
        inst.convert_bbox("xyxy")
        sub = inst[np.arange(len(inst)) % 3 != 1]
        cat = mod.Instances.concatenate([sub, inst[1:3]])
        inst.normalize(64, 48)
        out += [inst.bboxes, sub.bboxes, sub.keypoints, *sub.segments, cat.bboxes, cat.keypoints, *cat.segments]
        return out

    for a, b in zip(run(PI), run(JI), strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _write_task_dataset(root, task: str, n: int = 6, seed: int = 0):
    """PNGs of a few sizes with labels of the task's three row forms:
    polygon rows and box rows (segment), pose rows and box rows (pose), and
    a blank line; returns the images directory."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = [(64, 64), (48, 80), (90, 60)][i % 3]
        cv2.imwrite(str(root / "images" / f"{i}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
        rows = []
        for j in range(int(rng.integers(1, 9))):
            c = int(rng.integers(0, 3))
            cx, cy, bw, bh = rng.uniform(0.25, 0.75, 2).tolist() + rng.uniform(0.1, 0.4, 2).tolist()
            if task == "segment" and j % 4 != 3:
                a = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 14))))
                pts = np.stack([cx + bw / 2 * np.cos(a), cy + bh / 2 * np.sin(a)], 1).clip(0, 1)
                rows.append(" ".join([str(c)] + [f"{v:.5f}" for v in pts.ravel()]))
            elif task == "pose" and j % 4 != 3:
                kp = np.concatenate([np.stack([cx + bw * rng.uniform(-.5, .5, 17), cy + bh * rng.uniform(-.5, .5, 17)],
                                              1).clip(0, 1), rng.integers(0, 3, (17, 1))], 1)
                rows.append(" ".join([str(c), f"{cx:.5f} {cy:.5f} {bw:.5f} {bh:.5f}"] + [f"{v:.5f}" for v in kp.ravel()]))
            else:
                rows.append(f"{c} {cx:.5f} {cy:.5f} {bw:.5f} {bh:.5f}")
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows) + "\n\n")
    return root / "images"


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_labels_and_samples_match_jax(tmp_path, task):
    """`_parse_label_file` on the three row forms (a polygon row's box is its
    extent, a box row's polygon its corners, a box row's keypoints zeros),
    the class filter keeping polygons and keypoints with their boxes, and
    `_read`'s pixel polygons and keypoints, against JAX's dataset."""
    images = _write_task_dataset(tmp_path, task)
    for classes in (None, [0, 2]):
        jds = JD.DetectionDataset(images, imgsz=64, task=task, cache_labels=False, classes=classes)
        pds = PD.DetectionDataset(images, imgsz=64, task=task, cache_labels=False, classes=classes)
        for jl, pl in zip(jds.labels, pds.labels, strict=True):
            assert set(jl) == set(pl)
            np.testing.assert_array_equal(pl["cls"], jl["cls"])
            np.testing.assert_array_equal(pl["xywhn"], jl["xywhn"])
            if task == "segment":
                assert len(pl["segments"]) == len(jl["segments"]) == len(jl["cls"])
                for a, b in zip(pl["segments"], jl["segments"]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(pl["kpts"], jl["kpts"])
        for i in range(len(jds)):
            _assert_sample(pds._read(i), jds._read(i), img_exact=True)


def _assert_sample(p, j, img_exact=False, atol=1e-4):
    """Boxes, classes, polygons and keypoints of two samples equal (pixels
    at `atol`), and their images bitwise when `img_exact`."""
    np.testing.assert_array_equal(p.cls, j.cls)
    np.testing.assert_allclose(p.boxes, j.boxes, rtol=0, atol=atol)
    assert (p.segments is None) == (j.segments is None)
    if j.segments is not None:
        assert len(p.segments) == len(j.segments)
        for a, b in zip(p.segments, j.segments):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    assert (p.keypoints is None) == (j.keypoints is None)
    if j.keypoints is not None:
        np.testing.assert_allclose(p.keypoints, j.keypoints, rtol=0, atol=atol)
    if img_exact:
        np.testing.assert_array_equal(p.img, j.img)


def _task_sample(rng, task: str, h=96, w=96, n=8):
    """A (JAX, port) pair of equal samples with polygons or keypoints."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    c = rng.uniform([0.2 * w, 0.2 * h], [0.8 * w, 0.8 * h], (n, 2))
    r = rng.uniform(4, 0.2 * min(h, w), (n, 2))
    boxes = np.concatenate([c - r, c + r], 1).astype(np.float32)
    cls = rng.integers(0, 3, n).astype(np.int32)
    segs = kpts = None
    if task == "segment":
        segs = []
        for ci, ri in zip(c, r):
            a = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(4, 12))))
            segs.append(np.stack([ci[0] + ri[0] * np.cos(a), ci[1] + ri[1] * np.sin(a)], 1).astype(np.float32))
        boxes = np.stack([np.concatenate([s.min(0), s.max(0)]) for s in segs]).astype(np.float32)
    else:
        kpts = np.concatenate([c[:, None] + rng.uniform(-1, 1, (n, 17, 2)) * r[:, None],
                               rng.integers(0, 3, (n, 17, 1))], -1).astype(np.float32)

    def copy(mod):
        return mod.Sample(img.copy(), boxes.copy(), cls.copy(), None if segs is None else [s.copy() for s in segs],
                          None if kpts is None else kpts.copy())

    return copy(JA), copy(PA)


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_augmentations_carry_polygons_and_keypoints_like_jax(task):
    """Seeded `copy_paste` (its draw from the generator, the pasted pixels),
    `random_perspective` (warped polygons and their extents, keypoints
    outside the canvas invisible, area_thr 0.01 with segments), mosaic4,
    mosaic9, `random_flip` (keypoint indices kept), mixup, `stretch_resize`
    and HSV against JAX's: labels at 1e-4 px, images bitwise but the warp's
    (one level on at most 0.5% of pixels); the generator left in the same
    state."""
    rng = np.random.default_rng(11 if task == "segment" else 12)
    pasted = 0
    for seed in range(4):
        js, ps = _task_sample(rng, task)
        jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)
        j, p = JA.copy_paste(js, jr, 0.5 + 0.1 * seed), PA.copy_paste(ps, pr, 0.5 + 0.1 * seed)
        _assert_sample(p, j, img_exact=True)
        pasted += len(j.cls) - len(js.cls)
        j = JA.random_perspective(j, jr, degrees=10, translate=0.1, scale=0.5, shear=2, perspective=1e-4 * seed,
                                  border=(-8, -8) if seed % 2 else (0, 0))
        p = PA.random_perspective(p, pr, degrees=10, translate=0.1, scale=0.5, shear=2, perspective=1e-4 * seed,
                                  border=(-8, -8) if seed % 2 else (0, 0))
        _assert_sample(p, j)
        d = np.abs(p.img.astype(np.int64) - j.img)
        assert d.max() <= 1 and (d > 0).mean() <= 0.005
        p = PA.Sample(j.img.copy(), p.boxes, p.cls, p.segments, p.keypoints)  # HSV on the same bytes
        j, p = JA.random_hsv(j, jr), PA.random_hsv(p, pr)
        _assert_sample(p, j, img_exact=True)
        j, p = JA.random_flip(j, jr, 0.5, 0.5), PA.random_flip(p, pr, 0.5, 0.5)
        _assert_sample(p, j, img_exact=True)
        assert jr.random() == pr.random()
    assert (pasted > 0) == (task == "segment")  # copy-paste needs polygons
    pairs = [_task_sample(rng, task, h=int(rng.integers(40, 90)), w=int(rng.integers(40, 90))) for _ in range(9)]
    for fn in ("mosaic4", "mosaic9"):
        j = getattr(JA, fn)([JA.stretch_resize(a, 64) for a, _ in pairs], 64, np.random.default_rng(1))
        p = getattr(PA, fn)([PA.stretch_resize(b, 64) for _, b in pairs], 64, np.random.default_rng(1))
        _assert_sample(p, j, img_exact=True)
    (j1, p1), (j2, p2) = ((JA.stretch_resize(a, 64), PA.stretch_resize(b, 64)) for a, b in pairs[:2])
    _assert_sample(PA.mixup(p1, p2, np.random.default_rng(2)), JA.mixup(j1, j2, np.random.default_rng(2)),
                   img_exact=True)
    assert PA.albumentations_transform(p1, np.random.default_rng(0), compose=object()) is p1


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_collate_matches_jax(task):
    """`collate`'s masks (each kept gt filled at imgsz / 4, the largest
    boxes kept past max_gt) and keypoints bitwise JAX's."""
    rng = np.random.default_rng(5)
    pairs = [_task_sample(rng, task, h=64, w=64, n=int(rng.integers(1, 9))) for _ in range(3)]
    jb = JD.collate([a for a, _ in pairs], 6, 64, task=task)
    pb = PD.collate([b for _, b in pairs], 6, 64, task=task)
    assert set(pb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    key = "masks" if task == "segment" else "keypoints"
    assert pb[key].any() and pb[key].shape[:2] == (3, 6)


@pytest.mark.parametrize("task,workers", [("segment", 0), ("segment", 2), ("pose", 0), ("pose", 2)])
def test_loader_batches_match_jax(tmp_path, task, workers):
    """The port's Loader against JAX's build_loader on a segment or pose
    dataset with mosaic, copy-paste and the recipe's warp, two epochs:
    cls, mask, the gt masks and keypoints equal (bboxes and keypoints at
    1e-4 px), images within `tests/test_torch_data.py`'s loader bounds."""
    images = _write_task_dataset(tmp_path, task, n=6, seed=1)
    aug = dict(mosaic=0.5, copy_paste=0.5, degrees=5.0)
    jds = JD.DetectionDataset(images, imgsz=64, augment=True, aug=JD.AugConfig(**aug), task=task)
    pds = PD.DetectionDataset(images, imgsz=64, augment=True, aug=PD.AugConfig(**aug), task=task)
    jl = JD.build_loader(jds, 3, max_gt=8, seed=5, workers=1)
    pl = PD.Loader(pds, 3, max_gt=8, seed=5, workers=workers)
    worst, key = [], "masks" if task == "segment" else "keypoints"
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        n = 0
        for jb, pb in zip(jl, pl):
            n += 1
            np.testing.assert_array_equal(pb["cls"].numpy(), jb["cls"])
            np.testing.assert_array_equal(pb["mask"].numpy(), jb["mask"])
            np.testing.assert_allclose(pb["bboxes"].numpy(), jb["bboxes"], rtol=0, atol=1e-5)
            if task == "segment":
                np.testing.assert_array_equal(pb["masks"].numpy(), jb["masks"])
            else:
                np.testing.assert_allclose(pb["keypoints"].numpy(), jb["keypoints"], rtol=0, atol=1e-4)
            assert pb[key].numpy().any()
            d = np.abs(pb["img"].numpy().astype(np.int64) - jb["img"])
            worst.append((int(d.max()), float((d > 1).mean())))
        assert n == 2
    assert max(w[0] for w in worst) <= 3 and max(w[1] for w in worst) <= 0.01, worst
