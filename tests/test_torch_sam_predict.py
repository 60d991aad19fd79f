"""SAM's predictor, its AMG helpers, FastSAM's prompts and the
auto-annotator in the port (`tamtr_torch/models/sam/amg.py`, `predict.py`,
`models/fastsam.py`, `data/annotator.py`, and the cv2 rewrites they use in
`data/imgproc.py`) against the JAX package and cv2 on the CPU, one torch
thread.

The predictors are the tiny SAM (`build_sam_tiny_test(64)`) with the
port's seeded, spread weights, handed to the JAX SAM as flax variables.
Bounds: every AMG helper and the host NMS equal to JAX's; the connected
components and the contours bitwise cv2's (`connectedComponentsWithStats`
labels and areas, ties included; `findContours(RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)` and `contourArea` on 600 random masks); the 3-channel
float resize within 4 ulp of cv2's on the upscales the crop re-encode
makes; `generate` and `__call__` equal to JAX's (masks and boxes, scores at
1e-4); FastSAM's prompts equal; the auto-annotator's label files
byte-equal.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.data.imgproc import contour_area, find_external_contours, resize_linear_f32
from tamtr_torch.models.sam import amg
from tamtr_torch.models.sam.build import build_sam_tiny_test
from tamtr_torch.models.sam.predict import SAMPredictor, _nms_numpy

from torch_engine_data import one_thread, sam_flax_variables_of, spread_sam  # noqa: F401


def _image(seed=0, h=48, w=72):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def predictors():
    """(port `SAMPredictor`, JAX `SAMPredictor`) of the tiny SAM on the
    same weights, conf -1."""
    from tamtr_tpu.models.sam.build import build_sam_tiny_test as jtiny
    from tamtr_tpu.models.sam.predict import SAMPredictor as JPredictor

    sam = spread_sam(build_sam_tiny_test(64), 11)
    js = jtiny(64)
    js.variables = jax.tree.map(jnp.asarray, sam_flax_variables_of(sam))
    return SAMPredictor(sam, conf=-1.0, device="cpu"), JPredictor(js, conf=-1.0)


def test_amg_helpers_match_jax():
    """Point grids, crop boxes, batches, the stability score, mask -> box
    (an empty mask's [0, 0, 0, 0]), the uncrop helpers and the crop-edge
    test, on seeded inputs, equal to JAX's."""
    from tamtr_tpu.models.sam import amg as J

    for n, layers, scale in ((4, 0, 1), (8, 2, 2), (32, 1, 2)):
        for a, b in zip(amg.build_all_layer_point_grids(n, layers, scale), J.build_all_layer_point_grids(n, layers, scale)):
            np.testing.assert_array_equal(a, b)
    for size, layers, ratio in (((400, 600), 1, 0.25), ((1024, 1024), 2, 512 / 1500), ((37, 53), 1, 0.5)):
        assert amg.generate_crop_boxes(size, layers, ratio) == J.generate_crop_boxes(size, layers, ratio)
    arrs = (np.arange(10), np.arange(10) * 2)
    assert [[list(x) for x in b] for b in amg.batch_iterator(4, *arrs)] == \
        [[list(x) for x in b] for b in J.batch_iterator(4, *arrs)]
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 24, 20)).astype(np.float32) * 2
    logits[0] = -5  # an empty union
    for t, off in ((0.0, 1.0), (0.5, 0.95)):
        want = np.asarray(J.calculate_stability_score(jnp.asarray(logits), t, off))
        got = amg.calculate_stability_score(logits, t, off)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    masks = rng.random((6, 2, 17, 23)) < 0.02
    masks[0, 0] = False
    np.testing.assert_array_equal(amg.batched_mask_to_box(masks), np.asarray(J.batched_mask_to_box(jnp.asarray(masks))))
    boxes = np.sort(rng.uniform(0, 200, (30, 2, 2)), 1).reshape(30, 4).astype(np.float32)
    for crop in ([30, 30, 130, 130], [0, 0, 200, 200], [0, 50, 100, 200]):
        np.testing.assert_array_equal(amg.is_box_near_crop_edge(boxes, crop, [0, 0, 200, 200]),
                                      J.is_box_near_crop_edge(boxes, crop, [0, 0, 200, 200]))
        np.testing.assert_array_equal(amg.uncrop_boxes_xyxy(boxes, crop), J.uncrop_boxes_xyxy(boxes, crop))
        np.testing.assert_array_equal(amg.uncrop_points(boxes[:, :2], crop), J.uncrop_points(boxes[:, :2], crop))
        np.testing.assert_array_equal(amg.uncrop_masks(masks[:, 0], crop, 220, 210),
                                      J.uncrop_masks(masks[:, 0], crop, 220, 210))


def test_nms_numpy_matches_jax():
    """The host NMS on seeded boxes with duplicate scores, at three IoU
    thresholds, and on no boxes."""
    from tamtr_tpu.models.sam.predict import _nms_numpy as jnms

    rng = np.random.default_rng(1)
    boxes = np.concatenate([rng.uniform(0, 50, (40, 2)), rng.uniform(5, 40, (40, 2))], 1).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    scores = np.round(rng.random(40), 1).astype(np.float32)
    for thr in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(_nms_numpy(boxes, scores, thr), jnms(boxes, scores, thr))
    assert len(_nms_numpy(np.zeros((0, 4), np.float32), np.zeros(0), 0.5)) == 0


def _tied_masks():
    """Masks whose components tie in area, placed so that the first 2x2
    block and the first pixel order them differently."""
    out = []
    m = np.zeros((12, 16), np.uint8)
    m[1, 0:2] = 1  # row 1: the first pixel comes second, its block first
    m[0, 9:11] = 1
    out.append(m)
    m = np.zeros((20, 20), np.uint8)
    for y, x in ((3, 12), (2, 15), (11, 1), (10, 6)):
        m[y:y + 3, x:x + 2] = 1  # four islands of 6 pixels
    out.append(m)
    return out


def test_connected_components_and_remove_small_regions_match_cv2():
    """`connected_components` bitwise `cv2.connectedComponentsWithStats(m,
    8)` (labels, areas) on 300 random masks and the tied ones; then
    `remove_small_regions` in both modes equal to JAX's (which calls cv2),
    ties in the islands fallback included; the predictor's static
    `remove_small_regions` equal to JAX's."""
    from tamtr_tpu.models.sam import amg as J
    from tamtr_tpu.models.sam.predict import SAMPredictor as JPredictor

    rng = np.random.default_rng(2)
    masks = _tied_masks()
    for i in range(300):
        h, w = (int(v) for v in (rng.integers(1, 60, 2) if i < 250 else rng.integers(100, 400, 2)))
        m = (rng.random((h, w)) < rng.uniform(0.05, 0.6)).astype(np.uint8)
        masks.append(cv2.dilate(m, np.ones((3, 3), np.uint8)) if i % 3 == 0 and min(h, w) > 2 else m)
    for m in masks:
        n, lab, stats, _ = cv2.connectedComponentsWithStats(m, 8)
        n2, lab2, areas = amg.connected_components(m)
        assert n == n2
        np.testing.assert_array_equal(lab, lab2)
        np.testing.assert_array_equal(stats[:, -1], areas)
    for m in masks[:120]:
        for mode in ("holes", "islands"):
            for thr in (3, 7, 1000):
                got, gch = amg.remove_small_regions(m, thr, mode)
                want, wch = J.remove_small_regions(m, thr, mode)
                assert gch == wch
                np.testing.assert_array_equal(got, want)
    stack = np.stack([np.pad(m, ((0, 20 - m.shape[0]), (0, 20 - m.shape[1]))) for m in masks[:2]] +
                     [(rng.random((20, 20)) < 0.5) for _ in range(6)])
    got, gk = SAMPredictor.remove_small_regions(stack, min_area=5, nms_thresh=0.7)
    want, wk = JPredictor.remove_small_regions(stack, min_area=5, nms_thresh=0.7)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(got, want)


def _random_mask(rng, i):
    h, w = (int(v) for v in (rng.integers(1, 40, 2) if i < 450 else rng.integers(40, 160, 2)))
    kind = i % 5
    if kind == 0:
        return (rng.random((h, w)) < rng.uniform(0.05, 0.7)).astype(np.uint8)
    if kind == 1:  # blobs with holes
        m = cv2.dilate((rng.random((h, w)) < 0.3).astype(np.uint8), np.ones((3, 3), np.uint8))
        m[rng.random((h, w)) < 0.1] = 0
        return m
    m = np.zeros((h, w), np.uint8)
    if kind == 2:  # rectangles, touching or on the border, one-pixel and one-row ones
        for _ in range(int(rng.integers(1, 7))):
            y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
            m[y0:y0 + int(rng.integers(1, 12)), x0:x0 + int(rng.integers(1, 12))] = 1
        m[int(rng.integers(0, h)), :] = rng.integers(0, 2)
    elif kind == 3:  # isolated pixels and diagonal chains
        m[::2, ::3] = 1
        m[rng.random((h, w)) < 0.2] ^= 1
    else:  # a ring with an island inside and a component beside it
        m[:] = 0
        if h > 6 and w > 9:
            m[1:h - 1, 1:w - 4] = 1
            m[2:h - 2, 2:w - 5] = 0
            m[h // 2, w // 3] = 1
            m[: h // 2, w - 2] = 1
    return m


def test_contours_match_cv2_find_contours():
    """`find_external_contours` and `contour_area` bitwise
    `cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)` and
    `cv2.contourArea` on 600 seeded masks (random pixels, blobs with holes,
    rectangles touching each other and the border, single pixels and rows,
    diagonal chains, islands inside rings): the same contours, points and
    order."""
    rng = np.random.default_rng(3)
    n_contours = 0
    for i in range(600):
        m = _random_mask(rng, i)
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        got = find_external_contours(m)
        assert len(got) == len(want), i
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.reshape(-1, 2))
            assert contour_area(g) == cv2.contourArea(w)
        n_contours += len(got)
    assert n_contours > 3000


def test_resize_linear_f32_three_channels_against_cv2():
    """The 3-channel float32 resize against `cv2.resize` (INTER_LINEAR):
    within 4 ulp of the image's largest value on the upscales the crop
    re-encode makes (a crop of the 1024 canvas to 1024); printed, with the
    1-channel resize's difference on the same data beside it."""
    rng = np.random.default_rng(4)
    worst = 0.0
    for (h, w), dsize in (((37, 53), (64, 64)), ((512, 512), (1024, 1024)), ((600, 345), (1024, 1024))):
        x = (rng.random((h, w, 3)) * 255).astype(np.float32)
        want = cv2.resize(x, dsize, interpolation=cv2.INTER_LINEAR)
        got = resize_linear_f32(x, dsize)
        d = float(np.abs(got - want).max())
        d1 = float(np.abs(resize_linear_f32(x[..., 1].copy(), dsize) - want[..., 1]).max())
        print(f"{(h, w)} -> {dsize}: max |port - cv2| {d} (1 channel {d1}); ulp at 255 {np.spacing(np.float32(255))}")
        worst = max(worst, d)
        assert got.shape == want.shape and got.dtype == np.float32
    assert worst <= 4 * np.spacing(np.float32(255))


@pytest.mark.parametrize("crop_n_layers", [0, 1])
def test_generate_matches_jax(predictors, crop_n_layers):
    """`generate` with conf -1 (as `tests/test_sam.py` runs it) and a point
    stride of 4, without and with one crop layer (four crops re-encoded
    from their upscaled pixels): masks and boxes equal to JAX's, scores at
    1e-4."""
    port, jp = predictors
    img = _image(5)
    port.set_image(img)
    jp.set_image(img)
    kw = dict(points_stride=4, conf_thres=-10.0, stability_score_thresh=-1.0, crop_n_layers=crop_n_layers)
    got, want = port.generate(**kw), jp.generate(**kw)
    port.segment_all = jp.segment_all = False
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)
    np.testing.assert_array_equal(got[2], want[2])


def test_call_with_boxes_and_points_matches_jax(predictors):
    """`__call__` on an image with boxes, with points and labels, and
    without prompts (segment everything): one `Results` each whose masks
    (at the image's size), boxes and labels equal JAX's, scores at 1e-4."""
    port, jp = predictors
    img = _image(6, 40, 90)
    for kw in (dict(bboxes=np.array([[5, 5, 40, 30], [50, 3, 88, 38]])),
               dict(points=np.array([[20, 20], [60, 10]]), labels=np.array([1, 0])),
               dict(points_stride=4, conf_thres=-10.0, stability_score_thresh=-1.0)):
        (g,), (w,) = port(img, **kw), jp(img, **kw)
        assert g.orig_shape == w.orig_shape == (40, 90) and len(g) == len(w)
        np.testing.assert_array_equal(g.masks, w.masks)
        np.testing.assert_array_equal(g.boxes.xyxy, w.boxes.xyxy)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, atol=1e-4)


def _seg_results(lib):
    """One segment `Results` of each package on the same rows: 5
    detections of 3 classes (two of them one class), mask probabilities at
    16 x 24 for a 40 x 60 image."""
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 30, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 25, (5, 2))], 1).astype(np.float32)
    masks = (rng.random((5, 16, 24)) ** 0.5).astype(np.float32)
    return lib.Results("img.png", boxes, rng.random(5).astype(np.float32), np.array([0, 1, 2, 1, 0]),
                       ["car", "person", "dog"], orig_shape=(40, 60), masks=masks)


def test_fastsam_prompts_match_jax():
    """`FastSAM.prompt` on one segment `Results`: everything, a box prompt,
    points with a negative one, and a text prompt (the hash text table,
    and a given embed_fn), each equal to JAX's."""
    import tamtr_tpu.engine.results as jresults
    from tamtr_tpu.api import FastSAM as JFastSAM

    import tamtr_torch.engine.results as presults
    from tamtr_torch import FastSAM

    got, want = _seg_results(presults), _seg_results(jresults)
    rng = np.random.default_rng(8)
    table = {n: rng.standard_normal(8) for n in ("car", "person", "dog", "a person")}

    def embed(texts):
        return np.stack([table[t] for t in texts])

    cases = [dict(), dict(bboxes=[10, 10, 40, 35]), dict(points=[[12, 20], [30, 25], [50, 5]], labels=[1, 1, 0]),
             dict(texts="dog"), dict(texts="a person", embed_fn=embed)]
    for kw in cases:
        g, w = FastSAM.prompt(got, **kw), JFastSAM.prompt(want, **kw)
        assert g.dtype == w.dtype == bool
        np.testing.assert_array_equal(g, w)


class _Detector:
    """A detector whose `predict` returns fixed rows, as `Results` of one
    package, for every image of a directory."""

    def __init__(self, lib, folder):
        self.lib, self.folder = lib, folder

    def predict(self, source, conf=0.25):
        rng = np.random.default_rng(9)
        out = []
        for f in sorted(self.folder.glob("*.png")):
            h, w = cv2.imread(str(f)).shape[:2]
            n = int(rng.integers(0, 4))
            xy = rng.uniform(0, 0.5, (n, 2)) * [w, h]
            boxes = np.concatenate([xy, xy + rng.uniform(0.2, 0.5, (n, 2)) * [w, h]], 1).astype(np.float32)
            out.append(self.lib.Results(str(f), boxes, np.full(n, 0.9, np.float32), rng.integers(0, 3, n), ["a", "b", "c"],
                                        orig_shape=(h, w)))
        return out


def test_auto_annotate_label_files_equal_jax(predictors, tmp_path):
    """`auto_annotate` over 4 images (one without detections) with the
    same detector rows and SAM weights: the same label files, byte for
    byte; each line a class and an even count of coordinates in [0, 1]."""
    import tamtr_tpu.engine.results as jresults
    from tamtr_tpu.data.annotator import auto_annotate as jannotate

    import tamtr_torch.engine.results as presults
    from tamtr_torch.data.annotator import auto_annotate

    port, jp = predictors
    folder = tmp_path / "images"
    folder.mkdir()
    for i, (h, w) in enumerate(((48, 72), (64, 64), (50, 40), (33, 70))):
        cv2.imwrite(str(folder / f"{i}.png"), _image(20 + i, h, w))
    got = auto_annotate(folder, _Detector(presults, folder), sam_model=port, output_dir=tmp_path / "port")
    want = jannotate(folder, _Detector(jresults, folder), sam_model=jp, output_dir=tmp_path / "jax")
    names = sorted(p.name for p in want.glob("*.txt"))
    assert names == sorted(p.name for p in got.glob("*.txt")) and len(names) >= 2
    for name in names:
        text = (got / name).read_bytes()
        assert text == (want / name).read_bytes(), name
        for line in text.decode().splitlines():
            vals = line.split()
            assert int(vals[0]) in (0, 1, 2) and len(vals) % 2 == 1 and len(vals) >= 7
            assert all(0.0 <= float(v) <= 1.0 for v in vals[1:])
