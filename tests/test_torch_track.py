"""The port's trackers (`tamtr_torch/trackers/`) against the JAX package's
(`tamtr_tpu/trackers/`) on the CPU, on seeded detection sequences.

The scenes: objects moving at constant velocity across a 1360x765 frame
with box jitter, two of them crossing, two side by side in step (where the
appearance decides), one occluded for a gap of frames,
one seen with low scores (the second association's rescue), spurious
low-score boxes, and frames drawn from the boxes (each object a patch of
its own colour on noise) for the appearance branch. Both packages' id
counters are reset before each run. Track ids are equal and boxes, scores
and classes agree at 1e-5 for `bytetrack` and for `botsort` (GMC "none",
with and without ReID); the Kalman filter, the assignment, the embedder
and the embedding distance equal JAX's. Over a panned 320x240 sequence
`botsort` with its default camera-motion compensation (sparseOptFlow,
`trackers/gmc.py`) and ReID gives JAX's ids and boxes within 1e-4 of the
frame size.
"""

import numpy as np
import pytest
import torch

from tamtr_torch.trackers import bot_sort as pbot, byte_tracker as pbyte, kalman as pkal
from tamtr_torch.trackers.track import make_tracker, update_result_with_tracks

W, H = 1360, 765


def scene(seed: int, frames: int = 24):
    """(boxes, scores, classes, frame) per frame: 6 objects, two crossing,
    object 2 hidden in frames 8-11, object 3 at scores 0.2-0.45 in frames
    5-14, objects 4 and 5 side by side (ReID changes their tracks at seeds
    0 and 1), and 0-3 spurious boxes a frame at scores 0.1-0.3."""
    rng = np.random.default_rng(seed)
    n = 6
    start = rng.uniform([100, 100], [W - 300, H - 200], (n, 2))
    start[0], start[1] = (200, 300), (900, 320)  # 0 and 1 cross
    vel = rng.uniform(-12, 12, (n, 2))
    vel[0], vel[1] = (28, 1), (-28, 0)
    size = rng.uniform([40, 30], [120, 90], (n, 2))
    # 4 and 5: the same size, side by side, half overlapping, in step: IoU
    # alone swaps them under the jitter, their colours do not
    size[5], vel[5], start[5] = size[4], vel[4], start[4] + (size[4, 0] * 0.3, 0)
    colours = rng.integers(0, 256, (n, 3))
    cls = rng.integers(0, 3, n)
    out = []
    for f in range(frames):
        xy = start + vel * f
        boxes, scores, classes = [], [], []
        for i in range(n):
            if i == 2 and 8 <= f < 12:
                continue
            b = np.concatenate([xy[i], xy[i] + size[i]]) + rng.normal(0, 8 if i >= 4 else 1.5, 4)
            boxes.append(b)
            scores.append(rng.uniform(0.2, 0.45) if i == 3 and 5 <= f < 15 else rng.uniform(0.65, 0.95))
            classes.append(cls[i])
        for _ in range(rng.integers(0, 4)):
            p = rng.uniform([0, 0], [W - 80, H - 80])
            boxes.append(np.concatenate([p, p + rng.uniform(20, 80, 2)]))
            scores.append(rng.uniform(0.1, 0.3))
            classes.append(rng.integers(0, 3))
        frame = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
        for i in range(n):
            x1, y1 = np.clip(xy[i].astype(int), 0, [W, H])
            x2, y2 = np.clip((xy[i] + size[i]).astype(int), 0, [W, H])
            frame[y1:y2, x1:x2] = colours[i]
        out.append((np.array(boxes, np.float32).reshape(-1, 4), np.array(scores, np.float32),
                    np.array(classes, np.float32), frame))
    return out


def reset_ids():
    from tamtr_tpu.trackers.byte_tracker import Track as JaxTrack

    JaxTrack._count = 0
    pbyte.Track.reset_id()


TRACKERS = {"bytetrack": {}, "botsort": {"gmc_method": "none"}, "botsort-reid": {"gmc_method": "none",
                                                                                  "with_reid": True}}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", list(TRACKERS))
def test_trackers_match_jax(kind, seed):
    from tamtr_tpu.trackers.track import make_tracker as jax_make_tracker

    name, kw = kind.split("-")[0], TRACKERS[kind]
    reset_ids()
    port, jax_t = make_tracker(name, **kw), jax_make_tracker(name, **kw)
    seen = set()
    for boxes, scores, classes, frame in scene(seed):
        extra = ({"frame_bgr": frame} if name == "botsort" else {})
        got = port.update(boxes, scores, classes, **extra)
        want = jax_t.update(boxes, scores, classes, **extra)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        seen.update(got[:, 4].astype(int).tolist())
    assert len(seen) >= 5, seen  # the scene's objects got tracks


def test_update_result_with_tracks_matches_jax():
    """Results of one sequence through both packages' `update_result_with_tracks`."""
    from tamtr_tpu.engine.results import Results as JaxResults
    from tamtr_tpu.trackers.track import make_tracker as jax_make_tracker
    from tamtr_tpu.trackers.track import update_result_with_tracks as jax_update

    from tamtr_torch.engine.results import Results

    reset_ids()
    port, jax_t = make_tracker("botsort.yaml", gmc_method="none", with_reid=True), \
        jax_make_tracker("botsort.yaml", gmc_method="none", with_reid=True)
    names = ["a", "b", "c"]
    for boxes, scores, classes, frame in scene(5, frames=10):
        r = Results("f", boxes, scores, classes, names, orig_shape=(H, W), orig_img=frame)
        j = JaxResults("f", boxes, scores, classes, names, orig_shape=(H, W), orig_img=frame)
        update_result_with_tracks(r, port, frame=frame)
        jax_update(j, jax_t, frame=frame)
        np.testing.assert_array_equal(r.track_ids, j.track_ids)
        np.testing.assert_allclose(r.boxes.xyxy, j.boxes.xyxy, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(r.boxes.conf, j.boxes.conf)
        np.testing.assert_array_equal(r.boxes.cls, j.boxes.cls)
    assert len(r.track_ids) >= 5


def test_parts_match_jax():
    """The Kalman filter over a sequence, the gated assignment, the patch
    embedder (its resize bitwise cv2's) and the embedding distance."""
    from tamtr_tpu.trackers import bot_sort as jbot, byte_tracker as jbyte, kalman as jkal

    rng = np.random.default_rng(3)
    pk, jk = pkal.KalmanFilterXYAH(), jkal.KalmanFilterXYAH()
    m = np.array([500.0, 300.0, 0.7, 80.0])
    (pm, pc), (jm, jc) = pk.initiate(m), jk.initiate(m)
    for _ in range(20):
        (pm, pc), (jm, jc) = pk.predict(pm, pc), jk.predict(jm, jc)
        z = m + rng.normal(0, 3, 4)
        (pm, pc), (jm, jc) = pk.update(pm, pc, z), jk.update(jm, jc, z)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pc, jc)
    cost = rng.uniform(0, 1, (7, 9))
    assert pbyte.linear_assignment(cost, 0.5) == jbyte.linear_assignment(cost, 0.5)
    assert pbyte.linear_assignment(np.zeros((0, 3)), 0.5) == jbyte.linear_assignment(np.zeros((0, 3)), 0.5)
    frame = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    boxes = np.array([[3.5, 4.2, 60.9, 50.1], [100, 20, 131, 97], [-5, -5, 2, 3], [50, 50, 50, 60],
                      [10, 10, 13, 12]], np.float32)
    feats = pbot.patch_appearance_encoder(frame, boxes)
    np.testing.assert_array_equal(feats, jbot.patch_appearance_encoder(frame, boxes))
    t = pbyte.Track(boxes[0], 0.9, 1, feat=feats[0])
    jt = jbyte.Track(boxes[0], 0.9, 1, feat=feats[0])
    t.update_features(feats[1])
    jt.update_features(feats[1])
    np.testing.assert_array_equal(pbot.embedding_distance([t], feats), jbot.embedding_distance([jt], feats))


def test_gmc_methods_and_names():
    """GMC "none" is the identity and needs no device; the other methods
    need a device (a machine without a card raises, saying to pass
    device='cpu'); an unknown method raises ValueError; trackers by name,
    `make_tracker` passing `device` to BOTSORT."""
    assert np.array_equal(pbot.GMC("none").apply(np.zeros((4, 4, 3), np.uint8)), np.eye(2, 3, dtype=np.float32))
    for method in ("sparseOptFlow", "orb", "sift", "ecc"):
        assert pbot.GMC(method, device="cpu").method == method
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                pbot.GMC(method)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_tracker("botsort")
    t = make_tracker("botsort", device="cpu")
    assert t.gmc.method == "sparseOptFlow" and t.gmc.downscale == 2 and t.gmc.device == torch.device("cpu")
    assert make_tracker("botsort", device="cpu", gmc_downscale=3).gmc.downscale == 3
    assert isinstance(make_tracker("bytetrack", device="cpu"), pbyte.BYTETracker)
    with pytest.raises(ValueError):
        pbot.GMC("optical")
    assert isinstance(make_tracker("bytetrack.yaml"), pbyte.BYTETracker)
    assert isinstance(make_tracker("BoTSORT", gmc_method=None), pbot.BOTSORT)
    with pytest.raises(ValueError, match="unknown tracker"):
        make_tracker("deepsort")


def panned_scene(frames: int = 8, h: int = 240, w: int = 320, pan=(3, 2)):
    """(boxes, scores, classes, frame) per frame: a textured background
    panned by `pan` pixels a frame (a seeded canvas cropped), 5 objects
    drawn on it at their own velocities plus the pan, boxes jittered."""
    rng = np.random.default_rng(7)
    canvas = np.repeat(np.repeat(rng.integers(0, 256, (64, 64, 3), np.uint8), 8, 0), 8, 1)
    canvas = np.clip(canvas.astype(np.int16) + rng.integers(-20, 20, canvas.shape), 0, 255).astype(np.uint8)
    n = 5
    start = rng.uniform([20, 20], [w - 80, h - 70], (n, 2))
    vel = rng.uniform(-3, 3, (n, 2))
    size = rng.uniform([25, 20], [50, 40], (n, 2))
    colours = rng.integers(0, 256, (n, 3))
    out = []
    for f in range(frames):
        ox, oy = 40 + pan[0] * f, 30 + pan[1] * f
        frame = canvas[oy:oy + h, ox:ox + w].copy()
        xy = start + (vel - pan) * f
        boxes = []
        for i in range(n):
            x1, y1 = np.clip(xy[i].astype(int), 0, [w, h])
            x2, y2 = np.clip((xy[i] + size[i]).astype(int), 0, [w, h])
            frame[y1:y2, x1:x2] = colours[i]
            boxes.append(np.concatenate([xy[i], xy[i] + size[i]]) + rng.normal(0, 1.0, 4))
        out.append((np.array(boxes, np.float32), rng.uniform(0.6, 0.95, n).astype(np.float32),
                    np.zeros(n, np.float32), frame))
    return out


def test_botsort_sparse_flow_matches_jax():
    """BoT-SORT with its default GMC (sparseOptFlow) and ReID over a panned
    sequence: the port's ids equal JAX's and its boxes agree within 1e-4
    of the frame size."""
    from tamtr_tpu.trackers.track import make_tracker as jax_make_tracker

    torch.set_num_threads(1)
    reset_ids()
    port = make_tracker("botsort", device="cpu", with_reid=True)
    jax_t = jax_make_tracker("botsort", with_reid=True)
    assert port.gmc.method == jax_t.gmc.method == "sparseOptFlow"
    maps, apply = [], port.gmc.apply
    port.gmc.apply = lambda f: maps.append(apply(f)) or maps[-1]
    for i, (boxes, scores, classes, frame) in enumerate(panned_scene()):
        got = port.update(boxes, scores, classes, frame_bgr=frame)
        want = jax_t.update(boxes, scores, classes, frame_bgr=frame)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        scale = np.array([320, 240, 320, 240], np.float32)
        np.testing.assert_allclose(got[:, :4] / scale, want[:, :4] / scale, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[:, 5:], want[:, 5:], rtol=0, atol=1e-5)
        if i:  # the background's pan, seen through the moving objects
            assert np.abs(maps[-1][:, 2] - (-3, -2)).max() < 0.5, maps[-1]
    assert len(got) == 5
