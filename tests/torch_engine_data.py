"""What the port's engine tests share (`tests/test_torch_engine.py`,
`tests/test_torch_engine_train.py`): the nano shapes, one torch thread, the
class text table and a 64 px PNG val split labelled by a model. Not a
conftest: that one imports JAX, and the train tests need none."""

import json

import numpy as np
import pytest
import torch

NC, HD, IMG = 3, 128, 64
NAMES = ["red box", "green box", "blue box"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def unit_text() -> np.ndarray:
    """(NC, HD) unit rows from a numpy seed: the class text embeddings."""
    t = np.random.default_rng(1).standard_normal((NC, HD)).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def write_val_split(root, model, txt):
    """6 val PNGs of 64 px (the val resize is the identity) under `root`,
    labelled with `model`'s top-3 detections, boxes jittered by up to 8%;
    returns the `data.json` path."""
    from tamtr_torch.data.image_io import imwrite_png
    from tamtr_torch.ops.nms import postprocess_predictions

    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (6, IMG, IMG, 3), dtype=np.uint8)  # BGR
    with torch.inference_mode():
        pred = model(torch.from_numpy(imgs[..., ::-1] / np.float32(255)), torch.from_numpy(txt[None]))["pred"]
    boxes, scores, labels, valid, _ = (t.numpy() for t in postprocess_predictions(pred, 0.25, 0.7, 300))
    for i, img in enumerate(imgs):
        imwrite_png(root / "images" / f"{i}.png", img)
        xyxy = boxes[i][valid[i]][:3] * (1 + rng.uniform(-0.08, 0.08, (min(3, valid[i].sum()), 4)))
        xyxy = xyxy.clip(0, 1)
        lines = [f"{c} {(a + c2) / 2:.5f} {(b + d) / 2:.5f} {c2 - a:.5f} {d - b:.5f}"
                 for c, (a, b, c2, d) in zip(labels[i][valid[i]][:3], xyxy)]
        (root / "labels" / f"{i}.txt").write_text("\n".join(lines))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "images", "val": "images", "nc": NC, "names": NAMES}))
    return data
