"""What the port's engine tests share (`tests/test_torch_engine.py`,
`tests/test_torch_engine_train.py`, `tests/test_torch_predict.py`,
`tests/test_torch_cli.py`): the nano shapes, one torch thread, the class
text table, a 64 px PNG val split labelled by a model, and the JAX nano
model's variables with spread head weights. Not a conftest: that one
imports JAX, and the train tests need none (`jax_nano_variables` imports
it when called)."""

import json

import numpy as np
import pytest
import torch

NC, HD, IMG = 3, 128, 64
NAMES = ["red box", "green box", "blue box"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the whole module. Module scope puts it before
    the modules' own module-scoped fixtures (an autouse fixture comes first
    within its scope), which train and validate: at the default of one
    thread per core, under several test processes, a fixture that trains
    for ~3 s alone took minutes."""
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
    from tamtr_torch.data.image_io import imwrite
    from tamtr_torch.ops.nms import postprocess_predictions

    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (6, IMG, IMG, 3), dtype=np.uint8)  # BGR
    with torch.inference_mode():
        pred = model(torch.from_numpy(imgs[..., ::-1] / np.float32(255)), torch.from_numpy(txt[None]))["pred"]
    boxes, scores, labels, valid, _ = (t.numpy() for t in postprocess_predictions(pred, 0.25, 0.7, 300))
    for i, img in enumerate(imgs):
        imwrite(root / "images" / f"{i}.png", img)
        xyxy = boxes[i][valid[i]][:3] * (1 + rng.uniform(-0.08, 0.08, (min(3, valid[i].sum()), 4)))
        xyxy = xyxy.clip(0, 1)
        lines = [f"{c} {(a + c2) / 2:.5f} {(b + d) / 2:.5f} {c2 - a:.5f} {d - b:.5f}"
                 for c, (a, b, c2, d) in zip(labels[i][valid[i]][:3], xyxy)]
        (root / "labels" / f"{i}.txt").write_text("\n".join(lines))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "images", "val": "images", "nc": NC, "names": NAMES}))
    return data


def jax_nano_variables():
    """(JAX `TAMTRModel`, params, batch_stats) of `tamtr-nano.yaml` at nc =
    NC, initialised under `jax.jit` from key 0, as numpy trees; the
    zero-initialised head layers given small random values from a numpy
    seed and the contrastive bias 0, so that scores spread."""
    import jax
    import jax.numpy as jnp

    from tamtr_tpu.nn.graph import TAMTRModel

    model = TAMTRModel.from_yaml("tamtr-nano.yaml", nc=NC)
    v = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, NC, HD)), None, False))())
    to_np = lambda t: {k: to_np(x) if hasattr(x, "items") else np.array(x) for k, x in t.items()}  # noqa: E731
    params, batch_stats = to_np(v["params"]), to_np(v["batch_stats"])
    rng = np.random.default_rng(0)
    for name, sub in params["head"].items():
        if name.startswith("dec_score_head"):
            sub["bias"] = np.zeros_like(sub["bias"])
        if name.startswith(("dec_bbox_head", "enc_bbox_head")):
            k = sub["layers2"]["kernel"]
            sub["layers2"]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
        if name.startswith("layer"):
            for lin in ("sampling_offsets", "attention_weights"):
                k = sub["cross_attn"][lin]["kernel"]
                sub["cross_attn"][lin]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
    return model, params, batch_stats
