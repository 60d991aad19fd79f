"""What the port's engine tests share (`tests/test_torch_engine.py`,
`tests/test_torch_engine_train.py`, `tests/test_torch_predict.py`,
`tests/test_torch_cli.py` and the parallel, yolo, rtdetr and heads files):
the nano shapes, one torch thread, the class text table, a 64 px PNG val
split (square, or of mixed aspect ratios) labelled by a model, the JAX nano
model's variables with spread head weights, and the narrow Detect model's
config and head spreading. Not a conftest: that one
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


def assert_same_row_set(got, want, atol=1e-3):
    """Eval outputs (B, nq, 4 + nc) equal as sets of rows, as
    `tests/test_torch_model.py` compares them (top-k may swap near-tied
    queries): rows paired by a min-cost assignment, all but two an image
    within `atol`, and those two of equal best score (boundary ties)."""
    from scipy.optimize import linear_sum_assignment

    for b in range(got.shape[0]):
        dist = np.abs(got[b][:, None] - want[b][None]).max(-1)
        r, c = linear_sum_assignment(dist)
        ok = dist[r, c] < atol
        assert ok.sum() >= len(ok) - 2, np.sort(dist[r, c])[-3:]
        if not ok.all():
            np.testing.assert_allclose(np.sort(got[b][r[~ok], 4:].max(-1)), np.sort(want[b][c[~ok], 4:].max(-1)),
                                       atol=5e-3)


def unit_text() -> np.ndarray:
    """(NC, HD) unit rows from a numpy seed: the class text embeddings."""
    t = np.random.default_rng(1).standard_normal((NC, HD)).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def write_val_split(root, model, txt, names=NAMES, jitter=0.08):
    """6 val PNGs of 64 px (the val resize is the identity) under `root`,
    labelled with `model`'s top-3 detections, box corners jittered by up to
    `jitter` (relative), for the classes `names`; returns the `data.json`
    path."""
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
        xyxy = boxes[i][valid[i]][:3] * (1 + rng.uniform(-jitter, jitter, (min(3, valid[i].sum()), 4)))
        xyxy = xyxy.clip(0, 1)
        lines = [f"{c} {(a + c2) / 2:.5f} {(b + d) / 2:.5f} {c2 - a:.5f} {d - b:.5f}"
                 for c, (a, b, c2, d) in zip(labels[i][valid[i]][:3], xyxy)]
        (root / "labels" / f"{i}.txt").write_text("\n".join(lines))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "images", "val": "images", "nc": len(names),
                                "names": list(names)}))
    return data


def spread_head_params(tree, rng):
    """Flax params of a DETR head (or a tree holding such layers) with the
    zero-initialised layers given small random values from `rng` (the last
    box-MLP layers, sampling offsets, attention weights) and the score
    biases 0, so that every part of the head moves the output."""
    for name, sub in tree.items():
        if not hasattr(sub, "items"):
            continue
        if name in ("sampling_offsets", "attention_weights"):
            sub["kernel"] = (rng.standard_normal(sub["kernel"].shape) * 0.05).astype(np.float32)
        elif name.startswith(("dec_bbox_head", "enc_bbox_head")):
            k = sub["layers2"]["kernel"]
            sub["layers2"]["kernel"] = (rng.standard_normal(k.shape) * 0.05).astype(np.float32)
        elif name.startswith(("dec_score_head", "cv4_")):
            sub["bias"] = np.zeros_like(sub["bias"])
        else:
            spread_head_params(sub, rng)
    return tree


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


def yolo_narrow_cfg(nc: int = NC) -> dict:
    """`yolo-gelan.yaml`'s wiring at an eighth of its widths, with a Detect
    head of `nc` classes: the Detect family's small test model (as
    `tamtr-nano.yaml` is TAM-TR's). JSON, which YAML reads too, so one file
    serves both packages."""
    e = lambda c2, c3, c4: [c2, c3, c4, 1]  # noqa: E731
    return {
        "nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0,
        "backbone": [
            [-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepNCSPELAN4", e(32, 16, 8)],
            [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "RepNCSPELAN4", e(64, 32, 16)], [-1, 1, "Conv", [64, 3, 2]],
            [-1, 1, "RepNCSPELAN4", e(64, 64, 32)], [-1, 1, "Conv", [64, 3, 2]],
            [-1, 1, "RepNCSPELAN4", e(64, 64, 32)], [-1, 1, "SPPELAN", [64, 32]],
        ],
        "head": [
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]], [[-1, 6], 1, "Concat", [1]],
            [-1, 1, "RepNCSPELAN4", e(64, 64, 32)], [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
            [[-1, 4], 1, "Concat", [1]], [-1, 1, "RepNCSPELAN4", e(32, 32, 16)], [-1, 1, "Conv", [32, 3, 2]],
            [[-1, 12], 1, "Concat", [1]], [-1, 1, "RepNCSPELAN4", e(64, 64, 32)], [-1, 1, "Conv", [64, 3, 2]],
            [[-1, 9], 1, "Concat", [1]], [-1, 1, "RepNCSPELAN4", e(64, 64, 32)],
            [[15, 18, 21], 1, "Detect", ["nc"]],
        ],
    }


def write_yolo_narrow(root, nc: int = NC):
    """`yolo_narrow_cfg` written as `yolo-narrow.json` under `root`; returns its path."""
    path = root / "yolo-narrow.json"
    path.write_text(json.dumps(yolo_narrow_cfg(nc)))
    return path


def spread_detect_params(params):
    """Flax params of a Detect model with its heads spread so that a fresh
    model already assigns and detects: class biases 0 (scores near 0.5, not
    the prior's 1e-4) and box biases that put each side's DFL mass on bins 1
    and 2 (boxes of about 3 cells, not 15)."""
    for name, sub in params["head"].items():
        if name.startswith("cv3_") and name.endswith("_2"):
            sub["bias"] = np.zeros_like(sub["bias"])
        elif name.startswith("cv2_") and name.endswith("_2"):
            reg = sub["bias"].shape[0] // 4
            sub["bias"] = np.tile(-2.0 * np.abs(np.arange(reg) - 1.5), 4).astype(np.float32)
    return params


def calibrated_head(model, params, batch_stats, img: int, n_text: int = NC, seed: int = 0):
    """(params, batch_stats) of a JAX Detect model whose head normalises
    the eval-mode features of 4 seeded random images with their own
    statistics. At init (BatchNorm mean 0, variance 1) SiLU's slope of ~0.5
    shrinks the activations a layer, to ~1e-4 at the head of a GELAN and
    ~3e-7 at its deepest level, so the head's outputs are its biases alone.
    Here each head BatchNorm takes the batch statistics of its input, and
    the first one of each branch a scale of sqrt((var + eps) / var), which
    undoes BatchNorm's eps (1e-3, far above those variances): the head's
    activations are then of order 1 and vary with the image. (Calibrating
    every layer instead leaves channels whose variance over 4 images is
    near 0, and another image's activations then grow through the graph.)
    flax moves each running statistic by 3% towards the batch's: from
    zeros, the batch's is the new one over 0.03."""
    import jax
    import jax.numpy as jnp

    from tamtr_tpu.nn.yolo_head import Detect

    x = np.random.default_rng(seed).random((4, img, img, 3), dtype=np.float32)
    feats = jax.jit(lambda p, b: model.apply({"params": p, "batch_stats": b}, x, jnp.zeros((4, n_text, 512)), None,
                                             False, features_only=True))(params, batch_stats)
    zeros = jax.tree.map(np.zeros_like, batch_stats["head"])

    def head_stats(head_params):
        _, mut = Detect(nc=model.nc).apply({"params": head_params, "batch_stats": zeros}, feats, True,
                                           mutable=["batch_stats"])
        return jax.tree.map(lambda n: (np.asarray(n) / np.float32(0.03)).astype(np.float32),
                            jax.device_get(mut["batch_stats"]))

    first = head_stats(params["head"])
    head = {k: dict(v) for k, v in params["head"].items()}
    for name, sub in head.items():
        if name.endswith("_0"):
            var = first[name]["BatchNorm_0"]["var"]
            sub["BatchNorm_0"] = {**sub["BatchNorm_0"], "scale": (np.asarray(sub["BatchNorm_0"]["scale"]) * np.sqrt(
                (var + 1e-3) / var)).astype(np.float32)}
    return {**params, "head": head}, {**batch_stats, "head": head_stats(head)}


def jax_variables(model, img: int, n_text: int = NC, width: int = 512):
    """(params, batch_stats) as numpy trees of a JAX `TAMTRModel`,
    initialised under `jax.jit` from key 0 at `img` px."""
    import jax
    import jax.numpy as jnp

    v = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, img, img, 3)), jnp.zeros((1, n_text, width)), None,
        False))())
    to_np = lambda t: {k: to_np(x) if hasattr(x, "items") else np.array(x) for k, x in t.items()}  # noqa: E731
    return to_np(v["params"]), to_np(v["batch_stats"])


def spread_detect_model(model):
    """A port Detect model's heads spread as `spread_detect_params` spreads
    the flax ones: class biases 0, each side's DFL mass on bins 1 and 2."""
    head = model.model[-1]
    with torch.no_grad():
        for b, c in zip(head.cv2, head.cv3):
            b[2].bias.copy_((-2.0 * (torch.arange(head.reg_max, dtype=torch.float32) - 1.5).abs()).repeat(4))
            c[2].bias.zero_()
    return model


@torch.no_grad()
def calibrate_detect_model(model, img):
    """A port Detect model's eval head normalising the features of `img`
    (B, H, W, 3) with their own statistics, as `calibrated_head` does for
    the flax one: each head BatchNorm takes its input's batch moments, and
    the first of each branch a scale of sqrt((var + eps) / var)."""
    feats = []
    head = model.model[-1]
    hook = head.register_forward_pre_hook(lambda m, a: feats.append(a[0]))
    model.eval()(img, torch.zeros(img.shape[0], model.nc, model.text_width))
    hook.remove()
    for f, branches in zip(feats[0], zip(head.cv2, head.cv3)):
        for br in branches:
            x = f
            for j, cb in enumerate(br[:2]):
                var, mean = torch.var_mean(cb.conv(x), (0, 2, 3), unbiased=False)
                cb.bn.running_mean.copy_(mean)
                cb.bn.running_var.copy_(var)
                if j == 0:
                    cb.bn.weight.mul_(torch.where(var > 0, torch.sqrt((var + cb.bn.eps) / var.clamp(min=1e-30)), 1.0))
                x = cb(x)
    return model


RECT_SHAPES = [(64, 64), (48, 64), (64, 48), (40, 64), (64, 40), (56, 64)]


def write_rect_val_split(root, model, txt, names=NAMES):
    """6 val PNGs of mixed aspect ratios (`RECT_SHAPES`) under `root`,
    labelled with a Detect `model`'s top-3 detections of each image
    stretched square, corners jittered by up to 8%; returns the `data.json`
    path."""
    from tamtr_torch.data.image_io import imwrite
    from tamtr_torch.data.imgproc import resize_linear
    from tamtr_torch.engine.model import normalized_pred
    from tamtr_torch.ops.nms import postprocess_predictions

    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(RECT_SHAPES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        x = resize_linear(img, (IMG, IMG))[..., ::-1].astype(np.float32) / 255.0
        with torch.inference_mode():
            pred = normalized_pred(model, model(torch.from_numpy(x.copy())[None], torch.from_numpy(txt[None]))["pred"],
                                   (IMG, IMG))
        boxes, _, labels, valid, _ = (t.numpy() for t in postprocess_predictions(pred, 0.25, 0.7, 300))
        n = min(3, int(valid[0].sum()))
        xyxy = (boxes[0][valid[0]][:n] * (1 + rng.uniform(-0.08, 0.08, (n, 4)))).clip(0, 1)
        imwrite(root / "images" / f"{i}.png", img)
        (root / "labels" / f"{i}.txt").write_text("\n".join(
            f"{c} {(a + c2) / 2:.5f} {(b + d) / 2:.5f} {c2 - a:.5f} {d - b:.5f}"
            for c, (a, b, c2, d) in zip(labels[0][valid[0]][:n], xyxy)))
    data = root / "data.json"
    data.write_text(json.dumps({"path": str(root), "train": "images", "val": "images", "nc": len(names),
                                "names": list(names)}))
    return data
