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


def jax_nano_session(tmp_path_factory):
    """`jax_nano_variables()`, its arrays computed once per test session
    (`session_cached`): the JAX model, params and batch_stats."""
    from tamtr_tpu.nn.graph import TAMTRModel

    params, batch_stats = session_cached(tmp_path_factory, "eval-nano", lambda: jax_nano_variables()[1:])
    return TAMTRModel.from_yaml("tamtr-nano.yaml", nc=NC), params, batch_stats


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


def flax_variables_of(port):
    """(params, batch_stats) as nested numpy dicts for the JAX `TAMTRModel`
    of the same config, from a port model's state dict
    (`tamtr_torch/weights.py:to_jax_variables`, the inverse of
    `from_jax_variables`). A JAX model takes the port's seeded weights this
    way without the compile of its own init."""
    from tamtr_torch.weights import to_jax_variables

    v = to_jax_variables(port)
    return v["params"], v["batch_stats"]


def relabel_for_task(data, task: str, seed: int = 0):
    """Rewrite the box labels of a generated dataset (`tools/smoke_train_torch.py:
    make_dataset`, under `data`'s directory) for the segment or pose task:
    each box becomes a polygon of 6 to 12 points on an ellipse inside it
    (segment), or keeps its box and gets 17 keypoints inside it, about a
    fifth of them invisible (pose). Returns `data`."""
    from pathlib import Path

    rng = np.random.default_rng(seed)
    for lf in sorted(Path(data).parent.glob("*/labels/*.txt")):
        rows = []
        for line in lf.read_text().splitlines():
            c, cx, cy, w, h = line.split()
            cx, cy, w, h = float(cx), float(cy), float(w), float(h)
            if task == "segment":
                a = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(6, 13))))
                pts = np.stack([cx + w / 2 * np.cos(a), cy + h / 2 * np.sin(a)], 1).clip(0, 1)
                rows.append(" ".join([c] + [f"{v:.5f}" for v in pts.ravel()]))
            else:
                xy = np.stack([cx + w * rng.uniform(-0.45, 0.45, 17), cy + h * rng.uniform(-0.45, 0.45, 17)], 1)
                vis = np.where(rng.random(17) < 0.2, 0.0, 2.0)
                kp = np.concatenate([xy.clip(0, 1), vis[:, None]], 1)
                rows.append(" ".join([c, f"{cx:.5f}", f"{cy:.5f}", f"{w:.5f}", f"{h:.5f}"]
                                     + [f"{v:.5f}" for v in kp.ravel()]))
        lf.write_text("\n".join(rows))
    return data


def yolo_task_cfg(head: str, nc: int = NC) -> dict:
    """`yolo_narrow_cfg` with its head row swapped to `head` ("Segment", or
    "Pose" with the default kpt_shape (17, 3) in the row)."""
    cfg = yolo_narrow_cfg(nc)
    cfg["head"][-1] = [[15, 18, 21], 1, head, ["nc"] + ([[17, 3]] if head == "Pose" else [])]
    return cfg


@torch.no_grad()
def calibrate_yolo_head(model, img):
    """A port YOLO model (Detect, Segment or Pose) whose head normalises the
    eval features of `img` (B, H, W, 3) with their own statistics, as
    `calibrate_detect_model` does for Detect: every head BatchNorm takes its
    input's batch moments (the head run once in train mode from zeroed
    statistics, which then hold 0.03 of the batch's), and the first one of
    each branch and the Proto's first a scale of sqrt((var + eps) / var)."""
    from tamtr_torch.nn.layers import BN_MOMENTUM

    head = model.model[-1]
    feats = []
    hook = head.register_forward_pre_hook(lambda m, a: feats.append(a[0]))
    model.eval()(img, torch.zeros(img.shape[0], model.nc, model.text_width))
    hook.remove()
    bns = [m for m in head.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    firsts = [br[0].bn for name in ("cv2", "cv3", "cv4") for br in getattr(head, name, [])]
    if hasattr(head, "proto"):
        firsts.append(head.proto.cv1.bn)

    def take_stats():
        for bn in bns:
            bn.running_mean.zero_()
            bn.running_var.zero_()
        head.train()(feats[0])
        head.eval()
        for bn in bns:
            bn.running_mean.div_(BN_MOMENTUM)
            bn.running_var.div_(BN_MOMENTUM)

    take_stats()
    for bn in firsts:
        var = bn.running_var
        bn.weight.mul_(torch.where(var > 0, torch.sqrt((var + bn.eps) / var.clamp(min=1e-30)), 1.0))
    take_stats()
    return model


# ---------------------------------------------------------------------------
# The DETR head variants (`tests/test_torch_heads*.py`): each head on
# `tamtr-nano.yaml`'s wiring with its row swapped, as
# `tests/test_head_variants.py` builds them
# ---------------------------------------------------------------------------

HEAD_NC, HEAD_B, HEAD_M, HEAD_NQ, HEAD_ND = 5, 2, 6, 20, 12
HEADS = ["RTDETRDecoder", "ManbaDecoder", "DecouplingManbaWorldDecoder", "DecouplingDFLManbaWorldDecoder",
         "locationManbaDecoder", "DualRTDETRDecoder"]
HEAD_TEXT_WIDTH = {"DecouplingManbaWorldDecoder": HD, "DecouplingDFLManbaWorldDecoder": HD}


def session_cached(tmp_path_factory, name: str, make):
    """`make()` (a picklable tree of numpy arrays) computed once per test
    session: the first caller computes it under a file lock and writes it
    beside the session's temporary directories, where every xdist worker
    of the session reads it; the others wait on the lock, then read. A JAX
    init that several test files need is then compiled once per run."""
    import fcntl
    import os
    import pickle

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the session's workers
    path = root / f"shared-{name}.pkl"
    with open(root / f"shared-{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return pickle.loads(path.read_bytes())
            value = make()
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(value))
            tmp.rename(path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def variant_cfg(head: str) -> dict:
    """`tamtr-nano.yaml` with its head row swapped (JSON, which YAML reads)."""
    from tamtr_torch.nn.graph import load_model_cfg

    cfg = load_model_cfg("tamtr-nano.yaml")
    froms = [32, 36, 32, 36] if head == "DualRTDETRDecoder" else [32, 36, 40]
    extra = [True] if head in HEAD_TEXT_WIDTH else []
    cfg["head"][-1] = [froms, 1, head, ["nc", HD, HEAD_NQ, 4, 8, 3] + extra]
    return cfg


def jax_head(head: str, ch):
    """The JAX head module `tamtr_tpu/nn/graph.py` builds for `head` (the
    Dual head's shared core), DropPath off."""
    from tamtr_tpu.nn.decoder import LocationManbaDecoder, ManbaWorldDecoder

    kw = dict(nc=HEAD_NC, hd=HD, nq=HEAD_NQ, ndp=4, nh=8, ndl=3, max_gt=HEAD_M, num_denoising=HEAD_ND,
              vss_drop_path=0.0)
    if head == "locationManbaDecoder":
        return LocationManbaDecoder(ch=ch, **kw)
    if head == "DualRTDETRDecoder":
        return ManbaWorldDecoder(ch=ch[:len(ch) // 2], use_text=False, use_vss=False, **kw)
    variant = {"DecouplingManbaWorldDecoder": "decouple", "DecouplingDFLManbaWorldDecoder": "dfl"}.get(head, "base")
    return ManbaWorldDecoder(ch=ch, use_text=head in HEAD_TEXT_WIDTH, use_vss=head != "RTDETRDecoder",
                             variant=variant, **kw)


def apply_head(head: str, module, variables, feats, text, targets, train: bool):
    """The head's output, as `tamtr_tpu/nn/graph.py` calls it (the Dual core
    on each half of the levels); train also returns the new statistics."""
    import jax

    kw = dict(rngs={"cdn": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"]) \
        if train else {}
    if head != "DualRTDETRDecoder":
        return module.apply(variables, feats, text, targets, train, **kw)
    half = len(feats) // 2
    o1, o2 = (module.apply(variables, part, text, targets, train, **kw) for part in (feats[:half], feats[half:]))
    if not train:
        return {"pred": [o1["pred"], o2["pred"]]}
    return {"dual": (o1[0], o2[0]), **o1[0]}, o1[1]


def head_inputs(seed: int, width: int = HD):
    """Seeded images (HEAD_B, IMG, IMG, 3) and a unit text table (1, HEAD_NC, width)."""
    rng = np.random.default_rng(seed)
    img = rng.random((HEAD_B, IMG, IMG, 3), dtype=np.float32)
    txt = rng.standard_normal((1, HEAD_NC, width)).astype(np.float32)
    return img, txt / np.linalg.norm(txt, axis=-1, keepdims=True)


def head_targets(seed: int):
    """Padded targets of HEAD_M slots, 5 and 2 gts."""
    rng = np.random.default_rng(seed)
    mask = np.arange(HEAD_M)[None] < np.array([[5], [2]])
    box = np.concatenate([rng.uniform(0.2, 0.8, (HEAD_B, HEAD_M, 2)), rng.uniform(0.05, 0.4, (HEAD_B, HEAD_M, 2))],
                         -1)
    return {"cls": rng.integers(0, HEAD_NC, (HEAD_B, HEAD_M)).astype(np.int32),
            "bboxes": (box * mask[..., None]).astype(np.float32), "mask": mask}


@pytest.fixture(scope="module")
def heads_base(tmp_path_factory):
    """The JAX nano model's (params, batch_stats), initialised under
    `jax.jit`, and its features of the seeded eval images (the heads' train
    inputs): computed once per test session (`session_cached`)."""
    def make():
        import jax
        import jax.numpy as jnp

        from tamtr_tpu.nn.graph import TAMTRModel

        jm = TAMTRModel.from_yaml("tamtr-nano.yaml", nc=HEAD_NC)
        params, bs = jax_variables(jm, IMG, HEAD_NC, HD)
        img, _ = head_inputs(0)
        feats = jax.jit(lambda p, s, i: jm.apply({"params": p, "batch_stats": s}, i, jnp.zeros((HEAD_B, HEAD_NC, HD)),
                                                 None, False, features_only=True))(params, bs, img)
        return params, bs, [np.asarray(f) for f in feats]

    return session_cached(tmp_path_factory, "heads-base", make)


_VARIANTS = {}


def head_variant(head, base, tmp_path_factory):
    """(JAX model, params, batch_stats, head module, port model) of `head`
    on the nano wiring, built once per module; the head's JAX init once per
    test session (`session_cached`)."""
    if head in _VARIANTS:
        return _VARIANTS[head]
    import jax
    import jax.numpy as jnp

    from tamtr_tpu.nn.graph import TAMTRModel

    from tamtr_torch.nn.graph import TAMTRModel as PortModel
    from tamtr_torch.weights import from_jax_variables

    params, bs, feats = base
    path = tmp_path_factory.mktemp("heads") / f"{head}.json"
    path.write_text(json.dumps(variant_cfg(head)))
    jm = TAMTRModel.from_yaml(path, nc=HEAD_NC, max_gt=HEAD_M, num_denoising=HEAD_ND, vss_drop_path=0.0)
    levels = [feats[[32, 36, 40].index(j)] for j in jm.head_from]
    module = jax_head(head, tuple(f.shape[-1] for f in levels))
    width = HEAD_TEXT_WIDTH.get(head, 512)
    to_np = lambda t: {k: to_np(x) if hasattr(x, "items") else np.array(x) for k, x in t.items()}  # noqa: E731
    hv = session_cached(tmp_path_factory, f"head-{head}", lambda: to_np(jax.device_get(jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(3)}, [jnp.asarray(f) for f in levels[:len(module.ch)]],
        jnp.zeros((1, HEAD_NC, width)), None, False))())))
    rng = np.random.default_rng(4)
    params = {**params, "head": spread_head_params(hv["params"], rng)}
    bs = {**bs, "head": hv.get("batch_stats", {})}
    for name in params:  # the TIAGELANs' text attention at this head's text width (never run)
        if name.endswith("TIAGELAN"):
            gl = params[name]["attn"]["gl"]
            params[name] = {**params[name], "attn": {**params[name]["attn"], "gl": {
                "kernel": (rng.standard_normal((width, gl["kernel"].shape[1])) * 0.05).astype(np.float32),
                "bias": gl["bias"]}}}
    port = PortModel(variant_cfg(head), nc=HEAD_NC, max_gt=HEAD_M, num_denoising=HEAD_ND, vss_drop_path=0.0,
                     label_noise_ratio=0.0, box_noise_scale=0.0)
    sd, report = from_jax_variables(params, bs, port)
    assert not any(report.values()), report
    port.load_state_dict(sd, strict=True)
    _VARIANTS[head] = (jm, params, bs, module, port.eval())
    return _VARIANTS[head]


def check_variant_eval(head, base, tmp_path_factory):
    """The head's model's eval against JAX's: pred as a set of rows at 1e-3
    (`assert_same_row_set`), of each half for the Dual head."""
    import jax

    jm, params, bs, _, port = head_variant(head, base, tmp_path_factory)
    assert port.head_type == head and port.uses_text == jm.uses_text
    assert port.text_width == HEAD_TEXT_WIDTH.get(head, 512)
    img, txt = head_inputs(1, port.text_width)
    want = jax.jit(lambda i, t: jm.apply({"params": params, "batch_stats": bs}, i, t, None, False)["pred"])(img, txt)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(txt))["pred"]
    pairs = zip(got, want) if head == "DualRTDETRDecoder" else [(got, want)]
    for g, w in pairs:
        assert g.shape == (HEAD_B, HEAD_NQ, 4 + HEAD_NC)
        assert_same_row_set(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def no_cdn_noise():
    """The JAX package's CDN queries without noise (the port's head models
    are built with none): the two frameworks' random streams differ."""
    import tamtr_tpu.nn.decoder as jdec

    orig = jdec.get_cdn_group
    mp = pytest.MonkeyPatch()
    mp.setattr(jdec, "get_cdn_group", lambda *a, **k: orig(*a[:7], 0.0, 0.0))
    yield
    mp.undo()


def check_variant_train_step(head, base, tmp_path_factory, monkeypatch):
    """The head's training forward and gradient on the nano features, with
    JAX's top-k query order and assignment given to the port
    (`tests/test_torch_heads_step.py`'s bounds)."""
    import copy

    import jax
    import jax.numpy as jnp

    from tamtr_tpu.losses.detr_loss import DETRLossConfig as JCfg
    from tamtr_tpu.losses.detr_loss import rtdetr_detection_loss as jax_loss
    from tamtr_tpu.losses.matcher import hungarian_match
    from test_torch_train import _rel_err, _to_np, pin_topk

    from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
    from tamtr_torch.weights import from_jax_variables

    B, M = HEAD_B, HEAD_M
    _, params, bs, module, port = head_variant(head, base, tmp_path_factory)
    feats = [base[2][[32, 36, 40].index(j)] for j in port.head_from]
    tg = head_targets(2)
    width = port.text_width
    txt = head_inputs(3, width)[1].repeat(B, 0)
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    picked, top_k = [], jax.lax.top_k

    def recording(x, k):
        res = top_k(x, k)
        picked.append(res[1])
        return res

    def jl(p):  # the loss of JAX's own assignment, the outputs and the top-k indices
        out, _ = apply_head(head, module, {"params": p, "batch_stats": bs["head"]}, [jnp.asarray(f) for f in feats],
                            jnp.asarray(txt), jt, True)
        return jax_loss(out, jt, JCfg(nc=HEAD_NC))[0], (out, list(picked))

    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", recording)
        (want_loss, (out_j, jtopk)), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(params["head"])
    nd = int(out_j["num_dn"])
    bj, sj = (jnp.concatenate([jnp.asarray(out_j[f"enc_{k}"])[None], jnp.asarray(out_j[f"dec_{k}"])[:, :, nd:]], 0)
              for k in ("bboxes", "scores"))
    L = bj.shape[0]
    tile = lambda x: jnp.tile(jnp.asarray(x), (L,) + (1,) * (x.ndim - 1))  # noqa: E731
    jmatch = hungarian_match(bj.reshape(L * B, *bj.shape[2:]), sj.reshape(L * B, *sj.shape[2:]),
                             *(tile(tg[k]) for k in ("bboxes", "cls", "mask")))
    jmatch = torch.from_numpy(np.asarray(jmatch).astype(np.int64)).view(L, B, M)

    hm = copy.deepcopy(port.model[-1]).train()  # the module-scoped model stays in eval, its statistics unmoved
    pt = {k: torch.from_numpy(v) for k, v in tg.items()}
    with monkeypatch.context() as mp:
        pin_topk(mp, [torch.from_numpy(np.asarray(t).astype(np.int64)) for t in jtopk], [])
        out_p = hm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats], torch.from_numpy(txt), pt,
                   torch.Generator().manual_seed(0))
    loss, _ = rtdetr_detection_loss(out_p, pt, DETRLossConfig(nc=HEAD_NC), match=jmatch)
    hm.zero_grad()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    nd = out_p["num_dn"]
    assert nd == int(out_j["num_dn"]) == 2 * (HEAD_ND // M) * M
    for k in ("dec_bboxes", "dec_scores"):
        got, want = out_p[k].detach().numpy(), np.asarray(out_j[k])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3, err_msg=k)
    hidx = len(port.specs)
    gsd, _ = from_jax_variables({**params, "head": _to_np(jax.device_get(jgrads))}, bs, port)
    g32 = {k: p.grad.double().numpy() if p.grad is not None else np.zeros(tuple(p.shape))
           for k, p in ((f"model.{hidx}.{n}", p) for n, p in hm.named_parameters())}
    gj = {k: gsd[k].double().numpy() for k in g32}
    whole = lambda g: np.concatenate([v.ravel() for v in g.values()])  # noqa: E731
    rel = float(_rel_err(whole(g32), whole(gj)))
    top = max(np.linalg.norm(g) for g in gj.values())
    per_tensor = {k: float(_rel_err(g, gj[k])) for k, g in g32.items() if np.linalg.norm(gj[k]) > 1e-6 * top}
    print(f"{head}: head gradient |port - jax| {rel}; worst tensor {max(per_tensor.items(), key=lambda kv: kv[1])}")
    assert rel < 2e-2, rel
    for k, e in per_tensor.items():
        assert e < 7.5e-2, (k, e)
    assert sum(np.abs(g).max() > 0 for g in g32.values()) > 0.5 * len(g32)


# ---------------------------------------------------------------------------
# Segment Anything (`tests/test_torch_sam.py`, `tests/test_torch_sam_predict.py`)
# ---------------------------------------------------------------------------


def sam_flax_variables_of(sam):
    """The JAX package's SAM variables ({"image_encoder": {"params",
    "batch_stats"}, "prompt_encoder": ..., "mask_decoder": ...}, nested
    numpy dicts) of a port `SamModel`: the inverse of
    `tamtr_torch/weights.py:from_jax_sam_variables`. A JAX SAM takes the
    port's weights this way, with no JAX init."""
    from tamtr_torch.weights import sam_flax_route

    def to_flax(val, kind):  # the bridge's layout changes, undone
        if kind == "conv_transpose":  # (in, out, kH, kW) flipped -> (kH, kW, in, out)
            return val[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        if kind == "conv":  # OIHW -> HWIO
            return val.transpose(2, 3, 1, 0)
        return val.T if kind == "linear" else val

    trees, rows = {}, {}
    sd = sam.state_dict()
    for key, (top, col, path, kind) in sam_flax_route(sam).items():
        val = sd[key].detach().float().numpy()
        if isinstance(kind, tuple):  # a row of point_embeddings
            rows.setdefault((top, col, tuple(path)), {})[kind[1]] = val[0]
            continue
        node = trees.setdefault(top, {}).setdefault(col, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(to_flax(val, kind), np.float32)
    for (top, col, path), r in rows.items():
        trees[top][col][path[-1]] = np.stack([r[k] for k in sorted(r)]).astype(np.float32)
    return trees


@torch.no_grad()
def spread_sam(sam, seed: int = 0, scale: float = 0.2):
    """A port SAM with its zero-initialised tensors (pos_embed, rel_pos_*,
    attention_biases, the biases) and its norms' and BatchNorms' scales,
    biases and statistics given seeded random values, so that every
    parameter moves the output."""
    g = torch.Generator().manual_seed(seed)
    for name, t in sam.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith("running_var"):
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
        elif name.endswith(("bias", "running_mean", "pos_embed", "rel_pos_h", "rel_pos_w", "attention_biases")):
            t.copy_(torch.randn(t.shape, generator=g) * scale)
        elif t.ndim == 1 and name.endswith("weight"):  # LayerNorm and BatchNorm scales
            t.copy_(1.0 + torch.randn(t.shape, generator=g) * scale)
    return sam


def classify_narrow_cfg(nc: int = NC) -> dict:
    """`classify-gelan.yaml`'s wiring (the GELAN backbone, then Classify on
    the last map) at `yolo_narrow_cfg`'s eighth widths: the classify
    family's small test model."""
    return {"nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0,
            "backbone": yolo_narrow_cfg(nc)["backbone"][:9], "head": [[[-1], 1, "Classify", ["nc"]]]}


@torch.no_grad()
def calibrate_bn(model, img):
    """A port model whose every BatchNorm holds the batch moments of its
    input over `img` (B, H, W, 3) in a train-mode forward: in eval the
    model then computes that forward on `img`, its activations of order 1
    at every layer (at init SiLU shrinks them ~2x a layer, to ~1e-4 at a
    GELAN's last map, and the logits would be its biases)."""
    from tamtr_torch.nn.layers import BN_MOMENTUM

    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.running_mean.zero_()
        bn.running_var.zero_()
    model.train()(img, torch.zeros(img.shape[0], 1, 512))
    for bn in bns:
        bn.running_mean.div_(BN_MOMENTUM)
        bn.running_var.div_(BN_MOMENTUM)
    return model.eval()


def write_image_folder(root, classes=("green", "red", "blue"), n=(6, 3), seed: int = 0):
    """An ImageFolder `root/{train,val}/<class>/` of n[0] and n[1] images a
    class (PNG and JPEG, written by the port's encoders), of mixed sizes,
    the class's colour channel high: returns root."""
    from tamtr_torch.data.image_io import imwrite

    rng = np.random.default_rng(seed)
    for split, k in zip(("train", "val"), n):
        for ci, c in enumerate(classes):
            d = root / split / c
            d.mkdir(parents=True, exist_ok=True)
            for i in range(k):
                h, w = (int(v) for v in rng.integers(36, 72, 2))
                img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
                img[..., ci % 3] += 150
                imwrite(d / f"{i}.{'jpg' if i % 3 == 2 else 'png'}", img)
    return root


@torch.no_grad()
def spread_tamtr(model, seed: int = 7):
    """A seeded TAM-TR model (eval mode) whose outputs depend on its
    weights: every BatchNorm holding its input's moments over 4 seeded
    images (the BatchNorms alone in train mode for that forward), the
    contrastive heads' biases 0."""
    from tamtr_torch.nn.decoder import ContrastiveHead, ContrastiveHead2D
    from tamtr_torch.nn.layers import BN_MOMENTUM

    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.running_mean.zero_()
        bn.running_var.zero_()
        bn.train()
    x = torch.from_numpy(np.random.default_rng(seed).random((4, IMG, IMG, 3), dtype=np.float32))
    model(x, torch.zeros(4, model.nc, model.text_width))
    for bn in bns:
        bn.running_mean.div_(BN_MOMENTUM)
        bn.running_var.div_(BN_MOMENTUM)
        bn.eval()
    for mod in model.modules():
        if isinstance(mod, (ContrastiveHead, ContrastiveHead2D)):
            mod.bias.zero_()
    return model
