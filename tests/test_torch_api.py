"""The port's configs, box ops, postprocessing, entry point and import rules,
on the CPU."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tamtr_torch.api import TAMTR
from tamtr_torch.nn.graph import load_model_cfg
from tamtr_torch.ops import boxes as pboxes
from tamtr_torch.ops import nms as pnms

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["tamtr", "tamtr-nano", "tamtr-mid"])
def test_json_configs_equal_the_yaml(name):
    with open(REPO / "tamtr_tpu" / "cfg" / "models" / f"{name}.yaml") as f:
        want = yaml.safe_load(f)
    assert load_model_cfg(f"{name}.yaml") == want
    with pytest.raises(FileNotFoundError):
        load_model_cfg("no-such-model.yaml")


def test_import_without_jax_yaml_or_cv2():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tamtr_tpu', 'yaml', 'cv2', 'PIL', 'matplotlib',\n"
        "          'tensorboard', 'av', 'ffmpeg', 'imageio', 'transformers', 'safetensors', 'regex', 'ftfy',\n"
        "          'ultralytics', 'timm'):\n"
        "    sys.modules[m] = None\n"
        "import tamtr_torch, tamtr_torch.weights, tamtr_torch.kernels._build, chip_smoke\n"
        "import tamtr_torch.train.trainer, tamtr_torch.losses.detr_loss, tamtr_torch.losses.matcher\n"
        "import tamtr_torch.kernels.auction, tamtr_torch.ops.boxes\n"
        "import tamtr_torch.config, tamtr_torch.engine.model, tamtr_torch.engine.checkpoint\n"
        "import tamtr_torch.data.dataset, tamtr_torch.data.augment, tamtr_torch.data.imgproc\n"
        "import tamtr_torch.data.image_io, tamtr_torch.data.text, tamtr_torch.utils.metrics\n"
        "import tamtr_torch.utils.coco, tamtr_torch.utils.callbacks, tamtr_torch.utils.checks\n"
        "import tamtr_torch.utils.files, tools.smoke_train_torch\n"
        "import tamtr_torch.cli, tamtr_torch.serve, tamtr_torch.nn.autobackend, tamtr_torch.engine.results\n"
        "import tamtr_torch.utils.plotting, tamtr_torch.data.loaders, tamtr_torch.data.converter\n"
        "import tamtr_torch.data.video_io, tamtr_torch.data.clip_tokenizer, tamtr_torch.nn.clip_text\n"
        "import tamtr_torch.weight_files, tools.encode_texts_torch\n"
        "import tools.port_torch_weights_torch, tools.make_reference_ckpt_torch\n"
        "import tools.convert_visdrone_torch, tamtr_torch.trackers.track, tamtr_torch.trackers.bot_sort\n"
        "import tamtr_torch.nn.fuse, tamtr_torch.utils.profiler, tamtr_torch.utils.settings, tamtr_torch.utils.crash\n"
        "import tamtr_torch.utils.autobatch, tamtr_torch.utils.downloads, tamtr_torch.utils.errors\n"
        "import tamtr_torch.parallel.dist, tamtr_torch.parallel.seq_scan, tamtr_torch.parallel.launch\n"
        "import tamtr_torch.models.sam.predict, tamtr_torch.models.fastsam, tamtr_torch.data.annotator\n"
        "from tamtr_torch import TAMTR, RTDETRWorld, YOLO, RTDETR, SAM, FastSAM, NAS\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tamtr_tpu', 'yaml', 'cv2', 'PIL',\n"
        "                                                        'matplotlib', 'tensorboard', 'av', 'ffmpeg',\n"
        "                                                        'imageio', 'transformers', 'safetensors', 'regex',\n"
        "                                                        'ftfy', 'ultralytics', 'timm')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _boxes(rng, n):
    c = rng.uniform(0.2, 0.8, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([c, wh], 1).astype(np.float32)


def test_box_ops_match_jax():
    from tamtr_tpu.ops import boxes as jboxes

    rng = np.random.default_rng(0)
    xywh = _boxes(rng, 12)
    xyxy = np.array(jboxes.xywh2xyxy(jnp.asarray(xywh)))
    np.testing.assert_allclose(pboxes.xywh2xyxy(torch.from_numpy(xywh)).numpy(), xyxy, atol=1e-7)
    np.testing.assert_allclose(pboxes.xyxy2xywh(torch.from_numpy(xyxy)).numpy(),
                               np.asarray(jboxes.xyxy2xywh(jnp.asarray(xyxy))), atol=1e-7)
    np.testing.assert_allclose(
        pboxes.box_iou_pairwise(torch.from_numpy(xyxy[:5]), torch.from_numpy(xyxy)).numpy(),
        np.asarray(jboxes.box_iou_pairwise(jnp.asarray(xyxy[:5]), jnp.asarray(xyxy))), atol=1e-6,
    )


@pytest.mark.parametrize("name", ["xywh2ltwh", "ltwh2xywh", "ltwh2xyxy", "xyxy2ltwh"])
def test_box_conversions_match_jax(name):
    """The left-top-width-height conversions, on a (3, 5, 4) batch, at 1e-7."""
    from tamtr_tpu.ops import boxes as jboxes

    x = np.random.default_rng(len(name)).uniform(-50, 700, (3, 5, 4)).astype(np.float32)
    got = getattr(pboxes, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jboxes, name)(jnp.asarray(x))), rtol=0, atol=1e-7)
    assert got.shape == x.shape


@pytest.mark.parametrize("max_det", [300, 4])
def test_postprocess_matches_jax(max_det):
    """Clustered boxes so that NMS suppresses; ties in score keep the stable
    sort order; max_det=4 truncates the kept list."""
    from tamtr_tpu.ops.nms import postprocess_predictions as jax_post

    rng = np.random.default_rng(1)
    B, nq, nc = 2, 40, 3
    centres = _boxes(rng, 6)
    box = centres[rng.integers(0, 6, (B, nq))] + rng.normal(0, 0.01, (B, nq, 4)).astype(np.float32)
    scores = rng.random((B, nq, nc)).astype(np.float32)
    scores[0, 5] = scores[0, 6]  # an exact tie
    pred = np.concatenate([box, scores], -1)
    want = [np.asarray(a) for a in jax_post(jnp.asarray(pred), 0.25, 0.5, max_det)[:4]]
    got = [t.numpy() for t in pnms.postprocess_predictions(torch.from_numpy(pred), 0.25, 0.5, max_det)]
    assert 0 < want[3].sum() <= B * min(nq, max_det)
    assert want[3].sum() < B * nq  # NMS or max_det dropped queries
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-7)


def test_nms_ignores_non_positive_scores():
    b = torch.tensor([[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3]], dtype=torch.float32)
    keep, mask = pnms.nms(b, torch.tensor([0.0, 0.5, 0.4]), 0.5, max_det=4)
    assert keep.tolist() == [1, 2, -1, -1] and mask.tolist() == [True, True, False, False]


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAMTR("tamtr-nano.yaml")


def test_seeded_init_is_reproducible():
    a = TAMTR("tamtr-nano.yaml", device="cpu", seed=3).model.state_dict()
    b = TAMTR("tamtr-nano.yaml", device="cpu", seed=3).model.state_dict()
    c = TAMTR("tamtr-nano.yaml", device="cpu", seed=4).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.0.conv.weight"], c["model.0.conv.weight"])
    head = "model.41."
    assert torch.all(a[head + "VSSBlocks.0.op.Ds"] == 1)
    assert torch.allclose(a[head + "VSSBlocks.0.op.A_logs"][5], torch.log(torch.arange(1, 17.0)))
    assert torch.all(a[head + "dec_bbox_head.2.layers.2.weight"] == 0)
    assert a[head + "dec_score_head.0.bias"].item() == -10.0


def test_predict_resizes_and_scales_to_each_image():
    """Images of other sizes are resized to imgsz on the device; boxes come
    back in each image's own pixels, equal to a forward + postprocess done
    by hand."""
    import torch.nn.functional as F

    det = TAMTR("tamtr-nano.yaml", nc=4, device="cpu", seed=1, imgsz=64)
    rng = np.random.default_rng(2)
    im_u8 = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    im_f = rng.random((64, 64, 3), dtype=np.float32)
    txt = rng.standard_normal((4, 128)).astype(np.float32)
    res = det.predict([im_u8, im_f], txt, conf=0.0, iou=0.5, max_det=10)
    assert len(res) == 2
    x0 = F.interpolate(torch.from_numpy(im_u8).float().div(255).permute(2, 0, 1)[None], size=(64, 64),
                       mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    x = torch.cat([x0, torch.from_numpy(im_f)[None]])
    with torch.no_grad():
        pred = det.model(x, torch.from_numpy(txt)[None])["pred"]
    boxes, scores, labels, valid, _ = pnms.postprocess_predictions(pred, 0.0, 0.5, 10)
    for i, (h, w) in enumerate([(48, 80), (64, 64)]):
        r = res[i]
        assert r["boxes"].shape == (len(r["scores"]), 4) and 0 < len(r["scores"]) <= 10
        assert r["labels"].dtype == np.int32
        want = boxes[i][valid[i]].numpy() * np.array([w, h, w, h], np.float32)
        np.testing.assert_allclose(r["boxes"], want, rtol=1e-6)
        np.testing.assert_allclose(r["scores"], scores[i][valid[i]].numpy())
    # a (B, H, W, 3) array is a batch
    assert len(det.predict(np.stack([im_f, im_f]), txt, conf=0.0)) == 2
