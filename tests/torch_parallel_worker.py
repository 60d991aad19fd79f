"""One rank of `tests/test_torch_parallel.py`'s gloo runs (not a test file).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p python tests/torch_parallel_worker.py <case> <out> [arg]

Each case joins the process group over gloo, runs, and writes what the test
checks to `<out>.<rank>` (torch.save):
  tiny: a conv + BatchNorm + linear model with a global-mean loss, 3 steps:
        one process on the batch of 8 (rank 0), 2 data ranks of 4 (plain
        and ZeRO);
  nano: one `tamtr-nano.yaml` step on a batch of 4 at 64 px: one process at
        one torch thread (the reference) and at three (the fp32 noise
        floor), 2 data ranks of 2 (plain and ZeRO), and data 1 x sp 2;
  nano_bf16: the same step of the model computing in bf16: one process at
        one and at three torch threads, and 2 data ranks of 2;
  stem_bf16: the gradient of the nano model's first three layers at bf16
        (`stem_bf16`), one process against 2 data ranks;
  val:  `Engine.val` of the model in <arg>/model.pt on <arg>/data.json
        (the nano model, or the config <arg>/spec.json names);
  rect: the same, for the rect val of the narrow Detect model;
  yolo: one step of the narrow Detect model (`torch_engine_data.py:
        yolo_narrow_cfg`, heads spread) on 4 images of 64 px: one process
        at one and at three torch threads, 2 data ranks of 2;
  segment: the same step of the narrow model with a Segment head, each
        gt's mask its box's rectangle;
  classify: one cross-entropy step of the narrow Classify model
        (`torch_engine_data.py:classify_narrow_cfg`) on 4 images of 64 px:
        one process on the 4, 2 data ranks of 2.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

import tamtr_torch.train.trainer as trainer_mod
from tamtr_torch.nn.layers import BatchNorm2d
from tamtr_torch.parallel.dist import (
    all_reduce_grads, data_parallel, global_sum, init_distributed, make_groups, shard_batch,
)
from tamtr_torch.train.trainer import Trainer, TrainConfig


class TinyDet(nn.Module):
    """`tests/test_fsdp.py:TinyDet` in torch: conv (no bias before the
    BatchNorm, whose direction has no true gradient), BatchNorm, ReLU, mean,
    linear."""

    nc = 2

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, bias=False)
        self.bn = BatchNorm2d(8)
        self.fc = nn.Linear(8, 6)

    def forward(self, img, txt, targets, generator=None):
        x = torch.relu(self.bn(self.conv(img.permute(0, 3, 1, 2)))).mean((2, 3))
        return {"out": self.fc(x)}


def mse_share(out, targets, cfg):
    """This rank's share of the global batch's mean of out^2."""
    v = (out["out"] ** 2).sum() / global_sum(torch.tensor(float(out["out"].numel())))
    return v, {"giou": v, "class": v, "bbox": v, "match": torch.zeros(1)}


def run(trainer, batches, groups=None):
    losses = []
    for b in batches:
        losses.append(trainer.step(b if groups is None else shard_batch(b, groups.data_rank, groups.data_size))["loss"])
    return losses, {k: v.clone() for k, v in trainer.model.state_dict().items()}, \
        {k: v.clone() for k, v in trainer.ema.state_dict().items()}


def tiny():
    trainer_mod.rtdetr_detection_loss = mse_share
    torch.manual_seed(0)
    model = TinyDet()
    cfg = TrainConfig(batch_size=8, warmup_iters=2, epochs=2, accumulate=1)
    rng = np.random.default_rng(7)
    batches = [{"img": rng.random((8, 8, 8, 3), dtype=np.float32), "txt_feats": np.zeros((8, 4, 8), np.float32),
                "cls": np.zeros((8, 2), np.int32), "bboxes": np.full((8, 2, 4), 0.5, np.float32),
                "mask": np.zeros((8, 2), bool)} for _ in range(3)]
    groups = make_groups(1)
    out = {"one": run(Trainer(copy.deepcopy(model), cfg, steps_per_epoch=2, device="cpu"), batches)}
    for name, zero in (("dp", False), ("zero", True)):
        tr = Trainer(copy.deepcopy(model), cfg, steps_per_epoch=2, device="cpu", groups=groups, zero=zero)
        out[name] = run(tr, batches, groups)
    return out


def nano_batch(B=4, M=3, nc=5, sz=64, hd=128):
    rng = np.random.default_rng(7)
    return {"img": rng.random((B, sz, sz, 3), dtype=np.float32),
            "txt_feats": rng.standard_normal((B, nc, hd)).astype(np.float32),
            "cls": rng.integers(0, nc, (B, M)).astype(np.int32),
            "bboxes": np.clip(rng.random((B, M, 4)), 0.1, 0.9).astype(np.float32),
            "mask": np.tile(np.arange(M)[None] < 2, (B, 1))}


def nano(dtype=torch.float32):
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=5, max_gt=3, dtype=dtype)
    init_parameters(model, 0)
    batch = [nano_batch()]
    cfg = TrainConfig(batch_size=4, warmup_iters=10, epochs=2, accumulate=1)

    def trainer(**kw):
        return Trainer(copy.deepcopy(model), cfg, steps_per_epoch=10, device="cpu", seed=3, **kw)

    out = {}
    if dist.get_rank() == 0:
        out["one"] = run(trainer(), batch)
        torch.set_num_threads(3)
        out["floor"] = run(trainer(), batch)
        torch.set_num_threads(1)
    dp, dpsp = make_groups(1), make_groups(2)
    out["dp"] = run(trainer(groups=dp), batch, dp)
    if dtype != torch.float32:
        return out
    out["zero"] = run(trainer(groups=dp, zero=True), batch, dp)
    out["dpsp"] = run(trainer(groups=dpsp), batch, dpsp)
    return out


def stem_bf16():
    """The nano model's first three layers (two ConvBN, the ELAN stack:
    train-mode BatchNorm in each, in fp32 on bf16 activations) on 4 images
    of 32 px in bf16, loss sum(out * w) for a fixed w: the gradient (summed
    over the data ranks, as the trainer sums it), the running statistics and
    the output rows, of one process at one and at three torch threads, of 2
    data ranks of 2, and of one process on the first 2 images alone."""
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    model = TAMTRModel.from_cfg("tamtr-nano.yaml", nc=5, max_gt=3, dtype=torch.bfloat16)
    init_parameters(model, 0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((4, 3, 32, 32), dtype=np.float32)).to(torch.bfloat16)

    def grads(rows, groups=None):
        stem = copy.deepcopy(model.model[:3]).train()
        with data_parallel(groups):
            out = x[rows]
            for layer in stem:
                out = layer(out)
        w = torch.from_numpy(np.random.default_rng(6).standard_normal((4, *out.shape[1:])).astype(np.float32))
        (out.float() * w[rows]).sum().backward()
        g = [p.grad for p in stem.parameters()]
        if groups is not None:
            all_reduce_grads(g, groups.data)
        stats = [b for n, b in stem.named_buffers() if "running" in n]
        return torch.cat([t.reshape(-1) for t in g]), torch.cat([t.reshape(-1) for t in stats]), out.detach().float()

    out = {}
    if dist.get_rank() == 0:
        out["one"] = grads(slice(0, 4))
        torch.set_num_threads(3)
        out["floor"] = grads(slice(0, 4))
        torch.set_num_threads(1)
        out["half"] = grads(slice(0, 2))
    dp = make_groups(1)
    r = dp.data_rank
    out["dp"] = grads(slice(2 * r, 2 * r + 2), dp)
    return out


def val(root):
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.nn.graph import TAMTRModel

    root = Path(root)
    spec = json.loads((root / "spec.json").read_text())
    cfg = spec.get("cfg", "tamtr-nano.yaml")
    eng = Engine(cfg, device="cpu")
    model = TAMTRModel.from_cfg(cfg, nc=len(spec["names"]))
    model.load_state_dict(torch.load(root / "model.pt", weights_only=True))
    eng.model = model.eval()
    eng.set_classes(spec["names"], np.asarray(spec["txt"], np.float32))
    return eng.val(**spec["args"])


def yolo(head: str = "Detect"):
    from torch_engine_data import yolo_narrow_cfg

    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import loss_config_for
    from tamtr_torch.weights import init_parameters

    cfg_json = yolo_narrow_cfg(3)
    cfg_json["head"][-1] = [[15, 18, 21], 1, head, ["nc"]]
    model = TAMTRModel(cfg_json, max_gt=3)
    init_parameters(model, 0)
    with torch.no_grad():  # boxes of about 3 cells and scores near 0.5: anchors are assigned from the start
        for b, c in zip(model.model[-1].cv2, model.model[-1].cv3):
            b[2].bias.copy_((-2.0 * (torch.arange(16.0) - 1.5).abs()).repeat(4))
            c[2].bias.zero_()
    batch = nano_batch(nc=3, hd=512)
    batch["bboxes"][..., 2:] *= 0.4
    items = ("loss", "box", "cls", "dfl")
    if head == "Segment":  # each gt's mask: its box's rectangle at the protos' size
        boxes = batch["bboxes"]
        g = (np.arange(16) + 0.5) / 16
        lo, hi = boxes[..., :2] - boxes[..., 2:] / 2, boxes[..., :2] + boxes[..., 2:] / 2
        ins = [(g >= lo[..., k, None]) & (g < hi[..., k, None]) for k in (0, 1)]
        batch["masks"] = (ins[1][..., :, None] & ins[0][..., None, :]).astype(np.float32)
        items += ("seg",)
    cfg = TrainConfig(batch_size=4, warmup_iters=10, epochs=2, accumulate=1)

    def step(**kw):
        tr = Trainer(copy.deepcopy(model), cfg, loss_cfg=loss_config_for(model, imgsz=64), steps_per_epoch=10,
                     device="cpu", seed=3, **kw)
        groups = kw.get("groups")
        m = tr.step(batch if groups is None else shard_batch(batch, groups.data_rank, groups.data_size))
        return {k: m[k] for k in items}, {k: v.clone() for k, v in tr.model.state_dict().items()}

    out = {}
    if dist.get_rank() == 0:
        out["one"] = step()
        torch.set_num_threads(3)
        out["floor"] = step()
        torch.set_num_threads(1)
    out["dp"] = step(groups=make_groups(1))
    return out


def classify():
    from torch_engine_data import classify_narrow_cfg

    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import loss_config_for
    from tamtr_torch.weights import init_parameters

    model = TAMTRModel(classify_narrow_cfg(3), max_gt=1)
    init_parameters(model, 0)
    rng = np.random.default_rng(0)
    batch = {"img": rng.random((4, 64, 64, 3), dtype=np.float32), "txt_feats": np.zeros((4, 1, 512), np.float32),
             "cls": np.array([[0], [2], [1], [2]], np.int32), "bboxes": np.zeros((4, 1, 4), np.float32),
             "mask": np.zeros((4, 1), bool)}
    cfg = TrainConfig(batch_size=4, warmup_iters=10, epochs=2, accumulate=1)

    def step(**kw):
        tr = Trainer(copy.deepcopy(model), cfg, loss_cfg=loss_config_for(model), steps_per_epoch=10, device="cpu",
                     seed=3, **kw)
        groups = kw.get("groups")
        m = tr.step(batch if groups is None else shard_batch(batch, groups.data_rank, groups.data_size))
        return {k: m[k] for k in ("loss", "cls", "top1")}, {k: v.clone() for k, v in tr.model.state_dict().items()}

    out = {"one": step()} if dist.get_rank() == 0 else {}
    out["dp"] = step(groups=make_groups(1))
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    case, out_path = sys.argv[1], sys.argv[2]
    init_distributed("cpu")
    result = {"tiny": tiny, "nano": nano, "nano_bf16": lambda: nano(torch.bfloat16), "stem_bf16": stem_bf16,
              "val": lambda: val(sys.argv[3]), "rect": lambda: val(sys.argv[3]), "yolo": yolo,
              "segment": lambda: yolo("Segment"), "classify": classify}[case]()
    torch.save(result, f"{out_path}.{dist.get_rank()}")
    dist.destroy_process_group()
