"""RT-DETR through the port's command line on the CPU, one torch thread:
`python -m tamtr_torch train model=rtdetr.yaml batch=-1` (the batch fitted
by `utils/autobatch.py`, its CPU default), then `val` and `predict` from the
run's `best.pt`. No JAX: the parity of the model itself is
`tests/test_torch_rtdetr.py`'s."""

import sys
from pathlib import Path

import torch

from tamtr_torch import cli
from tamtr_torch.engine.checkpoint import load_checkpoint_raw

from torch_engine_data import IMG, one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import smoke_train_torch  # noqa: E402


def test_cli_trains_validates_and_predicts_rtdetr(tmp_path, capsys):
    """One epoch of rtdetr.yaml at 64 px on 4 + 2 generated images with
    batch=-1; the checkpoint names rtdetr.yaml and holds AIFI's and the
    RTDETRDecoder's weights; `val` prints finite metrics and `predict`
    writes a line per image."""
    data = smoke_train_torch.make_dataset(tmp_path / "data", 4, 2, IMG)
    cli.main(["train", "model=rtdetr.yaml", f"data={data}", "epochs=1", "batch=-1", f"imgsz={IMG}", "max_gt=8",
              "workers=0", "warmup_epochs=1", "conf=0.01", "plots=False", f"project={tmp_path}", "name=run",
              "device=cpu"])
    best = tmp_path / "run" / "weights" / "best.pt"
    ema, meta = load_checkpoint_raw(best)
    assert meta["model_cfg"] == "rtdetr.yaml" and "model.10.ma.in_proj_weight" in ema
    assert "model.42.dec_score_head.5.weight" in ema and not any("VSSBlocks" in k for k in ema)
    assert all(torch.isfinite(v).all() for v in ema.values() if v.is_floating_point())
    capsys.readouterr()
    cli.main(["val", f"model={best}", f"data={data}", f"imgsz={IMG}", "batch=2", "workers=1", "plots=False",
              "device=cpu"])
    assert "mAP50" in capsys.readouterr().out
    images = Path(data).parent / "val" / "images"
    cli.main(["predict", f"model={best}", f"source={images}", f"imgsz={IMG}", "conf=0.01", "device=cpu"])
    out = capsys.readouterr().out
    assert sum(1 for p in images.iterdir()) == 2 and out.count("\n") >= 2
