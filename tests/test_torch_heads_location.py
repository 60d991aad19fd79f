"""The eval of the DecouplingDFLManbaWorldDecoder, locationManbaDecoder and
DualRTDETRDecoder variants of the port against the JAX package on the CPU,
one torch thread, the Dual model's refusal by the engine and the fuse of
Location's conv stacks: the cases of `tests/test_torch_heads.py` split off
so that the test processes share them out (its docstring holds the set-up
and the bounds; the helpers are `tests/torch_engine_data.py`'s).
"""

import copy

import numpy as np
import pytest
import torch

from torch_engine_data import HEAD_B as B
from torch_engine_data import (HEADS, check_variant_eval, head_inputs, head_targets, head_variant,  # noqa: F401
                               heads_base, one_thread)


@pytest.mark.parametrize("head", HEADS[3:])
def test_variant_eval_matches_jax(head, heads_base, tmp_path_factory):
    check_variant_eval(head, heads_base, tmp_path_factory)


def test_dual_runs_through_the_model_and_the_trainer_only(heads_base, tmp_path_factory):
    """A Dual model trains a step through `Trainer.step` (the loss of the
    first half's outputs); the engine's entry points, which take one
    prediction per image, refuse it with a clear error, as the JAX engine
    cannot val or predict it either."""
    from tamtr_torch.api import TAMTR
    from tamtr_torch.config import get_cfg
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.train.trainer import Trainer, TrainConfig

    *_, port = head_variant("DualRTDETRDecoder", heads_base, tmp_path_factory)
    img, txt = head_inputs(4, 512)
    tr = Trainer(copy.deepcopy(port), TrainConfig(batch_size=B, accumulate=1, warmup_iters=1), device="cpu")
    m = tr.step({"img": img, "txt_feats": txt, **head_targets(5)})
    assert m["stepped"] == 1.0 and np.isfinite(m["loss"]) and m["grad_norm"] > 0
    eng = Engine("tamtr-nano.yaml", device="cpu")
    with pytest.raises(NotImplementedError, match="DualRTDETRDecoder"):
        eng._eval_model(port, get_cfg())
    det = TAMTR("tamtr-nano.yaml", device="cpu")
    det._lazy_engine().model = port
    with pytest.raises(NotImplementedError, match="DualRTDETRDecoder"):
        det.predict(img, txt)


def test_fuse_folds_the_location_heads_conv_stacks(heads_base, tmp_path_factory):
    """`fuse_model` folds each BatchNorm of Location's cv3 stacks and input
    projections into its conv; the fused twin's eval equals the model's."""
    from tamtr_torch.nn.fuse import fuse_model

    *_, port = head_variant("locationManbaDecoder", heads_base, tmp_path_factory)
    fused = fuse_model(port)
    head = fused.model[-1]
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in [*head.cv3.modules(), *head.input_proj.modules()])
    img, txt = head_inputs(6, 512)
    with torch.no_grad():
        got, want = (m(torch.from_numpy(img), torch.from_numpy(txt))["pred"] for m in (fused, port))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
