"""One nano training step at bf16 on the CPU: the port's (`TAMTRModel.dtype`
bf16, fp32 parameters) against the JAX package's `make_train_step` with the
model at `jnp.bfloat16`, from the same bridged weights and batch as
`tests/test_torch_train.py` (whose fixtures and helpers it shares: CDN
noise and DropPath off on both sides).

The top-k query order and the assignment are discrete choices that
rounding flips, more often at bf16; each moves whole terms of the loss. So
the port replays JAX's bf16 query order and takes JAX's bf16 assignment
(`test_whole_train_step_matches_make_train_step`'s way), and is then held
against JAX's bf16 step within twice JAX's own bf16-vs-fp32 distance, on
the loss and on the whole gradient. The whole gradient is ill-conditioned
at this size, so the bf16 backward is also held module by module
(`tests/test_torch_bf16_step.py`), each module alone in train mode on a
fixed input, where it is well conditioned. This test is alone in its file:
under `--dist loadfile` no other test queues behind it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_train import (  # noqa: F401
    _jax_assignment, _port_cfg, _port_grads, _port_model, batch, jax_forward_and_topk, jax_nano, jax_step,
    no_cdn_noise, one_thread, pin_topk, ptrain, rtdetr_detection_loss, run_jax_step,
)
from tamtr_torch.weights import from_jax_variables


def test_bf16_step_matches_make_train_step_at_bf16(jax_nano, jax_step, batch, monkeypatch):
    """Readings (relative to JAX's fp32 loss and gradient norm): the loss,
    port bf16 vs JAX bf16 3.2e-3 against JAX bf16 vs fp32 3.6e-2; the whole
    gradient 103% against 123%. The step is ill-conditioned (train-mode
    BatchNorm over 2 images of 64 px, down to 2x2 maps: gradient norm
    ~2.8e4, an fp32-vs-fp64 floor of 0.7%), and bf16 rounding moves the
    gradient by about its own size in either package, in every module of
    the model (JAX's own bf16-vs-fp32 distance per module: 93% in the head,
    110-180% in the backbone and neck). So the whole-gradient bound below,
    twice JAX's own distance, holds the form of the comparison but not the
    bf16 backward: `test_bf16_module_gradients_match_jax` holds that, module
    by module, where JAX's own distance is 3% or less. The loss is held
    here. After the step the parameters, the EMA and the BatchNorm
    statistics are fp32 and finite."""
    model, params, batch_stats = jax_nano
    model16 = model.clone(dtype=jnp.bfloat16)
    _, metrics32, jg32, _, _, _ = jax_step
    jcfg, metrics16, jg16, jparams16, _, _ = run_jax_step(model16, params, batch_stats, batch)
    out16, _, jtopk16 = jax_forward_and_topk(model16, params, batch_stats, batch)
    jmatch16 = _jax_assignment(out16, batch)

    port = _port_model(params, batch_stats)
    port.dtype = torch.bfloat16
    loss16, _, g16, _, out_p = _port_grads(port, batch, torch.float32, jmatch16, monkeypatch, topk=jtopk16)
    assert out_p["dec_scores"].dtype == torch.float32
    gsd16, _ = from_jax_variables(jg16, batch_stats, port)
    gsd32, _ = from_jax_variables(jg32, batch_stats, port)
    whole = lambda g: np.concatenate([np.asarray(g[k], np.float64).ravel() for k in sorted(g16)])  # noqa: E731
    gp, gj16, gj32 = whole(g16), whole({k: v.numpy() for k, v in gsd16.items()}), \
        whole({k: v.numpy() for k, v in gsd32.items()})
    l16, l32 = float(metrics16["loss"]), float(metrics32["loss"])
    d_loss, d_loss_jax = abs(loss16 - l16) / abs(l32), abs(l16 - l32) / abs(l32)
    d_grad, d_grad_jax = float(np.linalg.norm(gp - gj16) / np.linalg.norm(gj32)), \
        float(np.linalg.norm(gj16 - gj32) / np.linalg.norm(gj32))
    print(f"bf16 step: loss |port - jax bf16| {d_loss}, |jax bf16 - jax fp32| {d_loss_jax}; "
          f"gradient |port - jax bf16| {d_grad}, |jax bf16 - jax fp32| {d_grad_jax}")
    assert 0 < d_loss_jax and d_loss <= 2 * d_loss_jax, (d_loss, d_loss_jax)
    assert 0 < d_grad_jax and d_grad <= 2 * d_grad_jax, (d_grad, d_grad_jax)
    assert all(v.dtype == np.float64 or v.dtype == np.float32 for v in g16.values())

    # the step through the Trainer, with JAX's bf16 query order and assignment
    tr = ptrain.Trainer(port, _port_cfg(jcfg), steps_per_epoch=10, device="cpu")
    monkeypatch.setattr(ptrain, "rtdetr_detection_loss", lambda o, t, c: rtdetr_detection_loss(o, t, c, match=jmatch16))
    with monkeypatch.context() as mp:
        pin_topk(mp, jtopk16, [])
        m = tr.step(batch)
    assert m["stepped"] == 1.0 and np.isfinite(m["loss"])
    np.testing.assert_allclose(m["loss"], loss16, rtol=1e-6)
    for sd in (port.state_dict(), tr.ema.state_dict()):
        floats = [v for v in sd.values() if v.is_floating_point()]
        assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all()) for v in floats)
    assert all(p.dtype == torch.float32 for p in tr.params) and port.dtype == torch.bfloat16
