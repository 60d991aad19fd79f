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
at this size, so the bf16 backward is also held module by module, each
module alone in train mode on a fixed input, where it is well conditioned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (  # noqa: F401
    B, DETRLossConfig, _jax_assignment, _port_cfg, _port_grads, _port_model, _rel_err, batch, jax_forward_and_topk,
    jax_nano, jax_step, no_cdn_noise, one_thread, pin_topk, ptrain, rtdetr_detection_loss, run_jax_step,
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


def _zeros_but(params, path, leaf):
    """`params` with every array zero except the subtree at `path`, which is
    `leaf`: a gradient of one module in the whole model's layout, so that
    `from_jax_variables` maps it as it maps the parameters."""
    out = {k: _zeros_but(v, None, None) if isinstance(v, dict) else np.zeros_like(v) for k, v in params.items()}
    if path:
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = leaf
    return out


def _module_case(jmodel, params, batch_stats, part, rng):
    """(JAX module apply fn of (params, inputs), its param path, port module,
    its state_dict prefix, numpy inputs with the indices of the compute-dtype
    ones, port call) for one module of the nano model in train mode."""
    from tamtr_tpu.nn.decoder import DeformableDecoderLayer
    from tamtr_tpu.nn.graph import _build_module
    from tamtr_tpu.nn.ssm import VSSBlock

    port = _port_model(params, batch_stats).train()
    head, head_idx = "head", len(port.model) - 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if part in ("convbn", "elan"):
        idx = 0 if part == "convbn" else 2
        _, _, m, args = jmodel.specs[[s[0] for s in jmodel.specs].index(idx)]
        name, mod = f"m{idx}_{m}", port.model[idx]
        jmod = _build_module(m, args, name=None)
        c_in = next(p for n, p in mod.named_parameters() if n.endswith("conv.weight")).shape[1]

        def jfn(p, x):
            return jmod.apply({"params": p, "batch_stats": batch_stats[name]}, x, True, mutable=["batch_stats"])[0]

        return jfn, (name,), mod, f"model.{idx}.", [f(B, 16, 16, c_in)], (0,), \
            lambda x: mod(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    hmod = port.model[head_idx]
    if part == "vss":
        mod = hmod.VSSBlocks[0]
        jmod = VSSBlock(hidden_dim=mod.norm.normalized_shape[0], drop_path=0.0)
        return (lambda p, x: jmod.apply({"params": p}, x, True)), (head, "vss0"), mod, \
            f"model.{head_idx}.VSSBlocks.0.", [f(B, 8, 8, mod.norm.normalized_shape[0])], (0,), mod
    mod = hmod.decoder["layers"][0]
    ca = mod.cross_attn
    hd, shapes, Q = mod.linear1.in_features, [(8, 8), (4, 4), (2, 2)], 12
    jmod = DeformableDecoderLayer(hd, ca.nh, mod.linear1.out_features, ca.nl, ca.P)
    inputs = [f(B, Q, hd), rng.uniform(0.2, 0.8, (B, Q, 4)).astype(np.float32), f(B, 84, hd), f(B, Q, hd)]
    return (lambda p, e, r, v, q: jmod.apply({"params": p}, e, r, v, shapes, None, q)), (head, "layer0"), mod, \
        f"model.{head_idx}.decoder.layers.0.", inputs, (0, 2), \
        (lambda e, r, v, q: mod(e, r, v, shapes, q))


@pytest.mark.parametrize("part", ["convbn", "elan", "vss", "decoder_layer"])
def test_bf16_module_gradients_match_jax(jax_nano, part):
    """The bf16 backward module by module, in train mode, where it is well
    conditioned (each module alone on a fixed input; no train-mode
    BatchNorm over a few pixels in front of it): ConvBN (model layer 0, the
    fp32 BatchNorm island), the ELAN stack (layer 2), the head's first
    VSSBlock (the scan at bf16 I/O, the fp32 out_norm) and its first
    decoder layer (the bf16 gather, the fp32 sampling offsets and attention
    weights). The same inputs, rounded to bf16 where the module computes in
    it, go to the port's module and to JAX's at bf16 and fp32; the loss is
    sum(out * w) for a fixed w. Over the module's parameter gradients and
    its inputs' gradients together, relative to JAX's fp32 gradient: JAX's
    own bf16-vs-fp32 distance must be below 0.25 (the case is well
    conditioned) and the port's distance from JAX's bf16 gradient within
    twice it. Readings, port vs JAX bf16 against JAX bf16 vs fp32: convbn
    0.0051 / 0.0051, elan 0.026 / 0.025, vss 0.0081 / 0.0084,
    decoder_layer 0.026 / 0.027; so a zero gradient (distance 1) fails by
    a factor of 19 or more."""
    jmodel, params, batch_stats = jax_nano
    rng = np.random.default_rng(["convbn", "elan", "vss", "decoder_layer"].index(part))
    jfn, path, mod, prefix, inputs, seq, pfn = _module_case(jmodel, params, batch_stats, part, rng)
    inputs = [np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) if i in seq else x
              for i, x in enumerate(inputs)]
    jp = params
    for k in path:
        jp = jp[k]

    def jax_grads(dtype):
        xs = [jnp.asarray(x).astype(dtype) if i in seq else jnp.asarray(x) for i, x in enumerate(inputs)]
        out_shape = jax.eval_shape(jfn, jp, *xs).shape
        w = jnp.asarray(np.random.default_rng(9).standard_normal(out_shape).astype(np.float32))
        loss = lambda p, *a: jnp.sum(jfn(p, *a).astype(jnp.float32) * w)  # noqa: E731
        g = jax.grad(loss, argnums=tuple(range(len(xs) + 1)))(jp, *xs)
        sd, _ = from_jax_variables(_zeros_but(params, path, jax.device_get(g[0])), batch_stats, port_ref)
        return {k: np.asarray(sd[k], np.float64) for k, _ in port_ref.named_parameters() if k.startswith(prefix)} | \
            {f"input{i}": np.asarray(jnp.asarray(d).astype(jnp.float32), np.float64) for i, d in enumerate(g[1:])}, w

    port_ref = _port_model(params, batch_stats)
    g16, w = jax_grads(jnp.bfloat16)
    g32, _ = jax_grads(jnp.float32)
    xs = [torch.from_numpy(np.array(x)).to(torch.bfloat16 if i in seq else torch.float32).requires_grad_()
          for i, x in enumerate(inputs)]
    out = pfn(*xs)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(np.asarray(w))).sum().backward()
    gp = {f"{prefix}{n}": p.grad.double().numpy() for n, p in mod.named_parameters()} | \
        {f"input{i}": x.grad.double().numpy() for i, x in enumerate(xs)}
    assert all(p.grad.dtype == torch.float32 for p in mod.parameters())
    assert all(x.grad.dtype == x.dtype for x in xs)
    keys = sorted(g32)
    assert set(gp) == set(keys), set(gp) ^ set(keys)
    whole = lambda g: np.concatenate([g[k].ravel() for k in keys])  # noqa: E731
    p, j16, j32 = whole(gp), whole(g16), whole(g32)
    d_port, d_jax = np.linalg.norm(p - j16) / np.linalg.norm(j32), np.linalg.norm(j16 - j32) / np.linalg.norm(j32)
    print(f"bf16 {part}: gradient |port - jax bf16| {d_port}, |jax bf16 - jax fp32| {d_jax}")
    assert 0 < d_jax < 0.25, d_jax
    assert d_port <= 2 * d_jax, (d_port, d_jax)
