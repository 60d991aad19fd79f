"""The bf16 backward on the CPU, module by module: ConvBN, ELAN, a VSSBlock
and a decoder layer of the nano model, each alone in train mode on a fixed
input, where the backward is well conditioned, the port's gradients at bf16
against JAX's (`TAMTRModel.dtype` bf16, fp32 parameters; the JAX module at
`jnp.bfloat16`), from the bridged weights of `tests/test_torch_train.py`
(whose fixtures and helpers it shares).

The whole nano training step at bf16 is held in
`tests/test_torch_bf16_step_whole.py`, alone in its file so that a test
worker runs it beside these.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import B, _port_model, jax_nano, no_cdn_noise, one_thread  # noqa: F401
from tamtr_torch.weights import from_jax_variables


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
