"""The training step of each DETR head variant of the port against the
JAX package's on the CPU, one torch thread: the heads of
`tests/test_torch_heads.py` (its helpers and JAX nano init), each alone on
the nano model's features of two seeded images, CDN noise and DropPath off
on both sides, JAX's top-k order and assignment given to the port.

Bounds, the main path's (`tests/test_torch_train.py`): the loss at 1e-4,
the layers' boxes and scores at 2e-3 (the query order is JAX's), the whole
head gradient within 2% of JAX's and each tensor within 7.5%.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
from tamtr_torch.weights import from_jax_variables

from test_torch_heads import B, HEADS, M, NC, ND, _targets, apply_head, base, inputs, variant  # noqa: F401
from test_torch_train import _rel_err, _to_np, pin_topk
from torch_engine_data import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def no_cdn_noise():
    """The JAX package's CDN queries without noise (the port's model is
    built with none): the two frameworks' random streams differ."""
    import tamtr_tpu.nn.decoder as jdec

    orig = jdec.get_cdn_group
    mp = pytest.MonkeyPatch()
    mp.setattr(jdec, "get_cdn_group", lambda *a, **k: orig(*a[:7], 0.0, 0.0))
    yield
    mp.undo()


def _matched(out):
    nd = int(out["num_dn"])
    return [jnp.concatenate([jnp.asarray(out[f"enc_{k}"])[None], jnp.asarray(out[f"dec_{k}"])[:, :, nd:]], 0)
            for k in ("bboxes", "scores")]


@pytest.mark.parametrize("head", HEADS)
def test_variant_train_step_matches_jax(head, base, tmp_path_factory, no_cdn_noise, monkeypatch):
    """The head's training forward and gradient on the nano features, with
    JAX's top-k query order and assignment given to the port."""
    from tamtr_tpu.losses.detr_loss import DETRLossConfig as JCfg
    from tamtr_tpu.losses.detr_loss import rtdetr_detection_loss as jax_loss
    from tamtr_tpu.losses.matcher import hungarian_match

    _, params, bs, module, port = variant(head, base, tmp_path_factory)
    feats = [base[2][[32, 36, 40].index(j)] for j in port.head_from]
    tg = _targets(2)
    width = port.text_width
    txt = inputs(3, width)[1].repeat(B, 0)
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    picked, top_k = [], jax.lax.top_k

    def recording(x, k):
        res = top_k(x, k)
        picked.append(res[1])
        return res

    def jl(p):  # the loss of JAX's own assignment, the outputs and the top-k indices
        out, _ = apply_head(head, module, {"params": p, "batch_stats": bs["head"]}, [jnp.asarray(f) for f in feats],
                            jnp.asarray(txt), jt, True)
        return jax_loss(out, jt, JCfg(nc=NC))[0], (out, list(picked))

    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", recording)
        (want_loss, (out_j, jtopk)), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(params["head"])
    bj, sj = _matched(out_j)
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
    loss, _ = rtdetr_detection_loss(out_p, pt, DETRLossConfig(nc=NC), match=jmatch)
    hm.zero_grad()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    nd = out_p["num_dn"]
    assert nd == int(out_j["num_dn"]) == 2 * (ND // M) * M
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


