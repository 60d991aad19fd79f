"""The DETR head variants of the port (`tamtr_torch/nn/decoder.py`:
RTDETRDecoder, ManbaDecoder and the two Decoupling heads as
`ManbaWorldDecoder` switches,
`LocationManbaDecoder`, `DualRTDETRDecoder`; `DecouplingDecoderLayer`,
`ContrastiveHead2D`) against the JAX package on the CPU, one torch thread.

Each head sits on `tamtr-nano.yaml`'s wiring with its row swapped, as
`tests/test_head_variants.py` builds them (Dual on the levels [32, 36, 32,
36]). The JAX nano model is initialised once under `jax.jit`; each head is
initialised alone and put in its place, and the never-run text attention of
the TIAGELANs takes the head's text width (512 for the heads without text
scores). The zero-initialised head layers get small random values from a
numpy seed and the score biases 0, so that every part of the head moves the
output.

Bounds: the two modules at 1e-5; each model's eval as a set of rows at
1e-3 (`tests/test_torch_model.py`). The helpers, the JAX nano init and
each head's JAX init are `tests/torch_engine_data.py`'s, computed once per
test session (`session_cached`) and shared with the other head files:
`tests/test_torch_heads_location.py` (the eval of the DFL, Location and
Dual heads, the Dual model's refusal and Location's fuse) and the three
files of the training steps (`tests/test_torch_heads_step*.py`).
"""

import jax
import numpy as np
import pytest
import torch

from tamtr_torch.nn import decoder as PD

from test_torch_train import _to_np
from torch_engine_data import HEAD_B as B  # noqa: F401
from torch_engine_data import HEADS, check_variant_eval, heads_base, one_thread, spread_head_params  # noqa: F401


@pytest.mark.parametrize("head", HEADS[:3])
def test_variant_eval_matches_jax(head, heads_base, tmp_path_factory):
    check_variant_eval(head, heads_base, tmp_path_factory)


# ---------------------------------------------------------------------------
# The modules alone
# ---------------------------------------------------------------------------


def _layer_inputs(seed, Q=14, nd=6, shapes=((8, 8), (4, 4)), C=32):
    rng = np.random.default_rng(seed)
    Lv = sum(h * w for h, w in shapes)
    box = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)), rng.uniform(0.05, 0.4, (B, Q, 2))], -1)
    mask = PD.cdn_attn_mask(nd, Q - nd, nd // 2)
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, Q, C), (B, Q, C), (B, Lv, C), (B, Q, C))] + [
        box.astype(np.float32), mask]


@pytest.mark.parametrize("mode", ["decouple", "dfl"])
def test_decoupling_decoder_layer_matches_jax(mode):
    from tamtr_tpu.nn.decoder import DecouplingDecoderLayer

    shapes, nd = [(8, 8), (4, 4)], 6
    embed, embed_box, value, pos, box, mask = _layer_inputs(5)
    jl = DecouplingDecoderLayer(32, 4, 64, 2, 4, mode=mode, num_dn=nd)
    args = (embed, embed_box, box, value, shapes, mask, pos)
    v = _to_np(jax.device_get(jl.init(jax.random.PRNGKey(0), *args)))
    v = spread_head_params(v, np.random.default_rng(6))
    want = jl.apply(v, *args)
    port = PD.DecouplingDecoderLayer(32, 4, 64, 2, 4, mode=mode)
    sd = {}
    for key in port.state_dict():
        parts = key.split(".")
        node = v["params"]
        if parts[-1].startswith("in_proj"):
            kind = "kernel" if parts[-1].endswith("weight") else "bias"
            pieces = [np.asarray(node[parts[0]][n][kind]) for n in ("q_proj", "k_proj", "v_proj")]
            sd[key] = torch.from_numpy(np.concatenate([p.T if p.ndim == 2 else p for p in pieces], 0))
            continue
        for p in parts[:-1]:
            node = node[p]
        leaf = np.asarray(node["scale" if parts[0].startswith("norm") and parts[-1] == "weight" else
                               "kernel" if parts[-1] == "weight" else "bias"])
        sd[key] = torch.from_numpy(leaf.T.copy() if leaf.ndim == 2 else leaf)
    port.load_state_dict(sd, strict=True)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        got = port(t(embed), t(embed_box), t(box), t(value), shapes, t(pos), t(mask), nd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    assert hasattr(port, "self_attn2") == (mode == "dfl")


def test_contrastive_head_2d_matches_jax():
    from tamtr_tpu.nn.decoder import ContrastiveHead2D

    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 5, 6, 16)).astype(np.float32)
    w = rng.standard_normal((B, 4, 16)).astype(np.float32)
    jh = ContrastiveHead2D()
    v = {"params": {"bias": np.array([0.3], np.float32), "logit_scale": np.float32(1.7)}}
    want = np.asarray(jh.apply(v, x, w))  # (B, H, W, K)
    port = PD.ContrastiveHead2D()
    with torch.no_grad():
        port.bias.fill_(0.3)
        port.logit_scale.fill_(1.7)
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w))  # (B, K, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=1e-5)
