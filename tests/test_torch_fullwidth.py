"""Eval parity of the port against the JAX package at the published widths
on the CPU: `tamtr.yaml` (hd 512, 100 queries, 3 decoder layers, nc 10 as
on VisDrone) and `tamtr-mid.yaml` (its wiring at half the channels), at
128 px, batch 2. Both get the same variables (the JAX init under `jax.jit`
from key 0, the zero-initialised head layers spread as in
`tests/test_torch_model.py:_perturb`), bridged into the port by
`weights.from_jax_variables`, and the same image and unit-norm text rows;
the eval outputs are compared as a tie-robust set at 1e-3
(`tests/test_torch_model.py:_assert_same_set`).

Marked slow, so not part of tier 1: the full-width JAX init and compile
take minutes and gigabytes on the CPU. Run it with
`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fullwidth.py -m slow`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import _assert_same_set, _perturb

NC, IMG = 10, 128


@pytest.mark.slow
@pytest.mark.parametrize("name", ["tamtr-mid", "tamtr"])
def test_published_width_eval_matches_jax(name):
    from tamtr_tpu.nn.graph import TAMTRModel as JaxModel

    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import from_jax_variables

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jmodel = JaxModel.from_yaml(f"{name}.yaml", nc=NC)
        pmodel = TAMTRModel.from_cfg(f"{name}.yaml", nc=NC)
        hd = pmodel.model[-1].hd
        v = jax.device_get(jax.jit(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, NC, hd)), None, False))())
        to_np = lambda t: {k: to_np(x) if hasattr(x, "items") else np.array(x) for k, x in t.items()}  # noqa: E731
        params = _perturb(to_np(v["params"]), np.random.default_rng(0))
        batch_stats = to_np(v["batch_stats"])
        sd, report = from_jax_variables(params, batch_stats, pmodel)
        assert report == {"missing": [], "shape_mismatch": [], "unused_jax": []}
        pmodel.load_state_dict(sd, strict=True)
        rng = np.random.default_rng(8)
        img = rng.random((2, IMG, IMG, 3), dtype=np.float32)
        txt = rng.standard_normal((1, NC, hd)).astype(np.float32)
        txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
        want = np.asarray(jax.jit(lambda i, t: jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, i, t, None, False)["pred"])(jnp.asarray(img),
                                                                                   jnp.asarray(txt)))
        with torch.no_grad():
            got = pmodel.eval()(torch.from_numpy(img), torch.from_numpy(txt))["pred"].numpy()
    finally:
        torch.set_num_threads(prev)
    assert got.shape == want.shape == (2, 100, 4 + NC)
    assert want[..., 4:].std() > 0.05  # the spread head moves the scores
    _assert_same_set(got, want)
