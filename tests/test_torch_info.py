"""`TAMTR.info` and `utils/profiler.py` of the port on the CPU, against the
JAX package's `TAMTR.info` and `flops_of` at nano, 64 px, nc 10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamtr_torch.api import TAMTR, variable_count
from tamtr_torch.nn.graph import TAMTRModel as PortModel
from tamtr_torch.utils.profiler import Profile, flops_of, trace
from tamtr_torch.weights import init_parameters

from torch_engine_data import one_thread  # noqa: F401

# port / JAX operation count of one nano forward at 64 px, nc 10: 0.2294 /
# 0.2702 GFLOPs. FlopCounterMode counts matrix products and convolutions
# only (with B1's and B2's counts from their shapes); XLA also counts
# elementwise work
FLOPS_RATIO = 0.849


@pytest.fixture(scope="module")
def jax_nano10():
    from tamtr_tpu.nn.graph import TAMTRModel

    model = TAMTRModel.from_yaml("tamtr-nano.yaml", nc=10)
    img, txt = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 10, 128))
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)}, img, txt, None, False))()
    return model, v, img, txt


def test_info_equals_jax_summary(jax_nano10):
    """Layers and params as JAX's string; the count equal to the leaves of
    JAX's variables exactly (parameters and BatchNorm statistics); no
    GFLOPs before the engine holds a model."""
    from tamtr_tpu.api import TAMTR as JaxTAMTR

    _, v, _, _ = jax_nano10
    want = JaxTAMTR("tamtr-nano.yaml").info(imgsz=64, nc=10)
    got = TAMTR("tamtr-nano.yaml", device="cpu").info(imgsz=64, nc=10)
    assert got == want and "42 layers" in got and "3.4M params" in got
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(v))
    assert variable_count(PortModel.from_cfg("tamtr-nano.yaml", nc=10)) == n_jax == 3416442


def test_gflops_against_jax_cost_analysis(jax_nano10):
    """GFLOPs once the engine holds a model; the count against XLA's at
    the ratio stated above, within 2%."""
    from tamtr_tpu.utils.profiler import flops_of as jax_flops_of

    model, v, img, txt = jax_nano10
    det = TAMTR("tamtr-nano.yaml", nc=10, device="cpu", imgsz=64)
    det.model  # the seeded model
    s = det.info(imgsz=64, nc=10)
    got = flops_of(det.model, torch.zeros(1, 64, 64, 3), torch.zeros(1, 10, 128))
    assert s.endswith(f", {got['gflops']:.1f} GFLOPs @ 64px") and 0 < got["kernel_flops"] < got["flops"]
    want = jax_flops_of(lambda v: model.apply(v, img, txt, None, False)["pred"], v)
    assert got["gflops"] / want["gflops"] == pytest.approx(FLOPS_RATIO, rel=0.02)


def test_flops_take_out_the_plain_kernels_own_operations():
    """On the CPU, B1 and B2 run their plain versions, whose einsums the
    counter sees: flops_of counts them from their shapes instead, so the
    count does not change when the plain versions do more work."""
    import tamtr_torch.nn.decoder as decoder
    import tamtr_torch.nn.ssm as ssm

    model = PortModel.from_cfg("tamtr-nano.yaml", nc=10).eval()
    init_parameters(model, 0)
    img, txt = torch.rand(1, 64, 64, 3), torch.zeros(1, 10, 128)
    base = flops_of(model, img, txt)
    scan, gather = ssm.ss2d_scan, decoder.bilinear_gather

    def wasteful(fn):
        def run(*args):
            a = torch.rand(64, 64)
            a @ a  # operations the counter sees, inside the kernel call
            return fn(*args)
        return run

    ssm.ss2d_scan, decoder.bilinear_gather = wasteful(scan), wasteful(gather)
    try:
        again = flops_of(model, img, txt)
    finally:
        ssm.ss2d_scan, decoder.bilinear_gather = scan, gather
    assert again == base


def test_profile_and_trace(tmp_path):
    p = Profile()
    for _ in range(3):
        with p:
            torch.ones(8).sum()
    assert p.n == 3 and p.t > 0 and p.ms_per_call > 0
    with trace(tmp_path / "tr") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
