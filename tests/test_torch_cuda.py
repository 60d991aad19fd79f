"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test asks the `card` fixture, which skips when no CUDA
device is present (as on CPU-only machines). Run on a machine with an H100:
`python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("H,W,C", [(5, 7, 32), (40, 40, 512)])
def test_ss2d_scan_kernel_matches_plain(card, H, W, C):
    from tamtr_torch.kernels.selective_scan import ss2d_scan, ss2d_scan_ref

    g = torch.Generator().manual_seed(0)
    L, D, R, N = H * W, 2 * C, math.ceil(C / 16), 16
    layouts = torch.randn(2, 2, L, D, generator=g).to(card)
    dts_raw, Bs, Cs = (torch.randn(2, 2, 2, L, R + 2 * N, generator=g) * 0.6).to(card).split([R, N, N], -1)
    dt_w = ((torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5).to(card)
    dt_b = (torch.rand(4, D, generator=g) * -5 - 2).to(card)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=card).expand(4, D, N).contiguous()
    Ds = torch.randn(4, D, generator=g).to(card)
    args = (layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds)
    before = ss2d_scan.launches
    y = ss2d_scan(*args)
    torch.cuda.synchronize()
    assert ss2d_scan.launches == before + 1
    torch.testing.assert_close(y, ss2d_scan_ref(*args), atol=1e-4, rtol=1e-4)


def test_bilinear_gather_kernel_matches_plain(card):
    from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_ref
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(6, 7), (3, 4), (2, 3)]
    g = torch.Generator().manual_seed(1)
    B, Q, nh, c, nl, P = 2, 9, 8, 64, 3, 4
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g).to(card)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.4 - 0.2
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / 3, 1 - 0.2 / 2])  # last pixel cell
    loc = loc.to(card)
    w_att = torch.rand(B, Q, nh, nl, P, generator=g).to(card)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    assert int(idx2.max()) == Lv - 1
    out = bilinear_gather(value, idx4, w_pairs, idx2, nl * P)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P),
                               atol=1e-5, rtol=1e-5)


def test_model_runs_through_both_kernels(card):
    from tamtr_torch import TAMTR
    from tamtr_torch.kernels.deform_scatter import bilinear_gather
    from tamtr_torch.kernels.selective_scan import ss2d_scan

    det = TAMTR("tamtr-nano.yaml", nc=4, device=card, imgsz=64)
    before = (ss2d_scan.launches, bilinear_gather.launches)
    res = det.predict(torch.rand(2, 64, 64, 3), torch.randn(4, 128), conf=0.0)
    assert len(res) == 2
    assert (ss2d_scan.launches - before[0], bilinear_gather.launches - before[1]) == (3, 3)
