"""Deploy-time fusion (a port of `tamtr_tpu/nn/fuse.py`; the reference's
`switch_to_deploy` and `fuse()`).

`fuse_model(model)` returns an eval twin of a `TAMTRModel` that computes
the same function with fewer launches; `model` itself is not changed.

- Each RepConvN's 3x3 and 1x1 branches, each with its eval BatchNorm folded
  in, become one biased 3x3 conv `fused`, the 1x1 in the centre tap
  (`fuse_repconv`; reference `extra_modules/block.py:61-125`,
  `get_equivalent_kernel_bias`). The JAX package does the same to its
  variables (`fuse_repconv_variables`), and `TAMTRModel(..., deploy=True)`
  is the layout both give.
- Every other conv that a BatchNorm follows (each `ConvBN`, the head's three
  input projections) gets that BatchNorm folded into a biased conv
  (`fuse_conv_bn`; reference `torch_utils.py:159-206` `fuse_conv_and_bn`).
  The JAX package leaves this to XLA, which folds eval BatchNorm into the
  conv under jit; in eager PyTorch each BatchNorm is a launch of its own.

Folding is done in float64 and rounded once to the weights' dtype (fp32:
at a bf16 compute dtype the folded weights are cast at use, as every
layer's are).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from tamtr_torch.nn.layers import Conv2d, ConvBN, RepConvN


def _folded(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    """(weight, bias) in float64 of `conv` followed by eval-mode `bn`."""
    scale = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
    w = conv.weight.double() * scale[:, None, None, None]
    b0 = conv.bias.double() if conv.bias is not None else torch.zeros_like(scale)
    return w, bn.bias.double() + (b0 - bn.running_mean.double()) * scale


def _conv_like(conv: nn.Conv2d, weight: torch.Tensor, bias: torch.Tensor, padding=None) -> nn.Conv2d:
    """A biased Conv2d with `conv`'s geometry (and `padding` if given)."""
    out = Conv2d(conv.in_channels, conv.out_channels, weight.shape[-2:], conv.stride,
                 conv.padding if padding is None else padding, conv.dilation, conv.groups, bias=True,
                 device=conv.weight.device, dtype=conv.weight.dtype)
    out.weight.copy_(weight)
    out.bias.copy_(bias)
    return out


@torch.no_grad()
def fuse_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """One biased conv equal to `conv` then eval-mode `bn`."""
    return _conv_like(conv, *_folded(conv, bn))


@torch.no_grad()
def fuse_repconv(m: RepConvN) -> nn.Conv2d:
    """The biased 3x3 conv equal to an unfused RepConvN's two branches with
    their BatchNorms (before the activation)."""
    w3, b3 = _folded(m.conv1.conv, m.conv1.bn)
    w1, b1 = _folded(m.conv2.conv, m.conv2.bn)
    w3[:, :, 1, 1] += w1[:, :, 0, 0]
    return _conv_like(m.conv1.conv, w3, b3 + b1, padding=1)


def fuse_model(model: nn.Module) -> nn.Module:
    """A fused eval copy of `model`, without gradients: every RepConvN
    fused, every other conv + BatchNorm pair folded (module docstring). It
    computes at the model's own dtype (`TAMTRModel.dtype`; `with_dtype` of
    the twin for another); the folding is in float64 whatever the dtype.
    Its tensors are ordinary ones also when called under inference mode."""
    with torch.inference_mode(False), torch.no_grad():
        twin = copy.deepcopy(model).eval()
        _fuse_in_place(twin)
    return twin.requires_grad_(False)


def _fuse_in_place(twin: nn.Module) -> None:
    for m in list(twin.modules()):
        if isinstance(m, RepConvN) and not m.deploy:
            m.fused = fuse_repconv(m)
            del m.conv1, m.conv2
            m.deploy = True
    for m in list(twin.modules()):
        if isinstance(m, ConvBN) and isinstance(m.bn, nn.BatchNorm2d):
            m.conv, m.bn = fuse_conv_bn(m.conv, m.bn), nn.Identity()
        elif isinstance(m, nn.Sequential) and len(m) == 2 and isinstance(m[0], nn.Conv2d) \
                and isinstance(m[1], nn.BatchNorm2d):  # the head's input projections
            m[0], m[1] = fuse_conv_bn(m[0], m[1]), nn.Identity()
