"""VMamba SS2D mixer and VSS block (torch port of `tamtr_tpu/nn/ssm.py`).

Channels-last (B, H, W, C) throughout, as in the JAX package. The four scan
directions run in one call of `kernels.selective_scan.ss2d_scan`, which reads
the (B, 2, L, D) row/column layouts in place and walks the reversed
directions backwards, so no flipped copies exist. LayerNorm eps is 1e-5
everywhere (torch's default, which the reference uses).

Parameter names and shapes follow the reference checkpoint: `A_logs` is
(K*D, N) and `Ds` is (K*D,), with K = 4 directions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tamtr_torch.kernels.selective_scan import ss2d_scan

K_DIRS = 4


class SS2D(nn.Module):
    """2-D selective-scan mixer, the reference's `forward_type="v2"`.

    x (B, H, W, d_model) -> (B, H, W, d_model).
    """

    def __init__(self, d_model: int, d_state: int = 16, ssm_ratio: float = 2.0, d_conv: int = 3):
        super().__init__()
        d_inner = int(ssm_ratio * d_model)
        self.d_inner, self.N = d_inner, d_state
        self.R = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv, padding=d_conv // 2, groups=d_inner)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, self.R + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, d_inner, self.R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * d_inner, d_state))
        self.Ds = nn.Parameter(torch.empty(K_DIRS * d_inner))
        self.out_norm = nn.LayerNorm(d_inner, eps=1e-5)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        Di, N, R, L = self.d_inner, self.N, self.R, H * W
        xm, z = self.in_proj(x).chunk(2, -1)
        z = F.silu(z)
        xm = F.silu(self.conv2d(xm.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        x_row = xm.reshape(B, L, Di)
        x_col = xm.transpose(1, 2).reshape(B, L, Di)
        layouts = torch.stack([x_row, x_col], 1)  # (B, 2, L, Di)
        # direction k = 2f + j projects layout j with x_proj_weight[k]
        Wp = self.x_proj_weight.view(2, 2, R + 2 * N, Di)
        x_dbl = torch.einsum("bjld,fjcd->bfjlc", layouts, Wp).contiguous()  # (B, 2, 2, L, R+2N)
        dts_raw, Bs, Cs = x_dbl.split([R, N, N], dim=-1)  # views the kernel reads in place
        A = -torch.exp(self.A_logs.view(K_DIRS, Di, N))
        ys = ss2d_scan(
            layouts, dts_raw, self.dt_projs_weight, self.dt_projs_bias, A, Bs, Cs,
            self.Ds.view(K_DIRS, Di),
        )  # (B, 4, L, Di) natural order
        y_col = (ys[:, 1] + ys[:, 3]).view(B, W, H, Di).transpose(1, 2).reshape(B, L, Di)
        y = ys[:, 0] + ys[:, 2] + y_col
        y = self.out_norm(y).view(B, H, W, Di) * z
        return self.out_proj(y)


class Mlp(nn.Module):
    """GELU MLP inside VSSBlock (tanh-approximate GELU, as the JAX package runs it)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class VSSBlock(nn.Module):
    """Pre-norm residual SS2D + MLP block, channels-last. Eval only: DropPath
    is the identity."""

    def __init__(self, hidden_dim: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.op = SS2D(hidden_dim, d_state=d_state, ssm_ratio=ssm_ratio)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.mlp = Mlp(hidden_dim, int(hidden_dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.op(self.norm(x))
        return x + self.mlp(self.norm2(x))
