"""Shared network building blocks (port of `cld_tpu/models/nets.py`).

Modules keep the JAX package's channels-last [B, T, C] layout at their
boundary and the reference's torch `state_dict` key layout inside, so the
weights that `cld_tpu_torch.utils.weights` converts load with
``strict=True``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class MLP(nn.Module):
    """Hidden layers of Linear[+LayerNorm]+ReLU, final plain Linear.

    Keys follow the reference MLP's ``_model`` Sequential: [Linear,
    LayerNorm?, ReLU] per hidden layer, then the output Linear. LayerNorm
    takes flax's epsilon (1e-6), the value the converted weights were
    trained with."""

    def __init__(self, input_dim: int, output_dim: int,
                 layer_dims: Sequence[int] = (), normalization: bool = False):
        super().__init__()
        layers = []
        d = input_dim
        for width in layer_dims:
            layers.append(nn.Linear(d, width))
            if normalization:
                layers.append(nn.LayerNorm(width, eps=1e-6))
            layers.append(nn.ReLU())
            d = width
        layers.append(nn.Linear(d, output_dim))
        self._model = nn.Sequential(*layers)

    def forward(self, x):
        return self._model(x)


class SinusoidalPosEmb(nn.Module):
    """Transformer-style sinusoidal timestep embedding."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, device=t.device, dtype=torch.float32) * -emb)
        emb = t.to(torch.float32)[:, None] * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class FusedGroupNorm(nn.Module):
    """GroupNorm over [B, T, C] with the JAX package's statistics: f32
    moments, variance E[x^2] - E[x]^2 clamped at 0, epsilon 1e-5 inside the
    rsqrt. Parameters are torch GroupNorm's ``weight``/``bias`` [C]. The
    output takes the input's dtype when that is bf16 (the JAX module's
    `astype(self.dtype)` under bf16 compute)."""

    def __init__(self, num_channels: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups != 0:
            raise ValueError(
                f"FusedGroupNorm: num_groups={num_groups} must divide "
                f"features={num_channels}"
            )
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        G = self.num_groups
        Cg = C // G
        x32 = x.to(torch.float32)
        s = torch.sum(x32, dim=1)  # [B, C]
        ss = torch.sum(x32 * x32, dim=1)
        n = T * Cg
        mean = torch.sum(s.reshape(B, G, Cg), dim=-1) / n  # [B, G]
        var = torch.clamp(torch.sum(ss.reshape(B, G, Cg), dim=-1) / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        mean_c = torch.repeat_interleave(mean, Cg, dim=-1)  # [B, C]
        inv_c = torch.repeat_interleave(inv, Cg, dim=-1)
        y = (x32 - mean_c[:, None, :]) * (inv_c[:, None, :] * self.weight) + self.bias
        return y.to(torch.bfloat16) if x.dtype == torch.bfloat16 else y


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm(8) -> Mish over [B, T, C]. Keys ``block.0``
    (conv) and ``block.2`` (norm), as the reference's Sequential."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5,
                 n_groups: int = 8):
        super().__init__()
        self.block = nn.ModuleList([
            nn.Conv1d(in_channels, out_channels, kernel_size, padding=kernel_size // 2),
            nn.Identity(),
            FusedGroupNorm(out_channels, n_groups),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block[0](x.transpose(1, 2)).transpose(1, 2)
        return mish(self.block[2](y))


class Downsample1d(nn.Module):
    """Stride-2 conv halving the horizon, over [B, T, C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class Upsample1d(nn.Module):
    """Stride-2 transposed conv doubling the horizon, over [B, T, C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class MultiHeadDotProductAttention(nn.Module):
    """flax's `nn.MultiHeadDotProductAttention` (no dropout): per-head
    query / key / value projections, softmax(q k^T / sqrt(head_dim)) and an
    output projection, in the dtype of the region it runs in (bf16 logits
    under bf16 autocast). A masked logit takes the minimum of the logits'
    dtype, not -inf, as flax's does at its `dtype`, so a query whose keys
    are all masked averages them uniformly instead of giving NaN. Plain
    matmuls and softmax, as the JAX package computes it outside any kernel.

    `query`, `key`, `value` are Linear(in, qkv_features) and `out`
    Linear(qkv_features, out_features); flax's [D, H, hd] and [H, hd, D]
    kernels flatten onto them head-major."""

    def __init__(self, in_features: int, num_heads: int, qkv_features: int = None,
                 out_features: int = None, kv_features: int = None):
        super().__init__()
        qkv_features = qkv_features or in_features
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.query = nn.Linear(in_features, qkv_features)
        self.key = nn.Linear(kv_features or in_features, qkv_features)
        self.value = nn.Linear(kv_features or in_features, qkv_features)
        self.out = nn.Linear(qkv_features, out_features or in_features)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor = None,
                mask: torch.Tensor = None) -> torch.Tensor:
        """inputs_q [B, Lq, D], inputs_kv [B, Lk, D] (default: inputs_q);
        mask broadcastable to [B, heads, Lq, Lk], True where attended."""
        if inputs_kv is None:
            inputs_kv = inputs_q
        B, Lq, _ = inputs_q.shape
        Lk = inputs_kv.shape[1]
        H = self.num_heads
        q = self.query(inputs_q).reshape(B, Lq, H, -1)
        k = self.key(inputs_kv).reshape(B, Lk, H, -1)
        v = self.value(inputs_kv).reshape(B, Lk, H, -1)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Lq, -1)
        return self.out(y)
