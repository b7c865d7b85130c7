"""Residual-MLP denoiser, the alternative to the temporal UNet
(`diffuser_model_arch="MLPResNetwork"`; port of `cld_tpu/models/dm_mlp.py`).

The latent sequence is flattened and concatenated with a sinusoidal time
embedding and the conditioning, passed through residual MLP blocks and
reshaped back; same (x, cond_feat, t) signature as `TemporalMapUnet`.
Submodules carry the flax module names (`Dense_0`, `LayerNorm_0`, `block0`,
...) so that `utils.weights.export_flax` maps the JAX variables one to one;
LayerNorm takes flax's epsilon, 1e-6. At `compute_dtype` bf16
(`ops.precision`) it runs under bf16 autocast, as `TemporalMapUnet` does.
"""

from __future__ import annotations

import torch
from torch import nn

from cld_tpu_torch.models.nets import SinusoidalPosEmb, mish
from cld_tpu_torch.ops.precision import autocast


class ResidualMLPBlock(nn.Module):
    def __init__(self, in_dim: int, width: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, width)
        self.LayerNorm_0 = nn.LayerNorm(width, eps=1e-6)
        self.Dense_1 = nn.Linear(width, width)
        self.Dense_2 = nn.Linear(in_dim, width) if in_dim != width else None

    def forward(self, x):
        h = self.Dense_1(mish(self.LayerNorm_0(self.Dense_0(x))))
        if self.Dense_2 is not None:
            x = self.Dense_2(x)
        return mish(x + h)


class MLPResDenoiser(nn.Module):
    """(x [B, T, D], cond [B, C], t [B]) -> [B, T, D]."""

    compute_dtype = torch.float32

    def __init__(self, horizon: int = 52, transition_dim: int = 4, cond_dim: int = 256,
                 width: int = 512, num_blocks: int = 3, time_dim: int = 32):
        super().__init__()
        self.time_emb = SinusoidalPosEmb(time_dim)
        self.Dense_0 = nn.Linear(time_dim, time_dim * 4)
        self.Dense_1 = nn.Linear(time_dim * 4, time_dim)
        d = horizon * transition_dim + time_dim + cond_dim
        for i in range(num_blocks):
            setattr(self, f"block{i}", ResidualMLPBlock(d, width))
            d = width
        self.num_blocks = num_blocks
        self.out = nn.Linear(width, horizon * transition_dim)

    def forward(self, x: torch.Tensor, cond_feat: torch.Tensor, time: torch.Tensor):
        B, T, D = x.shape
        with autocast(self.compute_dtype, x.device.type):
            t = self.Dense_1(mish(self.Dense_0(self.time_emb(time))))
            h = torch.cat([x.reshape(B, T * D), t, cond_feat], dim=-1)
            for i in range(self.num_blocks):
                h = getattr(self, f"block{i}")(h)
            return self.out(h).reshape(B, T, D)
