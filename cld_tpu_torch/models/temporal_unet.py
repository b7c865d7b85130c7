"""1-D temporal UNet denoiser over the latent horizon (port of
`cld_tpu/models/temporal_unet.py`).

Channel ladder transition_dim -> dim*mults (4 -> 64 -> 128 -> 256 at the
config of record), horizon halving per level (52 -> 26 -> 13), two mid
blocks, skip-concat ups; every block adds a projection of
[sinusoidal-t-MLP || cond_feat]. Layout [B, T, C] at the boundary; keys
follow the reference `TemporalMapUnet`. At `compute_dtype` bf16
(`ops.precision`) the network runs under bf16 autocast over float32
parameters and eps_hat comes out in bf16; the samplers take it to float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from cld_tpu_torch.models.nets import (
    Conv1dBlock,
    Downsample1d,
    Mish,
    SinusoidalPosEmb,
    Upsample1d,
)
from cld_tpu_torch.ops.precision import autocast


class ResidualTemporalMapBlock(nn.Module):
    """Conv1dBlock -> + time/cond projection -> Conv1dBlock -> + residual."""

    def __init__(self, in_channels: int, out_channels: int, embed_dim: int,
                 kernel_size: int = 5):
        super().__init__()
        self.blocks = nn.ModuleList([
            Conv1dBlock(in_channels, out_channels, kernel_size),
            Conv1dBlock(out_channels, out_channels, kernel_size),
        ])
        self.time_mlp = nn.Sequential(Mish(), nn.Linear(embed_dim, out_channels))
        self.residual_conv = (
            nn.Conv1d(in_channels, out_channels, 1)
            if in_channels != out_channels else nn.Identity()
        )

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        out = self.blocks[0](x) + self.time_mlp(t)[:, None, :]
        out = self.blocks[1](out)
        if isinstance(self.residual_conv, nn.Conv1d):
            x = self.residual_conv(x.transpose(1, 2)).transpose(1, 2)
        return out + x


class TemporalMapUnet(nn.Module):
    """eps_hat = f(x_t [B, T, D], cond_feat [B, C], t [B] int) -> [B, T, D_out]."""

    compute_dtype = torch.float32

    def __init__(
        self,
        transition_dim: int = 4,
        output_dim: int = 4,
        cond_dim: int = 256,
        dim: int = 32,
        dim_mults: Sequence[int] = (2, 4, 8),
    ):
        super().__init__()
        self.down_factor = 2 ** (len(dim_mults) - 1)
        dims = [transition_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        embed_dim = dim + cond_dim
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim)
        )
        n = len(in_out)
        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            is_last = ind >= n - 1
            self.downs.append(nn.ModuleList([
                ResidualTemporalMapBlock(d_in, d_out, embed_dim),
                ResidualTemporalMapBlock(d_out, d_out, embed_dim),
                nn.Identity() if is_last else Downsample1d(d_out),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResidualTemporalMapBlock(mid, mid, embed_dim)
        self.mid_block2 = ResidualTemporalMapBlock(mid, mid, embed_dim)
        # ups mirror in_out[1:] reversed; the level-0 skip stays unused
        self.ups = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(reversed(in_out[1:])):
            is_last = ind >= n - 1
            self.ups.append(nn.ModuleList([
                ResidualTemporalMapBlock(d_out * 2, d_in, embed_dim),
                ResidualTemporalMapBlock(d_in, d_in, embed_dim),
                nn.Identity() if is_last else Upsample1d(d_in),
            ]))
        self.final_conv = nn.Sequential(
            Conv1dBlock(dims[1], dims[1], kernel_size=5),
            nn.Conv1d(dims[1], output_dim, 1),
        )

    def forward(self, x: torch.Tensor, cond_feat: torch.Tensor, time: torch.Tensor):
        if x.shape[1] % self.down_factor != 0:
            raise ValueError(
                f"horizon {x.shape[1]} must be divisible by {self.down_factor}"
            )
        with autocast(self.compute_dtype, x.device.type):
            return self._forward(x, cond_feat, time)

    def _forward(self, x, cond_feat, time):
        t = torch.cat([self.time_mlp(time), cond_feat], dim=-1)  # [B, dim + C]
        h = []
        for res0, res1, down in self.downs:
            x = res1(res0(x, t), t)
            h.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_block1(x, t), t)
        for res0, res1, up in self.ups:
            x = torch.cat([x, h.pop()], dim=-1)
            x = res1(res0(x, t), t)
            x = up(x)
        x = self.final_conv[0](x)
        return self.final_conv[1](x.transpose(1, 2)).transpose(1, 2)
