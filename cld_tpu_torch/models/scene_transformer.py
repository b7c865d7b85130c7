"""Scene-level transformer denoiser, the CTG++ model family (port of
`cld_tpu/models/scene_transformer.py`): every agent of a scene is denoised
jointly with factorized attention, self-attention along time per agent
alternating with self-attention across agents per timestep (padding agents
masked as keys), conditioned on per-agent context features and the
diffusion step.

Submodules carry the flax names (`Dense_0`, `time_pos_emb`, `input_proj`,
`cond_proj`, `block<i>` with `LayerNorm_<k>`, `time_attn`, `agent_attn`,
`Dense_<k>`, `LayerNorm_0`, `output_proj`) for `utils.weights.load_flax`.
LayerNorm takes flax's epsilon (1e-6); masked attention logits take the
minimum of their dtype, as flax's (`models.nets.MultiHeadDotProductAttention`).
`time_pos_emb` is shaped by the horizon, given at construction.

At `compute_dtype` bf16 (`ops.precision`) the denoiser runs under bf16
autocast over float32 parameters, except `time_pos_emb`, which is stored in
bf16 (`compute_dtype_params`) because the JAX module creates it in its
compute dtype; eps comes out bf16 and the diffusion math takes it in
float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cld_tpu_torch.models.nets import MultiHeadDotProductAttention, SinusoidalPosEmb, mish
from cld_tpu_torch.ops.precision import autocast


def _ln(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-6)


class FactorizedBlock(nn.Module):
    """Time attention -> agent attention -> Mish MLP, each pre-LayerNorm
    with a residual."""

    def __init__(self, width: int, num_heads: int = 4):
        super().__init__()
        self.LayerNorm_0 = _ln(width)
        self.time_attn = MultiHeadDotProductAttention(width, num_heads)
        self.LayerNorm_1 = _ln(width)
        self.agent_attn = MultiHeadDotProductAttention(width, num_heads)
        self.LayerNorm_2 = _ln(width)
        self.Dense_0 = nn.Linear(width, width * 4)
        self.Dense_1 = nn.Linear(width * 4, width)

    def forward(self, h: torch.Tensor, agent_mask: torch.Tensor) -> torch.Tensor:
        """h [B, A, T, F]; agent_mask [B, A] bool (True = a real agent)."""
        B, A, T, F = h.shape
        x = h.reshape(B * A, T, F)
        y = self.LayerNorm_0(x)
        h = (x + self.time_attn(y, y)).reshape(B, A, T, F)

        x = h.transpose(1, 2).reshape(B * T, A, F)
        mask = agent_mask[:, None, None, :].expand(B, T, A, A).reshape(B * T, 1, A, A)
        y = self.LayerNorm_1(x)
        x = x + self.agent_attn(y, y, mask=mask)
        h = x.reshape(B, T, A, F).transpose(1, 2)

        return h + self.Dense_1(mish(self.Dense_0(self.LayerNorm_2(h))))


class SceneTransformerDenoiser(nn.Module):
    """(x [B, A, T, D], cond [B, A, C], t [B], agent_mask [B, A]) ->
    eps [B, A, T, output_dim], zero on padding agents."""

    compute_dtype = torch.float32
    compute_dtype_params = ("time_pos_emb",)

    def __init__(self, horizon: int, cond_dim: int, transition_dim: int = 6,
                 output_dim: int = 6, width: int = 128, num_layers: int = 4, num_heads: int = 4,
                 time_dim: int = 32):
        super().__init__()
        self.num_layers = num_layers
        self.time_emb = SinusoidalPosEmb(time_dim)
        self.Dense_0 = nn.Linear(time_dim, width)
        self.time_pos_emb = nn.Parameter(torch.randn(1, 1, horizon, width) * 0.02)
        self.input_proj = nn.Linear(transition_dim, width)
        self.cond_proj = nn.Linear(cond_dim, width)
        for i in range(num_layers):
            setattr(self, f"block{i}", FactorizedBlock(width, num_heads))
        self.LayerNorm_0 = _ln(width)
        self.output_proj = nn.Linear(width, output_dim)

    def forward(self, x: torch.Tensor, cond_feat: torch.Tensor, time: torch.Tensor,
                agent_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, A = x.shape[:2]
        if agent_mask is None:
            agent_mask = torch.ones((B, A), dtype=torch.bool, device=x.device)
        with autocast(self.compute_dtype, x.device.type):
            t_emb = self.Dense_0(self.time_emb(time))  # [B, W]
            h = (self.input_proj(x) + self.time_pos_emb + self.cond_proj(cond_feat)[:, :, None]
                 + t_emb[:, None, None])
            for i in range(self.num_layers):
                h = getattr(self, f"block{i}")(h, agent_mask)
            out = self.output_proj(self.LayerNorm_0(h))
        return out * agent_mask[..., None, None]
