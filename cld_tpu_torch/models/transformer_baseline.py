"""Seq2seq transformer trajectory predictor (the `TransformerPred` algo; port
of `cld_tpu/models/transformer_baseline.py`): a transformer encoder over the
history tokens and a non-autoregressive decoder of learned future-time
queries that cross-attend to it, then a unicycle-integrated trajectory.

Submodules carry the flax names (`hist_proj`, `enc0`, `LayerNorm_0`,
`MultiHeadDotProductAttention_0`, `self_attn`, ...); LayerNorm takes flax's
epsilon, 1e-6; attention is `models.nets.MultiHeadDotProductAttention`.

At `compute_dtype` bf16 (`ops.precision`) the network runs under bf16
autocast, and its two learned embeddings (`hist_pos_emb`,
`future_queries`) are stored in bf16 (`compute_dtype_params`): the JAX
module creates them in its compute dtype. The other parameters stay
float32; the unicycle integration and the loss run outside autocast.
A masked attention logit takes the minimum of the logits' dtype, bf16's
under bf16, as flax's does.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.models.nets import MultiHeadDotProductAttention, mish
from cld_tpu_torch.models.vae import get_state_and_action_from_batch
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.precision import autocast


def _ln(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-6)


class EncoderBlock(nn.Module):
    def __init__(self, width: int, num_heads: int = 4):
        super().__init__()
        self.LayerNorm_0 = _ln(width)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(width, num_heads)
        self.LayerNorm_1 = _ln(width)
        self.Dense_0 = nn.Linear(width, width * 4)
        self.Dense_1 = nn.Linear(width * 4, width)

    def forward(self, x, mask=None):
        y = self.LayerNorm_0(x)
        x = x + self.MultiHeadDotProductAttention_0(y, y, mask=mask)
        return x + self.Dense_1(mish(self.Dense_0(self.LayerNorm_1(x))))


class DecoderBlock(nn.Module):
    def __init__(self, width: int, num_heads: int = 4):
        super().__init__()
        self.LayerNorm_0 = _ln(width)
        self.self_attn = MultiHeadDotProductAttention(width, num_heads)
        self.LayerNorm_1 = _ln(width)
        self.cross_attn = MultiHeadDotProductAttention(width, num_heads)
        self.LayerNorm_2 = _ln(width)
        self.Dense_0 = nn.Linear(width, width * 4)
        self.Dense_1 = nn.Linear(width * 4, width)

    def forward(self, q, kv):
        y = self.LayerNorm_0(q)
        q = q + self.self_attn(y, y)
        q = q + self.cross_attn(self.LayerNorm_1(q), kv)
        return q + self.Dense_1(mish(self.Dense_0(self.LayerNorm_2(q))))


class TransformerTrajectoryPredictor(nn.Module):
    """History tokens [B, hist_len, 5] (x, y, cos yaw, sin yaw, avail) ->
    future actions -> unicycle trajectory [B, horizon, 6]."""

    compute_dtype = torch.float32
    compute_dtype_params = ("hist_pos_emb", "future_queries")

    def __init__(self, hist_len: int = 31, horizon: int = 52, width: int = 64,
                 num_layers: int = 2, num_heads: int = 4,
                 dyn: UnicycleParams = RECORD_DYNAMICS, dt: float = 0.1):
        super().__init__()
        self.horizon, self.num_layers, self.dyn, self.dt = horizon, num_layers, dyn, dt
        self.hist_proj = nn.Linear(5, width)
        self.hist_pos_emb = nn.Parameter(torch.randn(1, hist_len, width) * 0.02)
        self.future_queries = nn.Parameter(torch.randn(1, horizon, width) * 0.02)
        for i in range(num_layers):
            setattr(self, f"enc{i}", EncoderBlock(width, num_heads))
            setattr(self, f"dec{i}", DecoderBlock(width, num_heads))
        self.action_head = nn.Linear(width, 2)

    def forward(self, batch: TrafficBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        hist = torch.cat([batch.history_positions, torch.cos(batch.history_yaws),
                          torch.sin(batch.history_yaws),
                          batch.history_availabilities[..., None]], dim=-1)  # [B, Th, 5]
        with autocast(self.compute_dtype, hist.device.type):
            tok = self.hist_proj(hist) + self.hist_pos_emb
            for i in range(self.num_layers):
                tok = getattr(self, f"enc{i}")(tok)
            q = self.future_queries.expand(hist.shape[0], -1, -1)
            for i in range(self.num_layers):
                q = getattr(self, f"dec{i}")(q, tok)
            actions = self.action_head(q)
        states = unicycle_forward_dynamics(self.dyn, get_current_states(batch), actions, self.dt)
        return {"trajectories": torch.cat([states, actions], dim=-1)}

    def loss(self, batch: TrafficBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        traj = self(batch, train)["trajectories"]
        gt = get_state_and_action_from_batch(batch, self.horizon, self.dt)
        avail = batch.target_availabilities[..., None]
        pos_loss = torch.mean(avail * (traj[..., :2] - gt[..., :2]) ** 2)
        yaw_loss = torch.mean(avail * (traj[..., 3:4] - gt[..., 3:4]) ** 2)
        return {"loss": pos_loss + yaw_loss, "trajectories": traj}
