"""Vector agent and neighbor history encoders (port of
`cld_tpu/models/history_encoders.py`): each agent's past states become an
(x, y, hx, hy, s, l, w, avail) vector per step, flattened through an MLP;
neighbors are encoded one by one and max-pooled, a neighbor with no
available step left out. Submodules carry the flax names (`traj_mlp`,
`agt_hist_encoder`) for `utils.weights.load_flax`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from cld_tpu_torch.models.nets import MLP


def prepare_hist_in(pos: torch.Tensor, yaw: torch.Tensor, speed: torch.Tensor,
                    extent: torch.Tensor, avail: torch.Tensor, add_coeffs: Sequence[float],
                    div_coeffs: Sequence[float]) -> torch.Tensor:
    """History [B, T, ...] -> flat [B, T * 8] features (x, y, hx, hy, s, l,
    w, avail), unavailable steps zeroed; (x, y), s and (l, w) normalized as
    (v + add) / div with the five coefficients."""
    B, T, _ = pos.shape
    hvec = torch.cat([torch.cos(yaw), torch.sin(yaw)], dim=-1)
    lw = extent[:, None, :2].expand(B, T, 2)
    add = torch.as_tensor(np.asarray(add_coeffs, np.float32), device=pos.device)
    div = torch.as_tensor(np.asarray(div_coeffs, np.float32), device=pos.device)
    pos_n = (pos + add[:2]) / div[:2]
    speed_n = (speed[..., None] + add[2]) / div[2]
    lw_n = (lw + add[3:]) / div[3:]
    feats = torch.cat([pos_n, hvec, speed_n, lw_n, avail[..., None]], dim=-1)  # [B, T, 8]
    feats = torch.where(avail[..., None] > 0, feats, torch.zeros_like(feats))
    return feats.reshape(B, -1)


class AgentHistoryEncoder(nn.Module):
    """Flattened-history MLP over `num_steps` steps -> [B, out_dim]."""

    def __init__(self, num_steps: int, out_dim: int = 128,
                 norm_add: Sequence[float] = (0.0,) * 5, norm_div: Sequence[float] = (1.0,) * 5):
        super().__init__()
        self.norm_add, self.norm_div = tuple(norm_add), tuple(norm_div)
        d = num_steps * 8
        self.traj_mlp = MLP(d, out_dim, (d, d, out_dim, out_dim), normalization=True)

    def forward(self, pos, yaw, speed, extent, avail) -> torch.Tensor:
        return self.traj_mlp(prepare_hist_in(pos, yaw, speed, extent, avail, self.norm_add,
                                             self.norm_div))


class NeighborHistoryEncoder(nn.Module):
    """Per-neighbor encoding and an availability-masked max pool:
    pos [B, Q, T, 2], ... -> [B, out_dim]."""

    def __init__(self, num_steps: int, out_dim: int = 128,
                 norm_add: Sequence[float] = (0.0,) * 5, norm_div: Sequence[float] = (1.0,) * 5):
        super().__init__()
        self.agt_hist_encoder = AgentHistoryEncoder(num_steps, out_dim, norm_add, norm_div)

    def forward(self, pos, yaw, speed, extent, avail) -> torch.Tensor:
        B, Q, T, _ = pos.shape
        enc = self.agt_hist_encoder(pos.reshape(B * Q, T, 2), yaw.reshape(B * Q, T, 1),
                                    speed.reshape(B * Q, T), extent.reshape(B * Q, 3),
                                    avail.reshape(B * Q, T)).reshape(B, Q, -1)
        # a neighbor with no available step is -inf, so that the pool skips it
        has_any = torch.any(avail > 0, dim=-1)  # [B, Q]
        enc = torch.where(has_any[..., None], enc, torch.full_like(enc, float("-inf")))
        pooled = torch.amax(enc, dim=1)
        # a scene with no such neighbor pools to 0, not -inf
        return torch.where(torch.isfinite(pooled), pooled, torch.zeros_like(pooled))
