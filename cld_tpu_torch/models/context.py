"""Context encoder: current state + raster stack -> conditioning feature
(port of `cld_tpu/models/context.py`).

A current-state MLP (4 -> 64), a ResNet-18 map encoder (raster -> 256) and
a combine MLP (320 -> 256) with LayerNorm. Keys follow the reference
(`map_encoder.encoder_heads.map_model.*` for the trunk)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.resnet import ResNet18Encoder


class _MapEncoder(nn.Module):
    def __init__(self, in_channels: int, feature_dim: int):
        super().__init__()
        self.encoder_heads = nn.ModuleDict(
            {"map_model": ResNet18Encoder(in_channels, feature_dim)}
        )

    def forward(self, image, train: bool = False):
        return self.encoder_heads["map_model"](image, train)


class ContextEncoder(nn.Module):
    def __init__(
        self,
        in_channels: int = 34,
        curr_state_feat_dim: int = 64,
        map_feature_dim: int = 256,
        cond_feat_dim: int = 256,
    ):
        super().__init__()
        self.agent_state_encoder = MLP(
            4, curr_state_feat_dim, (curr_state_feat_dim, curr_state_feat_dim),
            normalization=True,
        )
        self.map_encoder = _MapEncoder(in_channels, map_feature_dim)
        cond_in_dim = curr_state_feat_dim + map_feature_dim
        self.process_cond_mlp = MLP(
            cond_in_dim, cond_feat_dim,
            (cond_in_dim, cond_in_dim, cond_feat_dim, cond_feat_dim),
            normalization=True,
        )

    def forward(self, batch: TrafficBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        """`train` picks BatchNorm's batch statistics (and moves the running
        ones) in the map encoder; nothing else here depends on it."""
        curr_states = get_current_states(batch)  # [B, 4]
        state_feat = self.agent_state_encoder(curr_states)
        map_feat = self.map_encoder(batch.image, train)
        cond_feat = self.process_cond_mlp(torch.cat([state_feat, map_feat], dim=-1))
        return {"cond_feat": cond_feat, "curr_states": curr_states}
