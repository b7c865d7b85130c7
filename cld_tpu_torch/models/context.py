"""Context encoder: current state + raster stack -> conditioning feature
(port of `cld_tpu/models/context.py`).

A current-state MLP (4 -> 64), a ResNet map encoder (raster -> 256) and a
combine MLP (320 -> 256) with LayerNorm. `map_arch` names the encoder
(`resnet18`, `resnet34`, `resnet50`); a `_spatial_softmax` suffix puts the
keypoint head in place of the average pool. Keys follow the reference
(`map_encoder.encoder_heads.map_model.*` for the trunk). Under bf16 compute
(`compute_dtype`, `ops.precision`) the raster enters the trunk in bf16, as the
JAX module casts it, and `cond_feat` comes out in bf16."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.resnet import ResNetEncoder
from cld_tpu_torch.ops.precision import autocast


def parse_map_arch(map_arch: str):
    """"<arch>" or "<arch>_spatial_softmax" -> (arch, pool)."""
    suffix = "_spatial_softmax"
    if map_arch.endswith(suffix):
        return map_arch[: -len(suffix)], "spatial_softmax"
    return map_arch, "avg"


class _MapEncoder(nn.Module):
    def __init__(self, in_channels: int, feature_dim: int, map_arch: str = "resnet18"):
        super().__init__()
        arch, pool = parse_map_arch(map_arch)
        self.encoder_heads = nn.ModuleDict(
            {"map_model": ResNetEncoder(arch, in_channels, feature_dim, pool=pool)}
        )

    def forward(self, image, train: bool = False):
        return self.encoder_heads["map_model"](image, train)


class ContextEncoder(nn.Module):
    compute_dtype = torch.float32

    def __init__(
        self,
        in_channels: int = 34,
        curr_state_feat_dim: int = 64,
        map_feature_dim: int = 256,
        cond_feat_dim: int = 256,
        map_arch: str = "resnet18",
    ):
        super().__init__()
        self.agent_state_encoder = MLP(
            4, curr_state_feat_dim, (curr_state_feat_dim, curr_state_feat_dim),
            normalization=True,
        )
        self.map_encoder = _MapEncoder(in_channels, map_feature_dim, map_arch)
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
        image = batch.image
        if self.compute_dtype == torch.bfloat16:
            image = image.to(torch.bfloat16)
        with autocast(self.compute_dtype, curr_states.device.type):
            state_feat = self.agent_state_encoder(curr_states)
            map_feat = self.map_encoder(image, train)
            cond_feat = self.process_cond_mlp(torch.cat([state_feat, map_feat], dim=-1))
        return {"cond_feat": cond_feat, "curr_states": curr_states}
