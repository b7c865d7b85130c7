"""Rasterized behavior-cloning planner, the simplest zoo baseline (port of
`cld_tpu/models/bc.py`): map raster + current state -> context feature ->
MLP action decoder -> unicycle-integrated trajectory. `goal_conditional`
(the `bc_gc` algo) adds a goal feature, by default the last available
future pose (teacher forcing).

At `compute_dtype` bf16 (`ops.precision`) the networks (context encoder,
goal encoder, action decoder) run under bf16 autocast over float32
parameters; the unicycle integration and the loss take the bf16 actions
outside it, as the JAX module's do (float32 where they meet the float32
state).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.spatial_planner import last_available_index
from cld_tpu_torch.models.vae import get_state_and_action_from_batch
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.precision import autocast


class BCPlanner(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, raster_channels: int = 34, horizon: int = 52, cond_feat_dim: int = 256,
                 map_arch: str = "resnet18", goal_conditional: bool = False,
                 goal_feature_dim: int = 32, dyn: UnicycleParams = RECORD_DYNAMICS,
                 dt: float = 0.1):
        super().__init__()
        self.horizon, self.dyn, self.dt = horizon, dyn, dt
        self.goal_conditional = goal_conditional
        self.context_encoder = ContextEncoder(raster_channels, cond_feat_dim=cond_feat_dim,
                                              map_arch=map_arch)
        dec_in = cond_feat_dim + (goal_feature_dim if goal_conditional else 0)
        self.decoder = MLP(dec_in, horizon * 2, (cond_feat_dim, cond_feat_dim),
                           normalization=True)
        if goal_conditional:
            self.goal_encoder = MLP(3, goal_feature_dim, (32,))

    def _goal_feature(self, batch: TrafficBatch, goal: Optional[torch.Tensor]):
        if goal is None:
            idx = last_available_index(batch.target_availabilities)
            b = torch.arange(batch.target_positions.shape[0], device=idx.device)
            goal = torch.cat([batch.target_positions[b, idx], batch.target_yaws[b, idx]], dim=-1)
        return self.goal_encoder(goal)

    def forward(self, batch: TrafficBatch, train: bool = False,
                goal: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """`goal` [B, 3] (x, y, yaw) overrides the teacher-forced goal."""
        with autocast(self.compute_dtype, batch.image.device.type):
            aux = self.context_encoder(batch, train)
            feat = aux["cond_feat"]
            if self.goal_conditional:
                feat = torch.cat([feat, self._goal_feature(batch, goal)], dim=-1)
            actions = self.decoder(feat).reshape(-1, self.horizon, 2)
        states = unicycle_forward_dynamics(self.dyn, get_current_states(batch), actions, self.dt)
        return {"trajectories": torch.cat([states, actions], dim=-1), "aux_info": aux}

    def loss(self, batch: TrafficBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        """Position + yaw MSE against the ground truth, availability-masked."""
        traj = self(batch, train)["trajectories"]
        gt = get_state_and_action_from_batch(batch, self.horizon, self.dt)
        avail = batch.target_availabilities[..., None]
        pos_loss = torch.mean(avail * (traj[..., :2] - gt[..., :2]) ** 2)
        yaw_loss = torch.mean(avail * (traj[..., 3:4] - gt[..., 3:4]) ** 2)
        return {"loss": pos_loss + yaw_loss, "pos_loss": pos_loss, "yaw_loss": yaw_loss,
                "trajectories": traj}
