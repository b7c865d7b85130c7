"""Multi-agent trajectory predictor (the `agent_predictor` and `bc_ec` algos;
port of `cld_tpu/models/agent_predictor.py`): one ego-centric raster encodes
the scene; the ego takes the global context feature and every neighbor a
rotated-ROI feature cropped from a shared map grid at its current position;
MLP heads decode the ego's actions (unicycle-integrated) and the neighbors'
position offsets. `ec_conditioning` (the `bc_ec` algo) conditions the
neighbors on the ego's plan, the ground-truth future in training.

At `compute_dtype` bf16 (`ops.precision`) the context encoder, the ROI
encoder, the plan encoder and both heads run under bf16 autocast over
float32 parameters; the raster transform of the neighbors' positions, the
unicycle integration and the loss stay outside it, as in the JAX module.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.cvae_nets import RNNTrajectoryEncoder
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.roi_encoder import ROIMapEncoder
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.geometry import transform_points
from cld_tpu_torch.ops.precision import autocast


class MAAgentPredictor(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, raster_channels: int = 34, horizon: int = 52, dt: float = 0.1,
                 cond_feat_dim: int = 256, agent_feature_dim: int = 64,
                 map_arch: str = "resnet18", hidden: int = 256, ec_conditioning: bool = False,
                 ec_feat_dim: int = 64, dyn: UnicycleParams = RECORD_DYNAMICS,
                 pixel_size: float = 0.5):
        super().__init__()
        self.horizon, self.dt, self.dyn = horizon, dt, dyn
        self.ec_conditioning = ec_conditioning
        self.context = ContextEncoder(raster_channels, cond_feat_dim=cond_feat_dim,
                                      map_arch=map_arch)
        self.roi = ROIMapEncoder(raster_channels, agent_feature_dim=agent_feature_dim,
                                 pixel_size=pixel_size)
        self.ego_head = MLP(cond_feat_dim, horizon * 2, (hidden, hidden))
        neigh_in = agent_feature_dim + cond_feat_dim
        if ec_conditioning:
            self.ec_encoder = RNNTrajectoryEncoder(2, ec_feat_dim)
            neigh_in += ec_feat_dim
        self.neigh_head = MLP(neigh_in, horizon * 2, (hidden,))

    def forward(self, batch: TrafficBatch, train: bool = False,
                cond_traj: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """`cond_traj` [B, T, 2] is the ego plan the neighbors condition on
        (default: the ground-truth future)."""
        B = batch.image.shape[0]
        S = batch.all_other_agents_history_positions.shape[1]
        T = self.horizon
        dev = batch.image.device.type
        neigh_pos = batch.all_other_agents_history_positions[:, :, -1]  # [B, S, 2]
        neigh_yaw = batch.all_other_agents_history_yaws[:, :, -1, 0]  # [B, S]
        centers_px = transform_points(neigh_pos, batch.raster_from_agent)
        with autocast(self.compute_dtype, dev):
            ego_feat = self.context(batch, train)["cond_feat"]  # [B, C]
            roi_feat = self.roi(batch.image, centers_px, neigh_yaw, train)  # [B, S, F]
            ego_act = self.ego_head(ego_feat).reshape(B, T, 2)
        ego_states = unicycle_forward_dynamics(self.dyn, get_current_states(batch), ego_act,
                                               self.dt)
        feats = [roi_feat, ego_feat[:, None].expand(B, S, ego_feat.shape[-1])]
        with autocast(self.compute_dtype, dev):
            if self.ec_conditioning:
                plan = cond_traj if cond_traj is not None else batch.target_positions
                ec = self.ec_encoder(plan)
                feats.append(ec[:, None].expand(B, S, ec.shape[-1]))
            neigh_traj = self.neigh_head(torch.cat(feats, dim=-1)).reshape(B, S, T, 2)
        return {
            "ego_positions": ego_states[..., :2],
            "ego_yaws": ego_states[..., 3:4],
            "ego_actions": ego_act,
            "agent_positions": neigh_traj + neigh_pos[:, :, None, :],  # offsets from now
        }

    def loss(self, batch: TrafficBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        """Availability-masked future MSE of the ego (positions, yaw) and the
        neighbors (positions)."""
        out = self(batch, train)

        def masked_mean(sq, av, per):
            s = torch.sum(av) * per
            return torch.sum(sq * av) / torch.maximum(s, s.new_tensor(1e-6))

        ego_av = batch.target_availabilities[..., None]
        ego_mse = masked_mean((out["ego_positions"] - batch.target_positions) ** 2, ego_av, 2)
        yaw_mse = masked_mean((out["ego_yaws"] - batch.target_yaws) ** 2, ego_av, 1)
        n_av = batch.all_other_agents_future_availability[..., None]
        neigh_mse = masked_mean(
            (out["agent_positions"] - batch.all_other_agents_future_positions) ** 2, n_av, 2)
        return {"loss": ego_mse + yaw_mse + neigh_mse, "ego_mse": ego_mse, "yaw_mse": yaw_mse,
                "neigh_mse": neigh_mse, **out}
