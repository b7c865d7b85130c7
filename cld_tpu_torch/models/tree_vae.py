"""Staged trajectory-tree CVAE for contingency prediction (the `tree_vae`
algo; port of `cld_tpu/models/tree_vae.py`): the horizon splits into
`stages` segments of `frames_per_stage`; each stage has its own posterior
q(z_s | segment_s, cond_s) and decoder, and cond_s chains the previous
segment's end state, so different z_s per stage make a trajectory tree.

As in the JAX module, the context encoder always runs with its BatchNorm
running statistics (it is called without `train`), so a train step never
moves them. The reparametrization noise is explicit: `noise` [stages, B,
latent_dim], zeros (z = mean) when not given. Ego conditioning needs the
encoder built: `ec_traj_dim` is the conditioning trajectory's width.

At `compute_dtype` bf16 (`ops.precision`) the context encoder and every
network of the tree run under bf16 autocast over float32 parameters; the
reparametrization, the unicycle integration and the losses stay outside it,
as in the JAX module.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.cvae_nets import (
    MLPTrajectoryDecoder,
    PosteriorEncoder,
    RNNTrajectoryEncoder,
)
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.vae import get_state_and_action_from_batch
from cld_tpu_torch.ops.losses import kld_0_1_loss
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.ops.precision import autocast

STATE_EMBED_DIM = 32


class TreeTrajectoryVAE(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, raster_channels: int = 34, stages: int = 2, frames_per_stage: int = 10,
                 latent_dim: int = 4, condition_dim: int = 128, ec_feat_dim: int = 64,
                 cond_feat_dim: int = 256, map_arch: str = "resnet18", kl_weight: float = 10.0,
                 dt: float = 0.1, ec_traj_dim: Optional[int] = None):
        super().__init__()
        self.stages, self.frames_per_stage, self.latent_dim = stages, frames_per_stage, latent_dim
        self.kl_weight, self.dt = kl_weight, dt
        self.context = ContextEncoder(raster_channels, cond_feat_dim=cond_feat_dim,
                                      map_arch=map_arch)
        self.cond_proj = MLP(cond_feat_dim, condition_dim, (128,))
        self.state_embed = MLP(4, STATE_EMBED_DIM, ())
        self.ec_encoder = (RNNTrajectoryEncoder(ec_traj_dim, ec_feat_dim)
                           if ec_traj_dim is not None else None)
        cond_s = condition_dim + (ec_feat_dim if ec_traj_dim is not None else 0) + STATE_EMBED_DIM
        self.posteriors = nn.ModuleList([
            PosteriorEncoder(6, cond_s, {"mu": (latent_dim,), "logvar": (latent_dim,)})
            for _ in range(stages)])
        self.decoders = nn.ModuleList([
            MLPTrajectoryDecoder(latent_dim + cond_s, frames_per_stage, dt=dt)
            for _ in range(stages)])

    def _conditions(self, batch: TrafficBatch, cond_traj: Optional[torch.Tensor]):
        if cond_traj is not None and self.ec_encoder is None:
            raise ValueError("cond_traj needs a TreeTrajectoryVAE built with ec_traj_dim")
        with autocast(self.compute_dtype, batch.image.device.type):
            feats = [self.cond_proj(self.context(batch)["cond_feat"])]
            if cond_traj is not None:
                feats.append(self.ec_encoder(cond_traj))
            return torch.cat(feats, dim=-1)

    def _stage_cond(self, scene_feat, prev_state):
        with autocast(self.compute_dtype, prev_state.device.type):
            return torch.cat([scene_feat, self.state_embed(prev_state)], dim=-1)

    def forward(self, batch: TrafficBatch, train: bool = False,
                cond_traj: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Posterior forward and the per-stage losses."""
        F_, S = self.frames_per_stage, self.stages
        gt_scaled = TrajNormalizer().scale(get_state_and_action_from_batch(batch, F_ * S, self.dt))
        scene_feat = self._conditions(batch, cond_traj)
        cur = get_current_states(batch)
        recon, kld, trajs = 0.0, 0.0, []
        for s in range(S):
            seg = slice(s * F_, (s + 1) * F_)
            cond_s = self._stage_cond(scene_feat, cur)
            q = self.posteriors[s](gt_scaled[:, seg], cond_s)
            z = q["mu"] if noise is None else q["mu"] + noise[s] * torch.exp(0.5 * q["logvar"])
            traj = self.decoders[s](torch.cat([z, cond_s], dim=-1), curr_states=cur)[
                "trajectories"]  # [B, F, 6] descaled
            trajs.append(traj)
            av = batch.target_availabilities[:, seg, None]
            av_sum = torch.sum(av)
            recon = recon + torch.sum(((traj[..., :2] - batch.target_positions[:, seg]) ** 2) * av
                                      ) / torch.maximum(av_sum * 2, av_sum.new_tensor(1e-6))
            recon = recon + 0.05 * torch.sum(((traj[..., 3:4] - batch.target_yaws[:, seg]) ** 2)
                                             * av) / torch.maximum(av_sum, av_sum.new_tensor(1e-6))
            kld = kld + kld_0_1_loss(q["mu"], q["logvar"])
            cur = traj[:, -1, :4]  # chain the stages
        return {"loss": recon + self.kl_weight * kld, "recon": recon, "kld": kld,
                "trajectories": torch.cat(trajs, dim=1)}

    def sample(self, batch: TrafficBatch, n: int = 4, cond_traj: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prior tree sampling: n stage-latent chains -> [B, n, stages *
        frames_per_stage, 6]. `z` [stages, B * n, latent_dim] (sample-minor)
        is drawn from `generator` if not given."""
        F_, S = self.frames_per_stage, self.stages
        B = batch.image.shape[0]
        scene_rep = torch.repeat_interleave(self._conditions(batch, cond_traj), n, dim=0)
        cur = torch.repeat_interleave(get_current_states(batch), n, dim=0)
        if z is None:
            z = torch.randn((S, B * n, self.latent_dim), generator=generator, device=cur.device)
        trajs = []
        for s in range(S):
            traj = self.decoders[s](torch.cat([z[s], self._stage_cond(scene_rep, cur)], dim=-1),
                                    curr_states=cur)["trajectories"]
            trajs.append(traj)
            cur = traj[:, -1, :4]
        return torch.cat(trajs, dim=1).reshape(B, n, S * F_, 6)
